"""The port's speculative decoding against the reference's, on the CPU.

Both packages run on the same seeded numpy inputs at the reduced size:
the drafters' proposals, ``verify_attention``'s plain route against
``ref.verify_decode_xla`` (f32, 1e-5, rows past the view included),
``lm_verify_step`` against the reference's (rtol = atol = 1e-4, the
tolerance of ``tests/test_torch_models.py``), ``PagedKVCache.write_rows``
page for page, and engines, dense and paged, against the JAX engine on
``tests/test_spec.py``'s prompts in float32: speculative greedy streams
equal spec-off's and the JAX engine's, with the same spec counters and
verify plan keys, no policy evaluation inside a launch, and page
conservation.  The replay oracle on ``benchmarks/spec_ab.py``'s workload
gives ``experiments/bench/spec_ab.csv``'s oracle row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.kernels import ref as jref
from repro.models import build_model as j_build_model
from repro.models import lm as jlm
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.spec import Drafter as JDrafter
from repro.spec import SpecConfig as JSpecConfig
from repro.spec import VerifyOutcome as JVerifyOutcome
from repro.spec import get_drafter as j_get_drafter
from repro.spec import register_drafter as j_register_drafter
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import lm
from repro_torch.plan import LaunchPlan
from repro_torch.serving import Request, SamplingParams, ServingEngine
from repro_torch.spec import (
    Drafter,
    SpecConfig,
    VerifyOutcome,
    available_drafters,
    get_drafter,
    register_drafter,
)

F32 = dict(dtype="float32", param_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_spec.py's engine prompts
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3, 4, 1, 2, 3],
           [9, 9, 8, 9, 9, 8, 9], [2, 4, 6, 8, 2, 4, 6, 8, 2]]


def _garbage(history, k):
    """Out-of-distribution junk cycling with the history's length: the
    reject-heavy path (tests/test_spec.py's GarbageDrafter)."""
    n = len(history)
    return [(n * 7 + j * 13) % 50 + 1 for j in range(k)]


def _replay(script, history, k):
    """A recorded run's continuation of the history's prompt: every draft
    verifies (the replay oracle of benchmarks/spec_ab.py)."""
    h = tuple(history)
    for prompt, toks in script.items():
        if h[:len(prompt)] == prompt:
            done = len(h) - len(prompt)
            return list(toks[done:done + k])
    return []


class Garbage(Drafter):
    def propose(self, history, k):
        return _garbage(history, k)


class Replay(Drafter):
    script = {}

    def propose(self, history, k):
        return _replay(self.script, history, k)


class JGarbage(JDrafter):
    def propose(self, history, k):
        return _garbage(history, k)


class JReplay(JDrafter):
    script = {}

    def propose(self, history, k):
        return _replay(self.script, history, k)


for _name, _port, _jax in (("torch_test_garbage", Garbage, JGarbage),
                           ("torch_test_replay", Replay, JReplay)):
    register_drafter(_name, _port)
    j_register_drafter(_name, _jax)


# ---------------------------------------------------------------------------
# spec/: configs, outcomes, drafters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(k=0), dict(k=65), dict(max_rejects=0),
                                dict(method="")])
def test_spec_config_refuses_as_the_reference(kw):
    with pytest.raises(ValueError) as want:
        JSpecConfig(**kw)
    with pytest.raises(ValueError) as got:
        SpecConfig(**kw)
    assert str(got.value) == str(want.value)
    for ok in (dict(), dict(method="prompt_lookup", k=7, max_rejects=3)):
        assert SpecConfig(**ok).describe() == JSpecConfig(**ok).describe()
    o = VerifyOutcome(slot=0, proposed=4, accepted=2, emitted=(1, 2, 3))
    assert o.tokens_gained == JVerifyOutcome(0, 4, 2, (1, 2, 3)).tokens_gained
    with pytest.raises(ValueError):
        VerifyOutcome(slot=0, proposed=2, accepted=3, emitted=())


def test_drafter_registry():
    assert {"ngram", "prompt_lookup"} <= set(available_drafters())
    assert get_drafter("torch_test_garbage")().name == "torch_test_garbage"
    with pytest.raises(KeyError, match="unknown drafter"):
        get_drafter("nope")


@pytest.mark.parametrize("name,kw", [
    ("ngram", {}), ("ngram", dict(n=2)), ("ngram", dict(n=4)),
    ("prompt_lookup", {}), ("prompt_lookup", dict(min_ngram=2,
                                                  max_ngram=3))])
def test_drafters_propose_the_reference_tokens(name, kw):
    """Seeded histories over a small vocabulary (so n-grams recur), every
    length from empty to 40 and k from 1 to 6: the same proposals."""
    rng = np.random.default_rng(len(name) + len(kw))
    port, ref = get_drafter(name)(**kw), j_get_drafter(name)(**kw)
    for n in range(41):
        hist = rng.integers(0, 5, n).tolist()
        for k in range(1, 7):
            assert port.propose(hist, k) == ref.propose(hist, k), (n, k)


# ---------------------------------------------------------------------------
# ops.verify_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv,s", [(4, 4, 1), (8, 2, 3)])
def test_verify_attention_matches_reference(hq, hkv, s):
    """Slots whose rows sit inside the view, run past its end (padding
    rows clamp to the view) and a dead slot's stale position far past
    it: the plain route equals ``ref.verify_decode_xla`` at 1e-5, from a
    frozen plan, with no policy evaluation."""
    rng = np.random.default_rng(hq * 10 + s)
    B, M, L, D = 4, 5, 96, 16
    q = rng.standard_normal((B, M, hq, D)).astype(np.float32)
    k = rng.standard_normal((B, L, hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, hkv, D)).astype(np.float32)
    pos = np.array([0, 40, 93, 400], np.int32)
    want = jref.verify_decode_xla(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos), s)
    ops.reset_policy_eval_count()
    got = ops.verify_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos),
                               plan=LaunchPlan(kind="verify", num_splits=s))
    assert ops.policy_eval_count() == 0
    assert got.shape == (B, M, hq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_verify_attention_attends_the_plan_bucket():
    """A frozen plan's bucket cuts the view before the split, and a call
    without a frozen plan evaluates the policy once, on the M-row
    workload."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 3, 4, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 256, 2, 16)).astype(
        np.float32)) for _ in range(2))
    pos = torch.tensor([100, 126])
    plan = LaunchPlan(kind="verify", num_splits=2, bucket=128)
    cut = ops.verify_attention(q, k[:, :128], v[:, :128], pos,
                               plan=LaunchPlan(kind="verify", num_splits=2))
    torch.testing.assert_close(ops.verify_attention(q, k, v, pos,
                                                    plan=plan), cut)
    ops.reset_policy_eval_count()
    ops.verify_attention(q, k, v, pos)
    assert ops.policy_eval_count() == 1


# ---------------------------------------------------------------------------
# lm_verify_step and write_rows against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair_f32():
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2,
                            d_model=32).replace(**F32)
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32).replace(**F32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jmodel.init_params(jax.random.PRNGKey(0)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_lm_verify_step_matches_reference(pair_f32, kv_dtype):
    """Two prompts prefilled in the reference, the cache carried over,
    then one 4-row verify block per slot, the second slot's last rows
    past the 32-row cache: the same logits (B, M, vocab), and the same
    rows placed in the cache."""
    jcfg, jmodel, jparams, cfg, model, params = pair_f32
    rng = np.random.default_rng(3)
    L, lens, M = 32, (9, 30), 4
    jcaches = jmodel.init_cache(len(lens), L, kv_dtype=kv_dtype)
    for slot, n in enumerate(lens):
        padded = np.zeros(L, np.int32)
        padded[:n] = rng.integers(1, 256, n)
        _, jcaches = jlm.lm_prefill_slot(jparams, jcfg, jcaches,
                                         jnp.asarray(padded),
                                         jnp.int32(slot), jnp.int32(n), L,
                                         kv_dtype=kv_dtype)
    caches = cache_from_numpy(jax.tree.map(np.asarray, jcaches), cfg,
                              device="cpu")
    tokens = rng.integers(1, 256, (len(lens), M)).astype(np.int32)
    t = np.asarray(lens, np.int32)
    jlogits, jcaches = jlm.lm_verify_step(jparams, jcfg, jcaches,
                                          jnp.asarray(tokens),
                                          jnp.asarray(t))
    logits = lm.lm_verify_step(params, cfg, caches,
                               torch.from_numpy(tokens).long(),
                               torch.from_numpy(t).long())
    assert logits.shape == (len(lens), M, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jc = jcaches[0][0]
    for slot, n in enumerate(lens):
        rows = slice(n, min(n + M, L))
        for name in caches:
            got = caches[name][:, slot, rows]
            want = np.asarray(jc[name][:, slot, rows])
            if got.dtype == torch.int8:
                assert np.abs(got.numpy().astype(np.int32)
                              - want.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "int8", "fp8"])
def test_place_rows_at_drops_rows_past_the_view(dtype):
    """A block of 5 rows per slot placed at per-slot offsets: inside the
    view, straddling its end (the rows past it dropped, the last row
    keeping the block's value), wholly past it (a dead slot's stale
    position) and at row 0: the reference's ``_place_rows_at`` bits."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(0)
    B, V, M, H, D = 4, 16, 5, 2, 8
    old = rng.standard_normal((B, V, H, D)).astype(np.float32)
    new = rng.standard_normal((B, M, H, D)).astype(np.float32)
    start = np.array([3, 13, 40, 0])
    if dtype == "fp8":
        t_old = torch.from_numpy(old).to(torch.float8_e4m3fn)
        t_new = torch.from_numpy(new).to(torch.float8_e4m3fn)
        j_old = jnp.asarray(old).astype(jnp.float8_e4m3fn)
        j_new = jnp.asarray(new).astype(jnp.float8_e4m3fn)
    else:
        np_dt = np.int8 if dtype == "int8" else np.float32
        old = (old * 40).astype(np_dt)
        new = (new * 40).astype(np_dt)
        t_old, t_new = torch.from_numpy(old), torch.from_numpy(new)
        j_old, j_new = jnp.asarray(old), jnp.asarray(new)
    want = jattn._place_rows_at(j_old, j_new, jnp.asarray(start, jnp.int32))
    attn._place_rows_at(t_old, t_new, torch.from_numpy(start))
    np.testing.assert_array_equal(_bits(t_old), _bits(want))


def _numpy_like(rng, a):
    a = np.asarray(a)
    if a.dtype == np.int8:
        return rng.integers(-127, 128, a.shape).astype(np.int8)
    return rng.standard_normal(a.shape).astype(a.dtype)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_write_rows_moves_the_reference_pages(kv_dtype):
    """Random pools and views; each slot commits a different run of rows
    (one inside a page, one across a page boundary, one past the view's
    end, one dead slot): equal pools outside the trash page."""
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    B, L, ps, n, M = 4, 128, 16, 4, 5
    kw = dict(layout="paged", page_size=ps, page_budget=24)
    jmgr = j_build_model(jcfg).cache_manager(B, L, kv_dtype, **kw)
    mgr = build_model(cfg, device="cpu").cache_manager(B, L, kv_dtype, **kw)
    for m in (jmgr, mgr):
        assert m.reserve(0, 20) and m.reserve(1, 40) and m.reserve(2, 64)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: _numpy_like(rng, a), jmgr.init_storage())
    jstore = jax.tree.map(jnp.asarray, tree)
    store = cache_from_numpy(tree, cfg, device="cpu")
    jtable, table = jmgr.table_device(), mgr.table_device()
    vtree = jax.tree.map(lambda a: _numpy_like(rng, a),
                         jmgr.layout.gather_view(jstore, jtable, n))
    view = cache_from_numpy(vtree, cfg, device="cpu")
    start = np.array([3, 30, 61, 90])
    count = np.array([1, 5, 3, 2])
    jstore = jmgr.layout.write_rows(
        jstore, jax.tree.map(jnp.asarray, vtree), jtable,
        jnp.asarray(start, jnp.int32), jnp.asarray(count, jnp.int32), M, n)
    mgr.layout.write_rows(store, view, table, torch.from_numpy(start),
                          torch.from_numpy(count), M, n)
    for name, a in jstore[0][0].items():
        np.testing.assert_array_equal(_bits(store[name])[:, 1:],
                                      _bits(a)[:, 1:], err_msg=name)


# ---------------------------------------------------------------------------
# engines against the JAX engine
# ---------------------------------------------------------------------------


def _drain(pkg, pair, *, spec=None, layout="paged", max_new=16,
           scfg_kw=None, prompts=PROMPTS, slots=4, max_len=96,
           per_request=None):
    """Serve ``prompts`` through one package's engine (``pkg`` "jax" or
    "torch") in float32 with a float32 cache; ``spec`` is a (method, k,
    max_rejects) triple; ``per_request(i)`` may override it per request.
    Returns (streams, finish reasons, engine)."""
    jcfg, jmodel, jparams, cfg, model, params = pair
    is_jax = pkg == "jax"
    scfg = (JServeConfig if is_jax else ServeConfig)(
        model=jcfg if is_jax else cfg, cache_layout=layout,
        kv_cache_dtype="float32", **(scfg_kw or {}))
    if is_jax:
        eng = JServingEngine(jmodel, scfg, max_len=max_len,
                             batch_slots=slots)
        eng.load(jparams)
    else:
        ops.reset_policy_eval_count()
        eng = ServingEngine(model, scfg, max_len=max_len, batch_slots=slots,
                            device="cpu")
        eng.load(params)
    spec_cls = JSpecConfig if is_jax else SpecConfig
    for i, p in enumerate(prompts):
        knob = per_request(i) if per_request else spec
        sp = (JSamplingParams if is_jax else SamplingParams)(
            speculation=spec_cls(*knob) if knob else None)
        eng.submit((JRequest if is_jax else Request)(
            i, p, max_new_tokens=max_new, sampling=sp))
    done = eng.drain()
    if not is_jax:
        assert ops.policy_eval_count() == 0
    if eng.cache.is_paged:
        eng.cache.check_conservation()
    return ([c.tokens for c in done], [c.finish_reason for c in done], eng)


@pytest.fixture(scope="module")
def base(pair_f32):
    """Spec-off streams of PROMPTS, per layout (the JAX engine's and the
    port's are equal)."""
    out = {}
    for layout in ("dense", "paged"):
        jt, _, _ = _drain("jax", pair_f32, layout=layout)
        t, _, _ = _drain("torch", pair_f32, layout=layout)
        assert t == jt
        out[layout] = t
    return out


def _spec_counters(stats):
    return (stats.spec_steps, stats.spec_proposed, stats.spec_accepted,
            stats.spec_emitted, stats.spec_disabled)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_ngram_streams_and_counters_match_jax_engine(pair_f32, base,
                                                     layout):
    jt, _, jeng = _drain("jax", pair_f32, spec=("ngram", 4), layout=layout)
    t, _, eng = _drain("torch", pair_f32, spec=("ngram", 4), layout=layout)
    assert t == jt == base[layout]
    assert _spec_counters(eng.stats) == _spec_counters(jeng.stats)
    assert eng.sched.planned_verify_keys() == jeng.sched.planned_verify_keys()
    assert eng.stats.launches == {
        (k if isinstance(k, int) else tuple(k)): v
        for k, v in jeng.stats.launches.items()}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prompt_lookup_streams_equal_spec_off(pair_f32, base, layout):
    t, _, eng = _drain("torch", pair_f32, spec=("prompt_lookup", 4),
                       layout=layout)
    assert t == base[layout]
    assert eng.stats.spec_steps > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_oracle_accepts_every_draft(pair_f32, base, layout):
    """The replay oracle at k = 4: acceptance 1.0 and 5.0 tokens per
    verify step; paged, the JAX engine's counters and verify plan keys."""
    script = {tuple(p): tok for p, tok in zip(PROMPTS, base[layout])}
    Replay.script = JReplay.script = script
    t, _, eng = _drain("torch", pair_f32, spec=("torch_test_replay", 4),
                       layout=layout)
    assert t == base[layout]
    st = eng.stats
    assert st.spec_acceptance_rate == 1.0
    assert st.spec_tokens_per_step == 5.0
    assert eng.sched.planned_verify_keys() == [(4, 128)]
    if layout == "paged":
        jt, _, jeng = _drain("jax", pair_f32, spec=("torch_test_replay", 4),
                             layout=layout)
        assert jt == t
        assert _spec_counters(st) == _spec_counters(jeng.stats)
        assert jeng.sched.planned_verify_keys() == [(4, 128)]
    snap = st.to_json()
    assert snap["spec_tokens_per_step"] == 5.0
    assert snap["launches"]["verify/4/128"] == st.launches[("verify", 4,
                                                            128)]


def test_reject_heavy_run_conserves_pages_as_jax_engine(pair_f32):
    """Junk drafts under a tight page budget (pages of 4, 40 of them): every
    verify step rolls kv_len back, some draft rows find no page; streams,
    finish reasons and counters equal the JAX engine's and spec-off's,
    and conservation holds (checked in ``_drain``)."""
    kw = dict(scfg_kw=dict(cache_page_size=4, cache_page_budget=40),
              max_len=48, max_new=10)
    bt, breasons, _ = _drain("torch", pair_f32, **kw)
    jt, jreasons, jeng = _drain("jax", pair_f32,
                                spec=("torch_test_garbage", 4), **kw)
    t, reasons, eng = _drain("torch", pair_f32,
                             spec=("torch_test_garbage", 4), **kw)
    assert t == jt == bt and reasons == jreasons == breasons
    assert _spec_counters(eng.stats) == _spec_counters(jeng.stats)
    assert eng.stats.spec_accepted < eng.stats.spec_proposed


def test_max_rejects_disables_speculation(pair_f32):
    t, _, eng = _drain("torch", pair_f32, max_new=12,
                       spec=("torch_test_garbage", 3, 2))
    st = eng.stats
    assert st.spec_disabled == len(PROMPTS)
    assert st.spec_steps <= 3 * len(PROMPTS)
    assert t == _drain("torch", pair_f32, max_new=12)[0]


def test_serve_config_speculation_is_the_engine_default(pair_f32, base):
    """ServeConfig.speculation applies to requests that set none, and the
    run counts as the per-request ngram run does."""
    t, _, eng = _drain("torch", pair_f32, scfg_kw=dict(
        speculation="ngram", speculation_k=4))
    _, _, per_request = _drain("torch", pair_f32, spec=("ngram", 4))
    assert t == base["paged"]
    assert _spec_counters(eng.stats) == _spec_counters(per_request.stats)
    assert eng.stats.spec_steps > 0


@pytest.mark.parametrize("scfg_kw", [dict(), dict(prefill_mode="loop")],
                         ids=["fused", "loop"])
def test_mixed_traffic_rides_verify_launches(pair_f32, base, scfg_kw):
    """Speculating and plain requests share lockstep verify launches
    (plain slots, and loop-admission slots still feeding their prompt,
    ride as 1-token rows): spec-off's streams."""
    t, _, _ = _drain("torch", pair_f32, scfg_kw=scfg_kw,
                     per_request=lambda i: ("ngram", 3) if i % 2 == 0
                     else None)
    assert t == base["paged"]


# a 16-token prefix every request opens with (four pages of 4)
SHARED = [(3 * j) % 40 + 11 for j in range(16)]


@pytest.mark.parametrize("layout,scfg_kw,prompts", [
    ("paged", dict(cache_page_size=4, share_prefix=True),
     [SHARED + p for p in PROMPTS]),
    ("dense", dict(kv_quant="int8"), PROMPTS),
], ids=["paged_shared_prefix", "dense_int8"])
def test_ngram_with_shared_prefix_or_int8_matches_jax_engine(
        pair_f32, layout, scfg_kw, prompts):
    """``ngram`` speculation (k = 4) paged with prefix sharing over a
    16-token shared prefix, and dense over an int8 cache: the JAX
    engine's streams, finish reasons and spec counters."""
    kw = dict(spec=("ngram", 4), layout=layout, scfg_kw=scfg_kw,
              prompts=prompts)
    jt, jreasons, jeng = _drain("jax", pair_f32, **kw)
    t, reasons, eng = _drain("torch", pair_f32, **kw)
    assert t == jt and reasons == jreasons
    assert _spec_counters(eng.stats) == _spec_counters(jeng.stats)
    assert eng.stats.spec_steps > 0
    assert eng.sched.planned_verify_keys() == jeng.sched.planned_verify_keys()
    if scfg_kw.get("share_prefix"):
        assert eng.cache_stats()["prefix_hits"] == \
            jeng.cache_stats()["prefix_hits"] > 0


def test_spec_ab_oracle_row():
    """``benchmarks/spec_ab.py``'s full workload (reduced qwen2.5-3b at
    d_model 64, 8 mixed prompts, 32 new tokens, 4 slots, paged, k = 4):
    the replay oracle gives the CSV's oracle row (12 verify and 2 decode
    launches, 48 verify slot steps, 192 of 192 drafts, 5.0 tokens per
    step), the ngram cell rejects some drafts, every cell gives spec-off's
    streams, conserves pages and evaluates no policy in a launch."""
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=64)
    model = build_model(cfg, device="cpu")
    params = model.init_params(0)
    rng = np.random.default_rng(0)
    prompts = []
    for i in range(8):
        if i % 2 == 0:
            period = rng.integers(2, 5)
            motif = rng.integers(1, cfg.vocab_size, size=period).tolist()
            n = int(rng.integers(8, 16))
            prompts.append((motif * n)[:n])
        else:
            prompts.append(rng.integers(1, cfg.vocab_size,
                                        size=rng.integers(6, 14)).tolist())

    def cell(method):
        ops.reset_policy_eval_count()
        eng = ServingEngine(model, ServeConfig(model=cfg,
                                               cache_layout="paged"),
                            max_len=256, batch_slots=4, device="cpu")
        eng.load(params)
        for i, p in enumerate(prompts):
            eng.submit(Request(i, p, max_new_tokens=32, sampling=(
                SamplingParams(speculation=SpecConfig(method, 4))
                if method else SamplingParams())))
        toks = [c.tokens for c in eng.drain()]
        eng.cache.check_conservation()
        assert ops.policy_eval_count() == 0
        return toks, eng.stats

    base_toks, _ = cell(None)
    ngram_toks, ng = cell("ngram")
    Replay.script = {tuple(p): t for p, t in zip(prompts, base_toks)}
    oracle_toks, st = cell("torch_test_replay")
    assert ngram_toks == oracle_toks == base_toks
    assert ng.spec_accepted < ng.spec_proposed
    verify = sum(v for k, v in st.launches.items()
                 if isinstance(k, tuple) and k[0] == "verify")
    decode = sum(v for k, v in st.launches.items() if isinstance(k, int))
    assert (decode, verify, st.spec_steps, st.spec_proposed,
            st.spec_accepted) == (2, 12, 48, 192, 192)
    assert st.spec_acceptance_rate == 1.0
    assert st.spec_tokens_per_step == 5.0


def test_submit_validates_speculation(pair_f32):
    jcfg, jmodel, jparams, cfg, model, params = pair_f32
    eng = ServingEngine(model, ServeConfig(model=cfg), max_len=64,
                        batch_slots=1, device="cpu")
    eng.load(params)
    with pytest.raises(ValueError, match="unknown drafter"):
        eng.submit(Request(0, [1, 2], sampling=SamplingParams(
            speculation=SpecConfig(method="nope"))))
    with pytest.raises(TypeError, match="SpecConfig"):
        SamplingParams(speculation="ngram")
    with pytest.raises(ValueError, match="unknown drafter"):
        ServingEngine(model, ServeConfig(model=cfg, speculation="nope"),
                      max_len=64, batch_slots=1, device="cpu")
    with pytest.raises(ValueError, match="metadata-enabled"):
        ServingEngine(model, ServeConfig(model=cfg, speculation="ngram",
                                         use_scheduler_metadata=False),
                      max_len=64, batch_slots=1, device="cpu")
    assert model.supports_speculation

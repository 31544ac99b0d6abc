"""The port's hybrid family (recurrentgemma-9b) against the reference's, on
the CPU.

The layer pattern and its scan groups; the RG-LRU block's train path
(with the decode cache it emits) and decode steps; the log-depth scan
against the plain recurrence; windowed prefill's ring placement at L < W
and L >= W (f32 rows, and int8); ``Model.prefill`` then 8 decode
steps across the ring's wrap, against the reference within its
``hybrid`` tolerance (4e-2 of the largest logit, run in f32, as the
reference's tests run this family); reduced recurrentgemma-9b served by
both engines through loop admission, float32 weights over a bfloat16 and
an int8 cache, one prompt longer than the window; the family predicates
and refusals; and the ring decode launch's split at full width, equal to
the one the reference's launch evaluates inside its trace.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.kernels import ops as j_ops
from repro.models import attention as jattn
from repro.models import build_model as j_build_model
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro.models.common import param_count
from repro.plan import AttentionSpec as JAttentionSpec
from repro.plan import Planner as JPlanner
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_arch
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import build_model, lm, rglru
from repro_torch.models.common import rope_angles
from repro_torch.plan import AttentionSpec
from repro_torch.serving import GreedySampler, Request, ServingEngine
from repro_torch.serving.scheduler import Scheduler

ARCH = "recurrentgemma-9b"
D = 64
HYBRID_TOL = 4e-2          # tests/test_models.py's TOL["hybrid"]
F32 = dict(dtype="float32", param_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


def test_configs_and_layer_plan_match_reference():
    """Full and reduced configs field for field; ``layer_kinds`` and
    ``layer_groups`` as the reference's: 38 layers are 12 x (rglru,
    rglru, attn_window) then (rglru, rglru); the reduced 4 are one
    pattern and a one-layer remainder."""
    for cfg, jcfg in ((get_arch(ARCH), j_get_arch(ARCH)),
                      (reduced_config(ARCH), j_reduced_config(ARCH))):
        assert cfg.family == jcfg.family == "hybrid"
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "resolved_head_dim", "rope_theta",
                  "mlp_kind", "max_seq_len"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert vars(cfg.hybrid) == vars(jcfg.hybrid)
        assert lm.layer_kinds(cfg) == jlm.layer_kinds(jcfg)
        assert lm.layer_groups(cfg) == jlm.layer_groups(jcfg)
    pattern = ("rglru", "rglru", "attn_window")
    assert lm.layer_groups(get_arch(ARCH)) == [(pattern, 12),
                                               (pattern[:2], 1)]
    assert lm.layer_groups(reduced_config(ARCH)) == [(pattern, 1),
                                                     (pattern[:1], 1)]


def test_param_count_on_the_meta_device():
    """recurrentgemma-9b on the meta device: the reference's spec count,
    about 10.4 B (its untied 256,000-row embedding and unembedding are
    2.1 B of it)."""
    params = lm.LM(get_arch(ARCH), torch.device("meta"))
    n = sum(p.numel() for p in params.parameters())
    assert n == param_count(j_build_model(j_get_arch(ARCH)).param_specs())
    assert 1.0e10 < n < 1.1e10, n
    assert params.layers[0].mix.w_gate_i.shape == (4096, 4096)
    assert params.layers[2].mix.wk.shape == (4096, 1, 256)


def _rglru_weights(rng, d, w, cw):
    """One RG-LRU block's float32 weights at the reference's spec shapes,
    biases and ``lam`` away from their init so they count."""
    n = rng.standard_normal
    return {"w_in_a": n((d, w)) / d ** 0.5, "w_in_b": n((d, w)) / d ** 0.5,
            "conv_w": n((cw, w)) / cw ** 0.5, "conv_b": n(w) * 0.1,
            "lam": 1 + n(w) * 0.3, "w_gate_i": n((w, w)) / w ** 0.5,
            "b_gate_i": n(w) * 0.1, "w_gate_r": n((w, w)) / w ** 0.5,
            "b_gate_r": n(w) * 0.1, "w_out": n((w, d)) / w ** 0.5}


@pytest.mark.parametrize("length", [2, 9])
def test_rglru_train_and_decode_match_reference(length):
    """``apply_rglru_train`` with its decode cache (L below and above the
    conv tail), then 4 ``apply_rglru_decode`` steps from that cache, in
    float32, against the reference's: outputs, ``state`` and ``conv``
    within 1e-4."""
    cfg = reduced_config(ARCH, d_model=32).replace(**F32)
    jcfg = j_reduced_config(ARCH, d_model=32).replace(**F32)
    rng = np.random.default_rng(length)
    w = {k: np.asarray(v, np.float32) for k, v in
         _rglru_weights(rng, 32, 32, 4).items()}
    block = rglru.RGLRU(cfg, torch.float32, torch.device("cpu"))
    block.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    x = rng.standard_normal((2, length + 4, 32)).astype(np.float32)
    jout, jcache = jrglru.apply_rglru_train(
        jw, jcfg, jnp.asarray(x[:, :length]), return_cache=True)
    out, cache = rglru.apply_rglru_train(
        block, cfg, torch.from_numpy(x[:, :length]), return_cache=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name in ("state", "conv"):
        assert cache[name].dtype == torch.float32
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    for i in range(length, length + 4):
        xi = x[:, i:i + 1]
        jy, jcache = jrglru.apply_rglru_decode(jw, jcfg, jnp.asarray(xi),
                                               jcache)
        y = rglru.apply_rglru_decode(block, cfg, torch.from_numpy(xi), cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(cache["state"].numpy(),
                                   np.asarray(jcache["state"]), **TOL)


def test_linear_scan_equals_the_recurrence():
    """The log-depth scan against ``h_t = a_t h_{t-1} + b_t`` stepped in
    float64, at lengths around powers of two."""
    gen = torch.Generator().manual_seed(0)
    for length in (1, 2, 7, 8, 9, 33):
        a = torch.rand(2, length, 5, generator=gen)
        b = torch.randn(2, length, 5, generator=gen)
        h, want = torch.zeros(2, 5, dtype=torch.float64), []
        for t in range(length):
            h = a[:, t].double() * h + b[:, t].double()
            want.append(h)
        torch.testing.assert_close(rglru.linear_scan(a, b).double(),
                                   torch.stack(want, 1), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("length", [5, 13])
def test_windowed_prefill_places_the_ring(length, kv_dtype):
    """Windowed prefill at window 8 into an 8-row ring, L 5 (rows [0, L))
    and L 13 (position p at row p % 8, the last 8), in float32: the
    output and the ring rows as the reference's (within 1e-4; int8 codes
    within one step)."""
    cfg = reduced_config(ARCH, d_model=32).replace(**F32)
    jcfg = j_reduced_config(ARCH, d_model=32).replace(**F32)
    rng = np.random.default_rng(length)
    hd = cfg.resolved_head_dim
    w = {"wq": rng.standard_normal((32, 4, hd)), "wk":
         rng.standard_normal((32, 1, hd)) * 0.3,
         "wv": rng.standard_normal((32, 1, hd)),
         "wo": rng.standard_normal((4, hd, 32)) / 8}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    block = attn.Attention(cfg, torch.float32, torch.device("cpu"))
    block.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    x = (rng.standard_normal((2, length, 32)) * 0.5).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(length), (2, length))
    jy, jrows = jattn.attention_prefill(
        {k: jnp.asarray(v) for k, v in w.items()}, jcfg, jnp.asarray(x),
        pos, 8, window=8, kv_dtype=kv_dtype)
    rope = rope_angles(torch.arange(length)[None], hd, cfg.rope_theta)
    y, rows = attn.attention_prefill(block, cfg, torch.from_numpy(x), rope,
                                     kv_dtype=kv_dtype, window=8, ring=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    n = min(length, 8)
    assert rows["k"].shape[1] == n
    for name, leaf in rows.items():
        want = np.asarray(jrows[name])[:, :n]
        got = leaf.float().numpy()
        if want.dtype == np.int8:
            np.testing.assert_allclose(got, want, rtol=0, atol=1)
        else:
            np.testing.assert_allclose(got, want.astype(np.float32), **TOL)


def _pair(dtype):
    """Reduced recurrentgemma-9b (d_model 64: 4 / 1 heads of 16, window
    64, 3 rglru + 1 windowed layers) in ``dtype``, the reference's weights
    in both."""
    kw = dict(dtype=dtype, param_dtype=dtype)
    jcfg = j_reduced_config(ARCH, d_model=D).replace(**kw)
    cfg = reduced_config(ARCH, d_model=D).replace(**kw)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jax.jit(
        jmodel.init_params)(jax.random.PRNGKey(2)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("float32")


@pytest.mark.parametrize("length,kv_dtype", [(61, "float32"),
                                             (70, "int8")])
def test_prefill_then_decode_across_the_wrap(f32_pair, length, kv_dtype):
    """``Model.prefill`` of ``length`` tokens at B 2 (61: the ring part
    full; 70: wrapped), then 8 decode steps teacher-forced on the
    reference's argmax tokens, through t = 64 where the ring wraps, in
    float32: every step's logits within 4e-2 of the reference's largest,
    and the prefilled ring and recurrent caches as the reference's
    (through ``cache_from_numpy``: stacked by kind, in layer order)."""
    jcfg, jmodel, jparams, cfg, model, params = f32_pair
    rng = np.random.default_rng(length)
    tokens = rng.integers(0, cfg.vocab_size, (2, length)).astype(np.int32)
    jlog, jcache = jax.jit(jmodel.prefill, static_argnums=(2, 3))(
        jparams, {"tokens": jnp.asarray(tokens)}, 96, kv_dtype)
    log, cache = model.prefill(
        params, {"tokens": torch.from_numpy(tokens).long()}, 96, kv_dtype)
    want = cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                            device="cpu")
    assert sorted(cache) == sorted(want)
    assert cache["k"].shape == (1, 2, 64, 1, 16)
    assert cache["state"].shape == (3, 2, 64)
    for name, leaf in cache.items():
        assert leaf.shape == want[name].shape, name
        got, ref = leaf.float().numpy(), want[name].float().numpy()
        if leaf.dtype == torch.int8:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1)
        else:
            np.testing.assert_allclose(got, ref, **TOL)
    jdec = jax.jit(jmodel.decode_step)
    for i in range(9):
        scale = float(jnp.max(jnp.abs(jlog))) + 1e-9
        rel = float(np.max(np.abs(log.numpy() - np.asarray(jlog)))) / scale
        assert rel < HYBRID_TOL, (i, rel)
        if i == 8:
            break
        nxt = jnp.argmax(jlog, -1).astype(jnp.int32)
        jlog, jcache = jdec(jparams, jcache, nxt, jnp.int32(length + i))
        log = model.decode_step(params, cache,
                                torch.from_numpy(np.array(nxt)).long(),
                                torch.full((2,), length + i,
                                           dtype=torch.long))


PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3, 4, 1, 2, 3],
           list(range(1, 71)), [2, 4, 6, 8, 2, 4, 6]]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_reduced_hybrid_engines_serve_the_jax_streams(f32_pair, kv_quant):
    """4 requests over 2 slots, greedy, float32 weights over a bfloat16
    (``kv_quant=None``) or int8 ring, one 70-token prompt (past the
    64-row ring): ``prefill_mode="auto"`` resolves to the loop in both
    engines, which give the same streams, finish reasons and plan
    launches (every admission a run of decode steps); no policy
    evaluation inside a step; the ring launches take the side plan."""
    jcfg, jmodel, jparams, cfg, model, params = f32_pair
    kw = dict(kv_quant=kv_quant)
    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, **kw),
                          max_len=96, batch_slots=2,
                          sampler=JGreedySampler())
    jeng.load(jparams)
    ops.reset_policy_eval_count()
    eng = ServingEngine(model, ServeConfig(model=cfg, **kw), max_len=96,
                        batch_slots=2, sampler=GreedySampler(), device="cpu")
    eng.load(params)
    assert eng.prefill_mode == jeng.prefill_mode == "loop"
    for i, p in enumerate(PROMPTS):
        jeng.submit(JRequest(i, p, max_new_tokens=6))
        eng.submit(Request(i, p, max_new_tokens=6))
    jdone, done = jeng.drain(), eng.drain()
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert [c.finish_reason for c in done] == \
        [c.finish_reason for c in jdone]
    assert eng.stats.launches == dict(jeng.stats.launches)
    assert all(isinstance(k, int) for k in eng.stats.launches)
    assert ops.policy_eval_count() == 0
    (name, side), = eng.sched.side_plans().items()
    assert (name, side.spec.seqlen_k, side.bucket) == ("ring", 64, None)
    ring = eng._caches["k"]
    assert ring.shape[:3] == (1, 2, 64) and (ring.dtype == torch.int8) == \
        (kv_quant == "int8")


def test_hybrid_predicates_and_refusals(f32_pair):
    """Dense caches and loop admission only: the paged layout, fused
    prefill, prefix sharing and speculation refused with the reference's
    messages; the CLI serves it (reduced, on the CPU)."""
    from repro_torch.launch.serve import run_serving
    jcfg, jmodel, jparams, cfg, model, params = f32_pair
    for pred in ("supports_paged_cache", "supports_fused_prefill",
                 "supports_prefix_sharing", "supports_speculation",
                 "prefill_writes_full_slot"):
        assert getattr(model, pred) == getattr(jmodel, pred), pred
    assert not (model.supports_paged_cache or model.supports_fused_prefill)
    for kw, msg in ((dict(cache_layout="paged"),
                     "hybrid caches are not position-linear"),
                    (dict(prefill_mode="fused"), "loop"),
                    (dict(speculation="ngram"),
                     "hybrid models cannot run speculative verify steps")):
        for eng_cls, m, c, dev in (
                (JServingEngine, jmodel, JServeConfig(model=jcfg, **kw), {}),
                (ServingEngine, model, ServeConfig(model=cfg, **kw),
                 {"device": "cpu"})):
            with pytest.raises(ValueError, match=msg):
                eng_cls(m, c, **dev)
    with pytest.raises(ValueError, match="cannot share prefix pages"):
        model.cache_spec(2, 64, share_prefix=True)
    with pytest.raises(NotImplementedError, match="cannot fused-prefill"):
        model.prefill_slot_view(params, torch.zeros(8, dtype=torch.long), 8)
    done = run_serving(ARCH, num_requests=2, max_new=2, d_model=D,
                       device="cpu", log_fn=lambda line: None)
    assert [len(c.tokens) for c in done] == [2, 2]


def _reference_inline_ring_split(batch: int, policy: str) -> int:
    """The split the reference's windowed decode launch evaluates inside
    its trace at recurrentgemma-9b's full shape (B ``batch``, ring 2048,
    16 / 1 heads, D 256), under a frozen ``policy`` plan of another shape
    at 132 cores, traced abstractly (nothing allocated)."""
    cfg = j_get_arch(ARCH)
    frozen = JPlanner(policy=policy, num_cores=132).plan(
        JAttentionSpec.decode(batch, 4096, 16, 1, 256), bucket=4096)
    p = {k: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
         for k, s in jattn.attention_specs(cfg).items()}
    kv = jax.ShapeDtypeStruct((batch, 2048, 1, 256), jnp.bfloat16)
    x = jax.ShapeDtypeStruct((batch, 1, 4096), jnp.bfloat16)
    j_ops.reset_policy_eval_count()
    jax.eval_shape(lambda p, x, k, v: jattn.attention_decode(
        p, cfg, x, {"k": k, "v": v}, jnp.zeros((batch,), jnp.int32),
        plan=frozen, window=2048), p, x, kv, kv)
    assert j_ops.policy_eval_count() == 1
    return j_ops.last_inline_plan().num_splits


@pytest.mark.parametrize("policy", ["paper", "fa3_baseline"])
def test_ring_split_equals_the_references(policy):
    """At full width, max_len 4096 and 132 SMs the scheduler's ring side
    plan takes the split the reference's launch evaluates: S 16 at B 1
    and B 2 over the 2048-row ring, under ``paper`` and
    ``fa3_baseline``; frozen with no bucket, made by the planner alone."""
    cfg = get_arch(ARCH)
    for batch in (1, 2):
        sched = Scheduler(cfg, batch_slots=batch, max_len=4096,
                          policy=policy, num_cores=132)
        ops.reset_policy_eval_count()
        plan = sched.side_plans()["ring"]
        assert ops.policy_eval_count() == 0
        assert plan.frozen and plan.bucket is None
        assert plan.spec == AttentionSpec.decode(batch, 2048, 16, 1, 256)
        assert plan.num_splits == 16 == \
            _reference_inline_ring_split(batch, policy)

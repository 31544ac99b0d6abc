"""The port's quantized-KV slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: quantization is bit for bit (both round half to even and
cast f32 to e4m3 to nearest even); quantized decode attention within
``AB_ATOL`` = 2e-2 (accumulation order, as the reference's own fused
vs unfused oracle); reduced-model logits within 1e-4 and cache scales
within 1e-5 relative (the same float32 math summed in another order),
cache codes at most one quantization step apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.core.scheduler_metadata import get_scheduler_metadata
from repro.kernels import ops as jops
from repro.models import build_model as j_build_model
from repro.models import lm as jlm
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch import quant
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import (
    cache_from_numpy,
    params_from_numpy,
    tensor_from_numpy,
)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode_quant import (
    flash_decode_quant_partials,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import build_model
from repro_torch.plan import AttentionSpec, Planner, bucket_seqlen
from repro_torch.serving import GreedySampler, Request, ServingEngine

F32 = dict(dtype="float32", param_dtype="float32")


def _pair(seed=0, **cfg_kw):
    """Reduced qwen2.5-3b in both packages, one set of JAX weights."""
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2,
                            d_model=32).replace(**cfg_kw)
    cfg = reduced_config("qwen2.5-3b", num_layers=2,
                         d_model=32).replace(**cfg_kw)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    if cfg_kw.get("param_dtype") == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def tiny():
    return _pair()


@pytest.fixture(scope="module")
def tiny_f32():
    return _pair(**F32)


def _run_engines(pair, *, slots=2, max_len=64, lens=(3, 9, 2, 5),
                 max_new=(6, 4, 8, 5), **scfg_kw):
    jcfg, jmodel, jparams, cfg, model, params = pair

    def reqs(cls):
        return [cls(i, [(7 * i + j) % 200 + 1 for j in range(n)],
                    max_new_tokens=m) for i, (n, m) in
                enumerate(zip(lens, max_new))]

    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, **scfg_kw),
                          max_len=max_len, batch_slots=slots,
                          sampler=JGreedySampler())
    jeng.load(jparams)
    for r in reqs(JRequest):
        jeng.submit(r)
    jdone = jeng.drain()

    ops.reset_policy_eval_count()
    eng = ServingEngine(model, ServeConfig(model=cfg, **scfg_kw),
                        max_len=max_len, batch_slots=slots,
                        sampler=GreedySampler(), device="cpu")
    eng.load(params)
    for r in reqs(Request):
        eng.submit(r)
    done = eng.drain()
    return jeng, jdone, eng, done


def _plan_keys(eng):
    """bucket -> (kv_dtype, dtype_bytes) of every resident decode plan."""
    return {k: (e.plan.spec.workload().kv_dtype_name,
                e.plan.spec.workload().dtype_bytes)
            for k, e in eng.sched.plans.items() if isinstance(k, int)}


def _j_plan_keys(jeng):
    out = {}
    for k, e in jeng.sched.plans.items():
        if isinstance(k, int):
            d = e.plan.describe()
            out[k] = (d.get("kv_dtype", "bfloat16"),
                      d.get("dtype_bytes", 2))
    return out


# ---------------------------------------------------------------------------
# The KV-cache dtype follows ServeConfig, not the model's activation dtype
# ---------------------------------------------------------------------------


def test_f32_model_stores_and_keys_the_cache_as_the_reference(tiny_f32):
    """A float32 model under the default ServeConfig: the reference keeps
    its K/V in bfloat16 (``kv_cache_dtype``) and plans for 2-byte rows;
    the port must store, key and decode the same way."""
    jeng, jdone, eng, done = _run_engines(tiny_f32)
    jk = jeng._caches[0][0]["k"]
    assert str(jk.dtype) == "bfloat16"
    assert eng._caches["k"].dtype == eng._caches["v"].dtype
    assert str(eng._caches["k"].dtype) == "torch.bfloat16"
    assert _plan_keys(eng) == _j_plan_keys(jeng)
    assert set(_plan_keys(eng).values()) == {("bfloat16", 2)}
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert [c.finish_reason for c in done] == \
        [c.finish_reason for c in jdone]


# ---------------------------------------------------------------------------
# QuantSpec and the dtype registry
# ---------------------------------------------------------------------------


def test_quant_dtypes_equal_the_reference():
    assert set(quant.QUANT_DTYPES) == set(jquant.QUANT_DTYPES)
    for name, qd in quant.QUANT_DTYPES.items():
        jqd = jquant.QUANT_DTYPES[name]
        assert (qd.name, qd.storage, qd.qmax, qd.rounds) == \
            (jqd.name, jqd.storage, jqd.qmax, jqd.rounds)
        assert qd.torch_dtype.itemsize == jnp.dtype(jqd.storage).itemsize
    assert quant.QUANT_DTYPES["int8"].torch_dtype == torch.int8
    assert quant.QUANT_DTYPES["fp8"].torch_dtype == torch.float8_e4m3fn
    assert quant.GRANULARITIES == jquant.GRANULARITIES
    assert quant.AMAX_MODES == jquant.AMAX_MODES
    assert quant.AB_ATOL == jquant.AB_ATOL


@pytest.mark.parametrize("kw,exc,match", [
    ({"kv_dtype": "int4"}, ValueError, "kv_dtype"),
    ({"granularity": "per_tensor"}, ValueError, "granularity"),
    ({"amax_mode": "percentile"}, ValueError, "amax mode"),
    ({"amax_mode": "static"}, ValueError, "static_amax"),
    ({"eps": 0.0}, ValueError, "eps"),
    ({"scale_dtype": "floaty"}, TypeError, "floaty"),
])
def test_spec_validation_matches_reference(kw, exc, match):
    with pytest.raises(exc, match=match) as got:
        quant.QuantSpec(**kw)
    with pytest.raises(exc) as want:
        jquant.QuantSpec(**kw)
    if exc is ValueError:
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "fp8"},
                                 {"amax_mode": "static", "static_amax": 3.0},
                                 {"granularity": "per_page"}])
def test_spec_properties_match_reference(kw):
    ours, ref = quant.QuantSpec(**kw), jquant.QuantSpec(**kw)
    assert ours.storage_dtype == ref.storage_dtype
    assert ours.qmax == ref.qmax and ours.dtype_bytes == ref.dtype_bytes
    assert ours.describe() == ref.describe()


# ---------------------------------------------------------------------------
# Quantizer: bit for bit the reference's
# ---------------------------------------------------------------------------


def _bits(x) -> np.ndarray:
    """Raw bits of a jax array or torch tensor, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        raw = {1: torch.uint8, 4: torch.int32}[x.dtype.itemsize]
        return x.view(raw).numpy().view(f"u{x.dtype.itemsize}")
    a = np.asarray(x)
    return a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("granularity,amax_mode", [
    ("per_head", "abs_max"), ("per_page", "abs_max"),
    ("per_head", "static"), ("per_page", "static")])
def test_quantize_is_bit_identical(kv_dtype, granularity, amax_mode):
    rng = np.random.default_rng(len(granularity) + len(amax_mode))
    x = (rng.standard_normal((2, 37, 3, 16))
         * rng.uniform(0.01, 20.0, (2, 37, 3, 1))).astype(np.float32)
    x[0, 5] = 0.0                                   # all-zero rows: eps
    kw = dict(kv_dtype=kv_dtype, granularity=granularity,
              amax_mode=amax_mode)
    if amax_mode == "static":
        kw["static_amax"] = 4.0                     # most rows clip
    page = 8 if granularity == "per_page" else None
    jq, js = jquant.Quantizer(jquant.QuantSpec(**kw)).quantize(
        jnp.asarray(x), page_size=page)
    qz = quant.Quantizer(quant.QuantSpec(**kw))
    tq, ts = qz.quantize(torch.from_numpy(x), page_size=page)
    assert tq.dtype == quant.QUANT_DTYPES[kv_dtype].torch_dtype
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    jqz = jquant.Quantizer(jquant.QuantSpec(**kw))
    np.testing.assert_array_equal(
        qz.dequantize(tq, ts).numpy(), np.asarray(jqz.dequantize(jq, js)))
    np.testing.assert_array_equal(qz.row_error_bound(ts).numpy(),
                                  np.asarray(jqz.row_error_bound(js)))


def test_module_int8_transforms_and_cache_inference():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 5, 2, 8)).astype(np.float32))
    q, s = attn_mod.quantize_kv(x)
    want_q, want_s = quant.Quantizer().quantize(x)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert torch.equal(attn_mod.dequantize_kv(q, s),
                       quant.Quantizer().dequantize(q, s))
    model = build_model(reduced_config("qwen2.5-3b", num_layers=1),
                        device="cpu")
    for kv in ("int8", "fp8"):
        cache = model.init_cache(2, 16, kv_dtype=kv)
        assert quant.Quantizer.for_cache(cache).spec.kv_dtype == kv
        assert cache["k_s"].shape == cache["k"].shape[:4]
        assert cache["k_s"].dtype == torch.float32
    assert quant.Quantizer.for_cache(model.init_cache(2, 16)) is None
    with pytest.raises(ValueError, match="matches no"):
        quant.Quantizer.for_cache({"k": torch.zeros(1), "k_s": None})


def test_fp8_arrays_read_through_uint8_view():
    x = np.asarray(jnp.asarray([1.5, -2.25, 448.0, 3e-3],
                               jnp.float8_e4m3fn))
    t = tensor_from_numpy(x)
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
    i8 = tensor_from_numpy(np.asarray([-127, 3], np.int8))
    assert i8.dtype == torch.int8 and i8.tolist() == [-127, 3]


# ---------------------------------------------------------------------------
# Quantized decode attention: K4's plain version + K2's, against the
# reference's fused (interpret) and unfused paths, tails poisoned
# ---------------------------------------------------------------------------


def _poisoned(rng, b, lk, hq, hkv, d, kv_dtype):
    """The reference's test_quant._poisoned, on numpy: a quantized cache
    whose rows past kv_len hold data 127 / -127 and scales 1e4."""
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, hkv, d)).astype(np.float32)
    kv_len = rng.integers(1, lk + 1, size=b).astype(np.int32)
    art = jquant.Quantizer.from_kv_dtype(kv_dtype).quantized_kv(
        jnp.asarray(k), jnp.asarray(v))
    rows = jnp.arange(lk)[None, :, None] >= jnp.asarray(kv_len)[:, None,
                                                                 None]
    art = art._replace(
        k=jnp.where(rows[..., None], jnp.asarray(127, art.k.dtype), art.k),
        v=jnp.where(rows[..., None], jnp.asarray(-127, art.v.dtype), art.v),
        k_scale=jnp.where(rows, 1e4, art.k_scale),
        v_scale=jnp.where(rows, 1e4, art.v_scale))
    return q, art, kv_len


@pytest.mark.parametrize("kv_dtype,b,lk,hkv,g,d,s", [
    ("int8", 1, 512, 2, 8, 128, 3),     # the paper's cell, 16/2 heads
    ("fp8", 1, 512, 2, 8, 128, 3),
    ("int8", 2, 257, 2, 4, 64, 2),      # ragged last block
    ("fp8", 2, 257, 2, 4, 64, 2),
    ("int8", 3, 160, 1, 4, 32, 4),      # more splits than full blocks
    ("fp8", 3, 96, 4, 1, 16, 1),
])
def test_decode_quant_matches_reference_fused_and_unfused(
        kv_dtype, b, lk, hkv, g, d, s):
    rng = np.random.default_rng(lk + s)
    q, art, kv_len = _poisoned(rng, b, lk, hkv * g, hkv, d, kv_dtype)
    md = get_scheduler_metadata(b, 1, lk, hkv * g, hkv, d,
                                num_splits_override=s)
    jq, jlen = jnp.asarray(q), jnp.asarray(kv_len)
    fused = jops.decode_attention_quant(jq, art, jlen, impl="pallas",
                                        interpret=True, metadata=md)
    unfused = jops.decode_attention_quant(jq, art, jlen, impl="xla",
                                          metadata=md)
    tq = torch.from_numpy(q)
    tart = quant.QuantizedKV(*(tensor_from_numpy(np.asarray(a))
                               for a in art))
    plan = Planner(num_splits_override=s).plan(
        AttentionSpec.decode(b, lk, hkv * g, hkv, d, kv_dtype=kv_dtype))
    got = ops.decode_attention_quant(tq, tart, torch.from_numpy(kv_len),
                                     plan=plan)
    assert got.dtype == torch.float32 and got.shape == (b, hkv * g, d)
    assert bool(torch.isfinite(got).all())
    tol = quant.AB_ATOL[kv_dtype]
    for want in (fused, unfused):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=tol, rtol=0)
    # the kernel wrapper's CPU path: s partials, empty splits at -1e30
    qp = (tq * d ** -0.5).reshape(b, hkv, g, d)
    acc, l, m = flash_decode_quant_partials(qp, *tart, torch.from_numpy(
        kv_len), num_splits=s)
    assert acc.shape == (s, b, hkv, g, d) and l.shape == (s, b, hkv, g)
    assert bool(torch.isfinite(m).all()) and bool((m >= -1e30).all())


def test_decode_quant_bucket_view_cuts_the_scales():
    """A frozen plan's bucket cuts data and scales alike: attending a
    640-row view of a 2048-row cache equals attending the whole cache."""
    rng = np.random.default_rng(7)
    q, art, _ = _poisoned(rng, 2, 2048, 4, 2, 64, "int8")
    kv_len = torch.tensor([600, 17])
    tart = quant.QuantizedKV(*(tensor_from_numpy(np.asarray(a))
                               for a in art))
    spec = AttentionSpec.decode(2, 640, 4, 2, 64, kv_dtype="int8")
    view = ops.decode_attention_quant(
        torch.from_numpy(q), tart, kv_len,
        plan=Planner(num_splits_override=5).plan(spec, bucket=640))
    full = ops.decode_attention_quant(
        torch.from_numpy(q), tart, kv_len,
        plan=Planner(num_splits_override=5).plan(spec))
    torch.testing.assert_close(view, full, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The model: quantized prefill writes the reference's rows; decode from one
# shared cache gives the reference's logits
# ---------------------------------------------------------------------------

MAX_LEN, LENS, STEPS = 64, (7, 13), 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _codes(x) -> np.ndarray:
    """Signed storage codes: int8 values, or fp8 bit patterns ordered so
    that neighbouring e4m3 values differ by one."""
    a = x.view(torch.uint8).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).view(np.uint8)
    if str(x.dtype).endswith("int8"):
        return a.view(np.int8).astype(np.int32)
    mag = (a & 0x7F).astype(np.int32)
    return np.where(a & 0x80, -mag, mag)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_prefill_and_decode_match_jax(tiny_f32, kv_dtype):
    jcfg, jmodel, jparams, cfg, model, params = tiny_f32
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in LENS]
    jcaches = jmodel.init_cache(len(LENS), MAX_LEN, kv_dtype=kv_dtype)
    layout = model.cache_manager(len(LENS), MAX_LEN, kv_dtype).layout
    caches = layout.init_storage()
    next_tok = []
    for slot, p in enumerate(prompts):
        lb = bucket_seqlen(len(p), 16)
        padded = np.zeros(lb, np.int32)
        padded[:len(p)] = p
        jlogits, jcaches = jlm.lm_prefill_slot(
            jparams, jcfg, jcaches, jnp.asarray(padded), jnp.int32(slot),
            jnp.int32(len(p)), MAX_LEN, kv_dtype=kv_dtype)
        logits, rows = model.prefill_slot_view(
            params, torch.from_numpy(padded).long(), len(p),
            kv_dtype=kv_dtype)
        layout.write_slot(caches, rows, None, slot, 0)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        next_tok.append(int(jnp.argmax(jlogits)))
    # the prompt rows: codes equal or one step apart (where the f32 K/V
    # already differed by float noise), scales within 1e-5 relative (the
    # amax of K/V projected in another summation order: ~1.3e-6 seen)
    jc = jcaches[0][0]
    for slot, n in enumerate(LENS):
        for name in ("k", "v"):
            got = _codes(caches[name][:, slot, :n].contiguous())
            want = _codes(np.asarray(jc[name][:, slot, :n]))
            assert np.abs(got - want).max() <= 1
            assert np.mean(got != want) < 0.01
            np.testing.assert_allclose(
                caches[name + "_s"][:, slot, :n].numpy(),
                np.asarray(jc[name + "_s"][:, slot, :n]), rtol=1e-5, atol=0)

    # decode from one shared cache: the reference's, carried by interop
    caches = cache_from_numpy(jax.tree.map(np.asarray, jcaches), cfg,
                              device="cpu")
    assert caches["k"].dtype == quant.QUANT_DTYPES[kv_dtype].torch_dtype
    pos = np.asarray(LENS, np.int32)
    tok = np.asarray(next_tok, np.int32)
    planner = Planner(policy="paper")
    for _ in range(STEPS):
        jlogits, jcaches = jlm.lm_decode_step(
            jparams, jcfg, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        bucket = bucket_seqlen(int(pos.max()) + 1, 16)
        plan = planner.plan(AttentionSpec.decode(
            len(LENS), bucket, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, kv_dtype=kv_dtype), bucket=bucket)
        logits = model.decode_step(params, caches,
                                   torch.from_numpy(tok).long(),
                                   torch.from_numpy(pos).long(), plan=plan)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        want = np.asarray(jnp.argmax(jlogits, axis=-1))
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), want)
        tok, pos = want.astype(np.int32), pos + 1
    # each step's quantized row: the reference's codes, its scales
    jc = jcaches[0][0]
    for slot in range(len(LENS)):
        rows = slice(LENS[slot], int(pos[slot]))
        got = _codes(caches["k"][:, slot, rows].contiguous())
        assert np.abs(got - _codes(np.asarray(jc["k"][:, slot, rows]))
                      ).max() <= 1
        np.testing.assert_allclose(caches["k_s"][:, slot, rows].numpy(),
                                   np.asarray(jc["k_s"][:, slot, rows]),
                                   rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# The engine under kv_quant, against the reference engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,kv_quant,scfg_kw", [
    ("tiny", "int8", {}),
    ("tiny", "int8", {"use_scheduler_metadata": False}),  # loop admission
    ("tiny_f32", "int8", {}),
    ("tiny_f32", "fp8", {}),
])
def test_quantized_engine_matches_jax_engine(request, model, kv_quant,
                                             scfg_kw):
    """Refills with 2 slots: identical greedy streams, finish reasons,
    prefill and decode launches, plan misses and plan dtype keys; zero
    policy evaluations on the metadata path."""
    jeng, jdone, eng, done = _run_engines(request.getfixturevalue(model),
                                          kv_quant=kv_quant, **scfg_kw)
    assert eng.kv_dtype == jeng.kv_dtype == kv_quant
    assert eng._caches["k"].dtype == \
        quant.QUANT_DTYPES[kv_quant].torch_dtype
    assert set(eng._caches) == set(jeng._caches[0][0])
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert [c.finish_reason for c in done] == \
        [c.finish_reason for c in jdone]
    assert eng.stats.launches == jeng.stats.launches
    assert eng.stats.misses == jeng.stats.misses
    if scfg_kw.get("use_scheduler_metadata", True):
        assert _plan_keys(eng) == _j_plan_keys(jeng)
        assert set(_plan_keys(eng).values()) == {(kv_quant, 1)}
        assert ops.policy_eval_count() == 0
    else:
        assert eng.stats.fallback_launches == jeng.stats.fallback_launches


class _JRecording(JGreedySampler):
    def __init__(self):
        self.logits = []

    def sample(self, logits, *a, **kw):
        jax.debug.callback(lambda x: self.logits.append(np.asarray(x)),
                           logits, ordered=True)
        return super().sample(logits, *a, **kw)


class _Recording(GreedySampler):
    def __init__(self):
        self.logits = []

    def sample(self, logits, state, pos):
        self.logits.append(logits.float().numpy().copy())
        return super().sample(logits, state, pos)


def test_fp8_engine_on_bf16_weights_differs_only_at_a_tie(tiny):
    """bf16 activations and an fp8 cache (3 mantissa bits): a bf16 ulp of
    K can move an fp8 code by one step, so greedy streams may part where
    the two top logits tie within that noise.  Sampler calls pair one to
    one (same schedule); up to the first call whose argmax differs every
    token is equal, and there the reference's top-2 margin is below the
    largest logit difference seen so far."""
    jcfg, jmodel, jparams, cfg, model, params = tiny
    jsamp, samp = _JRecording(), _Recording()
    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, kv_quant="fp8"),
                          max_len=64, batch_slots=2, sampler=jsamp)
    jeng.load(jparams)
    eng = ServingEngine(model, ServeConfig(model=cfg, kv_quant="fp8"),
                        max_len=64, batch_slots=2, sampler=samp,
                        device="cpu")
    eng.load(params)
    for r in range(4):
        prompt = [(7 * r + j) % 200 + 1 for j in range((3, 9, 2, 5)[r])]
        jeng.submit(JRequest(r, prompt, max_new_tokens=6))
        eng.submit(Request(r, prompt, max_new_tokens=6))
    jdone, done = jeng.drain(), eng.drain()
    assert [len(c.tokens) for c in done] == [len(c.tokens) for c in jdone]
    assert len(samp.logits) == len(jsamp.logits)
    noise = 0.0
    for want, got in zip(jsamp.logits, samp.logits):
        want = want.reshape(got.shape)
        noise = max(noise, float(np.abs(want - got).max()))
        differ = np.flatnonzero(want.argmax(-1) != got.argmax(-1))
        if differ.size:
            top2 = np.sort(want[differ[0]])[-2:]
            assert top2[1] - top2[0] <= noise, (top2, noise)
            return
    assert [c.tokens for c in done] == [c.tokens for c in jdone]


def test_kv_quant_wins_and_unknown_names_raise(tiny):
    _, _, _, cfg, model, _ = tiny
    eng = ServingEngine(model, ServeConfig(model=cfg, kv_quant="fp8",
                                           kv_cache_dtype="float32"),
                        max_len=64, batch_slots=2, device="cpu")
    assert eng.kv_dtype == "fp8"
    w = eng.sched.decode_spec(128).workload()
    assert (w.dtype_bytes, w.kv_dtype) == (1, "fp8")
    eng = ServingEngine(model, ServeConfig(model=cfg,
                                           kv_cache_dtype="float32"),
                        max_len=64, batch_slots=2, device="cpu")
    assert eng.kv_dtype == "float32"
    with pytest.raises(ValueError, match="kv_quant"):
        ServingEngine(model, ServeConfig(model=cfg, kv_quant="int4"),
                      max_len=64, batch_slots=2, device="cpu")

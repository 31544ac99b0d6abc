"""The port's encdec family (whisper-large-v3) against the reference's, on
the CPU.

LayerNorm, the plain gelu MLP with biases and the sinusoidal table;
``encode``, the cross-attention train and decode paths and
``precompute_cross_kv``; ``Model.forward``, then ``Model.prefill`` with
frames and 8 teacher-forced decode steps, against the reference within
its ``encdec`` tolerance (5e-3 of the largest logit), in float32 (the
reference's own prefill emits f32 caches then); reduced whisper-large-v3
served by both engines in bfloat16 under fused and loop admission, dense
and paged (fused and loop also giving each other's streams, as the
reference's do), with the plan keys' launches and no policy evaluation
inside a step; the paged layout holding the cross cache dense, as the
reference's; the family predicates and refusals; and the cross decode
launch's split at full width, equal to the one the reference's launch
evaluates inside its trace.
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
from repro.models import common as jcommon
from repro.models import encdec as jencdec
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
from repro_torch.models import build_model, encdec
from repro_torch.models.common import GeluMLP, LayerNorm, apply_mlp, \
    apply_norm, sinusoidal_positions
from repro_torch.models.moe import balance_loss
from repro_torch.plan import AttentionSpec, Planner
from repro_torch.serving import GreedySampler, Request, ServingEngine
from repro_torch.serving.scheduler import Scheduler

ARCH = "whisper-large-v3"
D = 64
ENCDEC_TOL = 5e-3          # tests/test_models.py's TOL["encdec"]


def test_configs_match_reference():
    for cfg, jcfg in ((get_arch(ARCH), j_get_arch(ARCH)),
                      (reduced_config(ARCH, num_layers=2, d_model=D),
                       j_reduced_config(ARCH, num_layers=2, d_model=D))):
        assert cfg.family == jcfg.family == "encdec"
        for f in ("num_layers", "num_encoder_layers", "d_model",
                  "num_heads", "num_kv_heads", "d_ff", "vocab_size",
                  "resolved_head_dim", "rope_theta", "mlp_kind",
                  "cross_attention", "encoder_positions", "max_seq_len",
                  "tie_embeddings", "qkv_bias", "norm_eps"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert vars(cfg.frontend) == vars(jcfg.frontend)
    full = get_arch(ARCH)
    assert (full.num_heads, full.num_kv_heads, full.resolved_head_dim,
            full.encoder_positions) == (20, 20, 64, 1500)


def test_param_count_on_the_meta_device():
    """whisper-large-v3 on the meta device: the reference's spec count,
    about 1.6 B (32 + 32 layers, the 32768-row ``pos_dec``)."""
    params = encdec.EncDec(get_arch(ARCH), torch.device("meta"))
    n = sum(p.numel() for p in params.parameters())
    assert n == param_count(j_build_model(j_get_arch(ARCH)).param_specs())
    assert 1.5e9 < n < 1.8e9, n
    assert params.pos_dec.shape == (32768, 1280)
    assert params.dec_layers[0].ffn.bi.shape == (5120,)


def test_norm_mlp_and_positions_match_reference():
    """LayerNorm (``apply_norm`` with a bias), the gelu MLP with biases
    (the tanh gelu of ``jax.nn.gelu``) and the sinusoidal table, in
    float32, against the reference's functions."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 32)) * 2).astype(np.float32)
    ln = {"scale": rng.standard_normal(32).astype(np.float32),
          "bias": rng.standard_normal(32).astype(np.float32)}
    mod = LayerNorm(32, torch.float32, torch.device("cpu"))
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in ln.items()})
    np.testing.assert_allclose(
        apply_norm(mod, torch.from_numpy(x), 1e-6).numpy(),
        np.asarray(jcommon.apply_norm(ln, jnp.asarray(x), 1e-6)),
        rtol=1e-5, atol=1e-5)
    w = {n: (rng.standard_normal(s) / 4).astype(np.float32) for n, s in
         (("wi", (32, 96)), ("bi", (96,)), ("wo", (96, 32)), ("bo", (32,)))}
    mlp = GeluMLP(32, 96, torch.float32, torch.device("cpu"))
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    np.testing.assert_allclose(
        apply_mlp(mlp, torch.from_numpy(x), "gelu").numpy(),
        np.asarray(jcommon.apply_mlp({k: jnp.asarray(v) for k, v in
                                      w.items()}, jnp.asarray(x), "gelu")),
        rtol=1e-5, atol=1e-5)
    for length, dim in ((16, 64), (1500, 1280), (3, 2)):
        np.testing.assert_allclose(
            sinusoidal_positions(length, dim).numpy(),
            np.asarray(jcommon.sinusoidal_positions(length, dim)),
            rtol=1e-5, atol=2e-4)


def _pair(dtype):
    """Reduced whisper-large-v3 (d_model 64: 4 / 4 heads of 16, 2 + 2
    layers, 16 frames) in ``dtype``, the reference's weights in both."""
    kw = dict(dtype=dtype, param_dtype=dtype)
    jcfg = j_reduced_config(ARCH, num_layers=2, d_model=D).replace(**kw)
    cfg = reduced_config(ARCH, num_layers=2, d_model=D).replace(**kw)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(dtype), jax.jit(
        jmodel.init_params)(jax.random.PRNGKey(2)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("float32")


@pytest.fixture(scope="module")
def bf16_pair():
    return _pair("bfloat16")


def _frames(rng, b, cfg):
    return (rng.standard_normal((b, cfg.encoder_positions, cfg.d_model))
            * 0.1).astype(np.float32)


def test_encode_and_cross_attention_match_reference(f32_pair):
    """``encode`` (sinusoidal positions, non-causal attention), and decoder
    layer 0's cross attention over its output: the train path,
    ``precompute_cross_kv`` and the decode path (one query row over every
    memory row), within 1e-4 in float32 (the encoder's outputs reach
    about 8, where f32 roundings over its two layers reach 3e-5)."""
    jcfg, jmodel, jparams, cfg, model, params = f32_pair
    rng = np.random.default_rng(1)
    frames = _frames(rng, 2, cfg)
    jmem = jax.jit(jencdec.encode, static_argnums=1)(
        jparams, jcfg, jnp.asarray(frames))
    mem = encdec.encode(params, cfg, torch.from_numpy(frames))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **tol)
    lp = jax.tree.map(lambda a: a[0], jparams["dec_layers"])["cross"]
    block = params.dec_layers[0].cross
    x = rng.standard_normal((2, 7, D)).astype(np.float32)
    np.testing.assert_allclose(
        attn.cross_attention_train(block, cfg, torch.from_numpy(x),
                                   mem).numpy(),
        np.asarray(jattn.cross_attention_train(lp, jcfg, jnp.asarray(x),
                                               jmem)), **tol)
    jkv = jattn.precompute_cross_kv(lp, jcfg, jmem)
    kv = attn.precompute_cross_kv(block, cfg, mem)
    for name in ("k", "v"):
        np.testing.assert_allclose(kv[name].numpy(), np.asarray(jkv[name]),
                                   **tol)
    jout = jattn.cross_attention_decode(lp, jcfg, jnp.asarray(x[:, :1]), jkv)
    out = attn.cross_attention_decode(block, cfg, torch.from_numpy(x[:, :1]),
                                      kv)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)


def test_prefill_then_decode_matches_reference(f32_pair):
    """``Model.forward`` over 12 tokens and 16 frames at B 2, then
    ``Model.prefill`` and 8 decode steps teacher-forced on the reference's
    argmax tokens, in float32: every step's logits within 5e-3 of the
    reference's largest; the prefilled self and cross caches equal within
    1e-4 (through ``cache_from_numpy``)."""
    jcfg, jmodel, jparams, cfg, model, params = f32_pair
    rng = np.random.default_rng(4)
    (fshape, fdt), = model.frontend_inputs(2, 12).values()
    assert (fshape, fdt) == ((2, 16, D), "float32") == \
        jmodel.frontend_inputs(2, 12)["frames"]
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    frames = _frames(rng, 2, cfg)
    jbatch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "frames": torch.from_numpy(frames)}
    jfull, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    full, stats = model.forward(params, batch)
    assert float(balance_loss(stats)) == 0.0
    scale = float(jnp.max(jnp.abs(jfull)))
    assert np.abs(full.numpy() - np.asarray(jfull)).max() / scale < \
        ENCDEC_TOL
    jlog, jcache = jax.jit(jmodel.prefill, static_argnums=2)(
        jparams, jbatch, 48)
    log, cache = model.prefill(params, batch, 48)
    want = cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                            device="cpu")
    assert sorted(cache) == sorted(want) == ["cross_k", "cross_v", "k", "v"]
    for name, leaf in cache.items():
        assert leaf.shape == want[name].shape and leaf.dtype == \
            torch.float32
        np.testing.assert_allclose(leaf.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4)
    jdec = jax.jit(jmodel.decode_step)
    for i in range(9):
        scale = float(jnp.max(jnp.abs(jlog))) + 1e-9
        rel = float(np.max(np.abs(log.numpy() - np.asarray(jlog)))) / scale
        assert rel < ENCDEC_TOL, (i, rel)
        if i == 8:
            break
        nxt = jnp.argmax(jlog, -1).astype(jnp.int32)
        jlog, jcache = jdec(jparams, jcache, nxt, jnp.int32(12 + i))
        log = model.decode_step(params, cache,
                                torch.from_numpy(np.array(nxt)).long(),
                                torch.full((2,), 12 + i, dtype=torch.long))


PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3, 4, 1, 2, 3],
           [9, 9, 8, 9, 9, 8, 9, 9, 8, 9, 9, 8], [2, 4, 6, 8, 2, 4, 6]]
LAYOUTS = {"dense": dict(), "paged": dict(cache_layout="paged",
                                          cache_page_size=16)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_reduced_encdec_engines_serve_the_jax_streams(bf16_pair, layout):
    """4 requests over 2 slots, greedy, bf16, under fused and loop
    admission: the same streams, finish reasons and plan launches as the
    JAX engine's; fused and loop give the same streams (the cross cache
    is zero at both: admission resets the slot); no policy evaluation
    inside a step; the cross launches take the scheduler's side plan."""
    jcfg, jmodel, jparams, cfg, model, params = bf16_pair
    streams = {}
    for mode in ("fused", "loop"):
        kw = dict(LAYOUTS[layout], prefill_mode=mode)
        jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, **kw),
                              max_len=64, batch_slots=2,
                              sampler=JGreedySampler())
        jeng.load(jparams)
        ops.reset_policy_eval_count()
        eng = ServingEngine(model, ServeConfig(model=cfg, **kw), max_len=64,
                            batch_slots=2, sampler=GreedySampler(),
                            device="cpu")
        eng.load(params)
        for i, p in enumerate(PROMPTS):
            jeng.submit(JRequest(i, p, max_new_tokens=6))
            eng.submit(Request(i, p, max_new_tokens=6))
        jdone, done = jeng.drain(), eng.drain()
        assert [c.tokens for c in done] == [c.tokens for c in jdone]
        assert [c.finish_reason for c in done] == \
            [c.finish_reason for c in jdone]
        assert eng.stats.launches == dict(jeng.stats.launches)
        assert ops.policy_eval_count() == 0
        (name, side), = eng.sched.side_plans().items()
        assert (name, side.spec.seqlen_k, side.bucket) == ("cross", 16, None)
        if eng.cache.is_paged:
            eng.cache.check_conservation()
        streams[mode] = [c.tokens for c in done]
    assert streams["fused"] == streams["loop"]


def test_paged_layout_keeps_the_cross_cache_dense(bf16_pair):
    """The paged storage: self K / V as pages, cross K / V dense, the
    reference's shapes leaf for leaf; a gather passes the cross cache
    through; ``zero_slot`` zeroes exactly the slot's cross column."""
    jcfg, jmodel, jparams, cfg, model, params = bf16_pair
    jman = jmodel.cache_manager(2, 64, layout="paged", page_size=16)
    man = model.cache_manager(2, 64, layout="paged", page_size=16)
    jstore, store = jman.init_storage(), man.init_storage()
    names = {"k": ("self", "k"), "v": ("self", "v"),
             "cross_k": ("cross", "k"), "cross_v": ("cross", "v")}
    for name, (part, leaf) in names.items():
        assert store[name].shape == jstore[part][leaf].shape, name
    assert man.layout.paged == ("k", "v")
    assert man.layout.row_bytes() == jman.layout.row_bytes()
    for name in ("cross_k", "cross_v"):
        store[name].fill_(1.0)
    store["k"].fill_(1.0)
    view = man.layout.gather_view(store, man.table_device(), 2)
    assert view["cross_k"] is store["cross_k"]
    man.layout.zero_slot(store, 1)
    assert float(store["cross_k"][:, 1].abs().sum()) == 0.0
    assert float(store["cross_k"][:, 0].min()) == 1.0
    assert float(store["k"].min()) == 1.0


def test_encdec_predicates_and_refusals(bf16_pair):
    """Fused prefill and paging yes, prefix sharing and speculation no,
    the slot reset at fused admission, the CLI's refusal: each as the
    reference's, with its message."""
    from repro.launch.serve import run_serving as j_run_serving
    from repro_torch.launch.serve import run_serving
    jcfg, jmodel, jparams, cfg, model, params = bf16_pair
    for pred in ("supports_paged_cache", "supports_fused_prefill",
                 "supports_prefix_sharing", "supports_speculation",
                 "prefill_writes_full_slot"):
        assert getattr(model, pred) == getattr(jmodel, pred), pred
    assert (model.supports_paged_cache, model.supports_fused_prefill,
            model.prefill_writes_full_slot) == (True, True, False)
    for kw, msg in ((dict(cache_layout="paged", share_prefix=True),
                     "encdec models cannot share prefix pages"),
                    (dict(speculation="ngram"),
                     "encdec models cannot run speculative verify steps")):
        for eng_cls, m, c, dev in (
                (JServingEngine, jmodel, JServeConfig(model=jcfg, **kw), {}),
                (ServingEngine, model, ServeConfig(model=cfg, **kw),
                 {"device": "cpu"})):
            with pytest.raises(ValueError, match=msg):
                eng_cls(m, c, **dev)
    msg = "CLI serving drives text-only archs"
    with pytest.raises(NotImplementedError, match=msg):
        j_run_serving(ARCH, log_fn=lambda line: None)
    with pytest.raises(NotImplementedError, match=msg):
        run_serving(ARCH, device="cpu", log_fn=lambda line: None)


def _reference_inline_cross_split(batch: int, policy: str) -> int:
    """The split the reference's cross decode launch evaluates inside its
    trace at whisper-large-v3's full shape (B ``batch``, L_K 1500, 20 / 20
    heads, D 64), under a frozen ``policy`` plan of another shape at 132
    cores, traced abstractly (nothing allocated)."""
    cfg = j_get_arch(ARCH)
    frozen = JPlanner(policy=policy, num_cores=132).plan(
        JAttentionSpec.decode(batch, 1024, 20, 20, 64), bucket=1024)
    specs = jattn.attention_specs(cfg)
    p = {k: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
         for k, s in specs.items()}
    kv = jax.ShapeDtypeStruct((batch, 1500, 20, 64), jnp.bfloat16)
    x = jax.ShapeDtypeStruct((batch, 1, 1280), jnp.bfloat16)
    j_ops.reset_policy_eval_count()
    jax.eval_shape(lambda p, x, k, v: jattn.cross_attention_decode(
        p, cfg, x, {"k": k, "v": v}, plan=frozen), p, x, kv, kv)
    assert j_ops.policy_eval_count() == 1
    return j_ops.last_inline_plan().num_splits


@pytest.mark.parametrize("policy", ["paper", "fa3_baseline"])
def test_cross_split_equals_the_references(policy):
    """At full width and 132 SMs the scheduler's cross side plan takes
    the split the reference's launch evaluates: S 6 at B 1 and S 3 at B
    2, under ``paper`` and ``fa3_baseline``; frozen with no bucket (the
    launch reads all 1500 rows) and made once, by the planner alone."""
    cfg = get_arch(ARCH)
    for batch, want in ((1, 6), (2, 3)):
        sched = Scheduler(cfg, batch_slots=batch, max_len=2048,
                          policy=policy, num_cores=132)
        ops.reset_policy_eval_count()
        side = sched.side_plans()
        assert sched.side_plans() is side
        assert ops.policy_eval_count() == 0
        plan = side["cross"]
        assert plan.frozen and plan.bucket is None
        assert plan.spec == AttentionSpec.decode(batch, 1500, 20, 20, 64)
        assert plan.num_splits == want == \
            _reference_inline_cross_split(batch, policy)
        assert Planner(policy=policy, num_cores=132).plan(
            plan.spec).num_splits == want


def test_cross_decode_without_a_side_plan_evaluates_inside():
    """Called with only a frozen plan of another shape, the cross launch
    drops it and the policy decides over the encoder length inside the
    launch (counted), as the reference's does; with the side plan it
    evaluates nothing."""
    cfg = reduced_config(ARCH, num_layers=1, d_model=D)
    block = attn.Attention(cfg, torch.float32, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.common import init_params
    init_params(block, gen)
    x = torch.randn(2, 1, D, generator=gen)
    kv = {n: torch.randn(2, 16, 4, 16, generator=gen) for n in ("k", "v")}
    frozen = Planner(policy="paper").plan(
        AttentionSpec.decode(2, 128, 4, 4, 16), bucket=128)
    ops.reset_policy_eval_count()
    got = attn.cross_attention_decode(block, cfg, x, kv, plan=frozen)
    assert ops.policy_eval_count() == 1
    assert ops.last_inline_plan().spec.seqlen_k == 16
    side = Planner(policy="paper").plan(AttentionSpec.decode(2, 16, 4, 4,
                                                             16))
    ops.reset_policy_eval_count()
    torch.testing.assert_close(
        attn.cross_attention_decode(block, cfg, x, kv, plan=side), got)
    assert ops.policy_eval_count() == 0

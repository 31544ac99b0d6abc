"""The port's mla family (minicpm3-4b) against the reference's, on the CPU.

``_latents``, ``_queries``, ``mla_prefill`` (output and latent rows) and
the absorbed ``mla_decode`` (output and updated latent) against
``repro.models.mla`` on the same float32 weights and inputs; decode
attention with v a column view of k (``scale=1.0``) against
``ref.split_decode_xla`` at several split counts; prefill attention with
v narrower than q and k against ``ref.flash_attention_xla``; the four
family predicates of every registered arch against the reference's; the
full config's parameter count on the meta device; and reduced
minicpm3-4b served by both engines in float32 (the reference's tests run
mla in f32) under fused and loop admission, dense and paged caches, and
``kv_quant="int8"``, which leaves the latent unquantized, as in the
reference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.kernels import ref as jref
from repro.models import build_model as j_build_model
from repro.models import mla as jmla
from repro.models.common import param_count
from repro.plan import LaunchPlan as JLaunchPlan
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import ARCH_MODULES, get_arch
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model, lm, mla
from repro_torch.models.common import rope_angles
from repro_torch.plan import LaunchPlan
from repro_torch.serving import GreedySampler, Request, SamplingParams, \
    ServingEngine
from repro_torch.spec import SpecConfig

ARCH = "minicpm3-4b"
F32 = dict(dtype="float32", param_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
D = 32


def _cfgs():
    return (j_reduced_config(ARCH, num_layers=2, d_model=D).replace(**F32),
            reduced_config(ARCH, num_layers=2, d_model=D).replace(**F32))


def _weights(jcfg, seed=0):
    """One MLA layer's float32 weights at the reference's spec shapes
    (norm scales away from 1, so they count)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in jmla.mla_specs(jcfg).items():
        a = rng.standard_normal(spec.shape) / np.sqrt(
            spec.fan_in or spec.shape[0])
        if spec.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(spec.shape)
        out[name] = a.astype(np.float32)
    return out


def _port_mla(cfg, w):
    mod = mla.MLA(cfg, torch.float32, torch.device("cpu"))
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    return mod


def _rope(cfg, pos):
    return rope_angles(torch.from_numpy(pos), lm.rope_dim(cfg),
                       cfg.rope_theta)


# the reference's functions compiled once a shape (its eager ops would
# compile one by one)
_j_latents = jax.jit(jmla._latents, static_argnums=1)
_j_queries = jax.jit(jmla._queries, static_argnums=1)
_j_prefill = jax.jit(jmla.mla_prefill, static_argnums=(1, 4))
_j_decode = jax.jit(jmla.mla_decode, static_argnums=1,
                    static_argnames="plan")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def test_configs_match_reference():
    """MLAConfig field for field, at full width and reduced; the serving
    and plan widths that follow from it."""
    for cfg, jcfg in ((get_arch(ARCH), j_get_arch(ARCH)),
                      (reduced_config(ARCH, num_layers=2, d_model=D),
                       j_reduced_config(ARCH, num_layers=2, d_model=D))):
        assert cfg.family == jcfg.family == "mla"
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "resolved_head_dim", "rope_theta",
                  "mlp_kind", "tie_embeddings"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert vars(cfg.mla) == vars(jcfg.mla)
    full = get_arch(ARCH)
    assert mla.latent_width(full) == 288 and full.resolved_head_dim == 64


@pytest.mark.parametrize("b,length", [(2, 9), (1, 1)])
def test_latents_queries_and_prefill_match_reference(b, length):
    jcfg, cfg = _cfgs()
    w = _weights(jcfg)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, length, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(length, dtype=np.int32) + 3,
                          (b, length)).copy()
    mod = _port_mla(cfg, w)
    xt, rope = torch.from_numpy(x), _rope(cfg, pos)
    for got, want in zip(mla._latents(mod, cfg, xt, rope),
                         _j_latents(jw, jcfg, jnp.asarray(x),
                                       jnp.asarray(pos))):
        _close(got, want)
    for got, want in zip(mla._queries(mod, cfg, xt, rope),
                         _j_queries(jw, jcfg, jnp.asarray(x),
                                       jnp.asarray(pos))):
        _close(got, want)
    pos0 = np.broadcast_to(np.arange(length, dtype=np.int32),
                           (b, length)).copy()
    jy, jc = _j_prefill(jw, jcfg, jnp.asarray(x), jnp.asarray(pos0),
                        length + 4)
    y, rows = mla.mla_prefill(mod, cfg, xt, _rope(cfg, pos0))
    _close(y, jy, rtol=1e-4, atol=1e-5)
    assert rows["latent"].shape == (b, length, 1, mla.latent_width(cfg))
    _close(rows["latent"], np.asarray(jc["latent"])[:, :length])
    assert not np.asarray(jc["latent"])[:, length:].any()


def test_absorbed_decode_matches_reference():
    """Two slots at positions 5 and 11 over a cache of random latent rows
    (bf16, as both packages store it): the same output, and the same
    latent after the write."""
    jcfg, cfg = _cfgs()
    w = _weights(jcfg, seed=2)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, D)).astype(np.float32)
    t = np.array([5, 11], np.int32)
    lat = rng.standard_normal((2, 16, 1, mla.latent_width(cfg))).astype(
        np.float32)
    jlat = jnp.asarray(lat, jnp.bfloat16)
    cache = {"latent": torch.from_numpy(np.array(jlat.astype(jnp.float32))
                                        ).to(torch.bfloat16)}
    plan = JLaunchPlan(kind="decode", num_splits=2)
    jy, jc = _j_decode(jw, jcfg, jnp.asarray(x), {"latent": jlat},
                       jnp.asarray(t), plan=plan)
    y = mla.mla_decode(_port_mla(cfg, w), cfg, torch.from_numpy(x), cache,
                       torch.from_numpy(t).long(),
                       _rope(cfg, t[:, None]),
                       plan=LaunchPlan(kind="decode", num_splits=2))
    _close(y, jy, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        cache["latent"].float().numpy(),
        np.asarray(jc["latent"].astype(jnp.float32)))


@functools.partial(jax.jit, static_argnums=(4, 5))
def _j_split_decode(q, k, v, kv_len, s, scale):
    return jref.split_decode_xla(q, k, v, kv_len, s, scale=scale)


@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("dk,dv,g", [(288, 256, 40), (40, 32, 4)])
def test_decode_attention_over_a_column_view_of_k(s, dk, dv, g):
    """``ops.decode_attention(q, k, k[..., :dv], scale=1.0)`` (MLA's
    latent decode: one KV head, a pre-scaled q) against
    ``split_decode_xla`` on the same inputs, ragged lengths."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, g, dk)).astype(np.float32) * dk ** -0.5
    k = rng.standard_normal((2, 384, 1, dk)).astype(np.float32)
    lens = np.array([384, 131], np.int32)
    kt = torch.from_numpy(k)
    got = ops.decode_attention(torch.from_numpy(q), kt, kt[..., :dv],
                               torch.from_numpy(lens), scale=1.0,
                               plan=LaunchPlan(kind="decode", num_splits=s))
    want = _j_split_decode(jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(k[..., :dv]), jnp.asarray(lens), s,
                           1.0)
    assert got.shape == (2, g, dv)
    _close(got, want)


@pytest.mark.parametrize("lq", [1, 37, 128])
def test_prefill_attention_with_v_narrower_than_q(lq):
    """``ops.attention`` at MLA's prefill widths (q / k 96, v 64, causal),
    scaled by q's width, against ``flash_attention_xla``."""
    rng = np.random.default_rng(lq)
    q, k = (rng.standard_normal((1, lq, 4, 96)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, lq, 4, 64)).astype(np.float32)
    got = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=True)
    want = jax.jit(jref.flash_attention_xla)(q, k, v)
    assert got.shape == (1, lq, 4, 64)
    _close(got, want)


def test_family_predicates_match_reference_for_every_arch():
    """``supports_paged_cache``, ``supports_fused_prefill``,
    ``supports_prefix_sharing`` and ``supports_speculation`` of every arch
    the port registers, full and reduced, equal the reference's."""
    get_arch(ARCH)              # loads every module of ARCH_MODULES
    from repro_torch.configs.base import _REGISTRY
    assert len(_REGISTRY) == len(ARCH_MODULES)
    preds = ("supports_paged_cache", "supports_fused_prefill",
             "supports_prefix_sharing", "supports_speculation")
    seen = {}
    for name in sorted(_REGISTRY):
        for cfg, jcfg in ((get_arch(name), j_get_arch(name)),
                          (reduced_config(name), j_reduced_config(name))):
            model, jmodel = build_model(cfg, device="cpu"), \
                j_build_model(jcfg)
            got = tuple(getattr(model, p) for p in preds)
            assert got == tuple(getattr(jmodel, p) for p in preds), name
            seen[cfg.family] = got
    assert seen["mla"] == (True, True, False, False)
    assert seen["vlm"] == (True, False, False, False)
    assert seen["dense"] == seen["moe"] == (True,) * 4


def test_param_count_on_the_meta_device():
    """minicpm3-4b's parameters on the meta device (nothing allocated):
    the reference's spec count, about 4.3 B."""
    params = lm.LM(get_arch(ARCH), torch.device("meta"))
    n = sum(p.numel() for p in params.parameters())
    assert n == param_count(j_build_model(j_get_arch(ARCH)).param_specs())
    assert 4.0e9 < n < 4.6e9, n
    assert params.layers[0].mix.q_up.shape == (768, 40, 96)


# ---------------------------------------------------------------------------
# engines: reduced minicpm3-4b through both packages, float32
# ---------------------------------------------------------------------------

PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3, 4, 1, 2, 3],
           [9, 9, 8, 9, 9, 8, 9, 9, 8, 9, 9, 8], [2, 4, 6, 8, 2, 4, 6]]
CASES = {
    "fused_dense_bf16": dict(prefill_mode="fused"),
    "loop_paged_bf16": dict(prefill_mode="loop", cache_layout="paged",
                            cache_page_size=16),
    "fused_paged_int8": dict(prefill_mode="fused", cache_layout="paged",
                             cache_page_size=16, kv_quant="int8"),
    "loop_dense_int8": dict(prefill_mode="loop", kv_quant="int8"),
}


@pytest.fixture(scope="module")
def mla_pair():
    jcfg, cfg = _cfgs()
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jax.jit(jmodel.init_params)(jax.random.PRNGKey(1)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_mla_engines_serve_the_jax_streams(mla_pair, case):
    """4 requests over 2 slots (refills), greedy: the JAX engine's token
    streams, finish reasons and plan launches by key (decode plans at
    H_KV 1), with no policy evaluation inside a launch.  The latent is
    bf16 in both packages whatever the cache dtype; under int8 the plans
    are keyed int8 and the cache holds no scales."""
    jcfg, jmodel, jparams, cfg, model, params = mla_pair
    kw = CASES[case]
    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, **kw),
                          max_len=64, batch_slots=2,
                          sampler=JGreedySampler())
    jeng.load(jparams)
    ops.reset_policy_eval_count()
    eng = ServingEngine(model, ServeConfig(model=cfg, **kw), max_len=64,
                        batch_slots=2, sampler=GreedySampler(), device="cpu")
    eng.load(params)
    assert eng.prefill_mode == jeng.prefill_mode == kw["prefill_mode"]
    for i, p in enumerate(PROMPTS):
        jeng.submit(JRequest(i, p, max_new_tokens=6))
        eng.submit(Request(i, p, max_new_tokens=6))
    jdone, done = jeng.drain(), eng.drain()
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert [c.finish_reason for c in done] == \
        [c.finish_reason for c in jdone]
    assert eng.stats.launches == {
        (k if isinstance(k, int) else tuple(k)): v
        for k, v in jeng.stats.launches.items()}
    assert ops.policy_eval_count() == 0
    spec = eng.sched.decode_spec(128)
    assert (spec.num_heads_kv, spec.head_dim) == (1, cfg.resolved_head_dim)
    assert vars(spec.workload()) == vars(jeng.sched.decode_spec(128)
                                         .workload())
    shapes = model.cache_shapes(2, 64, eng.kv_dtype)
    assert shapes == {"latent": ((2, 2, 64, 1, 40), torch.bfloat16)}
    if eng.cache.is_paged:
        eng.cache.check_conservation()


def test_mla_refuses_prefix_sharing_and_speculation(mla_pair):
    """As the reference's engine refuses them, with its messages."""
    jcfg, jmodel, jparams, cfg, model, params = mla_pair
    with pytest.raises(ValueError, match="mla models cannot share prefix "
                                         "pages"):
        ServingEngine(model, ServeConfig(model=cfg, cache_layout="paged",
                                         share_prefix=True), device="cpu")
    with pytest.raises(ValueError, match="mla models cannot run "
                                         "speculative verify steps"):
        ServingEngine(model, ServeConfig(model=cfg, speculation="ngram"),
                      device="cpu")
    eng = ServingEngine(model, ServeConfig(model=cfg), device="cpu")
    with pytest.raises(ValueError, match="cannot run speculative"):
        eng.submit(Request(0, [1, 2], sampling=SamplingParams(
            speculation=SpecConfig(method="ngram"))))
    with pytest.raises(NotImplementedError, match="cannot suffix-prefill"):
        model.prefill_suffix_view(params, {}, torch.zeros(4, dtype=torch.long),
                                  0, 4)
    with pytest.raises(NotImplementedError, match="speculative verify"):
        model.verify_step(params, {}, torch.zeros((1, 2), dtype=torch.long),
                          torch.zeros(1, dtype=torch.long))

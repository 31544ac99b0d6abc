"""The port's vlm family (paligemma-3b) against the reference's, on the CPU.

``apply_mlp`` for ``geglu`` (the tanh-approximate gelu of the
reference's ``jax.nn.gelu``); ``Model.prefill`` with a projected patch
prefix, then 8 teacher-forced decode steps, against the reference's
logits within its own ``vlm`` tolerance (5e-3 of the largest logit),
under an f32 and an int8 cache, in float32: in bf16 the reduced model's
prefill logits part by 2e-2 of the largest, because XLA evaluates fused
elementwise chains (the gated MLP's gelu times up) in f32 and rounds
once, where PyTorch rounds every op, while in f32 they agree within
2e-5;
reduced paligemma-3b served by both engines, which admit through the
teacher-forcing loop, dense and paged, bf16 and int8; the refusals of
``prefill_mode="fused"``, prefix sharing, speculation and the CLI, as
the reference refuses them; and the full config's parameter count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.models import build_model as j_build_model
from repro.models.common import apply_mlp as j_apply_mlp
from repro.models.common import param_count
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_arch
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model, lm
from repro_torch.models.common import MLP, apply_mlp
from repro_torch.serving import GreedySampler, Request, ServingEngine

ARCH = "paligemma-3b"
D = 64
VLM_TOL = 5e-3             # tests/test_models.py's TOL["vlm"]


def test_configs_match_reference():
    for cfg, jcfg in ((get_arch(ARCH), j_get_arch(ARCH)),
                      (reduced_config(ARCH, num_layers=2, d_model=D),
                       j_reduced_config(ARCH, num_layers=2, d_model=D))):
        assert cfg.family == jcfg.family == "vlm"
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "resolved_head_dim", "q_group_size",
                  "rope_theta", "mlp_kind", "tie_embeddings"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert vars(cfg.frontend) == vars(jcfg.frontend)
    full = get_arch(ARCH)
    assert (full.num_heads, full.num_kv_heads, full.resolved_head_dim) == \
        (8, 1, 256)


@pytest.mark.parametrize("kind", ["geglu", "swiglu"])
def test_gated_mlp_matches_reference(kind):
    """geglu's gate is the tanh-approximate gelu, as ``jax.nn.gelu``'s
    default: within 1e-6 in f32, where the exact erf form is off by more
    than 1e-4."""
    rng = np.random.default_rng(0)
    w = {n: (rng.standard_normal(s) / 4).astype(np.float32) for n, s in
         (("wi_gate", (32, 96)), ("wi_up", (32, 96)), ("wo", (96, 32)))}
    x = (rng.standard_normal((3, 5, 32)) * 2).astype(np.float32)
    mod = MLP(32, 96, torch.float32, torch.device("cpu"))
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    got = apply_mlp(mod, torch.from_numpy(x), kind).numpy()
    want = np.asarray(jax.jit(j_apply_mlp, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), kind))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if kind == "geglu":
        xt = torch.from_numpy(x)
        exact = ((torch.nn.functional.gelu(xt @ mod.wi_gate)
                  * (xt @ mod.wi_up)) @ mod.wo).numpy()
        assert np.abs(exact - want).max() > 1e-4
    with pytest.raises(ValueError, match="only the swiglu and geglu"):
        apply_mlp(mod, torch.from_numpy(x), "gelu")


def test_param_count_on_the_meta_device():
    """paligemma-3b on the meta device: the reference's spec count (about
    2.9 B, the vision stub's patch_proj included)."""
    params = lm.LM(get_arch(ARCH), torch.device("meta"))
    n = sum(p.numel() for p in params.parameters())
    assert n == param_count(j_build_model(j_get_arch(ARCH)).param_specs())
    assert 2.7e9 < n < 3.2e9, n
    assert params.patch_proj.shape == (1152, 2048)


def _pair(dtype):
    """Reduced paligemma-3b (d_model 64: 4 / 1 heads of 16, 8 patches of
    48) in ``dtype``, the reference's weights in both packages."""
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
def vlm_pair():
    return _pair("bfloat16")


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_prefill_with_patches_then_decode_matches_reference(kv_dtype):
    """``Model.prefill`` over 8 projected patches and 20 text tokens at B
    2, then 8 decode steps teacher-forced on the reference's argmax
    tokens from t = L_total, in float32: every step's logits within 5e-3
    of the reference's largest, and layer 0's prefilled cache rows
    equal up to their storage's rounding."""
    jcfg, jmodel, jparams, cfg, model, params = _pair("float32")
    rng = np.random.default_rng(4)
    lt, steps, max_len = 20, 8, 48
    assert model.text_len(lt + 8) == lt
    (pshape, pdt), = model.frontend_inputs(2, lt + 8).values()
    assert (pshape, pdt) == (
        (2, 8, 48), "float32") == jmodel.frontend_inputs(2, lt + 8)[
            "patches"]
    tokens = rng.integers(0, cfg.vocab_size, (2, lt)).astype(np.int32)
    patches = (rng.standard_normal(pshape) * 0.1).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}
    jlog, jcache = jax.jit(jmodel.prefill, static_argnums=(2, 3))(
        jparams, jbatch, max_len, kv_dtype)
    log, cache = model.prefill(params, {
        "tokens": torch.from_numpy(tokens).long(),
        "patches": tensor_from_numpy(patches)}, max_len, kv_dtype)
    total = 8 + lt
    jdec = jax.jit(jmodel.decode_step)
    # layer 0's cache rows (the projected patches' and the tokens' K and
    # V) within one step of their storage: an int8 code, an f32 rounding
    for name, leaf in jcache[0][0].items():
        want = np.asarray(leaf)[0]
        tol = dict(rtol=0, atol=1) if want.dtype == np.int8 else \
            dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(cache[name][0].float().numpy(),
                                   want.astype(np.float32), **tol)
    for i in range(steps + 1):
        scale = float(jnp.max(jnp.abs(jlog))) + 1e-9
        rel = float(np.max(np.abs(log.numpy() - np.asarray(jlog)))) / scale
        assert rel < VLM_TOL, (i, rel)
        if i == steps:
            break
        nxt = jnp.argmax(jlog, -1).astype(jnp.int32)
        t = total + i
        jlog, jcache = jdec(jparams, jcache, nxt, jnp.int32(t))
        log = model.decode_step(params, cache, torch.from_numpy(
            np.array(nxt)).long(), torch.full((2,), t, dtype=torch.long))


PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3, 4, 1, 2, 3],
           [9, 9, 8, 9, 9, 8, 9, 9, 8, 9, 9, 8], [2, 4, 6, 8, 2, 4, 6]]
# dense and paged, bf16 and int8, in two runs
CASES = {"dense_bf16": dict(),
         "paged_int8": dict(cache_layout="paged", cache_page_size=16,
                            kv_quant="int8")}


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_vlm_engines_serve_the_jax_streams(vlm_pair, case):
    """4 requests over 2 slots, greedy, bf16 weights and cache (int8's
    own): ``prefill_mode="auto"`` resolves to the loop in both engines,
    which then give the same streams, finish reasons and plan launches
    (every admission a run of decode steps, no prefill key), with no
    policy evaluation inside a launch."""
    jcfg, jmodel, jparams, cfg, model, params = vlm_pair
    kw = CASES[case]
    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, **kw),
                          max_len=64, batch_slots=2,
                          sampler=JGreedySampler())
    jeng.load(jparams)
    ops.reset_policy_eval_count()
    eng = ServingEngine(model, ServeConfig(model=cfg, **kw), max_len=64,
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
    if eng.cache.is_paged:
        eng.cache.check_conservation()


def test_vlm_refuses_what_the_reference_refuses(vlm_pair):
    """``prefill_mode="fused"``, prefix sharing, speculation, fused
    admission at the facade and CLI serving, each with the reference's
    message."""
    from repro.launch.serve import run_serving as j_run_serving
    from repro_torch.launch.serve import run_serving
    jcfg, jmodel, jparams, cfg, model, params = vlm_pair
    for kw, msg in ((dict(prefill_mode="fused"),
                     "vlm models cannot fused-prefill a padded prompt"),
                    (dict(cache_layout="paged", share_prefix=True),
                     "prefix sharing admits through the fused prefill"),
                    (dict(speculation="ngram"),
                     "vlm models cannot run speculative verify steps")):
        for eng_cls, m, c, dev in (
                (JServingEngine, jmodel, JServeConfig(model=jcfg, **kw), {}),
                (ServingEngine, model, ServeConfig(model=cfg, **kw),
                 {"device": "cpu"})):
            with pytest.raises(ValueError, match=msg):
                eng_cls(m, c, **dev)
    with pytest.raises(NotImplementedError, match="cannot fused-prefill"):
        model.prefill_slot_view(params, torch.zeros(8, dtype=torch.long), 8)
    msg = "CLI serving drives text-only archs"
    with pytest.raises(NotImplementedError, match=msg):
        j_run_serving(ARCH, log_fn=lambda line: None)
    with pytest.raises(NotImplementedError, match=msg):
        run_serving(ARCH, device="cpu", log_fn=lambda line: None)

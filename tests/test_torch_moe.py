"""The port's MoE family against the reference's, on the CPU.

``apply_moe`` (both dispatches) against ``repro.models.moe.apply_moe``
on the same float32 weights and inputs, including a router biased so
that assignments overflow capacity and rows whose probabilities tie;
the full configs' parameter counts on the meta device; and reduced
granite-moe-3b-a800m and qwen3-moe-235b-a22b served by both engines in
float32 with one set of JAX-initialised weights, under fused and loop
admission, dense and paged caches, prefix sharing, ``ngram`` speculation
and an int8 cache: the same streams, finish reasons and plan launches.
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
from repro.models import build_model as j_build_model
from repro.models import moe as jmoe
from repro.models.common import param_count
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.spec import SpecConfig as JSpecConfig
from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.serving import (
    GreedySampler,
    Request,
    SamplingParams,
    ServingEngine,
)
from repro_torch.spec import SpecConfig

ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
F32 = dict(dtype="float32", param_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
D, E, F = 32, 8, 32


def _weights(router: str, seed: int = 0):
    """Float32 MoE weights at the reduced shape (d 32, 8 experts, f 32).
    ``biased``: expert 0's router column dominates, so every token's
    first choice is expert 0 and a group longer than the capacity drops
    assignments.  ``tied``: columns 1 and 2 are equal, so every token's
    probabilities of experts 1 and 2 tie."""
    rng = np.random.default_rng(seed)
    w = {"router": rng.standard_normal((D, E)).astype(np.float32),
         "wi_gate": (rng.standard_normal((E, D, F)) / 6).astype(np.float32),
         "wi_up": (rng.standard_normal((E, D, F)) / 6).astype(np.float32),
         "wo": (rng.standard_normal((E, F, D)) / 6).astype(np.float32)}
    if router == "biased":
        w["router"][:, 0] = 4.0
    elif router == "tied":
        w["router"][:, 2] = w["router"][:, 1]
    return w


def _cfgs(arch="granite-moe-3b-a800m"):
    return (j_reduced_config(arch, num_layers=2, d_model=D).replace(**F32),
            reduced_config(arch, num_layers=2, d_model=D).replace(**F32))


def _inputs(b, length, router, seed=1):
    x = np.random.default_rng(seed).standard_normal((b, length, D)).astype(
        np.float32)
    if router == "tied":
        x[0, 0] = 0.0               # zero logits: all eight experts tie
        x[1, 0, D // 2] = 1e-3      # small ones: near-ties far from zero
    if router == "biased":
        # positive inputs make expert 0's huge column win every row
        x = np.abs(x) + 0.5
    return x


@functools.partial(jax.jit, static_argnums=(1, 3))
def _j_moe(w, cfg, x, dispatch):
    """The reference's apply_moe and its routing decisions, compiled
    once a shape (its eager ops would compile one by one)."""
    out, aux = jmoe.apply_moe(w, cfg, x, dispatch=dispatch)
    _, experts, _ = jmoe._route(w, cfg, x)
    return out, aux, experts, jmoe._positions_in_expert(experts, E)[1]


def _port_moe(cfg, w):
    mod = moe.MoE(cfg, torch.float32, torch.device("cpu"))
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    return mod


def test_configs_match_reference():
    """MoEConfig field for field, at full width and reduced."""
    for arch in ARCHS:
        for cfg, jcfg in ((get_arch(arch), j_get_arch(arch)),
                          (reduced_config(arch, num_layers=2, d_model=D),
                           j_reduced_config(arch, num_layers=2, d_model=D))):
            assert cfg.family == jcfg.family == "moe"
            for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "d_ff", "vocab_size", "resolved_head_dim",
                      "q_group_size", "rope_theta", "qkv_bias", "mlp_kind"):
                assert getattr(cfg, f) == getattr(jcfg, f), (arch, f)
            assert vars(cfg.moe) == vars(jcfg.moe), arch


@pytest.mark.parametrize("router", ["random", "biased", "tied"])
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("b,length", [(2, 16), (3, 1), (2, 5)])
def test_apply_moe_matches_reference(router, dispatch, b, length):
    """Output and load-balance loss within 1e-5; routing decisions
    (experts, queue positions, and so the dropped assignments) equal."""
    jcfg, cfg = _cfgs()
    w = _weights(router)
    x = _inputs(b, length, router)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jout, jaux, jexp, jpos = _j_moe(jw, jcfg, jnp.asarray(x), dispatch)
    mod = _port_moe(cfg, w)
    out = moe.apply_moe(mod, cfg, torch.from_numpy(x), dispatch=dispatch)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    # the routing itself, decision for decision, and its loss
    _, exp, probs = moe._route(mod, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(float(moe.load_balance_loss(probs, exp, E)),
                               float(jaux), **TOL)
    _, pos = moe._positions_in_expert(exp, E)
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    cap = moe._capacity(length, E, cfg.moe.top_k, cfg.moe.capacity_factor)
    dropped = int((pos >= cap).sum())
    if router == "biased" and length > 1:
        assert dropped > 0, "the biased router must overflow capacity"
    if router == "tied":
        assert exp[0, 0].tolist() == [0, 1], \
            "an all-tied row takes the lowest expert indices"
        assert torch.equal(probs[..., 1], probs[..., 2])


def test_dispatches_agree_and_ep_shard_map_runs_as_gather():
    _, cfg = _cfgs()
    mod = _port_moe(cfg, _weights("biased"))
    x = torch.from_numpy(_inputs(2, 16, "biased"))
    outs = [moe.apply_moe(mod, cfg, x, dispatch=d)
            for d in ("gather", "einsum", "ep_shard_map")]
    torch.testing.assert_close(outs[0], outs[1], **TOL)
    assert torch.equal(outs[0], outs[2])
    grouped = moe.apply_moe(mod, cfg, x, group_size=4)
    per_row = moe.apply_moe(mod, cfg, x.reshape(8, 4, D))
    assert torch.equal(grouped, per_row.reshape(2, 16, D))
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        moe.apply_moe(mod, cfg, x, dispatch="alltoall")


def test_param_counts_on_the_meta_device():
    """The full configs' parameter counts on the meta device (nothing
    allocated) equal the reference's spec counts, and qwen3-moe's lies in
    the reference's advertised range (tests/test_models.py)."""
    expect = {"granite-moe-3b-a800m": (3.0e9, 3.6e9),
              "qwen3-moe-235b-a22b": (2.1e11, 2.6e11)}
    for arch, (lo, hi) in expect.items():
        params = lm.LM(get_arch(arch), torch.device("meta"))
        n = sum(p.numel() for p in params.parameters())
        assert n == param_count(j_build_model(j_get_arch(arch))
                                .param_specs()), arch
        assert lo < n < hi, f"{arch}: {n / 1e9:.2f}B params"
        router = params.layers[0].ffn.router
        assert router.dtype == torch.float32 and router.is_meta


def test_bf16_interop_keeps_the_router_float32(moe_pair):
    """A bf16 reference tree (the router float32, every other leaf
    bfloat16, as the reference's specs declare them) loads with the
    router still float32 and bit-equal."""
    jcfg = j_reduced_config(moe_pair[3].name, num_layers=2, d_model=D)
    cfg = reduced_config(moe_pair[3].name, num_layers=2, d_model=D)
    specs = jax.tree.map(lambda s: s.dtype,
                         j_build_model(jcfg).abstract_params())
    tree = jax.tree.map(lambda a, dt: np.asarray(jnp.asarray(a, dt)),
                        moe_pair[2], specs)
    params = params_from_numpy(tree, cfg, device="cpu")
    ffn, jffn = params.layers[1].ffn, tree["groups"][0][0]["ffn"]
    assert jffn["router"].dtype == np.float32
    assert ffn.router.dtype == torch.float32
    np.testing.assert_array_equal(ffn.router.numpy(), jffn["router"][1])
    assert ffn.wi_gate.dtype == torch.bfloat16
    np.testing.assert_array_equal(ffn.wo.float().numpy(),
                                  jffn["wo"][1].astype(np.float32))


def test_unported_families_name_themselves():
    """Every family of the reference is ported, so the check names a
    family no config has, and lists the ported ones and none left."""
    other = ModelConfig(name="x", family="rwkv", num_layers=1,
                        d_model=32, num_heads=4, num_kv_heads=4, d_ff=32,
                        vocab_size=64)
    for fn in (lambda: reduced_config(other),
               lambda: build_model(other, device="cpu")):
        with pytest.raises(ValueError, match="'rwkv' family is not "
                                             "ported yet .*ported: dense, "
                                             "moe, mla, vlm, encdec, "
                                             "hybrid, ssm; not yet: none"):
            fn()
    model = build_model(reduced_config("granite-moe-3b-a800m"),
                        device="cpu")
    assert model.supports_speculation and model.supports_prefix_sharing


# ---------------------------------------------------------------------------
# engines: the reduced configs through both packages, float32
# ---------------------------------------------------------------------------

PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3, 4, 1, 2, 3],
           [9, 9, 8, 9, 9, 8, 9, 9, 8, 9, 9, 8], [2, 4, 6, 8, 2, 4, 6]]
SHARED = [(3 * j) % 40 + 11 for j in range(16)]
# every mode in four runs an arch: (ServeConfig fields, shared prefix,
# ngram speculation)
CASES = {
    "fused_dense": (dict(prefill_mode="fused"), False, False),
    "loop_paged_int8": (dict(prefill_mode="loop", cache_layout="paged",
                             cache_page_size=16, kv_quant="int8"), False,
                        False),
    "share_prefix_ngram": (dict(cache_layout="paged", cache_page_size=4,
                                share_prefix=True), True, True),
    "ngram_int8": (dict(kv_quant="int8"), False, True),
}


@pytest.fixture(scope="module", params=ARCHS)
def moe_pair(request):
    jcfg, cfg = _cfgs(request.param)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jax.jit(jmodel.init_params)(jax.random.PRNGKey(1)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


@pytest.mark.parametrize("case", list(CASES))
def test_reduced_moe_engines_serve_the_jax_streams(moe_pair, case):
    """4 requests over 2 slots (refills), greedy, float32 cache (int8's
    own): the JAX engine's token streams, finish reasons and plan
    launches by key, with no policy evaluation inside a launch.  The
    verify rows route as one group per slot of k + 1 tokens, whose
    capacity (3 at k = 4) can drop assignments, as in the reference."""
    jcfg, jmodel, jparams, cfg, model, params = moe_pair
    scfg_kw, shared, spec = CASES[case]
    scfg_kw = dict({"kv_cache_dtype": "float32"}, **scfg_kw)
    prompts = [SHARED + p for p in PROMPTS] if shared else PROMPTS
    max_new = 12 if spec else 6
    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, **scfg_kw),
                          max_len=64, batch_slots=2,
                          sampler=JGreedySampler())
    jeng.load(jparams)
    ops.reset_policy_eval_count()
    eng = ServingEngine(model, ServeConfig(model=cfg, **scfg_kw),
                        max_len=64, batch_slots=2, sampler=GreedySampler(),
                        device="cpu")
    eng.load(params)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(i, p, max_new_tokens=max_new,
                             sampling=JSamplingParams(speculation=JSpecConfig(
                                 method="ngram", k=4) if spec else None)))
        eng.submit(Request(i, p, max_new_tokens=max_new,
                           sampling=SamplingParams(speculation=SpecConfig(
                               method="ngram", k=4) if spec else None)))
    jdone, done = jeng.drain(), eng.drain()
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert [c.finish_reason for c in done] == \
        [c.finish_reason for c in jdone]
    assert eng.stats.launches == {
        (k if isinstance(k, int) else tuple(k)): v
        for k, v in jeng.stats.launches.items()}
    assert ops.policy_eval_count() == 0
    if spec:
        assert eng.stats.spec_steps == jeng.stats.spec_steps > 0
        assert eng.stats.spec_accepted == jeng.stats.spec_accepted
    if shared:
        assert eng.cache_stats()["prefix_hits"] == \
            jeng.cache_stats()["prefix_hits"] > 0
    if eng.cache.is_paged:
        eng.cache.check_conservation()

"""The port's ssm family (mamba2-780m) against the reference's, on the CPU.

The configs and the layer plan; ``ssd_chunked`` with and without an
initial state; the SSD block's train path (with the decode cache it
emits) and decode steps on seeded weights whose conv taps are not
symmetric; the chunked prefill's final state against the token-by-token
recurrence; ``params_from_numpy`` and ``cache_from_numpy`` on the
reference's trees; ``Model.prefill`` then decode steps; reduced
mamba2-780m served by both engines at 1 and 2 slots; and the family's
predicates and refusals.  Everything runs in float32, as the reference's
tests run this family.  Component outputs agree within 1e-4 (one f32
sum order against another); model logits within 4e-2 of the largest,
the reference's ``ssm`` tolerance (``tests/test_models.py``).
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
from repro.models import lm as jlm
from repro.models import ssd as jssd
from repro.models.common import param_count
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_arch
from repro_torch.configs.base import PORTED_FAMILIES, UNPORTED_FAMILIES, \
    ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import build_model, lm, ssd
from repro_torch.serving import GreedySampler, Request, ServingEngine

ARCH = "mamba2-780m"
D = 32
SSM_TOL = 4e-2             # tests/test_models.py's TOL["ssm"]
F32 = dict(dtype="float32", param_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)


def test_configs_and_layer_plan_match_reference():
    """Full and reduced configs field for field (the reduced one at
    ``num_layers=2, d_model=32``: 4 SSD heads of 16, state 16, chunk 32);
    ``layer_kinds`` / ``layer_groups`` as the reference's; the family is
    ported and no family is left unported; the full model's parameter
    count on the meta device is the reference's: 857,379,072, of which
    the untied 50,280-row embedding and unembedding are 154 M."""
    assert "ssm" in PORTED_FAMILIES and UNPORTED_FAMILIES == ()
    for cfg, jcfg in ((get_arch(ARCH), j_get_arch(ARCH)),
                      (reduced_config(ARCH, d_model=D),
                       j_reduced_config(ARCH, d_model=D))):
        assert cfg.family == jcfg.family == "ssm"
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "norm_eps", "max_seq_len"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert vars(cfg.ssm) == vars(jcfg.ssm)
        assert lm.layer_kinds(cfg) == jlm.layer_kinds(jcfg)
        assert lm.layer_groups(cfg) == jlm.layer_groups(jcfg)
    params = lm.LM(get_arch(ARCH), torch.device("meta"))
    n = sum(p.numel() for p in params.parameters())
    assert n == param_count(j_build_model(j_get_arch(ARCH)).param_specs())
    assert n == 857_379_072, n
    block = params.layers[0]
    assert not hasattr(block, "ffn") and not hasattr(block, "ln2")
    assert block.mix.in_proj.shape == (1536, 2 * 3072 + 2 * 128 + 48)


def _ssd_inputs(rng, L, B=2, H=4, P=16, G=1, N=16):
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(
        np.float32) * 0.5
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("L,init", [(32, False), (64, False), (96, True)])
def test_ssd_chunked_matches_reference(L, init):
    """``ssd_chunked`` over 1, 2 and 3 chunks of 32 (the carry over the
    chunks is used from 2 on), with and without an initial state: y and
    the final state within 1e-4 of the reference's."""
    rng = np.random.default_rng(L)
    args = _ssd_inputs(rng, L)
    s0 = (rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
          if init else None)
    jy, js = jssd.ssd_chunked(*map(jnp.asarray, args), chunk=32,
                              init_state=None if s0 is None
                              else jnp.asarray(s0))
    y, s = ssd.ssd_chunked(*map(torch.from_numpy, args), chunk=32,
                           init_state=None if s0 is None
                           else torch.from_numpy(s0))
    assert y.dtype == torch.float32 and s.shape == (2, 4, 16, 16)
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(y.numpy() / scale, np.asarray(jy) / scale,
                               **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def _block(cfg, rng):
    """An SSD block with seeded float32 weights; the conv taps, biases,
    A_log, D and dt_bias away from their init so each counts, and the
    taps' rows distinct so a flipped tap order shows."""
    n = rng.standard_normal
    w = {}
    for name, spec in ssd.ssd_specs(cfg).items():
        w[name] = (n(spec.shape) * spec.std).astype(np.float32)
    w["conv_b"] = (n(w["conv_b"].shape) * 0.1).astype(np.float32)
    w["A_log"] = (n(w["A_log"].shape) * 0.3).astype(np.float32)
    w["D"] = (1 + n(w["D"].shape) * 0.3).astype(np.float32)
    w["dt_bias"] = (n(w["dt_bias"].shape) * 0.3).astype(np.float32)
    w["norm"] = (1 + n(w["norm"].shape) * 0.1).astype(np.float32)
    assert not np.allclose(w["conv_w"], w["conv_w"][::-1])
    block = ssd.SSD(cfg, torch.float32, torch.device("cpu"))
    block.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    return block, {k: jnp.asarray(v) for k, v in w.items()}


@pytest.mark.parametrize("length", [2, 40])
def test_ssd_block_train_and_decode_match_reference(length):
    """``apply_ssd_train`` with its decode cache (L below the conv tail,
    and past one 32-row chunk), then 4 ``apply_ssd_decode`` steps from
    that cache, in float32, against the reference's: outputs, ``state``
    and ``conv`` within 1e-4."""
    cfg = reduced_config(ARCH, d_model=D).replace(**F32)
    jcfg = j_reduced_config(ARCH, d_model=D).replace(**F32)
    rng = np.random.default_rng(length)
    block, jw = _block(cfg, rng)
    x = rng.standard_normal((2, length + 4, D)).astype(np.float32)
    jout, jcache = jssd.apply_ssd_train(jw, jcfg, jnp.asarray(x[:, :length]),
                                        return_cache=True)
    out, cache = ssd.apply_ssd_train(block, cfg,
                                     torch.from_numpy(x[:, :length]),
                                     return_cache=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name in ("state", "conv"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    for i in range(length, length + 4):
        jo, jcache = jssd.apply_ssd_decode(jw, jcfg,
                                           jnp.asarray(x[:, i:i + 1]), jcache)
        o = ssd.apply_ssd_decode(block, cfg, torch.from_numpy(x[:, i:i + 1]),
                                 cache)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)


def test_chunked_scan_and_prefill_equal_the_recurrence():
    """Over 96 rows (three 32-row chunks), ``ssd_chunked``'s y and final
    state equal the row-by-row recurrence (``ssd_recurrent``) run in
    float64, within 1e-4 relative; a scan started from a state
    (``init_state``) continues the scan that produced it; and over 70
    rows the block's chunked prefill (output and decode cache) equals 70
    ``apply_ssd_decode`` steps from a zero cache."""
    args = [torch.from_numpy(a) for a in
            _ssd_inputs(np.random.default_rng(8), 96)]
    y, s = ssd.ssd_chunked(*args, chunk=32)
    y64, s64 = ssd.ssd_recurrent(*(a.double() for a in args))
    assert y64.dtype == s64.dtype == torch.float64
    scale = y64.abs().max()
    torch.testing.assert_close(y.double() / scale, y64 / scale, **TOL)
    torch.testing.assert_close(s.double() / s64.abs().max(),
                               s64 / s64.abs().max(), **TOL)
    _, s_mid = ssd.ssd_chunked(*(a[:, :64] for a in args[:2]), args[2],
                               *(a[:, :64] for a in args[3:]), chunk=32)
    y2, s2 = ssd.ssd_chunked(*(a[:, 64:] for a in args[:2]), args[2],
                             *(a[:, 64:] for a in args[3:]), chunk=32,
                             init_state=s_mid)
    torch.testing.assert_close(y2, y[:, 64:], **TOL)
    torch.testing.assert_close(s2, s, **TOL)

    cfg = reduced_config(ARCH, d_model=D).replace(**F32)
    rng = np.random.default_rng(7)
    block, _ = _block(cfg, rng)
    x = torch.from_numpy(rng.standard_normal((2, 70, D)).astype(np.float32))
    out, cache = ssd.apply_ssd_train(block, cfg, x, return_cache=True)
    rec = ssd.init_ssd_cache(cfg, 2, torch.float32)
    want = torch.cat([ssd.apply_ssd_decode(block, cfg, x[:, i:i + 1], rec)
                      for i in range(70)], dim=1)
    torch.testing.assert_close(out, want, **TOL)
    for name in ("state", "conv"):
        torch.testing.assert_close(cache[name], rec[name], **TOL)


def _pair():
    jcfg = j_reduced_config(ARCH, d_model=D).replace(**F32)
    cfg = reduced_config(ARCH, d_model=D).replace(**F32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype("float32"),
                           jax.jit(jmodel.init_params)(
                               jax.random.PRNGKey(3)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def ssm_pair():
    return _pair()


def test_params_and_caches_from_numpy(ssm_pair):
    """The reference's tree lands leaf for leaf (``ln1`` and the SSD
    ``mix`` a layer, no ``ln2`` / ``ffn``), bit for bit; ``cache_from_
    numpy`` of the reference's prefill cache is the port's prefill cache
    (``state`` (layers, B, H, P, N) f32, ``conv`` (layers, B, 3, 96))."""
    jcfg, jmodel, jparams, cfg, model, params = ssm_pair
    tree = jax.tree.map(np.asarray, jparams)
    mix = tree["groups"][0][0]["mix"]
    assert sorted(mix) == sorted(ssd.ssd_specs(cfg))
    assert set(tree["groups"][0][0]) == {"ln1", "mix"}
    for li in range(cfg.num_layers):
        layer = params.layers[li]
        for name in mix:
            np.testing.assert_array_equal(
                getattr(layer.mix, name).numpy(), mix[name][li])
        np.testing.assert_array_equal(
            layer.ln1.scale.numpy(), tree["groups"][0][0]["ln1"]["scale"][li])
    tokens = np.random.default_rng(0).integers(0, 256, (2, 40)).astype(
        np.int32)
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, 64)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(
        tokens).long()}, 64)
    want = cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg,
                            device="cpu")
    assert sorted(want) == sorted(cache) == ["conv", "state"]
    assert cache["state"].shape == (2, 2, 4, 16, 16)
    assert cache["conv"].shape == (2, 2, 3, 96)
    for name in cache:
        assert cache[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(cache[name].numpy(), want[name].numpy(),
                                   **TOL)


@pytest.mark.parametrize("length", [20, 70])
def test_prefill_then_decode_matches_reference(ssm_pair, length):
    """``Model.prefill`` of ``length`` tokens at B 2 (one chunk; three),
    then 8 decode steps teacher-forced on the reference's argmax tokens:
    every step's logits within 4e-2 of the reference's largest (and in
    fact within 1e-4)."""
    jcfg, jmodel, jparams, cfg, model, params = ssm_pair
    rng = np.random.default_rng(length)
    tokens = rng.integers(0, cfg.vocab_size, (2, length)).astype(np.int32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  96)
    log, cache = model.prefill(
        params, {"tokens": torch.from_numpy(tokens).long()}, 96)
    jdec = jax.jit(jmodel.decode_step)
    for i in range(9):
        scale = float(jnp.max(jnp.abs(jlog))) + 1e-9
        rel = float(np.max(np.abs(log.numpy() - np.asarray(jlog)))) / scale
        assert rel < min(SSM_TOL, 1e-4), (i, rel)
        if i == 8:
            break
        nxt = jnp.argmax(jlog, -1).astype(jnp.int32)
        jlog, jcache = jdec(jparams, jcache, nxt, jnp.int32(length + i))
        log = model.decode_step(params, cache,
                                torch.from_numpy(np.array(nxt)).long(),
                                torch.full((2,), length + i,
                                           dtype=torch.long))


PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3, 4, 1, 2, 3],
           list(range(1, 41)), [2, 4, 6, 8, 2, 4, 6]]


@pytest.mark.parametrize("slots", [1, 2])
def test_reduced_ssm_engines_serve_the_jax_streams(ssm_pair, slots):
    """4 greedy requests (one prompt past a 32-row chunk) at ``slots``
    slots: ``prefill_mode="auto"`` resolves to the loop in both engines,
    which give the same streams, finish reasons and plan launches; no
    kernel launches, no policy evaluation inside a step."""
    jcfg, jmodel, jparams, cfg, model, params = ssm_pair
    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg), max_len=64,
                          batch_slots=slots, sampler=JGreedySampler())
    jeng.load(jparams)
    ops.reset_policy_eval_count()
    ops.reset_launch_counts()
    eng = ServingEngine(model, ServeConfig(model=cfg), max_len=64,
                        batch_slots=slots, sampler=GreedySampler(),
                        device="cpu")
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
    assert ops.policy_eval_count() == 0
    assert sum(ops.launch_counts().values()) == 0
    assert eng.sched.side_plans() == {}
    assert sorted(eng._caches) == ["conv", "state"]


def test_ssm_predicates_and_refusals(ssm_pair):
    """Dense caches and loop admission only, with the reference's
    messages: the paged layout ("not position-linear"), fused prefill,
    prefix sharing and speculation are refused, ``auto`` resolves to the
    loop, and a sequence-sharded shard refuses the family; the CLI
    serves it (reduced, on the CPU)."""
    from repro_torch.launch.serve import run_serving
    jcfg, jmodel, jparams, cfg, model, params = ssm_pair
    for pred in ("supports_paged_cache", "supports_fused_prefill",
                 "supports_prefix_sharing", "supports_speculation",
                 "prefill_writes_full_slot"):
        assert getattr(model, pred) == getattr(jmodel, pred), pred
    assert not (model.supports_paged_cache or model.supports_fused_prefill
                or model.supports_speculation)
    for kw, msg in ((dict(cache_layout="paged"),
                     "ssm caches are not position-linear"),
                    (dict(prefill_mode="fused"), "loop"),
                    (dict(speculation="ngram"),
                     "ssm models cannot run speculative verify steps")):
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
    _, (sub,) = make_engine_mesh(1, 2, [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="ssm models cannot sequence-"
                                         "shard their decode"):
        ServingEngine(model, ServeConfig(model=cfg), max_len=64, mesh=sub)
    done = run_serving(ARCH, num_requests=2, max_new=2, d_model=D,
                       device="cpu", log_fn=lambda line: None)
    assert [len(c.tokens) for c in done] == [2, 2]

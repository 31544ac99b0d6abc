"""Tensor- and expert-parallel serving against the reference, on the CPU.

The port's logical axes (``Model.param_axes`` / ``cache_axes``) leaf by
leaf against the reference's spec trees for all ten archs, mapped
through the name map ``interop.params_from_numpy`` uses; the per-device
slices of ``serve_param_rules`` over grids (1, 2), (1, 3), (1, 4) and (2,
2) against the reference's ``spec_for`` at full width, and
``place_params``' tensors against the slices they stand for; the
tensor-parallel forward (one prefill and one decode step) against the
replicated weights and the JAX single-device model in float32;
``ShardedServingEngine(ShardSpec(sp=2|4, params="tp"))`` streams against
the JAX single-device engine's; expert parallelism (``ep_shard_map``)
where the reference runs it, which drops other tokens than ``gather``
does; and (marked ``multidevice``, one subprocess with forced host
devices) the reference's own EP layer, its sharded MoE engines with a
verify run, and its ``params="tp"`` engines at (1, 2) and (1, 4).
"""
import json
import os
import subprocess
import sys
import textwrap
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.models import build_model as j_build_model
from repro.models.common import is_spec as j_is_spec
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.sharding import rules as jrules
from repro_torch import interop
from repro_torch.configs.base import ServeConfig, get_arch
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.models import build_model
from repro_torch.models.common import TPModule, apply_mlp
from repro_torch.models.moe import apply_moe, ep_applies
from repro_torch.serving import GreedySampler, Request, ServingEngine
from repro_torch.shard import ShardSpec, ShardedServingEngine, \
    clear_shard_plan_caches
from repro_torch.sharding import activation_mesh, device_coords, \
    local_slices
from repro_torch.sharding.place import device_param_bytes, param_specs, \
    place_params

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = ["qwen2.5-3b", "codeqwen1.5-7b", "stablelm-12b",
         "granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "minicpm3-4b",
         "paligemma-3b", "whisper-large-v3", "recurrentgemma-9b",
         "mamba2-780m"]
GRIDS = [(1, 2), (1, 3), (1, 4), (2, 2)]


@pytest.fixture(autouse=True)
def _fresh_registry():
    clear_shard_plan_caches()
    yield
    clear_shard_plan_caches()


def _grid(n, dp=1):
    return make_engine_mesh(dp, n, [CPU] * (dp * n))[0]


# ---------------------------------------------------------------------------
# logical axes
# ---------------------------------------------------------------------------


def _per_layer(specs):
    """The reference's spec tree with every leaf its axes, a layer stack's
    (``layers`` first) an object array of each layer's remaining axes, so
    the interop name map unstacks it as it unstacks weights."""
    def conv(s):
        if s.axes and s.axes[0] == "layers":
            a = np.empty(s.shape[0], dtype=object)
            for i in range(s.shape[0]):
                a[i] = s.axes[1:]
            return a
        return s.axes
    return jax.tree_util.tree_map(conv, specs, is_leaf=j_is_spec)


def _ref_param_axes(jmodel, cfg):
    tree = _per_layer(jmodel.param_specs())
    stacks = ("enc_layers", "dec_layers") if cfg.family == "encdec" \
        else ("groups",)
    out = dict(interop._flatten({k: v for k, v in tree.items()
                                 if k not in stacks}))
    if cfg.family == "encdec":
        for stack, n in (("enc_layers", cfg.num_encoder_layers),
                         ("dec_layers", cfg.num_layers)):
            for li, name, a in interop._unstack(tree[stack], n, stack):
                out[f"{stack}.{li}.{name}"] = a
    else:
        for li, name, a in interop._grouped_layers(tree["groups"], cfg):
            out[f"layers.{li}.{name}"] = a
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_references(arch):
    """Every parameter's logical axes, by the port's name, are the
    reference's (a layer stack's without its ``layers`` axis); the names
    cover the weights' state dict."""
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    model = build_model(cfg, device="cpu")
    got = model.param_axes()
    want = _ref_param_axes(j_build_model(jcfg), cfg)
    assert got == want
    assert set(got) == set(_meta_module(model).state_dict())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_cache_axes_equal_the_references(arch, kv):
    """Every cache leaf's axes (the layer stack first) are the
    reference's for each layer that holds it."""
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    model = build_model(cfg, device="cpu")
    got = model.cache_axes(2, 64, kv)
    assert set(got) == set(model.cache_shapes(2, 64, kv))
    jmodel = j_build_model(jcfg)
    tree = _per_layer(jmodel.cache_specs(2, 64, kv))
    if cfg.family == "encdec":
        rows = [(li, ("cross_" if part == "cross" else "") + name, a)
                for part in ("self", "cross")
                for li, name, a in interop._unstack(tree[part],
                                                    cfg.num_layers, part)]
    else:
        rows = list(interop._grouped_layers(tree, cfg))
    assert {name for _, name, _ in rows} == set(got)
    for _, name, axes in rows:
        assert got[name] == ("layers",) + axes, name


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _shard_len(n, entry, grid):
    axes = () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)
    parts = int(np.prod([grid[a] for a in axes])) if axes else 1
    return n // parts


@pytest.mark.parametrize("grid", GRIDS)
def test_slices_equal_the_references_spec_for(grid):
    """At full width, every parameter's spec under ``serve_param_rules``
    over the grid is the reference's ``spec_for``, and every device's
    slice of it has the reference's shard length on every dim and tiles
    the dim with the other devices'."""
    dp, sp = grid
    mesh = _grid(sp, dp)
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": dp, "model": sp})
    for arch in ARCHS:
        model = build_model(get_arch(arch), device="cpu")
        axes = model.param_axes()
        shapes = {name: tuple(t.shape) for name, t in
                  _meta_module(model).state_dict().items()}
        specs = param_specs(_meta_module(model), mesh)
        for name, shape in shapes.items():
            want = tuple(jrules.spec_for(shape, axes[name],
                                         jrules.serve_param_rules(), fake))
            assert specs[name] == want, (arch, name)
            starts = [set() for _ in shape]
            for i in range(dp * sp):
                sl = local_slices(shape, specs[name], mesh,
                                  device_coords(mesh, i))
                entries = tuple(want) + (None,) * (len(shape) - len(want))
                for dim, ((lo, ln), e) in enumerate(zip(sl, entries)):
                    assert ln == _shard_len(shape[dim], e, fake.shape)
                    starts[dim].add(lo)
            for dim, n in enumerate(shape):
                ln = local_slices(shape, specs[name], mesh,
                                  device_coords(mesh, 0))[dim][1]
                assert sorted(starts[dim]) == list(range(0, n, ln))


def _meta_module(model):
    from repro_torch.models import encdec, lm
    cls = encdec.EncDec if model.cfg.family == "encdec" else lm.LM
    return cls(model.cfg, torch.device("meta"))


def test_full_width_examples():
    """qwen2.5-3b at model 2: 8 query heads, 1 KV head, ff 5504 and vocab
    75968 a device; granite-moe-3b-a800m at model 4: 10 experts a device,
    ff whole inside an expert, vocab 49155 replicated."""
    q = build_model(get_arch("qwen2.5-3b"), device="cpu")
    s = param_specs(_meta_module(q), _grid(2))
    assert s["layers.0.mix.wq"] == (None, "model")
    assert s["layers.0.mix.wk"] == (None, "model")
    assert s["layers.0.ffn.wi_gate"] == (None, "model")
    assert s["embed.tok"] == ("model",)
    g = build_model(get_arch("granite-moe-3b-a800m"), device="cpu")
    s = param_specs(_meta_module(g), _grid(4))
    assert s["layers.0.ffn.wi_gate"] == (("data", "model"),)
    assert s["layers.0.ffn.router"] == (None, ("data", "model"))
    assert s["embed.tok"] == ()


def placed_shapes(placed, names):
    """Each device's shape of every parameter in ``names`` (dotted, as
    ``state_dict`` keys) in a placed tree."""
    out = [{} for _ in placed.devices]
    for name in names:
        *path, leaf = name.split(".")
        node = placed
        for part in path:
            node = node[int(part)] if isinstance(node, list) else \
                node.children[part]
        for s, mod in enumerate(node.mods):
            out[s][name] = tuple(getattr(mod, leaf).shape)
    return out


@pytest.fixture(scope="module")
def granite():
    return _pair("granite-moe-3b-a800m")


def test_place_params_holds_each_devices_slice(granite):
    """Each device of a (1, 4) grid holds its contiguous slice of every
    cut parameter (the experts 2 a device, the router's columns) and the
    whole of every other; a cut weight read whole raises; the byte
    counts add the slices once and the whole ones on every device."""
    params = granite[5]
    tp = place_params(params, _grid(4))
    assert isinstance(tp, TPModule) and len(tp.layers) == 2
    ffn = tp.layers[1].ffn
    for s, mod in enumerate(ffn.mods):
        assert mod.wi_gate.is_contiguous()
        torch.testing.assert_close(
            mod.wi_gate, params.layers[1].ffn.wi_gate[2 * s:2 * s + 2],
            rtol=0, atol=0)
        torch.testing.assert_close(
            mod.router, params.layers[1].ffn.router[:, 2 * s:2 * s + 2],
            rtol=0, atol=0)
    torch.testing.assert_close(ffn.whole("router"),
                               params.layers[1].ffn.router, rtol=0, atol=0)
    assert tp.layers[0].ln1.scale is tp.layers[0].ln1.mods[0].scale
    with pytest.raises(AttributeError, match="cut over the model axis"):
        ffn.wi_gate
    shapes = placed_shapes(tp, ["layers.0.mix.wq", "embed.tok"])
    assert shapes[3]["layers.0.mix.wq"] == (64, 1, 16)
    total = sum(t.numel() * t.element_size() for t in params.parameters())
    per_dev = device_param_bytes(tp)
    assert len(per_dev) == 4 and all(b < total for b in per_dev)
    assert place_params(params, _grid(1)) is params


@pytest.mark.parametrize("sp", [2, 4])
def test_tp_gelu_mlp_adds_its_output_bias_once(sp):
    """Whisper's GeluMLP placed over a (1, sp) grid: ``wi``, ``bi`` and
    ``wo`` are cut on ``ff`` and ``bo`` is whole on every device; the
    tensor-parallel MLP gives the replicated weights' output, its bias
    added once (random biases: the init's zeros would hide a repeat)."""
    cfg = reduced_config("whisper-large-v3").replace(**F32)
    params = build_model(cfg, device="cpu").init_params(0)
    gen = torch.Generator().manual_seed(5)
    for block in (params.enc_layers[0], params.dec_layers[0]):
        with torch.no_grad():
            for name in ("bi", "bo"):
                b = getattr(block.ffn, name)
                b.copy_(torch.randn(b.shape, generator=gen))
    tp = place_params(params, _grid(sp))
    x = torch.randn(2, 5, cfg.d_model, generator=gen)
    for block, placed in ((params.enc_layers[0], tp.enc_layers[0]),
                          (params.dec_layers[0], tp.dec_layers[0])):
        ffn = placed.ffn
        assert ffn.dims == {"wi": 1, "bi": 0, "wo": 0, "bo": None}
        want = apply_mlp(block.ffn, x, "gelu")
        torch.testing.assert_close(apply_mlp(ffn, x, "gelu"), want,
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the tensor-parallel forward
# ---------------------------------------------------------------------------


def _pair(arch, d_model=64):
    jcfg = j_reduced_config(arch, d_model=d_model).replace(**F32)
    cfg = reduced_config(arch, d_model=d_model).replace(**F32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype("float32"),
                           jax.jit(jmodel.init_params)(
                               jax.random.PRNGKey(0)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


TP_ARCHS = ["qwen2.5-3b", "granite-moe-3b-a800m", "minicpm3-4b"]


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_prefill_and_decode_logits(arch):
    """One prefill of (2, 16) tokens and one decode step with the weights
    tensor-parallel over 2 and 4 devices give the replicated weights'
    logits and the JAX single-device model's within 1e-5 relative (f32),
    and the replicated caches."""
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch)
    toks = np.random.default_rng(3).integers(1, 250, (2, 16))
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                            32, kv_dtype="float32")
    want, wc = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 32,
                             kv_dtype="float32")
    prefilled = {name: c.clone() for name, c in wc.items()}
    nxt = want.argmax(-1)
    pos = torch.full((2,), 16, dtype=torch.int64)
    jd, _ = jmodel.decode_step(jparams, jc, jnp.asarray(nxt.numpy(),
                                                        jnp.int32),
                               jnp.asarray(pos.numpy(), jnp.int32))
    wd = model.decode_step(params, wc, nxt, pos)
    tol = dict(rtol=1e-5, atol=1e-5)
    # across frameworks, logits near zero differ by up to 7e-5 absolute;
    # MLA's JAX prefill emits its latent cache in f32 where both engines
    # hold bf16, so its decode step is held to the replicated weights'
    jtol = dict(rtol=1e-5, atol=1e-4)
    jax_decode = cfg.family != "mla"
    np.testing.assert_allclose(want.numpy(), np.asarray(jl), **jtol)
    if jax_decode:
        np.testing.assert_allclose(wd.numpy(), np.asarray(jd), **jtol)
    for sp in (2, 4):
        tp = place_params(params, _grid(sp))
        got, gc = model.prefill(tp, {"tokens": torch.from_numpy(toks)}, 32,
                                kv_dtype="float32")
        torch.testing.assert_close(got, want, **tol)
        for name in wc:
            torch.testing.assert_close(gc[name], prefilled[name], **tol)
        gd = model.decode_step(tp, gc, nxt, pos)
        torch.testing.assert_close(gd, wd, **tol)
        if jax_decode:
            np.testing.assert_allclose(gd.numpy(), np.asarray(jd), **jtol)


def _reqs(n, seed=0, max_new=6, lo=2, hi=8):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, 250, size=int(rng.integers(lo, hi))
                             ).tolist(), max_new) for i in range(n)]


def _jax_streams(pair, reqs, *, slots, max_len, **scfg_kw):
    jcfg, jmodel, jparams = pair[:3]
    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, **scfg_kw),
                          max_len=max_len, batch_slots=slots,
                          sampler=JGreedySampler())
    jeng.load(jparams)
    for i, p, n in reqs:
        jeng.submit(JRequest(i, list(p), max_new_tokens=n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {c.request_id: (c.tokens, c.finish_reason)
                for c in jeng.drain()}


def _sharded(pair, spec, *, max_len, **scfg_kw):
    cfg, model, params = pair[3:]
    eng = ShardedServingEngine(model, ServeConfig(model=cfg, **scfg_kw),
                               spec=spec, max_len=max_len,
                               sampler=GreedySampler(),
                               devices=[CPU] * spec.num_devices)
    eng.load(params)
    return eng


def _drain(eng, reqs):
    for i, p, n in reqs:
        eng.submit(Request(i, list(p), max_new_tokens=n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {c.request_id: (c.tokens, c.finish_reason)
                for c in eng.drain()}


@pytest.mark.parametrize("arch,kw", [
    ("qwen2.5-3b", {}),
    ("qwen2.5-3b", dict(cache_layout="paged", cache_page_size=16,
                        seqlen_bucket=64)),
    ("qwen2.5-3b", dict(kv_quant="int8")),
    ("granite-moe-3b-a800m", {}),
    ("minicpm3-4b", {}),
])
def test_tp_sharded_engine_streams_equal_the_jax_engine(arch, kw):
    """``ShardedServingEngine(ShardSpec(sp=2|4, params="tp"))`` serves the
    JAX single-device engine's streams (dense, paged, int8; the moe and
    mla families), its shard's weights a TPModule over its grid."""
    pair = _pair(arch, d_model=32)
    reqs = _reqs(3, seed=1, lo=6, hi=20)
    want = _jax_streams(pair, reqs, slots=2, max_len=128, **kw)
    for sp in (2, 4):
        eng = _sharded(pair, ShardSpec(sp=sp, slots_per_shard=2,
                                       params="tp"), max_len=128, **kw)
        assert isinstance(eng.cores[0]._params, TPModule)
        assert _drain(eng, reqs) == want, sp


def test_tp_engine_on_one_device_keeps_the_module():
    """``param_policy="tp"`` on a model axis of 1 changes nothing, and a
    ServingEngine without a grid ignores it, as the reference's does."""
    pair = _pair("qwen2.5-3b", d_model=32)
    cfg, model, params = pair[3:]
    eng = ServingEngine(model, ServeConfig(model=cfg), device="cpu",
                        param_policy="tp")
    eng.load(params)
    assert eng._params is params
    sh = _sharded(pair, ShardSpec(dp=2, sp=1, slots_per_shard=2,
                                  params="tp"), max_len=64)
    assert sh.cores[1]._params is params


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def _ep_input(cfg, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32)


def test_ep_runs_where_the_reference_does(granite):
    """``ep_shard_map`` runs expert parallelism under a bound grid whose
    model axis is above 1 and divides L, else gather; under a (1, 2) and
    a (1, 4) grid at L 16 it drops other tokens than gather does (2 of
    16 rows differ on this input), with the replicated experts and with
    the experts placed 4 and 2 a device."""
    cfg, params = granite[3], granite[5]
    ffn = params.layers[0].ffn
    x = torch.from_numpy(_ep_input(cfg))
    gather = apply_moe(ffn, cfg, x, dispatch="gather")
    torch.testing.assert_close(
        apply_moe(ffn, cfg, x, dispatch="ep_shard_map"), gather,
        rtol=0, atol=0)
    for n in (2, 4):
        grid = _grid(n)
        with activation_mesh(grid):
            assert ep_applies(x) and not ep_applies(x[:, :n - 1])
            ep = apply_moe(ffn, cfg, x, dispatch="ep_shard_map")
            tp = place_params(params, grid).layers[0].ffn
            ep_tp = apply_moe(tp, cfg, x, dispatch="ep_shard_map")
            dec = apply_moe(tp, cfg, x[:, :1], dispatch="ep_shard_map")
        rows = int(((ep - gather).abs().amax(-1) > 1e-5).sum())
        assert rows == 2, n
        torch.testing.assert_close(ep_tp, ep, rtol=1e-6, atol=1e-6)
        # decode's L 1: gather with the experts on their devices
        torch.testing.assert_close(
            dec, apply_moe(ffn, cfg, x[:, :1], dispatch="gather"),
            rtol=0, atol=0)
    with activation_mesh(_grid(3)):
        assert not ep_applies(x)


def test_ep_over_a_grid_with_data_rows(granite):
    """Over a (2, 2) grid the batch rides the data rows, each row its own
    expert parallelism over its batch rows, as the reference's
    ``shard_map`` cuts B over the data axis."""
    cfg, params = granite[3], granite[5]
    ffn = params.layers[0].ffn
    x = torch.from_numpy(np.concatenate([_ep_input(cfg, 4),
                                         _ep_input(cfg, 5)]))
    with activation_mesh(_grid(2, dp=2)):
        both = apply_moe(ffn, cfg, x, dispatch="ep_shard_map")
    with activation_mesh(_grid(2)):
        one = torch.cat([apply_moe(ffn, cfg, x[i:i + 1],
                                   dispatch="ep_shard_map")
                         for i in range(2)])
    torch.testing.assert_close(both, one, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the reference, with forced host devices
# ---------------------------------------------------------------------------


_REFERENCE = """
    import json, warnings
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import ServeConfig
    from repro.configs.reduced import reduced_config
    from repro.launch.mesh import make_engine_mesh
    from repro.models import build_model
    from repro.models.moe import apply_moe
    from repro.serving import GreedySampler, Request
    from repro.shard import ShardSpec, ShardedServingEngine
    from repro.sharding.ctx import activation_mesh
    warnings.simplefilter("ignore")
    ARGS = json.loads(ARGS_JSON)
    out = {}

    def engine(model, cfg, params, reqs, spec, max_len, **kw):
        eng = ShardedServingEngine(model, ServeConfig(model=cfg, **kw),
                                   spec=spec, max_len=max_len,
                                   sampler=GreedySampler())
        eng.load(params)
        for i, p, n in reqs:
            eng.submit(Request(i, p, max_new_tokens=n))
        done = eng.drain()
        return eng, {str(c.request_id): [c.tokens, c.finish_reason]
                     for c in done}

    def pair(arch, d_model):
        cfg = reduced_config(arch, d_model=d_model).replace(
            dtype="float32", param_dtype="float32")
        model = build_model(cfg)
        params = jax.tree.map(lambda a: a.astype("float32"),
                              jax.jit(model.init_params)(
                                  jax.random.PRNGKey(0)))
        return cfg, model, params

    # the EP layer at L 16
    cfg, model, params = pair("granite-moe-3b-a800m", 64)
    ffn = jax.tree.map(lambda a: a[0], params["groups"][0][0]["ffn"])
    x = jnp.asarray(np.asarray(ARGS["ep_x"], np.float32))
    for n in (2, 4):
        sub = make_engine_mesh(1, n)[1][0]
        with activation_mesh(sub):
            ep, _ = apply_moe(ffn, cfg, x, dispatch="ep_shard_map")
        out[f"ep{n}"] = np.asarray(ep).tolist()

    # sharded MoE engines: fused admission at bucket 16, a verify run at k 3
    for name, sp, kw in (("moe2", 2, {}), ("moe4", 4, {}),
                         ("spec2", 2, dict(speculation="ngram",
                                           speculation_k=3))):
        _, out[name] = engine(model, cfg, params, ARGS["moe_reqs"],
                              ShardSpec(sp=sp, slots_per_shard=2),
                              64, prefill_bucket=16, **kw)

    # params="tp" engines: routes, streams, each leaf's shard shape
    cfg, model, params = pair("qwen2.5-3b", 32)
    for sp in (2, 4):
        eng, streams = engine(model, cfg, params, ARGS["tp_reqs"],
                              ShardSpec(sp=sp, slots_per_shard=2,
                                        params="tp"), 128)
        out[f"tp{sp}"] = {
            "routes": [eng.routed(0)], "streams": streams,
            "shards": jax.tree.map(
                lambda a: list(a.sharding.shard_shape(a.shape)),
                eng.cores[0]._params)}
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(granite):
    cfg = granite[3]
    args = {"ep_x": _ep_input(cfg).tolist(),
            "moe_reqs": _moe_reqs(), "tp_reqs": _reqs(3, seed=1, lo=6,
                                                       hi=20)}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = f"ARGS_JSON = {json.dumps(json.dumps(args))}\n" + \
        textwrap.dedent(_REFERENCE)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _moe_reqs():
    """Prompts on which the reference's sharded engine at sp 2 and 4
    gives other streams than its single-device engine (expert
    parallelism drops other tokens at admission), plus two repetitive
    ones whose n-gram drafts make verify steps."""
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(1, 250, size=int(rng.integers(13, 17))
                             ).tolist(), 8) for i in range(3)]
    return reqs + [(3, [7, 8, 9, 10] * 3, 8), (4, [3, 4] * 6, 8)]


@pytest.mark.multidevice
def test_ep_layer_equals_the_references(granite, reference):
    """The port's ``ep_shard_map`` under a (1, 2) and a (1, 4) grid equals
    the reference's EP output at L 16 within 1e-5, including the rows
    where EP and gather differ."""
    cfg, params = granite[3], granite[5]
    ffn = params.layers[0].ffn
    x = torch.from_numpy(_ep_input(cfg))
    gather = apply_moe(ffn, cfg, x, dispatch="gather")
    for n in (2, 4):
        want = np.asarray(reference[f"ep{n}"], np.float32)
        with activation_mesh(_grid(n)):
            got = apply_moe(ffn, cfg, x, dispatch="ep_shard_map")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        differ = np.abs(want - gather.numpy()).max(-1) > 1e-5
        assert differ.sum() == 2


@pytest.mark.multidevice
def test_sharded_moe_streams_equal_the_references(granite, reference):
    """The port's sharded engines on granite-moe-3b-a800m (reduced) give
    the reference's sharded streams at sp 2 and 4, replicated and
    tensor-parallel, where those differ from its single-device engine's,
    and with ngram speculation at k 3 (verify steps of 4 rows, EP at sp
    2)."""
    reqs = _moe_reqs()
    single = _jax_streams(granite, reqs, slots=2, max_len=64,
                          prefill_bucket=16)
    single = {str(k): [v[0], v[1]] for k, v in single.items()}
    assert reference["moe2"] != single and reference["moe4"] != single
    for name, sp, kw in (("moe2", 2, {}), ("moe4", 4, {}),
                         ("spec2", 2, dict(speculation="ngram",
                                           speculation_k=3))):
        for params in ("replicated", "tp"):
            eng = _sharded(granite, ShardSpec(sp=sp, slots_per_shard=2,
                                              params=params),
                           max_len=64, prefill_bucket=16, **kw)
            got = _drain(eng, reqs)
            assert {str(k): [v[0], v[1]] for k, v in got.items()} == \
                reference[name], (name, params)
            if kw:
                assert eng.cores[0].stats.spec_steps > 0


def _shard_shapes(tree, cfg):
    """The reference's tree of shard shapes (lists) by the port's
    parameter names, through the interop name map: a layer stack's shape
    less its ``layers`` dim for each of its layers."""
    def stacked(node):
        if isinstance(node, dict):
            return {k: stacked(v) for k, v in node.items()}
        if not isinstance(node[0], int):          # a list of stacks
            return [stacked(v) for v in node]
        a = np.empty(node[0], dtype=object)
        for i in range(node[0]):
            a[i] = tuple(node[1:])
        return a
    out = {name: tuple(v) for name, v in interop._flatten(
        {k: v for k, v in tree.items() if k != "groups"})}
    for li, name, a in interop._grouped_layers(stacked(tree["groups"]),
                                               cfg):
        out[f"layers.{li}.{name}"] = a
    return out


@pytest.mark.multidevice
def test_tp_engines_equal_the_references(reference):
    """The reference's ``params="tp"`` engines at (1, 2) and (1, 4): the
    port's give their routes and streams, and each device holds the
    reference's shard shape of every parameter."""
    pair = _pair("qwen2.5-3b", d_model=32)
    reqs = _reqs(3, seed=1, lo=6, hi=20)
    cfg = pair[3]
    for sp in (2, 4):
        want = reference[f"tp{sp}"]
        eng = _sharded(pair, ShardSpec(sp=sp, slots_per_shard=2,
                                       params="tp"), max_len=128)
        got = _drain(eng, reqs)
        assert [eng.routed(0)] == want["routes"]
        assert {str(k): [v[0], v[1]] for k, v in got.items()} == \
            want["streams"]
        ref = _shard_shapes(want["shards"], cfg)
        assert set(ref) == set(pair[5].state_dict())
        for dev in placed_shapes(eng.cores[0]._params, list(ref)):
            assert dev == ref, sp

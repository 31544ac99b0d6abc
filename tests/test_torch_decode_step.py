"""The frozen mesh step builders against the reference's, on the CPU.

``serving/decode_step.py``'s planning helpers (``attention_spec``,
``decode_workload``, ``mesh_launch_plan``, ``mesh_plan``,
``mesh_split_decision``) field by field for every arch over grids (1, 1)
to (2, 4), under ``paper`` and ``fa3_baseline``, at seq_len 512 and 4096;
the port's bundles over ``[cpu] * n`` (head-sharded K1 a device,
sequence-sharded partials + combine, ``decode_impl="auto"``'s one launch
at a split rounded up to the axis, sequence-parallel prefill a K3 launch
a chunk); the ``build_serve_step`` shim; ``ServeConfig.decode_impl`` and
``make_host_mesh``; and (marked ``multidevice``, one subprocess with
forced host devices) the reference's prefill and decode bundles' tokens
and cache placements, and its ``_attention_seqpar``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.serving import decode_step as jds
from repro_torch.configs.base import ServeConfig, ShapeConfig, get_arch
from repro_torch.configs.reduced import reduced_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_engine_mesh, make_host_mesh
from repro_torch.models import build_model
from repro_torch.plan import LaunchPlan, plan_scope
from repro_torch.serving import decode_step as ds
from repro_torch.serving.decode_step import build_mesh_decode_step, \
    build_prefill_step, join_caches

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
F32 = dict(dtype="float32", param_dtype="float32")
ARCHS = ["qwen2.5-3b", "codeqwen1.5-7b", "stablelm-12b",
         "granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "minicpm3-4b",
         "paligemma-3b", "whisper-large-v3", "recurrentgemma-9b",
         "mamba2-780m"]
GRIDS = [(1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (2, 4)]
SPEC_FIELDS = ("kind", "batch", "seqlen_q", "seqlen_k", "num_heads_q",
               "num_heads_kv", "head_dim", "window", "v_width", "kv_dtype",
               "mesh_axis", "mesh_axis_size")
PLAN_FIELDS = ("kind", "num_splits", "pack_gqa", "policy", "num_cores",
               "bucket", "mesh_splits", "min_splits", "seq_shard_axis")


def _grid(dp, sp):
    return make_engine_mesh(dp, sp, [CPU] * (dp * sp))[0]


@pytest.mark.parametrize("policy", ["paper", "fa3_baseline"])
def test_plans_equal_the_references(policy):
    """``attention_spec``, ``decode_workload``, ``mesh_launch_plan`` (and
    its spec), ``mesh_plan`` and ``mesh_split_decision`` equal the
    reference's field by field, for every arch, grid and seq_len (the
    reference's read only the grid's axis sizes)."""
    for arch in ARCHS:
        cfg, jcfg = get_arch(arch), j_get_arch(arch)
        for L in (512, 4096):
            shape = ShapeConfig("d", L, 1, "decode")
            jshape = JShapeConfig("d", L, 1, "decode")
            spec, jspec = ds.attention_spec(cfg, shape), \
                jds.attention_spec(jcfg, jshape)
            for f in SPEC_FIELDS:
                assert getattr(spec, f) == getattr(jspec, f), (arch, f)
            assert dataclasses.asdict(ds.decode_workload(cfg, shape)) == \
                dataclasses.asdict(jds.decode_workload(jcfg, jshape))
            for dp, sp in GRIDS:
                mesh = _grid(dp, sp)
                fake = types.SimpleNamespace(
                    axis_names=("data", "model"),
                    shape={"data": dp, "model": sp})
                got = ds.mesh_launch_plan(cfg, shape, mesh, policy)
                want = jds.mesh_launch_plan(jcfg, jshape, fake, policy)
                assert (got is None) == (want is None) == \
                    (cfg.family == "ssm")
                assert ds.mesh_split_decision(cfg, shape, mesh, policy) \
                    == jds.mesh_split_decision(jcfg, jshape, fake, policy)
                assert ds.mesh_plan(cfg, shape, mesh, policy)[1] == \
                    jds.mesh_plan(jcfg, jshape, fake, policy)[1]
                if got is None:
                    continue
                for f in PLAN_FIELDS:
                    assert getattr(got, f) == getattr(want, f), \
                        (arch, L, dp, sp, f)
                for f in SPEC_FIELDS:
                    assert getattr(got.spec, f) == getattr(want.spec, f)


def test_the_papers_cell_on_two_devices():
    """qwen2.5-3b at B 1, seq_len 512 over a model axis of 2:
    ``fa3_baseline`` head-shards (one KV head a device, S 1) and
    ``paper`` sequence-shards at S 3; on 4 devices H_KV 2 does not
    divide, so both shard the sequence."""
    cfg = get_arch("qwen2.5-3b")
    shape = ShapeConfig("d", 512, 1, "decode")
    base = ds.mesh_launch_plan(cfg, shape, _grid(1, 2), "fa3_baseline")
    paper = ds.mesh_launch_plan(cfg, shape, _grid(1, 2), "paper")
    assert (base.mesh_splits, base.num_splits) == (1, 1)
    assert (paper.mesh_splits, paper.num_splits) == (2, 3)
    for pol in ("paper", "fa3_baseline"):
        assert ds.mesh_split_decision(cfg, shape, _grid(1, 4), pol) == 4
    code = get_arch("codeqwen1.5-7b")
    for sp in (2, 4):
        for pol in ("paper", "fa3_baseline"):
            assert ds.mesh_split_decision(code, shape, _grid(1, sp),
                                          pol) == 1


def test_serve_config_and_host_mesh():
    """``ServeConfig.decode_impl`` and ``shape`` default to the
    reference's; ``make_host_mesh`` builds (n // model_axis, model_axis)
    over the given devices and refuses without a card otherwise."""
    cfg = get_arch("qwen2.5-3b")
    jcfg = j_get_arch("qwen2.5-3b")
    s, j = ServeConfig(model=cfg), JServeConfig(model=jcfg)
    assert s.decode_impl == j.decode_impl == "fused"
    assert dataclasses.astuple(s.shape) == dataclasses.astuple(j.shape)
    mesh = make_host_mesh(2, [CPU] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert make_host_mesh(devices=[CPU] * 3).shape == {"data": 3,
                                                       "model": 1}
    with pytest.raises(ValueError, match="does not fit"):
        make_host_mesh(4, [CPU] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


def test_build_serve_step_shim_warns_once_and_delegates(monkeypatch):
    cfg = dataclasses.replace(reduced_config("qwen2.5-3b"), **F32)
    model = build_model(cfg, device="cpu")
    scfg = ServeConfig(model=cfg, shape=ShapeConfig("d", 32, 2, "decode"))
    monkeypatch.setattr(ds, "_BUILD_SERVE_STEP_WARNED", False)
    with pytest.warns(DeprecationWarning, match="build_mesh_decode_step"):
        bundle = ds.build_serve_step(model, scfg, _grid(1, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = ds.build_serve_step(model, scfg, _grid(1, 2))
    want = build_mesh_decode_step(model, scfg, _grid(1, 2))
    for b in (bundle, again):
        assert (b.max_len, b.mesh_splits) == (want.max_len, want.mesh_splits)
        assert b.cache_shardings == want.cache_shardings


# ---------------------------------------------------------------------------
# the port's bundles
# ---------------------------------------------------------------------------


def _model(arch):
    cfg = dataclasses.replace(reduced_config(arch), **F32)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init_params(0)


def _run(model, params, mesh, *, policy="paper", impl="fused", prompt=24,
         steps=6, seq_len=32, toks=None):
    """Prefill a (2, prompt) batch, then ``steps`` decode steps: (the
    prefill token then each step's, the decode bundle, its caches)."""
    cfg = model.cfg
    pcfg = ServeConfig(model=cfg, shape=ShapeConfig("p", prompt, 2,
                                                    "prefill"),
                       split_policy=policy, decode_impl=impl)
    if toks is None:
        toks = np.random.default_rng(0).integers(1, 200, (2, prompt))
    pb = build_prefill_step(model, pcfg, mesh)
    nt, caches = pb.step(params, {"tokens": torch.from_numpy(toks)})
    dcfg = dataclasses.replace(pcfg, shape=ShapeConfig("d", seq_len, 2,
                                                       "decode"))
    db = build_mesh_decode_step(model, dcfg, mesh)
    dense = join_caches(caches, CPU)
    full = model.init_cache(2, db.max_len)
    for name, c in dense.items():
        full[name][:, :, :c.shape[2]] = c
    placed, pp = db.place_caches(full), db.place_params(params)
    seq, tok = [nt.tolist()], nt
    for t in range(prompt, prompt + steps):
        tok, placed = db.step(pp, placed, tok, t)
        seq.append(tok.tolist())
    return seq, db, placed


def test_head_and_sequence_sharded_bundles_agree(monkeypatch):
    """At (1, 2): ``fa3_baseline`` head-shards codeqwen1.5-7b's cache
    (reduced: 4 KV heads; HeadShards, two decode launches a layer and
    step); on qwen2.5-3b (reduced: 1 KV head) ``paper`` fused shards the
    sequence (a partials launch a device, one combine) and ``auto`` runs
    one launch on the lead; each gives its one-device bundle's tokens."""
    calls = {"decode": 0, "partials": 0, "combine": 0}
    for name, key in (("decode_attention", "decode"),
                      ("flash_decode_partials", "partials"),
                      ("flash_combine", "combine")):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    for arch, policy, impl, kind, per_step in (
            ("codeqwen1.5-7b", "fa3_baseline", "fused", ops.HeadShards,
             {"decode": 2, "partials": 0, "combine": 0}),
            ("qwen2.5-3b", "paper", "fused", ops.SeqShards,
             {"decode": 0, "partials": 2, "combine": 1}),
            ("qwen2.5-3b", "paper", "auto", ops.SeqShards,
             {"decode": 1, "partials": 0, "combine": 0})):
        cfg, model, params = _model(arch)
        one, _, _ = _run(model, params, _grid(1, 1))
        for k in calls:
            calls[k] = 0
        seq, db, placed = _run(model, params, _grid(1, 2), policy=policy,
                               impl=impl)
        assert seq == one, (policy, impl)
        assert type(placed[0]["k"]) is kind
        steps = 6 * cfg.num_layers
        assert calls == {k: n * steps for k, n in per_step.items()}
        assert db.mesh_splits == (1 if policy == "fa3_baseline" else 2)


def test_head_shards_are_not_sequence_chunks():
    """A head-sharded cache is no sequence chunking: the engine's
    sequence checks do not take it, the sequence-sharded decode refuses
    it, and both kinds index, join and copy over their own dim."""
    x = torch.arange(2 * 4 * 8 * 4 * 3, dtype=torch.float32).reshape(
        2, 4, 8, 4, 3)
    devices = [torch.device("cpu")] * 2
    heads = ops.HeadShards.place(x, devices, dim=3)
    seq = ops.SeqShards.place(x, devices, dim=2)
    assert not isinstance(heads, ops.SeqShards)
    assert not ops.seq_sharded({"k": heads}) and ops.seq_sharded({"k": seq})
    for leaf, dim in ((heads, 3), (seq, 2)):
        assert [c.shape[dim] for c in leaf.chunks] == [x.shape[dim] // 2] * 2
        layer = leaf[1]
        assert type(layer) is type(leaf) and layer.dim == dim - 1
        assert torch.equal(layer.join(x.device), x[1])
        leaf.copy_(x + 1)
        assert torch.equal(leaf.join(x.device), x + 1)
    q = torch.zeros(4, 4, 3)
    cache = {"k": heads[0], "v": heads[0]}
    new = {"k": torch.zeros(4, 4, 3), "v": torch.zeros(4, 4, 3)}
    t = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError, match="not cut on its sequence"):
        ops.decode_update_seqsharded(q, cache, new, t, t + 1,
                                     devices=devices)


def test_auto_rounds_the_split_up_to_the_axis():
    """``decode_impl="auto"`` pins ``min_splits`` = the axis size, and
    the decode op rounds the plan's split up to a multiple of it."""
    plan = LaunchPlan(num_splits=3, min_splits=2)
    assert ops._splits(plan, 512) == 4
    assert ops._splits(plan, 3) == 3
    with plan_scope(LaunchPlan(min_splits=4)):
        assert ops._splits(LaunchPlan(num_splits=1), 512) == 4
    cfg, model, _ = _model("qwen2.5-3b")
    scfg = ServeConfig(model=cfg, shape=ShapeConfig("d", 32, 2, "decode"),
                       decode_impl="auto")
    db = build_mesh_decode_step(model, scfg, _grid(1, 2))
    assert (db.plan.min_splits, db.plan.seq_shard_mesh) == (2, None)
    fused = build_mesh_decode_step(model, dataclasses.replace(
        scfg, decode_impl="fused"), _grid(1, 2))
    assert fused.plan.min_splits == 1
    assert fused.plan.seq_shard_mesh is not None


def test_prefill_step_runs_sequence_parallel_where_heads_do_not_divide(
        monkeypatch):
    """qwen2.5-3b (reduced: 4 heads) over a model axis of 3 prefills its
    24 rows sequence-parallel (three 8-row prefill launches a layer at
    q_offset 0 / 8 / 16) and gives the one-device step's tokens and
    caches; over 2 devices the heads divide and nothing runs
    sequence-parallel."""
    cfg, model, params = _model("qwen2.5-3b")
    offsets = []
    fn = ops.flash_prefill

    def counted(q, k, v, **kw):
        offsets.append((q.shape[1], kw.get("q_offset", 0)))
        return fn(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_prefill", counted)
    toks = np.random.default_rng(0).integers(1, 200, (2, 24))
    scfg = ServeConfig(model=cfg, shape=ShapeConfig("p", 24, 2, "prefill"))
    want_tok, want_c = build_prefill_step(model, scfg, _grid(1, 1)).step(
        params, {"tokens": torch.from_numpy(toks)})
    assert offsets == [(24, 0)] * cfg.num_layers
    offsets.clear()
    pb = build_prefill_step(model, scfg, _grid(1, 3))
    assert pb.plan.seq_shard_mesh is not None
    tok, caches = pb.step(params, {"tokens": torch.from_numpy(toks)})
    assert offsets == [(8, 0), (8, 8), (8, 16)] * cfg.num_layers
    assert tok.tolist() == want_tok.tolist()
    for name, c in join_caches(caches, CPU).items():
        torch.testing.assert_close(c, want_c[0][name], rtol=1e-6,
                                   atol=1e-6)
    assert build_prefill_step(model, scfg, _grid(1, 2)).plan \
        .seq_shard_mesh is None
    assert pb.batch_shardings == {"tokens": (("data",),)}
    params_meta, batch = pb.abstract_args()
    assert batch["tokens"].shape == (2, 24)
    assert batch["tokens"].device.type == "meta"


def test_step_builders_refuse_families_without_tensor_parallel_decode():
    cfg, model, _ = _model("mamba2-780m")
    scfg = ServeConfig(model=cfg, shape=ShapeConfig("d", 32, 2, "decode"))
    with pytest.raises(ValueError, match="tensor-parallel decode"):
        build_mesh_decode_step(model, scfg, _grid(1, 2))
    db = build_mesh_decode_step(model, scfg, _grid(1, 1))
    assert db.plan.frozen is False and db.mesh_splits == 1


# ---------------------------------------------------------------------------
# the reference, with forced host devices
# ---------------------------------------------------------------------------


QKV_SHAPES = ((2, 64, 5, 16), (2, 72, 1, 16), (2, 72, 1, 16))
CASES = [["qwen2.5-3b", [1, 2], "paper", "fused", 32],
         ["qwen2.5-3b", [1, 2], "paper", "auto", 32],
         ["qwen2.5-3b", [1, 3], "paper", "fused", 30],
         ["codeqwen1.5-7b", [1, 2], "fa3_baseline", "fused", 32],
         ["codeqwen1.5-7b", [2, 2], "paper", "auto", 32],
         ["granite-moe-3b-a800m", [1, 4], "paper", "fused", 32],
         ["minicpm3-4b", [1, 2], "paper", "fused", 32]]

_REFERENCE = """
    import json, warnings
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.configs.base import ServeConfig, ShapeConfig
    from repro.configs.reduced import reduced_config
    from repro.kernels import ops
    from repro.models import build_model
    from repro.plan import LaunchPlan, plan_scope
    from repro.serving.decode_step import (build_mesh_decode_step,
                                           build_prefill_step)
    warnings.simplefilter("ignore")
    ARGS = json.loads(ARGS_JSON)
    out = {"bundles": []}
    for arch, grid, pol, impl, seq_len in ARGS["cases"]:
        cfg = reduced_config(arch).replace(dtype="float32",
                                           param_dtype="float32")
        model = build_model(cfg)
        params = jax.tree.map(lambda a: a.astype("float32"),
                              jax.jit(model.init_params)(
                                  jax.random.PRNGKey(0)))
        mesh = make_mesh(tuple(grid), ("data", "model"))
        scfg = ServeConfig(model=cfg, shape=ShapeConfig("p", 24, 2,
                                                        "prefill"),
                           split_policy=pol, decode_impl=impl)
        pb = build_prefill_step(model, scfg, mesh)
        toks = np.asarray(ARGS["tokens"], np.int32)
        nt, caches = pb.step(params, {"tokens": jnp.asarray(toks)})
        dcfg = ServeConfig(model=cfg, shape=ShapeConfig("d", seq_len, 2,
                                                        "decode"),
                           split_policy=pol, decode_impl=impl)
        db = build_mesh_decode_step(model, dcfg, mesh)
        flat, tree = jax.tree_util.tree_flatten(caches)
        abstract = jax.tree_util.tree_leaves(db.abstract_args()[1])
        padded = [jnp.zeros(a.shape, a.dtype).at[:, :, :c.shape[2]].set(c)
                  for c, a in zip(flat, abstract)]
        cc = jax.device_put(jax.tree_util.tree_unflatten(tree, padded),
                            db.cache_shardings)
        seq, tok = [np.asarray(nt).tolist()], nt
        for t in range(24, 30):
            tok, cc = db.step(params, cc, tok, jnp.int32(t))
            seq.append(np.asarray(tok).tolist())
        shard = jax.tree_util.tree_leaves(db.cache_shardings)
        out["bundles"].append(dict(
            seq=seq, mesh_splits=db.mesh_splits, max_len=db.max_len,
            specs=[[list(e) if isinstance(e, tuple) else e
                    for e in s.spec] for s in shard],
            shard_shapes=[list(s.shard_shape(a.shape))
                          for s, a in zip(shard, abstract)]))

    # sequence-parallel attention (the reference's multidevice test)
    mesh = make_mesh((2, 4), ("data", "model"))
    rng = np.random.default_rng(ARGS["qkv_seed"])
    q, k, v = (jnp.asarray(rng.standard_normal(s).astype(np.float32))
               for s in QKV_SHAPES)
    plan = LaunchPlan(kind="prefill", seq_shard_mesh=mesh)
    for w in (None, 16):
        with plan_scope(plan):
            o = jax.jit(lambda *a: ops.attention(*a, causal=True, window=w,
                                                 q_offset=8))(q, k, v)
        out[f"seqpar{w}"] = np.asarray(o).tolist()
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    args = {"cases": CASES, "qkv_seed": 1,
            "tokens": np.random.default_rng(0).integers(
                1, 200, (2, 24)).tolist()}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"ARGS_JSON = {json.dumps(json.dumps(args))}\n"
            f"QKV_SHAPES = {QKV_SHAPES!r}\n") + textwrap.dedent(_REFERENCE)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return args, json.loads(r.stdout.strip().splitlines()[-1])


def _spec_list(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.multidevice
@pytest.mark.parametrize("case", range(len(CASES)))
def test_bundles_equal_the_references(reference, case):
    """The port's prefill then six decode steps give the reference
    bundles' tokens, fused and ``auto``, head- and sequence-sharded (one
    case prefills sequence-parallel over 3 devices); the cache specs
    equal the reference's, and each row's device holds the reference's
    shard shape of every leaf."""
    args, ref = reference
    arch, grid, policy, impl, seq_len = CASES[case]
    want = ref["bundles"][case]
    _, model, _ = _model(arch)
    import jax
    from repro.configs.reduced import reduced_config as jr
    from repro.models import build_model as jbuild
    from repro_torch.interop import params_from_numpy
    jcfg = jr(arch).replace(**F32)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float32),
                           jax.jit(jbuild(jcfg).init_params)(
                               jax.random.PRNGKey(0)))
    params = params_from_numpy(jparams, model.cfg, device="cpu")
    mesh = _grid(*grid)
    seq, db, placed = _run(model, params, mesh, policy=policy, impl=impl,
                           seq_len=seq_len,
                           toks=np.asarray(args["tokens"]))
    assert seq == want["seq"]
    assert (db.mesh_splits, db.max_len) == (want["mesh_splits"],
                                            want["max_len"])
    names = list(model.cache_shapes(2, db.max_len))
    assert [_spec_list(db.cache_shardings[n]) for n in names] == \
        want["specs"]
    for name, shard in zip(names, want["shard_shapes"]):
        for row in placed:
            leaf = row[name]
            chunks = leaf.chunks if isinstance(leaf, ops.Shards) \
                else (leaf,)
            for c in chunks:
                assert list(c.shape) == shard, (name, case)


@pytest.mark.multidevice
def test_seqpar_attention_equals_the_references(reference):
    """``ops.attention`` under a prefill plan over a (2, 4) grid runs the
    prefill kernel a chunk of query rows a device (the batch over the
    data rows), and equals the reference's ``_attention_seqpar`` with and
    without a window within 2e-5."""
    args, ref = reference
    from repro_torch.kernels import ops as port_ops
    rng = np.random.default_rng(args["qkv_seed"])
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in QKV_SHAPES)
    plan = LaunchPlan(kind="prefill", seq_shard_mesh=_grid(2, 4))
    for w in (None, 16):
        with plan_scope(plan):
            got = port_ops.attention(q, k, v, causal=True, window=w,
                                     q_offset=8)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ref[f"seqpar{w}"]),
                                   rtol=2e-5, atol=2e-5)

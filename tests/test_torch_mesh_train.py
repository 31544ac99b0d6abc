"""The port's mesh training against the reference's, on the CPU.

``place_trainable`` puts every weight's slices where the reference's
``param_rules()`` puts them over grids (1, 1), (2, 2), (2, 4) and (1, 3)
(the reference's ``tree_shardings`` index maps, from a subprocess with 8
forced host devices); the AdamW moments follow their weights; a weight
the grid leaves whole on several devices is one leaf, so ``global_norm``
counts it once.  The port's mesh ``build_train_step`` at (2, 4) on
reduced qwen2.5-3b, and at (1, 4) on reduced granite-moe-3b-a800m under
``ep_shard_map``, takes three steps from the reference's weights and
batches: each step's loss, aux_loss, total_loss and lr within 1e-5
relative, grad_norm within 1e-4 (``TRAJECTORY_TOL`` of
``tests/test_torch_train.py``), and the final weights within 1e-4 of
their norm, against the reference's mesh step on the subprocess's 8
devices.  One step at (2, 2), (4, 1) and (1, 3) equals the port's
one-device step (loss within 1e-6 relative, weights within 1e-5 of their
norm), for every family that trains at a model axis above 1 and, at (2,
1), for the others.  Sequence-parallel training attention runs where the
reference's step runs ``_attention_seqpar`` (counted in the reference's
trace and in the port's prefill calls), and its gradients equal whole-
sequence attention's in float64.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs.base import OptimizerConfig, ShapeConfig, \
    TrainConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.plan import LaunchPlan, plan_scope
from repro_torch.sharding.place import MeshParams, leaf_key, \
    place_trainable
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import build_train_step, param_tree

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
F32 = dict(dtype="float32", param_dtype="float32")
PLACEMENT_GRIDS = ((1, 1), (2, 2), (2, 4), (1, 3))
TRAJECTORIES = {"qwen": ("qwen2.5-3b", (2, 4)),
                "granite": ("granite-moe-3b-a800m", (1, 4))}
TRAJECTORY_TOL = {"loss": 1e-5, "aux_loss": 1e-5, "total_loss": 1e-5,
                  "lr": 1e-5, "tokens": 0.0, "grad_norm": 1e-4}
SEQ, BATCH, STEPS = 16, 4, 3
OKW = dict(lr=3e-3, warmup_steps=2, total_steps=20)
# the reference's sequence-parallel decision: (model axis, seq len)
SEQPAR_CASES = ((3, 18), (2, 18), (3, 16))


def _cfg(arch):
    return reduced_config(arch, num_layers=2, d_model=32).replace(**F32)


def _grid(data, model):
    return make_host_mesh(model, [CPU] * (data * model))


_REFERENCE = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import OptimizerConfig, ShapeConfig, TrainConfig
from repro.configs.reduced import reduced_config
from repro.data.synthetic import DataConfig, SyntheticLM
from repro.kernels import ops
from repro.launch.mesh import make_engine_mesh
from repro.models import build_model
from repro.models.common import abstract_params
from repro.sharding.rules import param_rules, tree_shardings
from repro.training import train_step as ts

ARGS = json.loads(sys.argv[1])
F32 = dict(dtype="float32", param_dtype="float32")
out = {}

def cfg_of(arch):
    return reduced_config(arch, num_layers=2, d_model=32).replace(**F32)

def flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), x) for p, x in leaves]

# placement: every leaf's index map over each grid
for arch in ("qwen2.5-3b", "granite-moe-3b-a800m"):
    model = build_model(cfg_of(arch))
    aparams = abstract_params(model.param_specs())
    for d, m in ARGS["grids"]:
        mesh = make_engine_mesh(d, m)[0]
        shard = tree_shardings(mesh, aparams, model.param_axes(),
                               param_rules())
        idx = {}
        for (key, a), (_, s) in zip(flat(aparams), flat(shard)):
            dm = s.devices_indices_map(a.shape)
            idx[key] = [[[sl.start or 0, a.shape[k] if sl.stop is None
                          else sl.stop]
                         for k, sl in enumerate(dm[dev])]
                        for dev in mesh.devices.reshape(-1)]
        out[f"place/{arch}/{d}x{m}"] = json.dumps(idx)

# three mesh steps from the reference's own weights
for name, (arch, (d, m)) in ARGS["traj"].items():
    cfg = cfg_of(arch)
    mesh = make_engine_mesh(d, m)[0]
    tcfg = TrainConfig(model=cfg, shape=ShapeConfig(
        "t", ARGS["seq"], ARGS["batch"], "train"),
        optimizer=OptimizerConfig(**ARGS["okw"]))
    bundle = ts.build_train_step(build_model(cfg), tcfg, mesh)
    params, state = bundle.init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    state = jax.tree.map(lambda a: a, state)
    for k, x in flat(params):
        out[f"{name}/init/{k}"] = np.asarray(x)
    data = SyntheticLM(DataConfig(cfg.vocab_size, ARGS["seq"],
                                  ARGS["batch"], seed=3))
    metrics = []
    for step in range(ARGS["steps"]):
        batch = {k: jnp.asarray(v) for k, v in data.batch_at(step).items()}
        params, state, mt = bundle.step(params, state, batch)
        metrics.append({k: float(v) for k, v in mt.items()})
    out[f"{name}/metrics"] = json.dumps(metrics)
    for k, x in flat(params):
        out[f"{name}/final/{k}"] = np.asarray(x)

# where the reference's step runs sequence-parallel attention
seqpar = ops._attention_seqpar
for m, L in ARGS["seqpar"]:
    calls = []
    def counting(*a, **kw):
        calls.append(kw["q_offset"])
        return seqpar(*a, **kw)
    ops._attention_seqpar = counting
    cfg = cfg_of("qwen2.5-3b")
    mesh = make_engine_mesh(1, m)[0]
    tcfg = TrainConfig(model=cfg, shape=ShapeConfig("t", L, 2, "train"))
    bundle = ts.build_train_step(build_model(cfg), tcfg, mesh)
    jax.eval_shape(bundle.step, *bundle.abstract_args())
    ops._attention_seqpar = seqpar
    out[f"seqpar/{m}/{L}"] = np.asarray(len(calls))

np.savez(ARGS["out"], **{k: np.asarray(v) for k, v in out.items()})
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's side on 8 forced host devices, once a module."""
    path = tmp_path_factory.mktemp("mesh_train") / "reference.npz"
    args = {"grids": PLACEMENT_GRIDS, "traj": TRAJECTORIES, "seq": SEQ,
            "batch": BATCH, "steps": STEPS, "okw": OKW,
            "seqpar": SEQPAR_CASES, "out": str(path)}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(args)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in leaves]


def _tree_from(ref, prefix, like):
    """The reference's arrays under ``prefix`` in ``like``'s structure."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        ref[f"{prefix}/{jax.tree_util.keystr(p)}"] for p, _ in leaves])


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@pytest.mark.multidevice
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("grid", PLACEMENT_GRIDS)
def test_every_slice_lies_where_param_rules_put_it(reference, arch, grid):
    """Device (d, s)'s slice of every weight equals the reference's shard
    on device (d, s) of the same grid: the reference's index map applied
    to the dense weights, layer stacks included."""
    d, m = grid
    cfg = _cfg(arch)
    dense = build_model(cfg, device="cpu").init_params(1)
    tree = place_trainable(dense, _grid(d, m))
    want = params_to_numpy(dense, cfg)
    idx = json.loads(str(reference[f"place/{arch}/{d}x{m}"]))
    for i in range(d * m):
        held = {n: tree.held(n, i // m, i % m) for n in tree.layout}
        got = dict(_flat(params_to_numpy(held, cfg)))
        for key, arr in _flat(want):
            sl = tuple(slice(a, b) for a, b in idx[key][i])
            np.testing.assert_array_equal(got[key], arr[sl],
                                          err_msg=f"{key} on device {i}")


def test_moments_follow_their_weights_and_whole_weights_count_once():
    """At (2, 2): one leaf per distinct slice (a norm's scale, cut over
    the data axis only, is one leaf a row, read by both of the row's
    devices), moments keyed, shaped and placed like their leaves, and
    the global norm of the leaves' gradients equals the norm of the
    dense gradient, each logical weight counted once (the joined
    gradient within 1e-5 of that norm)."""
    cfg = _cfg("qwen2.5-3b")
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(model=cfg, shape=ShapeConfig("t", SEQ, BATCH,
                                                    "train"))
    bundle = build_train_step(model, tcfg, _grid(2, 2))
    params, state = bundle.init(0)
    scale = "layers.0.ln1.scale"
    assert [k for k in params.leaves if k.startswith(scale)] == \
        [leaf_key(scale, 0, None), leaf_key(scale, 1, None)]
    assert params.held(scale, 0, 0) is params.held(scale, 0, 1)
    assert bundle.param_specs[scale] == ("data",)
    assert bundle.param_specs["layers.0.mix.wq"] == ("data", "model")
    assert bundle.opt_specs["m"] is bundle.param_specs
    for k in ("m", "v"):
        assert list(state[k]) == list(params.leaves)
        for n, t in state[k].items():
            leaf = params.leaves[n]
            assert (t.shape, t.device, t.dtype) == \
                (leaf.shape, leaf.device, torch.float32)
    batch = bundle.to_device(SyntheticLM(DataConfig(
        cfg.vocab_size, SEQ, BATCH, seed=2)).batch_at(0))
    _, _, grads = bundle.grads(params, batch)
    one = build_train_step(model, tcfg)
    dense = model.init_params(0)
    _, _, want = one.grads(one._state(dense)[0], batch)
    joined = params.join(grads)
    assert float(opt.global_norm(grads)) == pytest.approx(
        float(opt.global_norm(want)), rel=1e-6)
    diff = sum(float((joined[n] - g).square().sum())
               for n, g in want.items())
    assert diff ** 0.5 <= 1e-5 * float(opt.global_norm(want))


# ---------------------------------------------------------------------------
# against the reference's mesh step and the port's one-device step
# ---------------------------------------------------------------------------


@pytest.mark.multidevice
@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_mesh_steps_match_the_references(reference, name):
    """Three steps over the reference's grid from its weights and the
    same SyntheticLM batches (qwen at (2, 4); granite at (1, 4), where
    ``ep_shard_map`` runs expert parallelism and its own load-balance
    loss): the per-step metrics within ``TRAJECTORY_TOL``, the final
    weights within 1e-4 of their norm."""
    arch, (d, m) = TRAJECTORIES[name]
    cfg = _cfg(arch)
    mesh = _grid(d, m)
    bundle = build_train_step(build_model(cfg, device="cpu"), TrainConfig(
        model=cfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
        optimizer=OptimizerConfig(**OKW)), mesh)
    like = params_to_numpy(build_model(cfg, device="cpu").init_params(0),
                           cfg)
    params = params_from_numpy(_tree_from(reference, f"{name}/init", like),
                               cfg, device="cpu", mesh=mesh)
    state = opt.adamw_init(params.leaves)
    data = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=3))
    want = json.loads(str(reference[f"{name}/metrics"]))
    for step in range(STEPS):
        _, _, got = bundle.step(params, state,
                                bundle.to_device(data.batch_at(step)))
        for k, tol in TRAJECTORY_TOL.items():
            assert float(got[k]) == pytest.approx(want[step][k], rel=tol,
                                                  abs=1e-7), (step, k)
    if cfg.moe is not None:
        assert want[0]["aux_loss"] > 0
    final = _flat(_tree_from(reference, f"{name}/final", like))
    got = dict(_flat(params_to_numpy(params, cfg)))
    diff = sum(float(np.sum((got[k] - w).astype(np.float64) ** 2))
               for k, w in final)
    norm = sum(float(np.sum(w.astype(np.float64) ** 2)) for _, w in final)
    assert diff ** 0.5 <= 1e-4 * norm ** 0.5


def _one_step(arch, grid, seq=SEQ, batch=BATCH):
    cfg = _cfg(arch)
    model = build_model(cfg, device="cpu")
    mesh = None if grid is None else _grid(*grid)
    bundle = build_train_step(model, TrainConfig(
        model=cfg, shape=ShapeConfig("t", seq, batch, "train"),
        optimizer=OptimizerConfig(**OKW)), mesh)
    params, state = bundle.init(0)
    data = SyntheticLM(DataConfig(cfg.vocab_size, model.text_len(seq),
                                  batch, seed=1))
    nb = data.batch_at(0)
    rng = np.random.default_rng(5)
    for k, (shape, _) in model.frontend_inputs(batch, seq).items():
        nb[k] = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    _, _, m = bundle.step(params, state, bundle.to_device(nb))
    dense = params.state_dict() if isinstance(params, MeshParams) \
        else param_tree(params)
    return m, {n: t.detach() for n, t in dense.items()}


@pytest.mark.parametrize("arch,grid", [
    ("qwen2.5-3b", (2, 2)), ("qwen2.5-3b", (4, 1)), ("qwen2.5-3b", (1, 3)),
    ("minicpm3-4b", (2, 2)), ("minicpm3-4b", (1, 3)),
    ("granite-moe-3b-a800m", (4, 1)), ("granite-moe-3b-a800m", (2, 4)),
    ("paligemma-3b", (2, 1)), ("whisper-large-v3", (2, 1)),
    ("recurrentgemma-9b", (2, 1)), ("mamba2-780m", (2, 1))])
def test_one_mesh_step_equals_the_one_device_step(arch, grid):
    """One step over the grid against the same step on one device: loss
    within 1e-6 relative, the weights within 1e-5 of their norm.  Granite
    runs at L 18, which a model axis of 4 does not divide, so its (2, 4)
    step routes by gather as the one-device step does (as the
    reference's falls back there too), its experts cut over the model
    axis; at (4, 1) the load-balance loss comes from the rows' routing
    stats, over the whole batch."""
    seq = 18 if arch == "granite-moe-3b-a800m" else SEQ
    if arch in ("recurrentgemma-9b",):
        seq = 80
    want, w0 = _one_step(arch, None, seq)
    got, w1 = _one_step(arch, grid, seq)
    for k in ("loss", "aux_loss", "total_loss"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6,
                                              abs=1e-7), k
    diff = sum(float((w1[n] - w0[n]).square().sum()) for n in w0)
    norm = sum(float(w.square().sum()) for w in w0.values())
    assert diff ** 0.5 <= 1e-5 * norm ** 0.5


# ---------------------------------------------------------------------------
# sequence-parallel training attention
# ---------------------------------------------------------------------------


@pytest.mark.multidevice
@pytest.mark.parametrize("model_axis,seq", SEQPAR_CASES)
def test_seqpar_attention_runs_where_the_references_does(
        reference, monkeypatch, model_axis, seq):
    """Heads 4 over a model axis of 3 at L 18: every attention call of
    the step runs on chunks of 6 query rows at q_offset 0 / 6 / 12 (the
    forward, and its rerun under remat); a model axis of 2, or L 16, runs
    it whole.  The reference's trace of its step calls
    ``_attention_seqpar`` exactly where the port does (once: its layers
    are one scanned body)."""
    calls = []
    real = ops.flash_prefill

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["q_offset"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_prefill", counting)
    cfg = _cfg("qwen2.5-3b")
    bundle = build_train_step(build_model(cfg, device="cpu"), TrainConfig(
        model=cfg, shape=ShapeConfig("t", seq, 2, "train")),
        _grid(1, model_axis))
    params, state = bundle.init(0)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, 2, seed=0))
    bundle.step(params, state, bundle.to_device(data.batch_at(0)))
    layers = cfg.num_layers * 2                  # forward + remat rerun
    taken = cfg.num_heads % model_axis != 0 and seq % model_axis == 0
    if taken:
        c = seq // model_axis
        assert calls == [(c, seq, i * c) for _ in range(layers)
                         for i in range(model_axis)]
    else:
        assert calls == [(seq, seq, 0)] * layers
    assert int(reference[f"seqpar/{model_axis}/{seq}"]) == int(taken)


def test_seqpar_gradients_equal_whole_sequence_attention():
    """``_attention_seqpar`` over a (1, 3) grid is differentiable: its
    q / k / v gradients (K and V's summed over the chunks) equal whole-
    sequence attention's in float64 within 1e-10, causal and windowed."""
    rng = np.random.default_rng(7)
    B, L, Hq, Hkv, D = 2, 18, 4, 2, 8
    for window in (None, 5):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, L, h, D))).requires_grad_(True) for h in (Hq, Hkv, Hkv))
        do = torch.from_numpy(rng.standard_normal((B, L, Hq, D)))
        want = torch.autograd.grad(
            ops.attention(q, k, v, window=window), (q, k, v), do)
        with plan_scope(LaunchPlan(kind="prefill",
                                   seq_shard_mesh=_grid(1, 3))):
            out = ops.attention(q, k, v, window=window)
        got = torch.autograd.grad(out, (q, k, v), do)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)

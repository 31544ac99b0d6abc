"""The port's int8 error-feedback gradient compression against the
reference's, on the CPU.

``quantize_int8`` / ``dequantize_int8`` equal the reference's bit for bit
(codes and values) on seeded arrays at several scales, and keep the
round-trip error within half a step; ``compressed_psum`` over a list of
eight replicas' gradients equals the reference's ``compressed_psum``
inside a ``shard_map`` over 8 forced host devices (one subprocess) bit
for bit: the mean and every replica's new error feedback, float32 and
bfloat16 gradients; ``build_compressed_dp_grads`` over an (8, 1) grid is
within 0.02 of the gradient's scale of the exact gradient (the bound of
the reference's ``tests/test_multidevice.py``); and the error feedback
makes the compressed gradients' running mean converge to the true one
(the reference's ``tests/test_training.py`` case).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as jcomp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.training.compression import build_compressed_dp_grads, \
    compressed_psum, dequantize_int8, init_error_feedback, quantize_int8

REPO = Path(__file__).resolve().parents[1]
REPLICAS = 8
SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}


def _replica_grads(seed=0):
    """Eight replicas' gradients and error-feedback buffers (float32; "c"
    holds bfloat16 values, and is cast to bfloat16 on both sides)."""
    rng = np.random.default_rng(seed)
    g = {k: (rng.standard_normal((REPLICAS,) + s) * (1 + i)).astype(
        np.float32) for i, (k, s) in enumerate(SHAPES.items())}
    g["c"] = torch.from_numpy(g["c"]).bfloat16().float().numpy()
    e = {k: (rng.standard_normal((REPLICAS,) + s) * 1e-2).astype(
        np.float32) for k, s in SHAPES.items()}
    return g, e


_REFERENCE = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.training.compression import compressed_psum

args = json.loads(sys.argv[1])
with np.load(args["inp"]) as f:
    g = {k[2:]: jnp.asarray(f[k]) for k in f.files if k.startswith("g/")}
    e = {k[2:]: jnp.asarray(f[k]) for k in f.files if k.startswith("e/")}
g["c"] = g["c"].astype(jnp.bfloat16)
mesh = Mesh(np.array(jax.devices()), ("data",))

def body(gb, eb):
    first = lambda t: jax.tree.map(lambda x: x[0], t)
    mean, ef = compressed_psum(first(gb), "data", ef=first(eb))
    return mean, jax.tree.map(lambda x: x[None], ef)

mean, ef = jax.jit(shard_map(body, mesh=mesh,
                             in_specs=(P("data"), P("data")),
                             out_specs=(P(), P("data")),
                             check_rep=False))(g, e)
out = {f"mean/{k}": np.asarray(v) for k, v in mean.items()}
out.update({f"ef/{k}": np.asarray(v) for k, v in ef.items()})
np.savez(args["out"], **out)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ``compressed_psum`` in a ``shard_map`` over 8
    forced host devices, once a module."""
    d = tmp_path_factory.mktemp("compression")
    g, e = _replica_grads()
    np.savez(d / "inp.npz", **{f"g/{k}": v for k, v in g.items()},
             **{f"e/{k}": v for k, v in e.items()})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    args = {"inp": str(d / "inp.npz"), "out": str(d / "out.npz")}
    r = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(args)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(d / "out.npz") as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("scale_of", ["max", "tiny", "zero"])
def test_quantize_and_dequantize_equal_the_references_bits(seed, scale_of):
    """Codes and dequantized values bit for bit at the shared scale
    (max / 127), at a scale so small every code clips, and at a zero
    scale (the 1e-30 floor); the round trip within half a step at the
    max scale (the reference's property)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(97) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    scale = {"max": np.abs(x).max() / np.float32(127.0),
             "tiny": np.float32(1e-6), "zero": np.float32(0.0)}[scale_of]
    scale = np.float32(scale)
    q = quantize_int8(torch.from_numpy(x), torch.tensor(scale))
    jq = jcomp.quantize_int8(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    deq = dequantize_int8(q, torch.tensor(scale)).numpy()
    jdeq = np.asarray(jcomp.dequantize_int8(jq, jnp.asarray(scale)))
    assert deq.tobytes() == jdeq.tobytes()
    if scale_of == "max":
        assert (np.abs(deq - x) <= scale * 0.5 + 1e-6).all()


@pytest.mark.multidevice
def test_compressed_psum_equals_the_references_bits(reference):
    """The same eight replicas' gradients and buffers: the mean and each
    replica's new buffer bit for bit the reference's shard_map's."""
    g, e = _replica_grads()
    grads = [{k: torch.from_numpy(v[i]) for k, v in g.items()}
             for i in range(REPLICAS)]
    for r in grads:
        r["c"] = r["c"].bfloat16()
    efs = [{k: torch.from_numpy(v[i]) for k, v in e.items()}
           for i in range(REPLICAS)]
    mean, new_ef = compressed_psum(grads, ef=efs)
    for k in SHAPES:
        assert mean[k].dtype == torch.float32
        assert mean[k].numpy().tobytes() == reference[f"mean/{k}"].tobytes()
        got = np.stack([r[k].numpy() for r in new_ef])
        assert got.tobytes() == reference[f"ef/{k}"].tobytes(), k


def _problem():
    rng = np.random.default_rng(0)
    W, X, Y = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((16, 16), (32, 16), (32, 16)))

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2), {}
    return {"w": W}, {"x": X, "y": Y}, loss_fn


def test_compressed_dp_grads_close_to_exact():
    """Eight data rows of a (8, 1) CPU grid, the weights replicated: the
    compressed mean gradient within 0.02 of the exact gradient's scale,
    the loss the rows' mean, and one residual a replica."""
    params, batch, loss_fn = _problem()
    w = params["w"].clone().requires_grad_(True)
    exact = torch.autograd.grad(loss_fn({"w": w}, batch)[0], [w])[0]
    grad_fn = build_compressed_dp_grads(loss_fn,
                                        make_host_mesh(1, ["cpu"] * 8))
    loss, grads, ef = grad_fn(params, batch, init_error_feedback(params))
    diff = (grads["w"] - exact).abs().max() / exact.abs().max()
    assert float(diff) < 0.02
    assert float(loss) == pytest.approx(float(loss_fn(params, batch)[0]),
                                        rel=1e-6)
    assert len(ef) == 8 and all(e["w"].shape == (16, 16) for e in ef)
    # a second exchange starts from each replica's own residual
    _, again, ef2 = grad_fn(params, batch, ef)
    assert float((again["w"] - exact).abs().max() / exact.abs().max()) < 0.02
    assert not torch.equal(ef2[0]["w"], ef[0]["w"])


def test_error_feedback_is_unbiased_over_steps():
    """The running mean of 50 compressed gradients, each step's residual
    added to the next, is the true gradient within 2e-2."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(100,)).astype(np.float32))
    ef = torch.zeros(100)
    tot = torch.zeros(100)
    for _ in range(50):
        gf = g_true + ef
        scale = gf.abs().max() / 127.0
        deq = dequantize_int8(quantize_int8(gf, scale), scale)
        ef = gf - deq
        tot += deq
    np.testing.assert_allclose((tot / 50).numpy(), g_true.numpy(),
                               atol=2e-2)

"""The port's fused quantized-KV decode (partials and combine in one op)
on the CPU, against the JAX package's ``flash_decode_quant_partials``
followed by its ``flash_combine``, both Pallas kernels in interpret mode.
Inputs are made with numpy from a seed, quantized once by the reference's
``Quantizer`` and handed to both packages as the same codes and scales.

The Pallas kernel needs the cache padded to whole splits of whole 128-row
blocks, as ``tests/test_torch_decode.py`` pads it; the pad rows lie past
kv_len, so they are masked.  q is bfloat16, as on the main path; the
output is float32, so the two are compared before any output rounding.

Tolerance: ``AB_ATOL`` (2e-2), the reference's own bound between its
fused and unfused quantized decode (the same f32 math summed in another
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.kernels.flash_combine import flash_combine as j_combine
from repro.kernels.flash_decode import \
    flash_decode_quant_partials as j_partials
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_decode_quant as fdq
from repro_torch.quant import AB_ATOL

# tests/test_torch_decode.py's shapes: b, hkv, g, d, length, s, kv_len
SHAPES = [
    (1, 2, 8, 128, 384, 1, [300]),            # S = 1: no combine
    (2, 2, 8, 128, 1024, 8, [1000, 450]),     # the main path's shape
    (1, 2, 8, 128, 256, 4, [200]),            # S > blocks: 2 empty splits
    (1, 2, 8, 64, 640, 8, [600]),             # D = 64, S > blocks
    (2, 4, 1, 64, 384, 3, [384, 5]),          # G = 1
    (1, 1, 16, 128, 512, 2, [511]),           # G = 16
    (2, 2, 8, 128, 512, 3, [1, 300]),         # kv_len = 1
    (1, 1, 64, 128, 256, 2, [200]),           # G = 64 (Table 1, H_KV 1)
    (2, 1, 32, 128, 256, 1, [256, 77]),       # G = 32 (Table 1, H_KV 2)
    (1, 2, 4, 160, 256, 2, [250]),            # D = 160 (stablelm-12b)
    (1, 1, 8, 256, 256, 3, [180]),            # D = 256, S > blocks
]


def _inputs(rng, b, hkv, g, d, length, kv_dtype):
    """bf16 q (b, hkv, g, d), pre-scaled, and the quantized cache (k, v,
    k_scale, v_scale) as numpy arrays."""
    q = (rng.standard_normal((b, hkv, g, d), np.float32) * d ** -0.5
         ).astype(jnp.bfloat16)
    k = rng.standard_normal((b, length, hkv, d), np.float32)
    v = rng.standard_normal((b, length, hkv, d), np.float32)
    art = jquant.Quantizer.from_kv_dtype(kv_dtype).quantized_kv(
        jnp.asarray(k), jnp.asarray(v))
    return q, tuple(np.asarray(a) for a in art)


def _reference(q, art, lens, s):
    """JAX partials then JAX combine (f32 out), the cache zero-padded to S
    whole splits of 128-row blocks."""
    length = art[0].shape[1]
    nblk = -(-length // 128)
    pad = ((0, 0), (0, -(-nblk // s) * s * 128 - length))
    k, v, ks, vs = (jnp.pad(jnp.asarray(a), pad + ((0, 0),) * (a.ndim - 2))
                    for a in art)
    acc, l, m = j_partials(jnp.asarray(q), k, v, ks, vs, jnp.asarray(lens),
                           num_splits=s, interpret=True)
    return np.asarray(j_combine(acc, l, m, out_dtype=jnp.float32,
                                interpret=True))


def _port(q, art, lens, s):
    out = fdq.flash_decode_quant(
        tensor_from_numpy(q), *(tensor_from_numpy(a) for a in art),
        torch.from_numpy(lens), num_splits=s, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == q.shape
    return out.numpy()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("b,hkv,g,d,length,s,lens", SHAPES)
def test_fused_quant_decode_matches_pallas_partials_and_combine(
        b, hkv, g, d, length, s, lens, kv_dtype):
    rng = np.random.default_rng(length + 10 * s + g)
    q, art = _inputs(rng, b, hkv, g, d, length, kv_dtype)
    lens = np.asarray(lens, np.int32)
    np.testing.assert_allclose(_port(q, art, lens, s),
                               _reference(q, art, lens, s),
                               rtol=0, atol=AB_ATOL[kv_dtype])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_poisoned_tail_does_not_reach_the_output(kv_dtype):
    """Rows past kv_len hold codes 127 / -127 and scales 1e4 (the
    reference's poisoned-tail oracle): the output is the clean cache's,
    held against the Pallas kernels on the clean cache."""
    rng = np.random.default_rng(7)
    b, hkv, g, d, length, s = 2, 2, 8, 128, 512, 3
    q, art = _inputs(rng, b, hkv, g, d, length, kv_dtype)
    lens = np.asarray([300, 77], np.int32)
    tail = np.arange(length)[None, :] >= lens[:, None]
    k, v, ks, vs = (a.copy() for a in art)
    k[tail] = np.asarray(127, np.float32).astype(k.dtype)
    v[tail] = np.asarray(-127, np.float32).astype(v.dtype)
    ks[tail] = 1e4
    vs[tail] = 1e4
    np.testing.assert_allclose(_port(q, (k, v, ks, vs), lens, s),
                               _reference(q, art, lens, s),
                               rtol=0, atol=AB_ATOL[kv_dtype])


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    """On the CPU the fused op is decode_quant_plain (partials, then
    combine), bit for bit, and counts no launch."""
    rng = np.random.default_rng(3)
    q, art = _inputs(rng, 2, 2, 8, 64, 384, "int8")
    q = tensor_from_numpy(q)
    art = [tensor_from_numpy(a) for a in art]
    lens = torch.tensor([384, 100])
    before = dict(build.LAUNCHES)
    got = fdq.flash_decode_quant(q, *art, lens, num_splits=2)
    assert dict(build.LAUNCHES) == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fdq.decode_quant_plain(q, *art, lens,
                                                   num_splits=2))


def test_quantized_op_shares_the_decode_workspace():
    """The quantized cache's fused kernel takes its partials and counters
    from the bf16 kernel's pool, one set per (device, stream)."""
    dev = torch.device("cpu")
    shape = (3, 2, 2, 8, 64)             # S, B, Hkv, G, D
    try:
        assert fdq.fused_workspace is fd.fused_workspace
        mine = fdq.fused_workspace(dev, 11, *shape)
        assert fd.fused_workspace(dev, 11, *shape) == mine
        n = 3 * 2 * 2 * 8
        assert mine[2] - mine[1] == 4 * n        # m right after l
        assert fd._WORKSPACE[(dev, 11, "acc")].numel() == n * 64
        assert not fd._WORKSPACE[(dev, 11, "counters")].any()
        other = fdq.fused_workspace(dev, 12, *shape)
        assert not set(other) & set(mine)
    finally:
        for stream in (11, 12):
            for name in ("acc", "lm", "counters"):
                fd._WORKSPACE.pop((dev, stream, name), None)

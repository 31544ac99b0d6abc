"""The port's fused split-KV decode (partials and combine in one op) on the
CPU, against the JAX package's ``flash_decode_partials`` followed by its
``flash_combine``, both Pallas kernels in interpret mode.  Inputs are made
with numpy from a seed and handed to both packages.

The Pallas decode kernel needs the cache padded to whole splits of whole
128-row blocks, as ``repro.kernels.ops`` pads it; the pad rows lie past
kv_len, so they are masked, and a split of the port with no block (S
greater than the block count) matches a Pallas split of pad rows only.

Tolerances: bfloat16 2e-2 (inputs and output rounded to 8 mantissa
bits); float32 1e-5 (the same math summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_combine import flash_combine as j_combine
from repro.kernels.flash_decode import flash_decode_partials as j_partials
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as fd

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(rng, b, hkv, g, d, length):
    q = rng.standard_normal((b, hkv, g, d), np.float32) * d ** -0.5
    k = rng.standard_normal((b, length, hkv, d), np.float32)
    v = rng.standard_normal((b, length, hkv, d), np.float32)
    return q, k, v


def _reference(q, k, v, lens, s, dtype):
    """JAX partials then JAX combine, the cache zero-padded to S whole
    splits of 128-row blocks."""
    jd = DTYPES[dtype][0]
    nblk = -(-k.shape[1] // 128)
    pad = -(-nblk // s) * s * 128 - k.shape[1]
    kp, vp = (np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0))) for x in (k, v))
    acc, l, m = j_partials(jnp.asarray(q).astype(jd),
                           jnp.asarray(kp).astype(jd),
                           jnp.asarray(vp).astype(jd), jnp.asarray(lens),
                           num_splits=s, interpret=True)
    return np.asarray(j_combine(acc, l, m, out_dtype=jd, interpret=True),
                      np.float32)


def _port(q, k, v, lens, s, dtype):
    td = DTYPES[dtype][1]
    out = fd.flash_decode(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                          torch.from_numpy(lens), num_splits=s)
    assert out.dtype == td and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hkv,g,d,length,s,lens", [
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
])
def test_fused_decode_matches_pallas_partials_and_combine(
        b, hkv, g, d, length, s, lens, dtype):
    rng = np.random.default_rng(length + 10 * s + g)
    q, k, v = _inputs(rng, b, hkv, g, d, length)
    lens = np.asarray(lens, np.int32)
    np.testing.assert_allclose(_port(q, k, v, lens, s, dtype),
                               _reference(q, k, v, lens, s, dtype),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_poisoned_tail_does_not_reach_the_output(dtype):
    """Rows past kv_len hold 1e4 in K and V: the output is the clean
    cache's, held against the Pallas kernels on the clean cache."""
    rng = np.random.default_rng(7)
    b, hkv, g, d, length, s = 2, 2, 8, 128, 512, 3
    q, k, v = _inputs(rng, b, hkv, g, d, length)
    lens = np.asarray([300, 77], np.int32)
    tail = np.arange(length)[None, :] >= lens[:, None]
    kp, vp = k.copy(), v.copy()
    kp[tail] = 1e4
    vp[tail] = -1e4
    np.testing.assert_allclose(_port(q, kp, vp, lens, s, dtype),
                               _reference(q, k, v, lens, s, dtype),
                               rtol=TOLS[dtype], atol=TOLS[dtype])


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    """On the CPU the wrapper is decode_plain (partials, then combine),
    bit for bit, and counts no launch."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x) for x in _inputs(rng, 2, 2, 8, 64, 384))
    lens = torch.tensor([384, 100])
    before = dict(build.LAUNCHES)
    got = fd.flash_decode(q, k, v, lens, num_splits=2,
                          out_dtype=torch.bfloat16)
    assert dict(build.LAUNCHES) == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fd.decode_plain(q, k, v, lens, num_splits=2,
                                            out_dtype=torch.bfloat16))


def test_workspace_is_kept_and_grown_on_demand():
    """The fused kernel's partials and counters are allocated once per
    device, stream and name, reused while they fit, grown when they do
    not."""
    dev = torch.device("cpu")
    try:
        a = fd._workspace(dev, 0, "test", 10, torch.int32)
        assert a.numel() == 10 and not a.any()
        assert fd._workspace(dev, 0, "test", 7, torch.int32) is a
        b = fd._workspace(dev, 0, "test", 11, torch.int32)
        assert b.numel() == 20 and not b.any()
        assert fd._workspace(dev, 0, "test", 20, torch.int32) is b
    finally:
        fd._WORKSPACE.pop((dev, 0, "test"), None)


def test_workspace_is_one_per_stream():
    """Launches on two streams never share counters or partials."""
    dev = torch.device("cpu")
    try:
        a = fd._workspace(dev, 1, "test", 8, torch.int32)
        b = fd._workspace(dev, 2, "test", 8, torch.int32)
        assert a is not b and a.data_ptr() != b.data_ptr()
        assert fd._workspace(dev, 1, "test", 8, torch.int32) is a
    finally:
        for stream in (1, 2):
            fd._WORKSPACE.pop((dev, stream, "test"), None)

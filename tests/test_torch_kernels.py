"""The port's attention ops (their plain PyTorch path, on the CPU) against
the JAX package's Pallas kernels in interpret mode, on the grids of
tests/test_kernels.py.  Inputs are made with numpy from a seed and
handed to both packages.

Tolerances, as in the reference's own kernel tests: float32 2e-5 (the
same math summed in another order); bfloat16 2e-2 for decode and 3e-2
for prefill (inputs and outputs rounded to 8 mantissa bits).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scheduler_metadata import get_scheduler_metadata
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode_partials as j_partials
from repro.kernels.flash_prefill import flash_prefill as j_prefill
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_combine import flash_combine
from repro_torch.kernels.flash_decode import flash_decode_partials
from repro_torch.plan import AttentionSpec, Planner

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _plan(b, lk, hq, hkv, d, s, bucket=None):
    return Planner(num_splits_override=s).plan(
        AttentionSpec.decode(b, lk, hq, hkv, d), bucket=bucket)


DECODE_GRID = [
    (1, 1, 8, 128, 1),
    (1, 1, 8, 512, 3),        # the paper's target shape (B=1, MQA, L=512)
    (1, 2, 4, 512, 3),        # H_KV=2 row of Table 1
    (2, 2, 2, 384, 1),
    (1, 1, 4, 1024, 4),
    (2, 4, 1, 256, 2),        # MHA-style (g=1)
    (1, 1, 1, 2048, 8),
    (1, 1, 64, 256, 2),       # Table 1's H_KV=1 row (G=64)
    (2, 1, 32, 256, 1),       # Table 1's H_KV=2 row (G=32)
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hkv,g,lk,s", DECODE_GRID)
def test_decode_matches_pallas_kernel(b, hkv, g, lk, s, dtype):
    rng = np.random.default_rng(b * 7 + lk)
    d, hq = 128, hkv * g
    jq, tq = _both(rng.standard_normal((b, hq, d), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((b, lk, hkv, d), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((b, lk, hkv, d), np.float32), dtype)
    lens = rng.integers(1, lk + 1, size=b).astype(np.int32)
    want = jops.decode_attention(
        jq, jk, jv, jnp.asarray(lens), impl="pallas", interpret=True,
        metadata=get_scheduler_metadata(b, 1, lk, hq, hkv, d,
                                        num_splits_override=s))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    tlens = torch.from_numpy(lens)

    got = ops.decode_attention(tq, tk, tv, tlens,
                               plan=_plan(b, lk, hq, hkv, d, s))
    assert got.dtype == tq.dtype and got.shape == (b, hq, d)
    _close(got, want, tol)

    # the two kernels directly: partials over s splits, then the combine
    qp = (tq.float() * d ** -0.5).to(tq.dtype).reshape(b, hkv, g, d)
    acc, l, m = flash_decode_partials(qp, tk, tv, tlens, num_splits=s)
    assert acc.shape == (s, b, hkv, g, d) and l.shape == (s, b, hkv, g)
    out = flash_combine(acc, l, m, out_dtype=tq.dtype)
    _close(out.reshape(b, hq, d), want, tol)


@pytest.mark.parametrize("b,hkv,g,lk,s,lens", [
    (1, 2, 8, 512, 3, [512]),       # 4 blocks in 3 splits: split 2 empty
    (2, 2, 4, 640, 5, [600, 70]),   # ragged: most of slot 1's splits masked
])
def test_partials_match_pallas_partials(b, hkv, g, lk, s, lens):
    """Split by split, the port's partition and partials equal the
    Pallas kernel's (fed the cache padded to whole splits, as
    ops._decode_pallas does); empty splits hold m = -1e30, l = 0."""
    rng = np.random.default_rng(lk + s)
    d = 128
    q = (rng.standard_normal((b, hkv, g, d), np.float32) * d ** -0.5)
    k = rng.standard_normal((b, lk, hkv, d), np.float32)
    v = rng.standard_normal((b, lk, hkv, d), np.float32)
    nblk = -(-lk // 128)
    pad = (-(-nblk // s) * s) * 128 - lk
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    lens = np.asarray(lens, np.int32)
    wacc, wl, wm = j_partials(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(lens),
                              num_splits=s)
    acc, l, m = flash_decode_partials(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), num_splits=s)
    _close(acc, wacc, 2e-5)
    _close(l, wl, 2e-5)
    _close(m, wm, 2e-5)
    assert (m.numpy() >= ref.NEG_INF).all() and np.isfinite(m.numpy()).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucket_view_equals_full_cache(dtype):
    """Attending over the plan's bucket view k[:, :bucket] of a longer
    cache is the same function as JAX attending the whole cache: rows at
    or past kv_len are masked either way."""
    rng = np.random.default_rng(5)
    b, hkv, g, d, cap, bucket = 2, 2, 8, 128, 1024, 384
    hq = hkv * g
    jq, tq = _both(rng.standard_normal((b, hq, d), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((b, cap, hkv, d), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((b, cap, hkv, d), np.float32), dtype)
    lens = np.asarray([300, 384], np.int32)
    want = jops.decode_attention(
        jq, jk, jv, jnp.asarray(lens), impl="pallas", interpret=True,
        metadata=get_scheduler_metadata(b, 1, cap, hq, hkv, d,
                                        num_splits_override=8))
    plan = _plan(b, bucket, hq, hkv, d, 3, bucket=bucket)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens), plan=plan)
    _close(got, want, 2e-2 if dtype == "bfloat16" else 2e-5)


def test_inline_policy_is_counted():
    """No frozen plan: the policy runs inside the call and is counted;
    a frozen plan leaves the counter alone."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 16, 128), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 512, 2, 128), np.float32))
    lens = torch.tensor([400])
    ops.reset_policy_eval_count()
    a = ops.decode_attention(q, k, k, lens, plan=_plan(1, 512, 16, 2, 128, 3))
    assert ops.policy_eval_count() == 0
    b = ops.decode_attention(q, k, k, lens)
    assert ops.policy_eval_count() == 1
    want = ref.naive_decode_attention(q, k, k, lens)
    torch.testing.assert_close(a, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(b, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,lq,lk,window,offset", [
    (1, 4, 1, 128, 128, None, 0),
    (2, 4, 2, 256, 256, None, 0),
    (1, 8, 8, 128, 128, None, 0),          # MHA
    (1, 4, 1, 200, 200, None, 0),          # non-multiple of block
    (1, 4, 1, 256, 256, 64, 0),            # local window
    (1, 4, 1, 256, 256, 100, 0),           # window edge inside a tile
    (1, 2, 1, 64, 320, None, 256),         # chunked prefill offset
])
def test_prefill_matches_pallas_kernel(b, hq, hkv, lq, lk, window, offset,
                                       dtype):
    rng = np.random.default_rng(lq + lk)
    d = 64
    jq, tq = _both(rng.standard_normal((b, lq, hq, d), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((b, lk, hkv, d), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((b, lk, hkv, d), np.float32), dtype)
    want = j_prefill(jq, jk, jv, causal=True, window=window,
                     q_offset=offset, interpret=True)
    got = ops.attention(tq, tk, tv, causal=True, window=window,
                        q_offset=offset)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, 3e-2 if dtype == "bfloat16" else 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lq,lk,offset,causal", [
    (130, 130, 0, True),                   # ragged against 64-row tiles
    (100, 356, 256, True),                 # q_offset = Lk - Lq, Lk > Lq
    (130, 130, 0, False),                  # not causal
])
def test_prefill_matches_pallas_kernel_main_widths(lq, lk, offset, causal,
                                                   dtype):
    """qwen2.5-3b's attention widths (16 query heads over 2 KV heads,
    head_dim 128): narrower twins of the shapes the card holds the
    prefill kernel to."""
    rng = np.random.default_rng(lq * 3 + lk)
    b, hq, hkv, d = 1, 16, 2, 128
    jq, tq = _both(rng.standard_normal((b, lq, hq, d), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((b, lk, hkv, d), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((b, lk, hkv, d), np.float32), dtype)
    want = j_prefill(jq, jk, jv, causal=causal, q_offset=offset,
                     interpret=True)
    got = ops.attention(tq, tk, tv, causal=causal, q_offset=offset)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, 3e-2 if dtype == "bfloat16" else 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("b,hq,hkv,lq,lk,window,offset", [
    (1, 4, 2, 130, 130, None, 0),          # causal, ragged against tiles
    (1, 4, 1, 200, 200, 100, 0),           # local window
    (2, 2, 1, 60, 188, None, 128),         # q_offset, ragged Lq
])
def test_prefill_matches_pallas_kernel_wide_heads(b, hq, hkv, lq, lk, window,
                                                  offset, d, dtype):
    """Head dims 160 (stablelm-12b) and 256 (paligemma, recurrentgemma),
    which the prefill kernel takes besides 64 and 128."""
    rng = np.random.default_rng(lq + lk + d)
    jq, tq = _both(rng.standard_normal((b, lq, hq, d), np.float32), dtype)
    jk, tk = _both(rng.standard_normal((b, lk, hkv, d), np.float32), dtype)
    jv, tv = _both(rng.standard_normal((b, lk, hkv, d), np.float32), dtype)
    want = j_prefill(jq, jk, jv, causal=True, window=window,
                     q_offset=offset, interpret=True)
    got = ops.attention(tq, tk, tv, causal=True, window=window,
                        q_offset=offset)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, 3e-2 if dtype == "bfloat16" else 2e-5)


def test_reference_oracles_agree():
    """The port's naive oracles equal the reference's on one input."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 40, 4, 32), np.float32)
    k = rng.standard_normal((2, 40, 2, 32), np.float32)
    want = jref.naive_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(k), causal=True, window=16)
    got = ref.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(k), causal=True, window=16)
    _close(got, want, 2e-5)

"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: run them on a machine with an H100 and nvcc with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Elsewhere every test skips, with the reason from
``repro_torch.kernels.build.available()``.  Whether a card is present is
decided inside the ``cuda`` fixture, never at import or collection, so
every pytest worker collects the same tests.

Tolerances: bf16 2e-2 for decode and 3e-2 for prefill (both kernels'
tensor-core bodies carry P as two bf16 terms in P V),
the prefill backward's dq, dk, dv normwise against the float64 plain
backward: 1e-2 in bf16 (its outputs round to bf16, 2^-9 a value), 1e-5
in float32; the prefill kernel's LSE within 1e-4 of the largest
|LSE| (scores summed in f32 on the tensor cores against float64),
float32 2e-5 for the combine, the f32 decode and the f32 prefill (one
fixed-order sum against another order), ``AB_ATOL`` (2e-2) for the
quantized decode (its tensor-core body also carries P, times each key's
v scale, as two bf16 terms).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_combine import combine_plain, flash_combine
from repro_torch.kernels.flash_decode import (
    decode_partials_plain,
    decode_plain,
    flash_decode,
    flash_decode_partials,
)
from repro_torch.kernels.flash_decode_quant import (
    decode_quant_partials_plain,
    decode_quant_plain,
    flash_decode_quant,
    flash_decode_quant_partials,
)
from repro_torch.kernels.flash_prefill import (
    BWD_LAUNCHES_PER_CALL,
    bwd_cta_slots,
    bwd_work,
    flash_prefill,
    flash_prefill_bwd,
    flash_prefill_lse,
    prefill_backward_plain,
    prefill_lse_plain,
    prefill_plain,
)
from repro_torch.models import build_model
from repro_torch.plan import AttentionSpec, LaunchPlan, Planner, plan_scope
from repro_torch.quant import AB_ATOL, QuantizedKV, Quantizer
from repro_torch.serving import CategoricalSampler, Request, ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    ok, why = build.available()
    if not ok:
        pytest.skip(why)
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("b,hkv,g,d,cap,bucket,s", [
    (1, 2, 8, 128, 2048, 512, 3),
    (2, 2, 8, 128, 2048, 2048, 16),
    (2, 1, 4, 64, 256, 256, 2),
    (3, 4, 2, 128, 640, 640, 5),
])
def test_decode_and_combine_match_plain(cuda, b, hkv, g, d, cap, bucket, s):
    k = _rand(cuda, (b, cap, hkv, d))
    v = _rand(cuda, (b, cap, hkv, d))
    q = _rand(cuda, (b, hkv, g, d))
    lens = torch.randint(1, bucket + 1, (b,), device="cuda",
                         generator=cuda, dtype=torch.int32)
    kv, vv = k[:, :bucket], v[:, :bucket]
    got = flash_decode_partials(q, kv, vv, lens, num_splits=s)
    want = decode_partials_plain(q, kv, vv, lens, num_splits=s)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(
        flash_combine(*got, out_dtype=torch.float32),
        combine_plain(*got, out_dtype=torch.float32), rtol=2e-5, atol=2e-5)
    out = flash_combine(*got, out_dtype=torch.bfloat16)
    torch.testing.assert_close(
        out.reshape(b, hkv * g, d).float(),
        ref.naive_decode_attention(q.reshape(b, hkv * g, d), kv, vv, lens,
                                   scale=1.0).float(), rtol=2e-2, atol=2e-2)
    again = flash_combine(*flash_decode_partials(q, kv, vv, lens,
                                                 num_splits=s),
                          out_dtype=torch.bfloat16)
    assert torch.equal(again, out)          # same split, same bits


@pytest.mark.parametrize("b,hkv,g,d,cap,bucket,s", [
    (1, 2, 8, 128, 2048, 512, 3),
    (2, 2, 8, 128, 2048, 2048, 16),
    (2, 1, 4, 64, 256, 256, 2),
    (3, 4, 2, 128, 640, 640, 5),
    (2, 1, 16, 128, 1024, 1024, 8),   # G = 16: all 16 rows of M used
    (2, 4, 1, 128, 640, 640, 3),      # G = 1: 15 rows of M are padding
    (2, 2, 8, 64, 1024, 1024, 1),     # D = 64, S = 1: no combine
    (2, 2, 8, 128, 2048, 384, 1),     # the serving run's 384 bucket
    (1, 2, 8, 128, 2048, 512, 6),     # S > blocks: two empty splits
])
def test_fused_decode_matches_plain(cuda, b, hkv, g, d, cap, bucket, s):
    """The tensor-core kernel with its combine epilogue against the
    plain partials and combine; three calls give the same bits."""
    k = _rand(cuda, (b, cap, hkv, d))
    v = _rand(cuda, (b, cap, hkv, d))
    q = _rand(cuda, (b, hkv, g, d))
    lens = torch.randint(1, bucket + 1, (b,), device="cuda",
                         generator=cuda, dtype=torch.int32)
    kv, vv = k[:, :bucket], v[:, :bucket]
    got = flash_decode(q, kv, vv, lens, num_splits=s)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hkv, g, d)
    torch.testing.assert_close(
        got.float(), decode_plain(q, kv, vv, lens, num_splits=s).float(),
        rtol=2e-2, atol=2e-2)
    for _ in range(2):
        assert torch.equal(flash_decode(q, kv, vv, lens, num_splits=s), got)


def test_fused_decode_at_kv_len_one(cuda):
    """One valid row: the output is that row of V in every query head."""
    k = _rand(cuda, (2, 1024, 2, 128))
    v = _rand(cuda, (2, 1024, 2, 128))
    q = _rand(cuda, (2, 2, 8, 128))
    lens = torch.tensor([1, 1], device="cuda", dtype=torch.int32)
    for s in (1, 8):
        got = flash_decode(q, k, v, lens, num_splits=s)
        torch.testing.assert_close(
            got, v[:, 0, :, None, :].expand(2, 2, 8, 128), rtol=0, atol=0)


def test_fused_decode_f32_query_over_a_bf16_cache(cuda):
    """An f32 model over a bf16 cache takes the CUDA-core body with the
    same epilogue: f32 out, exact to 2e-5, with S = 1 and S > 1."""
    k = _rand(cuda, (2, 640, 2, 128))
    v = _rand(cuda, (2, 640, 2, 128))
    q = _rand(cuda, (2, 2, 8, 128), torch.float32)
    lens = torch.tensor([600, 33], device="cuda", dtype=torch.int32)
    for s in (1, 5):
        got = flash_decode(q, k, v, lens, num_splits=s)
        assert got.dtype == torch.float32
        torch.testing.assert_close(
            got, decode_plain(q, k, v, lens, num_splits=s), rtol=2e-5,
            atol=2e-5)


@pytest.mark.parametrize("s", [1, 3])
def test_fused_decode_never_reads_a_nan_tail(cuda, s):
    """Rows past kv_len hold NaN and Inf: the kernel never loads them, so
    the output has the clean cache's bits."""
    k = _rand(cuda, (2, 512, 2, 128))
    v = _rand(cuda, (2, 512, 2, 128))
    q = _rand(cuda, (2, 2, 8, 128))
    lens = torch.tensor([300, 77], device="cuda", dtype=torch.int32)
    tail = torch.arange(512, device="cuda")[None] >= lens[:, None]
    kp, vp = k.clone(), v.clone()
    kp[tail] = float("nan")
    vp[tail] = float("inf")
    got = flash_decode(q, kp, vp, lens, num_splits=s)
    assert torch.equal(got, flash_decode(q, k, v, lens, num_splits=s))
    torch.testing.assert_close(
        got.float(), decode_plain(q, k, v, lens, num_splits=s).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("s", [33, 40, 64])
def test_fused_decode_merges_more_splits_than_one_chunk(cuda, s):
    """S > 32: the last CTA finds m* over all splits first, then merges
    the partials 32 at a time.  An 8192-row view (64 blocks); kv_len 5000
    leaves the splits past row 5000 with no valid row, S = 33 and 40 have
    splits past the view's end; tails hold NaN and Inf; three calls give
    the same bits."""
    k = _rand(cuda, (2, 8192, 2, 128))
    v = _rand(cuda, (2, 8192, 2, 128))
    q = _rand(cuda, (2, 2, 8, 128))
    lens = torch.tensor([5000, 8192], device="cuda", dtype=torch.int32)
    tail = torch.arange(8192, device="cuda")[None] >= lens[:, None]
    kp, vp = k.clone(), v.clone()
    kp[tail] = float("nan")
    vp[tail] = float("inf")
    got = flash_decode(q, kp, vp, lens, num_splits=s)
    torch.testing.assert_close(
        got.float(), decode_plain(q, k, v, lens, num_splits=s).float(),
        rtol=2e-2, atol=2e-2)
    for _ in range(2):
        assert torch.equal(flash_decode(q, kp, vp, lens, num_splits=s), got)


@pytest.mark.parametrize("b,bucket,s", [(2, 1024, 8), (2, 384, 1),
                                         (1, 512, 3)])
def test_fused_decode_over_large_values_and_few_dominant_keys(cuda, b,
                                                               bucket, s):
    """The full-width model's regime: V entries of ~100, the top scores a
    few units apart, so an output is a short sum of large V entries.
    Rounding P to one bf16 term misses 2e-2 here; the kernel's two terms
    stay within it."""
    k = _rand(cuda, (b, 2048, 2, 128)) * 10
    v = _rand(cuda, (b, 2048, 2, 128)) * 100
    q = _rand(cuda, (b, 2, 8, 128)) * 0.08
    lens = torch.tensor([bucket - 24, bucket // 2 + 3][:b], device="cuda",
                        dtype=torch.int32)
    kv, vv = k[:, :bucket], v[:, :bucket]
    got = flash_decode(q, kv, vv, lens, num_splits=s)
    torch.testing.assert_close(
        got.float(), decode_plain(q, kv, vv, lens, num_splits=s).float(),
        rtol=2e-2, atol=2e-2)


def test_fused_decode_same_bits_across_alternating_calls(cuda):
    """Calls that alternate the split count and the batch give the bits
    of their first call: every launch leaves the counters at zero."""
    k = _rand(cuda, (2, 2048, 2, 128))
    v = _rand(cuda, (2, 2048, 2, 128))
    q = _rand(cuda, (2, 2, 8, 128))
    lens = torch.tensor([1000, 450], device="cuda", dtype=torch.int32)
    calls = [(2, 1024, 8), (1, 512, 3), (2, 1152, 9), (2, 384, 1),
             (1, 1024, 8), (2, 2048, 16)]

    def run(b, bucket, s):
        return flash_decode(q[:b], k[:b, :bucket], v[:b, :bucket],
                            lens[:b].clamp(max=bucket), num_splits=s)

    first = [run(*c) for c in calls]
    for _ in range(2):
        for c, want in zip(calls, first):
            assert torch.equal(run(*c), want), c


def test_bf16_engine_decodes_through_the_fused_kernel_alone(cuda):
    """A bf16 model over a bf16 cache, 36 layers: each decode step
    launches the decode kernel once per layer and the combine never."""
    cfg = reduced_config("qwen2.5-3b", num_layers=36, d_model=256)
    model = build_model(cfg, device="cuda")
    eng = ServingEngine(model, ServeConfig(model=cfg), max_len=256,
                        batch_slots=2, device="cuda")
    eng.load(model.init_params(0))
    ops.reset_launch_counts()
    for i, n in enumerate((3, 140, 9)):
        eng.submit(Request(i, [(5 * i + j) % 250 + 1 for j in range(n)],
                           max_new_tokens=6))
    done = eng.drain()
    counts = ops.launch_counts()
    steps = sum(v for k, v in eng.stats.launches.items()
                if isinstance(k, int))
    assert [len(c.tokens) for c in done] == [6, 6, 6]
    assert steps > 0
    assert counts["flash_decode"] == 36 * steps
    assert counts["flash_combine"] == 0
    assert counts["flash_decode_quant"] == 0


# The shapes the prefill kernel's tiling (64 query rows x 64 keys) cares
# about; chip_smoke.py's PREFILL_CASES is the same list.
PREFILL_CASES = [(1, L, L, 16, 2, 128, None, 0, True)
                 for L in (128, 384, 512, 1024)] + [   # main-path buckets
    (1, 37, 37, 16, 2, 128, None, 0, True),       # ragged real prompts
    (1, 1000, 1000, 16, 2, 128, None, 0, True),
    (2, 200, 200, 16, 2, 128, None, 0, True),     # B=2
    (1, 200, 200, 16, 2, 128, None, 0, True),
    (1, 256, 256, 8, 8, 128, None, 0, True),      # MHA
    (1, 256, 256, 4, 1, 64, 100, 0, True),        # D=64, window off-tile
    (1, 256, 256, 4, 1, 64, 64, 0, True),         # D=64, window on-tile
    (1, 512, 512, 16, 2, 128, 128, 0, True),
    (1, 64, 320, 16, 2, 128, None, 256, True),    # q_offset = Lk - Lq
    (1, 64, 320, 2, 1, 64, None, 256, True),      # D=64, group of 2
    (1, 100, 1124, 16, 2, 128, None, 1024, True),
    (1, 300, 300, 16, 2, 128, None, 0, False),    # not causal
]


def _prefill_inputs(gen, b, lq, lk, hq, hkv, d, dtype):
    q = (_rand(gen, (b, lq, hq, d), torch.float32) * d ** -0.5).to(dtype)
    return q, _rand(gen, (b, lk, hkv, d), dtype), _rand(gen, (b, lk, hkv, d),
                                                        dtype)


@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,window,offset,causal",
                         PREFILL_CASES)
def test_prefill_matches_plain(cuda, b, lq, lk, hq, hkv, d, window, offset,
                               causal):
    """The bf16 (tensor-core) kernel against the plain version; the same
    inputs give the same bits."""
    q, k, v = _prefill_inputs(cuda, b, lq, lk, hq, hkv, d, torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=offset)
    got = flash_prefill(q, k, v, **kw)
    want = prefill_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)
    assert torch.equal(flash_prefill(q, k, v, **kw), got)


@pytest.mark.parametrize("b,lq,lk,offset", [(1, 1024, 1024, 0),
                                            (2, 200, 200, 0),
                                            (1, 64, 320, 256)])
def test_prefill_over_large_values_and_few_dominant_keys(cuda, b, lq, lk,
                                                         offset):
    """The full-width model's regime (V entries of ~100, the top scores a
    few units apart): P rounded to one bf16 term misses 3e-2 here; the
    kernel's two terms stay within it."""
    q, k, v = _prefill_inputs(cuda, b, lq, lk, 16, 2, 128, torch.float32)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k * 10, v * 100))
    got = flash_prefill(q, k, v, causal=True, q_offset=offset)
    torch.testing.assert_close(
        got.float(), prefill_plain(q, k, v, causal=True,
                                   q_offset=offset).float(),
        rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,window,offset,causal", [
    (1, 200, 200, 16, 2, 128, None, 0, True),
    (1, 256, 256, 4, 1, 64, 100, 0, True),
])
def test_prefill_f32_matches_plain(cuda, b, lq, lk, hq, hkv, d, window,
                                   offset, causal):
    """f32 inputs take the CUDA-core instantiation, exact to 2e-5."""
    q, k, v = _prefill_inputs(cuda, b, lq, lk, hq, hkv, d, torch.float32)
    kw = dict(causal=causal, window=window, q_offset=offset)
    torch.testing.assert_close(flash_prefill(q, k, v, **kw),
                               prefill_plain(q, k, v, **kw), rtol=2e-5,
                               atol=2e-5)


def test_decode_takes_f32_queries_over_a_bf16_cache(cuda):
    """An f32 model over the default bf16 cache: q and the cache differ."""
    k = _rand(cuda, (2, 640, 2, 128))
    v = _rand(cuda, (2, 640, 2, 128))
    q = _rand(cuda, (2, 2, 8, 128), torch.float32)
    lens = torch.tensor([600, 33], device="cuda", dtype=torch.int32)
    got = flash_decode_partials(q, k, v, lens, num_splits=5)
    want = decode_partials_plain(q, k, v, lens, num_splits=5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=2e-5, atol=2e-5)


def _poisoned_cache(gen, b, cap, hkv, d, lens, kv_dtype, mul=(1.0, 1.0)):
    """A quantized cache whose rows past kv_len hold data 127 and scales
    1e4, as the reference's poisoned-tail oracle; K and V are drawn from
    normals of standard deviations ``mul`` before quantization."""
    art = Quantizer.from_kv_dtype(kv_dtype).quantized_kv(
        _rand(gen, (b, cap, hkv, d), torch.float32) * mul[0],
        _rand(gen, (b, cap, hkv, d), torch.float32) * mul[1])
    tail = torch.arange(cap, device="cuda")[None] >= lens[:, None]
    k, v, ks, vs = (t.clone() for t in art)
    for x, val in ((k, 127.0), (v, -127.0)):     # through the raw bytes
        x.view(torch.uint8)[tail] = torch.tensor(
            val, device="cuda").to(x.dtype).view(torch.uint8)
    ks[tail] = 1e4
    vs[tail] = 1e4
    return QuantizedKV(k, v, ks, vs)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("b,hkv,g,d,cap,bucket,s,qdt", [
    (1, 2, 8, 128, 2048, 512, 3, torch.bfloat16),
    (2, 2, 8, 128, 2048, 2048, 16, torch.bfloat16),
    (2, 1, 4, 64, 256, 256, 2, torch.float32),
    (3, 4, 2, 128, 640, 640, 5, torch.float32),
])
def test_decode_quant_matches_plain(cuda, kv_dtype, b, hkv, g, d, cap,
                                    bucket, s, qdt):
    """The quantized cache's kernel (bf16 q on the tensor cores, f32 q on
    the CUDA cores) over poisoned tails: its partials-only epilogue and
    its fused combine against the plain versions; the same split gives
    the same bits."""
    lens = torch.randint(1, bucket + 1, (b,), device="cuda",
                         generator=cuda, dtype=torch.int32)
    art = _poisoned_cache(cuda, b, cap, hkv, d, lens, kv_dtype)
    view = QuantizedKV(*(t[:, :bucket] for t in art))    # strided views
    q = _rand(cuda, (b, hkv, g, d), qdt)
    got = flash_decode_quant_partials(q, *view, lens, num_splits=s)
    want = decode_quant_partials_plain(q, *view, lens, num_splits=s)
    tol = AB_ATOL[kv_dtype]
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, w, rtol=tol, atol=tol)
    out = flash_combine(*got, out_dtype=torch.float32)
    qz = Quantizer.from_kv_dtype(kv_dtype)
    torch.testing.assert_close(
        out.reshape(b, hkv * g, d),
        ref.naive_decode_attention(
            q.float().reshape(b, hkv * g, d),
            qz.dequantize(view.k, view.k_scale),
            qz.dequantize(view.v, view.v_scale), lens, scale=1.0),
        rtol=tol, atol=tol)
    again = flash_combine(*flash_decode_quant_partials(
        q, *view, lens, num_splits=s), out_dtype=torch.float32)
    assert torch.equal(again, out)          # same split, same bits
    fused = flash_decode_quant(q, *view, lens, num_splits=s)
    assert fused.dtype == qdt and fused.shape == (b, hkv, g, d)
    torch.testing.assert_close(
        fused.float(),
        decode_quant_plain(q, *view, lens, num_splits=s).float(),
        rtol=tol, atol=tol)
    for _ in range(2):
        assert torch.equal(flash_decode_quant(q, *view, lens, num_splits=s),
                           fused)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("b,bucket,s", [(2, 1024, 8), (2, 384, 1),
                                         (1, 512, 3)])
def test_fused_decode_quant_over_large_values_and_few_dominant_keys(
        cuda, kv_dtype, b, bucket, s):
    """The full-width model's regime, K x 10 and V x 100 before
    quantization: a dequantized V entry rounded to bf16, or P rounded to
    one bf16 term, misses AB_ATOL here."""
    lens = torch.tensor([bucket - 24, bucket // 2 + 3][:b], device="cuda",
                        dtype=torch.int32)
    art = _poisoned_cache(cuda, b, 2048, 2, 128, lens, kv_dtype,
                          mul=(10.0, 100.0))
    view = QuantizedKV(*(t[:, :bucket] for t in art))
    q = _rand(cuda, (b, 2, 8, 128)) * 0.08
    tol = AB_ATOL[kv_dtype]
    torch.testing.assert_close(
        flash_decode_quant(q, *view, lens, num_splits=s).float(),
        decode_quant_plain(q, *view, lens, num_splits=s).float(),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [33, 40, 64])
def test_fused_decode_quant_merges_more_splits_than_one_chunk(cuda, s):
    """S > 32 over an 8192-row int8 view with kv_len 5000 (splits with no
    valid row, and past the view's end at S = 33 and 40); poisoned tails;
    the same bits again."""
    lens = torch.tensor([5000, 8192], device="cuda", dtype=torch.int32)
    art = _poisoned_cache(cuda, 2, 8192, 2, 128, lens, "int8")
    q = _rand(cuda, (2, 2, 8, 128))
    got = flash_decode_quant(q, *art, lens, num_splits=s)
    torch.testing.assert_close(
        got.float(), decode_quant_plain(q, *art, lens, num_splits=s).float(),
        rtol=AB_ATOL["int8"], atol=AB_ATOL["int8"])
    assert torch.equal(flash_decode_quant(q, *art, lens, num_splits=s), got)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_fused_decode_quant_at_kv_len_one(cuda, kv_dtype):
    """One valid row: every query head's output is that row of V,
    dequantized, to within the two bf16 terms that carry p times the v
    scale (about 2^-17 of it)."""
    lens = torch.tensor([1, 1], device="cuda", dtype=torch.int32)
    art = _poisoned_cache(cuda, 2, 1024, 2, 128, lens, kv_dtype)
    q = _rand(cuda, (2, 2, 8, 128))
    row = Quantizer.from_kv_dtype(kv_dtype).dequantize(art.v[:, :1],
                                                       art.v_scale[:, :1])
    for s in (1, 8):
        got = flash_decode_quant(q, *art, lens, num_splits=s,
                                 out_dtype=torch.float32)
        torch.testing.assert_close(
            got, row[:, 0, :, None, :].expand(2, 2, 8, 128), rtol=1e-5,
            atol=1e-6)


def test_fused_decode_quant_f32_query_over_an_int8_cache(cuda):
    """An f32 model over an int8 cache takes the CUDA-core body with the
    fused epilogue: f32 out, exact to 2e-5, with S = 1 and S > 1."""
    lens = torch.tensor([600, 33], device="cuda", dtype=torch.int32)
    art = _poisoned_cache(cuda, 2, 640, 2, 128, lens, "int8")
    q = _rand(cuda, (2, 2, 8, 128), torch.float32)
    for s in (1, 5):
        got = flash_decode_quant(q, *art, lens, num_splits=s)
        assert got.dtype == torch.float32
        torch.testing.assert_close(
            got, decode_quant_plain(q, *art, lens, num_splits=s), rtol=2e-5,
            atol=2e-5)


def test_fused_decode_quant_same_bits_across_alternating_calls(cuda):
    """Quantized and bf16 decode calls that alternate the split count and
    the batch, on one stream's shared workspace, give the bits of their
    first call: every launch leaves the counters at zero."""
    lens = torch.tensor([1000, 450], device="cuda", dtype=torch.int32)
    art = _poisoned_cache(cuda, 2, 2048, 2, 128, lens, "fp8")
    k = _rand(cuda, (2, 2048, 2, 128))
    q = _rand(cuda, (2, 2, 8, 128))
    calls = [(2, 1024, 8), (1, 512, 3), (2, 1152, 9), (2, 384, 1),
             (1, 1024, 8), (2, 2048, 16)]

    def run(b, bucket, s, quant):
        kv = lens[:b].clamp(max=bucket)
        if quant:
            return flash_decode_quant(q[:b], *(t[:b, :bucket] for t in art),
                                      kv, num_splits=s)
        return flash_decode(q[:b], k[:b, :bucket], k[:b, :bucket], kv,
                            num_splits=s)

    cases = [c + (quant,) for c in calls for quant in (True, False)]
    first = [run(*c) for c in cases]
    for _ in range(2):
        for c, want in zip(cases, first):
            assert torch.equal(run(*c), want), c


def test_cuda_tensors_never_take_the_plain_path(cuda):
    q = _rand(cuda, (1, 2, 8, 96))                 # head_dim 96: no kernel
    k = _rand(cuda, (1, 128, 2, 96))
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode_partials(q, k, k, torch.tensor([5], device="cuda"),
                              num_splits=1)


def test_engine_smoke_on_the_card(cuda):
    """Reduced qwen2.5-3b (head_dim 64) served on the card in float32:
    the kernels carry every launch, and the tokens equal a CPU run of the
    same weights."""
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=256).replace(
        dtype="float32", param_dtype="float32")
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init_params(0)
    reqs = [Request(i, [(5 * i + j) % 250 + 1 for j in range(n)],
                    max_new_tokens=6) for i, n in enumerate((3, 140, 9))]
    tokens = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        eng = ServingEngine(model, ServeConfig(model=cfg,
                                               kv_cache_dtype="float32"),
                            max_len=256, batch_slots=2, device=dev)
        eng.load(params.to(dev))
        ops.reset_launch_counts()
        for r in reqs:
            eng.submit(r)
        tokens[dev] = [c.tokens for c in eng.drain()]
        counts = ops.launch_counts()
        by_shape = ops.launch_counts_by_key("flash_prefill")
        steps = sum(v for k, v in eng.stats.launches.items()
                    if isinstance(k, int))
    assert counts["flash_prefill"] == cfg.num_layers * len(reqs)
    # f32 prompts take the CUDA-core kernel, counted by padded length
    assert by_shape == {("float32", k[1]): cfg.num_layers * v
                        for k, v in eng.stats.launches.items()
                        if isinstance(k, tuple)}
    # the decode kernel merges its own splits: the combine never runs
    assert counts["flash_decode"] == cfg.num_layers * steps
    assert counts["flash_combine"] == 0
    assert tokens["cuda"] == tokens["cpu"]


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_engine_on_the_card(cuda, kv_quant):
    """The same model served under kv_quant: the quantized cache's
    decode kernel carries every decode launch, merging its own splits;
    the bf16 decode kernel and the combine kernel launch never."""
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=256)
    model = build_model(cfg, device="cuda")
    eng = ServingEngine(model, ServeConfig(model=cfg, kv_quant=kv_quant),
                        max_len=256, batch_slots=2, device="cuda")
    eng.load(model.init_params(0))
    ops.reset_launch_counts()
    for i, n in enumerate((3, 140, 9)):
        eng.submit(Request(i, [(5 * i + j) % 250 + 1 for j in range(n)],
                           max_new_tokens=6))
    done = eng.drain()
    counts = ops.launch_counts()
    steps = sum(v for k, v in eng.stats.launches.items()
                if isinstance(k, int))
    assert [len(c.tokens) for c in done] == [6, 6, 6]
    assert counts["flash_decode"] == 0
    assert counts["flash_combine"] == 0
    assert counts["flash_decode_quant"] == cfg.num_layers * steps
    assert counts["flash_prefill"] == cfg.num_layers * 3
    assert {dt for dt, _ in ops.launch_counts_by_key("flash_prefill")} \
        == {"bfloat16"}


# The repair's shapes: G beyond 16 query heads per KV head and head dims
# 160 and 256, which the reference's configs and the paper's Table 1 use
# (chip_smoke.py phase 2 holds the same grid).  S = 1, S = 5 and S = 32
# (one 128-row block a split).
WIDE_GROUPS = (1, 3, 4, 32, 40, 64)
WIDE_DIMS = (128, 160, 256)
WIDE_SHAPES = [(2, 1024, (1000, 333), 1), (2, 2048, (2000, 700), 5),
               (1, 4096, (4000,), 32)]


def _nan_tailed(x, lens, value):
    y = x.clone()
    y[torch.arange(x.shape[1], device="cuda")[None] >= lens[:, None]] = value
    return y


def _check_wide(gen, g, d, shapes, kv_dtype=None, mul=(1.0, 1.0, 1.0),
                hkv=None):
    """The decode kernel over a bf16 cache with NaN / Inf tails or, with
    ``kv_dtype``, the quantized cache's over poisoned tails, at each of
    ``shapes``: within its tolerance of the plain version, and the same
    bits again.  q, K and V are drawn from normals of standard deviations
    ``mul``; ``hkv`` KV heads (default 1 past G 32, else 2)."""
    if hkv is None:
        hkv = 1 if g >= 32 else 2
    q = _rand(gen, (2, hkv, g, d)) * mul[0]
    if kv_dtype is None:
        k = _rand(gen, (2, 4096, hkv, d)) * mul[1]
        v = _rand(gen, (2, 4096, hkv, d)) * mul[2]
    for b, bucket, kv_len, s in shapes:
        lens = torch.tensor(kv_len, device="cuda", dtype=torch.int32)
        if kv_dtype is None:
            kp = _nan_tailed(k[:b], lens, float("nan"))[:, :bucket]
            vp = _nan_tailed(v[:b], lens, float("inf"))[:, :bucket]
            run = functools.partial(flash_decode, q[:b], kp, vp, lens,
                                    num_splits=s)
            want = decode_plain(q[:b], k[:b, :bucket], v[:b, :bucket], lens,
                                num_splits=s)
            tol = 2e-2
        else:
            art = _poisoned_cache(gen, b, 4096, hkv, d, lens, kv_dtype,
                                  mul=mul[1:])
            view = QuantizedKV(*(t[:, :bucket] for t in art))
            run = functools.partial(flash_decode_quant, q[:b], *view, lens,
                                    num_splits=s)
            want = decode_quant_plain(q[:b], *view, lens, num_splits=s)
            tol = AB_ATOL[kv_dtype]
        got = run()
        assert got.shape == (b, hkv, g, d)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        assert torch.equal(run(), got)


@pytest.mark.parametrize("g", WIDE_GROUPS)
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_fused_decode_takes_any_group_and_head_dim(cuda, g, d):
    """Tails hold NaN and Inf; each split count gives the plain version's
    output within 2e-2 and the same bits on a second call."""
    _check_wide(cuda, g, d, WIDE_SHAPES)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("g", WIDE_GROUPS)
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_fused_decode_quant_takes_any_group_and_head_dim(cuda, kv_dtype, g,
                                                         d):
    """Tails hold codes 127 and scales 1e4; each split count gives the
    plain version's output within AB_ATOL and the same bits again."""
    _check_wide(cuda, g, d, WIDE_SHAPES, kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("g", [32, 64])
@pytest.mark.parametrize("bucket,kv_len", [(2048, 2000), (4096, 4000)])
@pytest.mark.parametrize("s", [16, 32])
def test_wide_decode_merges_many_splits_over_large_values(cuda, kv_dtype, g,
                                                          bucket, kv_len, s):
    """G 32 and 64 merging 16 and 32 splits, as Table 1's long cells plan
    them, on the K x 10, V x 100 data, where a dropped or mis-weighted
    split moves an output far past the tolerance."""
    _check_wide(cuda, g, 128, [(1, bucket, (kv_len,), s)], kv_dtype,
                mul=(1.0, 10.0, 100.0))


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("g", [72, 128])
def test_wide_decode_loops_over_groups_past_64(cuda, kv_dtype, g):
    """More than 64 query rows a KV head run in passes of 64 rows."""
    _check_wide(cuda, g, 128, [(2, 1024, (1000, 333), 1),
                               (1, 4096, (4000,), 32)], kv_dtype)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("g", [32, 64])
def test_wide_decode_at_head_dim_64(cuda, kv_dtype, g):
    """D = 64 past 16 query rows a KV head takes the wide bodies."""
    _check_wide(cuda, g, 64, WIDE_SHAPES, kv_dtype)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("s", [1, 3])
def test_wide_decode_over_large_values_and_few_dominant_keys(cuda, d, s):
    """G = 64 on the full-width model's regime (K x 10, V x 100): both
    decode kernels within their tolerances of the plain versions."""
    lens = torch.tensor([484], device="cuda", dtype=torch.int32)
    k = _rand(cuda, (1, 512, 1, d)) * 10
    v = _rand(cuda, (1, 512, 1, d)) * 100
    q = _rand(cuda, (1, 1, 64, d))
    torch.testing.assert_close(
        flash_decode(q, k, v, lens, num_splits=s).float(),
        decode_plain(q, k, v, lens, num_splits=s).float(), rtol=2e-2,
        atol=2e-2)
    for kv_dtype in ("int8", "fp8"):
        art = _poisoned_cache(cuda, 1, 512, 1, d, lens, kv_dtype,
                              mul=(10.0, 100.0))
        tol = AB_ATOL[kv_dtype]
        torch.testing.assert_close(
            flash_decode_quant(q, *art, lens, num_splits=s).float(),
            decode_quant_plain(q, *art, lens, num_splits=s).float(),
            rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("b,lq,lk,hq,hkv,window,offset", [
    (1, 384, 384, 16, 2, None, 0),         # causal
    (1, 300, 300, 8, 2, 100, 0),           # windowed
    (2, 100, 356, 8, 1, None, 256),        # q_offset, ragged Lq
])
def test_prefill_takes_head_dims_160_and_256(cuda, b, lq, lk, hq, hkv,
                                             window, offset, d, dtype, tol):
    q, k, v = _prefill_inputs(cuda, b, lq, lk, hq, hkv, d, dtype)
    kw = dict(causal=True, window=window, q_offset=offset)
    got = flash_prefill(q, k, v, **kw)
    torch.testing.assert_close(got.float(),
                               prefill_plain(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(flash_prefill(q, k, v, **kw), got)


def test_table1_cells_through_the_metadata_path(cuda):
    """The paper's Table 1 (B=1, H_Q=64, D=128, H_KV 1 / 2 / 8) through
    ops.decode_attention under get_scheduler_metadata's frozen plans at
    132 SMs: each output within 2e-2 of the plain version (and of its
    largest element), no policy run
    inside a call, and the policies' splits differ exactly at L_K 512 with
    H_KV 1 and 2."""
    from repro_torch.core import get_scheduler_metadata
    changed = set()
    ops.reset_policy_eval_count()
    for lk in (128, 256, 384, 512, 2048, 4096):
        for hkv in (1, 2, 8):
            q = _rand(cuda, (1, 64, 128))
            k = _rand(cuda, (1, lk, hkv, 128))
            v = _rand(cuda, (1, lk, hkv, 128))
            lens = torch.tensor([lk], device="cuda", dtype=torch.int32)
            splits = {}
            for policy in ("fa3_baseline", "paper"):
                plan = get_scheduler_metadata(1, 1, lk, 64, hkv, 128,
                                              policy=policy, num_cores=132)
                splits[policy] = plan.num_splits
                got = ops.decode_attention(q, k, v, lens, plan=plan)
                qp = (q.float() * 128 ** -0.5).to(q.dtype).reshape(
                    1, hkv, -1, 128)
                want = decode_plain(qp, k, v, lens,
                                    num_splits=plan.num_splits
                                    ).reshape(1, 64, 128).float()
                torch.testing.assert_close(got.float(), want, rtol=2e-2,
                                           atol=2e-2)
                # outputs are a few hundredths at L_K in the thousands:
                # hold the error to 2e-2 of the largest one as well
                err = (got.float() - want).abs().max().item()
                assert err <= 2e-2 * want.abs().max().item()
            if splits["fa3_baseline"] != splits["paper"]:
                changed.add((lk, hkv))
    assert changed == {(512, 1), (512, 2)}
    assert ops.policy_eval_count() == 0


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_paged_engine_serves_the_dense_streams(cuda, kv_quant):
    """Reduced qwen2.5-3b at head_dim 128 (d_model 512), bf16 weights:
    a paged engine (page 64, dense-equivalent budget) gathers the same
    rows of every slot as the dense engine attends, so it serves the
    dense engine's streams bit for bit, with the same launches by kernel
    and by (view, S) and (dtype, Lq) key, and the same frozen splits."""
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=512)
    model = build_model(cfg, device="cuda")
    params = model.init_params(0)
    decode = "flash_decode_quant" if kv_quant else "flash_decode"
    runs = {}
    for layout in ("dense", "paged"):
        eng = ServingEngine(model, ServeConfig(model=cfg, kv_quant=kv_quant,
                                               cache_layout=layout),
                            max_len=512, batch_slots=2, device="cuda")
        eng.load(params)
        ops.reset_launch_counts()
        ops.reset_policy_eval_count()
        for i, n in enumerate((3, 140, 9, 300)):
            eng.submit(Request(i, [(5 * i + j) % 250 + 1 for j in range(n)],
                               max_new_tokens=8))
        done = eng.drain()
        runs[layout] = ([c.tokens for c in done], ops.launch_counts(),
                        ops.launch_counts_by_key(decode),
                        ops.launch_counts_by_key("flash_prefill"),
                        eng.planned_splits())
        assert ops.policy_eval_count() == 0
    assert runs["paged"] == runs["dense"]
    eng.cache.check_conservation()


def test_suffix_prefill_attention_matches_plain(cuda, monkeypatch):
    """Prefix sharing's suffix prefill on the card, reduced qwen2.5-3b at
    head_dim 128: every layer's attention launches the prefill kernel
    with ``q_offset = start`` over the slot's view, within 3e-2 of
    ``prefill_plain`` on the model's own inputs; then a shared engine
    admits its followers through suffix launches alone."""
    from repro_torch.models import lm
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=512)
    model = build_model(cfg, device="cuda")
    params = model.init_params(0)
    calls = []

    def checked(q, k, v, **kw):
        got = flash_prefill(q, k, v, **kw)
        torch.testing.assert_close(got.float(),
                                   prefill_plain(q, k, v, **kw).float(),
                                   rtol=3e-2, atol=3e-2)
        calls.append(kw["q_offset"])
        return got

    toks = torch.arange(1, 201, device="cuda") % 250
    padded = torch.zeros(256, dtype=toks.dtype, device="cuda")
    padded[:200] = toks
    _, view = lm.lm_prefill_view(params, cfg, padded, 200)
    suffix = torch.zeros(128, dtype=toks.dtype, device="cuda")
    suffix[:72] = toks[128:]
    monkeypatch.setattr(ops, "flash_prefill", checked)
    logits = lm.lm_prefill_suffix_view(params, cfg, view, suffix, 128, 200)
    assert calls == [128] * cfg.num_layers
    assert bool(torch.isfinite(logits).all())
    monkeypatch.undo()
    eng = ServingEngine(model, ServeConfig(model=cfg, cache_layout="paged",
                                           share_prefix=True),
                        max_len=512, batch_slots=2, device="cuda")
    eng.load(params)
    system = [(3 * j) % 250 + 1 for j in range(192)]
    for i in range(4):
        eng.submit(Request(i, system + [i + 1] * (5 + i), max_new_tokens=4))
    done = eng.drain()
    assert [len(c.tokens) for c in done] == [4] * 4
    kinds = {}
    for k, v in eng.stats.launches.items():
        if isinstance(k, tuple):
            kinds[k[0]] = kinds.get(k[0], 0) + v
    assert kinds == {"prefill": 1, "sprefill": 3}
    eng.cache.check_conservation()


# Prefix sharing's suffix prefill: a padded suffix of 128 rows over a
# slot's view from q_offset = the shared rows; at Lk 1024 the last query
# rows lie past the view's end (chip_smoke.py's SUFFIX_CASES): Lq, Lk,
# q_offset
SUFFIX_CASES = [(128, 512, 448), (128, 1024, 960), (128, 1024, 1000)]


@pytest.mark.parametrize("mul", [(1.0, 1.0), (10.0, 100.0)],
                         ids=["random", "large_values"])
@pytest.mark.parametrize("lq,lk,offset", SUFFIX_CASES)
def test_prefill_at_suffix_shapes(cuda, lq, lk, offset, mul):
    """The prefill kernel at the suffix prefill's shapes, including
    ``q_offset + Lq > Lk`` (rows past the view's end attend every key),
    on random data and on K x 10, V x 100 data, against the plain
    version; the same inputs give the same bits."""
    q, k, v = _prefill_inputs(cuda, 1, lq, lk, 16, 2, 128, torch.float32)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k * mul[0], v * mul[1]))
    kw = dict(causal=True, q_offset=offset)
    got = flash_prefill(q, k, v, **kw)
    torch.testing.assert_close(got.float(),
                               prefill_plain(q, k, v, **kw).float(),
                               rtol=3e-2, atol=3e-2)
    assert torch.equal(flash_prefill(q, k, v, **kw), got)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("bucket,lens,s", [(1024, (1000, 450), 8),
                                           (384, (60, 320), 1),
                                           (512, (484,), 3)])
def test_paged_decode_equals_dense_bits(cuda, kv_dtype, bucket, lens, s):
    """The decode kernels over a paged cache: a pool holds a dense cache's
    pages in a shuffled order (page 0, the trash page, holds none), and
    ``ops.decode_attention`` over ``PagedKV`` views of it launches the
    same kernel once and gives the dense launch's bits on the same
    resident view (K1 over bf16, K4 over int8 and fp8 with their scales
    paged beside the codes)."""
    b, cap, hkv, g, d, page = len(lens), 2048, 2, 8, 128, 64
    kv_len = torch.tensor(lens, device="cuda", dtype=torch.int32)
    q = _rand(cuda, (b, hkv * g, d))
    if kv_dtype:
        art = _poisoned_cache(cuda, b, cap, hkv, d, kv_len, kv_dtype)
        dense = dict(k=art.k, v=art.v, k_scale=art.k_scale,
                     v_scale=art.v_scale)
    else:
        dense = dict(k=_rand(cuda, (b, cap, hkv, d)),
                     v=_rand(cuda, (b, cap, hkv, d)))
    n = cap // page
    table = (torch.randperm(b * n, device="cuda", generator=cuda)
             + 1).view(b, n).int()
    paged = {}
    for name, x in dense.items():
        pool = x.new_zeros((b * n + 1, page) + x.shape[2:])
        ops.bit_view(pool)[table.reshape(-1).long()] = ops.bit_view(
            x).reshape((b * n, page) + x.shape[2:])
        paged[name] = ops.PagedKV(pool, table, bucket // page)
    plan = Planner(num_splits_override=s).plan(
        AttentionSpec.decode(b, bucket, hkv * g, hkv, d,
                             kv_dtype=kv_dtype or "bfloat16"),
        bucket=bucket)
    want = ops.decode_attention(q, kv_len=kv_len, plan=plan, **dense)
    ops.reset_launch_counts()
    got = ops.decode_attention(q, kv_len=kv_len, plan=plan, **paged)
    name = "flash_decode_quant" if kv_dtype else "flash_decode"
    assert ops.launch_counts_by_key(name) == {(bucket, s): 1}
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,hkv,g,d,bucket,pos,s,sharp", [
    # rows inside the view, rows past its end, a dead slot far past it
    (4, 2, 8, 128, 1024, (100, 1000, 1021, 3000), 8, False),
    (4, 2, 8, 128, 512, (420, 60, 507, 0), 3, True),
    (2, 32, 1, 128, 384, (300, 379), 1, False),    # codeqwen1.5-7b's G
    (2, 8, 4, 160, 1024, (1000, 450), 8, True),    # stablelm-12b's G, D
])
def test_verify_attention_runs_each_row_on_the_decode_kernel(
        cuda, b, hkv, g, d, bucket, pos, s, sharp):
    """A verify block of M = 5 rows per slot: M launches of the decode
    kernel under ("flash_decode", bucket, S), each row within 2e-2 of
    ``decode_plain`` over ``clamp(pos + j + 1, 1, bucket)`` keys of the
    same view, on random data and on the model's regime (K x 10, V x
    100, a few dominant keys)."""
    M = 5
    k = _rand(cuda, (b, 2048, hkv, d)) * (10 if sharp else 1)
    v = _rand(cuda, (b, 2048, hkv, d)) * (100 if sharp else 1)
    q = _rand(cuda, (b, M, hkv * g, d)) * (0.08 * d ** 0.5 if sharp else 1)
    pos = torch.tensor(pos, device="cuda")
    plan = LaunchPlan(kind="verify", num_splits=s, bucket=bucket)
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    got = ops.verify_attention(q, k, v, pos, plan=plan)
    assert ops.launch_counts_by_key("flash_decode") == {(bucket, s): M}
    assert ops.policy_eval_count() == 0
    qp = (q.float() * d ** -0.5).to(q.dtype).reshape(b, M, hkv, g, d)
    for j in range(M):
        lens = (pos + j + 1).clamp(1, bucket)
        want = decode_plain(qp[:, j].contiguous(), k[:, :bucket],
                            v[:, :bucket], lens, num_splits=s)
        torch.testing.assert_close(
            got[:, j].reshape(b, hkv, g, d).float(), want.float(),
            rtol=2e-2, atol=2e-2)


def test_categorical_sampler_is_reproducible_on_the_card(cuda):
    """qwen2.5-3b's vocab, greedy and sampled rows: the same seeds and
    positions draw the same tokens on a second call; greedy rows are the
    argmax; sampled tokens stay inside their row's top-k; the bonus row
    draws what ``sample`` draws at its position."""
    B, M, V = 4, 3, 151936
    logits = torch.randn((B, M, V), generator=cuda, device="cuda") * 3
    st = {"temperature": np.array([0.0, 0.8, 1.0, 0.8], np.float32),
          "top_k": np.array([0, 50, 0, 50], np.int32),
          "top_p": np.array([1.0, 0.9, 0.9, 1.0], np.float32),
          "seed": np.array([1, 2, 3, 4], np.int64)}
    pos = np.array([5, 17, 400, 2])
    sampler = CategoricalSampler()
    first = sampler.sample(logits[:, 0], st, pos)
    assert torch.equal(sampler.sample(logits[:, 0], st, pos), first)
    assert first[0] == logits[0, 0].argmax()
    for b in (1, 3):
        assert first[b] in torch.topk(logits[b, 0], 50).indices
    draft = logits[:, :M - 1].argmax(-1)
    draft[2, 1] = -1                             # a padding row
    toks, acc = sampler.verify(logits, draft, st, pos)
    again, acc2 = sampler.verify(logits, draft, st, pos)
    assert torch.equal(toks, again) and torch.equal(acc, acc2)
    assert torch.equal(toks[0], logits[0].argmax(-1))
    assert torch.equal(toks[:, M - 1],
                       sampler.sample(logits[:, M - 1], st, pos + M - 1))
    assert int(acc[2]) <= 1


# ---------------------------------------------------------------------------
# measured split autotuning on the card
# ---------------------------------------------------------------------------


def test_calibrator_times_the_decode_kernels_on_the_card(cuda):
    """A tiny wallclock grid: every entry is timed (source wallclock), its
    best split is its curve's argmin, every time lies above the timing
    floor, and the timed calls ran the decode kernel (bf16) and the
    quantized cache's (int8) at every candidate split: the warmup and
    timed repeats' launches each, plus those of the repeats the
    calibrator discarded and redid (the host had not enqueued them
    before the spin ran out), which it counts."""
    from repro_torch.tune import Calibrator, TuneSpec
    spec = TuneSpec(lk_buckets=(384, 1024), batches=(1,),
                    head_shapes=((16, 2, 128),), impls=("cuda",),
                    repeats=3, warmup=1)
    cal = Calibrator(spec, mode="wallclock", launches=4)
    ops.reset_launch_counts()
    table = cal.calibrate()
    redone = cal.redone
    floor = cal.floor_us()
    assert table.fingerprint["sources"] == "measured"
    assert table.fingerprint["backend"] == "cuda"
    runs = (spec.warmup + spec.repeats) * cal.launches
    extra = 0
    for e in table.entries:
        lats = e["latencies_us"]
        assert e["source"] == "wallclock"
        assert e["best_split"] == int(min(sorted(lats, key=int),
                                          key=lats.get))
        assert all(t > floor for t in lats.values()), (e, floor)
        name = "flash_decode_quant" if e["kv_dtype"] == "int8" \
            else "flash_decode"
        by = ops.launch_counts_by_key(name)
        for s in lats:
            n = by[(e["lk_bucket"], int(s))]
            assert n >= runs and (n - runs) % cal.launches == 0
            extra += n - runs
    assert extra == redone * cal.launches
    table.validate()


def test_wallclock_head_dim_the_kernels_lack_raises(cuda):
    from repro_torch.tune import Calibrator, TuneSpec
    with pytest.raises(ValueError, match=r"head_dim \[8\]"):
        Calibrator(TuneSpec(head_shapes=((4, 1, 8),)), mode="wallclock")
    spec = TuneSpec(head_shapes=((4, 1, 128),))
    assert Calibrator(spec).mode == "wallclock"
    assert Calibrator(spec, device="cpu").mode == "modeled"


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_measured_engine_launches_at_the_table_splits(cuda, kv_quant):
    """The reduced qwen2.5-3b (head_dim 128) on the card under
    ``split_policy="measured"`` with a table whose splits differ from
    ``paper``'s: every decode plan is the table's (tuned), the decode
    kernel (K4 under int8) launches at exactly those (view, S), and no
    policy runs inside a launch."""
    from repro_torch.tune import SplitTable
    entries = [{"batch": 2, "num_heads_q": 4, "num_heads_kv": 1,
                "head_dim": 128, "impl": "cuda", "dtype_bytes": nbytes,
                "kv_dtype": name, "lk_bucket": lk, "best_split": s,
                "source": "wallclock",
                "latencies_us": {"1": 10.0, str(s): 5.0} if s > 1
                else {"1": 5.0}}
               for name, nbytes in (("bfloat16", 2), ("int8", 1))
               for lk, s in ((128, 1), (256, 2), (384, 2), (512, 4))]
    table = SplitTable(entries, {"backend": "cuda", "num_cores": 132})
    table.validate()
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=512)
    model = build_model(cfg, device="cuda")
    eng = ServingEngine(model, ServeConfig(model=cfg, split_policy="measured",
                                           kv_quant=kv_quant),
                        max_len=512, batch_slots=2, tune_table=table,
                        device="cuda")
    eng.load(model.init_params(0))
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    # both slots decode in the 384 bucket, then slot 0 alone in 128, 256
    for i, (n, new) in enumerate(((100, 60), (300, 10))):
        eng.submit(Request(i, [(7 * i + j) % 250 + 1 for j in range(n)],
                           max_new_tokens=new))
    eng.drain()
    name = "flash_decode_quant" if kv_quant else "flash_decode"
    probe = SplitTable(entries, table.fingerprint)    # counts apart
    want = {}
    for key, n in eng.stats.launches.items():
        if isinstance(key, int):
            s = probe.choose(eng.sched.decode_spec(key).workload())[0]
            want[(key, s)] = want.get((key, s), 0) + cfg.num_layers * n
            plan = dict(eng.sched.plans.items())[key].plan
            assert plan.tuned and plan.num_splits == s
    assert ops.launch_counts_by_key(name) == want
    assert sorted(want) == [(128, 1), (256, 2), (384, 2)]
    assert ops.policy_eval_count() == 0
    assert eng.stats.measured_fallbacks == 0
    assert eng.stats.measured_lookups == len(eng.planned_splits())


# The MoE family's head shapes: granite-moe-3b-a800m (24 query heads over
# 8 KV heads: G 3, D 64) and qwen3-moe-235b-a22b (64 over 4: G 16, D 128)
MOE_HEADS = [(24, 8, 64), (64, 4, 128)]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("hq,hkv,d", MOE_HEADS)
def test_decode_kernels_at_the_moe_head_shapes(cuda, kv_dtype, hq, hkv, d):
    """Both decode kernels at the serving cell's decode shapes (B 2, view
    1024, kv_len 1000 and 450; B 1, view 384) and S 1, 3 and 8, over
    NaN / Inf or poisoned tails: the plain version's output within the
    tolerance, and the same bits again."""
    _check_wide(cuda, hq // hkv, d,
                [(2, 1024, (1000, 450), s) for s in (1, 3, 8)]
                + [(1, 384, (300,), 3)], kv_dtype, hkv=hkv)


@pytest.mark.parametrize("hq,hkv,d", MOE_HEADS)
@pytest.mark.parametrize("lq,lk,offset", [(1024, 1024, 0), (384, 384, 0),
                                          (128, 1024, 960)])
def test_prefill_at_the_moe_head_shapes(cuda, hq, hkv, d, lq, lk, offset):
    """The bf16 prefill kernel at the MoE heads: the serving cell's
    buckets 1024 and 384, and a suffix prefill from q_offset 960."""
    q, k, v = _prefill_inputs(cuda, 1, lq, lk, hq, hkv, d, torch.bfloat16)
    kw = dict(causal=True, q_offset=offset)
    got = flash_prefill(q, k, v, **kw)
    torch.testing.assert_close(got.float(),
                               prefill_plain(q, k, v, **kw).float(),
                               rtol=3e-2, atol=3e-2)
    assert torch.equal(flash_prefill(q, k, v, **kw), got)


def test_moe_engine_on_the_card(cuda):
    """Reduced granite-moe-3b-a800m (head_dim 64) served on the card in
    float32: the kernels carry every attention launch, the tokens equal a
    CPU run of the same weights, and the gather and einsum dispatches
    agree on the card."""
    from repro_torch.models import moe
    cfg = reduced_config("granite-moe-3b-a800m", num_layers=2,
                         d_model=256).replace(dtype="float32",
                                              param_dtype="float32")
    params = build_model(cfg, device="cpu").init_params(0)
    reqs = [Request(i, [(5 * i + j) % 250 + 1 for j in range(n)],
                    max_new_tokens=6) for i, n in enumerate((3, 140, 9))]
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(build_model(cfg, device=dev),
                            ServeConfig(model=cfg, kv_cache_dtype="float32"),
                            max_len=256, batch_slots=2, device=dev)
        eng.load(params.to(dev))
        ops.reset_launch_counts()
        for r in reqs:
            eng.submit(r)
        tokens[dev] = [c.tokens for c in eng.drain()]
        counts = ops.launch_counts()
        steps = sum(v for k, v in eng.stats.launches.items()
                    if isinstance(k, int))
    assert counts["flash_prefill"] == cfg.num_layers * len(reqs)
    assert counts["flash_decode"] == cfg.num_layers * steps
    assert tokens["cuda"] == tokens["cpu"]
    ffn = params.to("cuda").layers[0].ffn
    x = _rand(cuda, (2, 64, cfg.d_model), torch.float32)
    gather, _ = moe.apply_moe(ffn, cfg, x, dispatch="gather")
    einsum, _ = moe.apply_moe(ffn, cfg, x, dispatch="einsum")
    torch.testing.assert_close(gather, einsum, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the single-KV-head families: MLA's latent decode (K 288, V its first
# 256 columns) and prefill (q / k 96, v 64), paligemma's MQA at D 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mul", [(1.0, 1.0), (10.0, 100.0)],
                         ids=["normal", "sharp"])
@pytest.mark.parametrize("s", [1, 3, 8])
def test_decode_at_mla_latent_widths(cuda, s, mul):
    """K1 at (Dk 288, Dv 256), G 40, H_KV 1: V is the column view
    ``latent[..., :256]`` of a 2048-row cache read through a 1024-row
    bucket, kv_len ragged, the latent's tail past kv_len NaN; on normal
    data and on K x 10, V x 100 (the first 256 columns scaled by 100,
    the rope columns by 10).  Within 2e-2 of ``decode_plain``, and the
    same bits again."""
    lat = _rand(cuda, (2, 2048, 1, 288))
    lat[..., :256] *= mul[1]
    lat[..., 256:] *= mul[0]
    lens = torch.tensor([1000, 333], device="cuda", dtype=torch.int32)
    q = _rand(cuda, (2, 1, 40, 288)) * 288 ** -0.5
    # the kernel reads the NaN-tailed cache, the plain version the clean
    kp = _nan_tailed(lat, lens, float("nan"))[:, :1024]
    k, v = lat[:, :1024], lat[:, :1024, :, :256]
    run = functools.partial(flash_decode, q, kp, kp[..., :256], lens,
                            num_splits=s)
    got = run()
    assert got.shape == (2, 1, 40, 256)
    want = decode_plain(q, k, v, lens, num_splits=s)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(run(), got)
    parts = flash_decode_partials(q, k, v, lens, num_splits=s)
    for a, w in zip(parts, decode_partials_plain(q, k, v, lens,
                                                 num_splits=s)):
        assert a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("lq", [128, 1024])
def test_prefill_at_mla_widths(cuda, lq):
    """K3 at (q / k 96, v 64), 40 heads over 40, causal, ragged against
    the 64-row tile at neither length: within 3e-2 of ``prefill_plain``,
    the same bits again."""
    q = (_rand(cuda, (1, lq, 40, 96), torch.float32) * 96 ** -0.5).to(
        torch.bfloat16)
    k = _rand(cuda, (1, lq, 40, 96))
    v = _rand(cuda, (1, lq, 40, 64))
    got = flash_prefill(q, k, v, causal=True)
    assert got.shape == (1, lq, 40, 64)
    torch.testing.assert_close(got.float(),
                               prefill_plain(q, k, v, causal=True).float(),
                               rtol=3e-2, atol=3e-2)
    assert torch.equal(flash_prefill(q, k, v, causal=True), got)


@pytest.mark.parametrize("s", [1, 5])
def test_decode_kernels_at_paligemma_mqa(cuda, s):
    """K1 and K4 at G 8, D 256, H_KV 1 (paligemma-3b's decode) over NaN /
    poisoned tails: within their tolerances of the plain versions."""
    _check_wide(cuda, 8, 256, [(2, 1024, (1000, 450), s)], hkv=1)
    _check_wide(cuda, 8, 256, [(2, 1024, (1000, 450), s)], "int8", hkv=1)


def test_prefill_at_paligemma_mqa(cuda):
    """K3 at D 256, 8 query heads over 1, Lq 384 (256 patches and 128
    text tokens), causal."""
    q, k, v = _prefill_inputs(cuda, 2, 384, 384, 8, 1, 256, torch.bfloat16)
    got = flash_prefill(q, k, v, causal=True)
    torch.testing.assert_close(got.float(),
                               prefill_plain(q, k, v, causal=True).float(),
                               rtol=3e-2, atol=3e-2)


def test_unequal_widths_raise_where_no_kernel_takes_them(cuda):
    """The f32 routes take equal widths only, and a width pair no body is
    compiled for raises on the card: nothing falls back to the plain
    version."""
    lat = _rand(cuda, (1, 256, 1, 288))
    lens = torch.tensor([200], device="cuda", dtype=torch.int32)
    q = _rand(cuda, (1, 1, 40, 288))
    with pytest.raises(ValueError, match="tensor-core body only"):
        flash_decode(q.float(), lat, lat[..., :256], lens, num_splits=1)
    with pytest.raises(ValueError, match="tensor-core body only"):
        flash_decode(q.float(), lat.float(), lat.float()[..., :256], lens,
                     num_splits=1)
    with pytest.raises(ValueError, match=r"\(288, 128\)"):
        flash_decode(q, lat, lat[..., :128], lens, num_splits=1)
    with pytest.raises(ValueError, match="flash_decode_quant kernel"):
        flash_decode_quant(q, *_poisoned_cache(cuda, 1, 256, 1, 288, lens,
                                               "int8"), lens, num_splits=1)
    k = _rand(cuda, (1, 128, 4, 96))
    v = _rand(cuda, (1, 128, 4, 64))
    with pytest.raises(ValueError, match="f32 CUDA-core body"):
        flash_prefill(k.float(), k.float(), v.float())
    with pytest.raises(ValueError, match=r"\(96, 32\)"):
        flash_prefill(k, k, v[..., :32].contiguous())


@pytest.mark.parametrize("arch,kv_quant,layout", [
    ("minicpm3-4b", None, "dense"), ("minicpm3-4b", "int8", "paged"),
    ("paligemma-3b", None, "dense"), ("paligemma-3b", "int8", "paged")])
def test_single_kv_head_engines_on_the_card(cuda, arch, kv_quant, layout):
    """minicpm3-4b and paligemma-3b cut to 2 layers and d_model 512, every
    head width kept (latent 288 / 256, MLA prefill 96 / 64; paligemma's
    D 256 at 8 / 1 heads), served on the card: every attention launch is
    a kernel (minicpm3-4b's latent stays bf16 under int8, so K1 decodes
    it), each layer's attention is within its tolerance of the plain
    version on the model's own inputs, and the decode launches by (view,
    S) are what the plan keys imply."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).replace(num_layers=2, d_model=512)
    model = build_model(cfg, device="cuda")
    params = model.init_params(0)
    eng = ServingEngine(model, ServeConfig(model=cfg, kv_quant=kv_quant,
                                           cache_layout=layout),
                        max_len=512, batch_slots=2, device="cuda")
    eng.load(params)
    checks = {"flash_decode": 0, "flash_decode_quant": 0,
              "flash_prefill": 0}

    def checked(name, fn, plain, tol):
        def run(*args, **kw):
            got = fn(*args, **kw)
            torch.testing.assert_close(got.float(), plain(*args, **kw)
                                       .float(), rtol=tol, atol=tol)
            checks[name] += 1
            return got
        return run

    routes = {"flash_decode": checked("flash_decode", flash_decode,
                                      decode_plain, 2e-2),
              "flash_decode_quant": checked(
                  "flash_decode_quant", flash_decode_quant,
                  decode_quant_plain, AB_ATOL["int8"]),
              "flash_prefill": checked("flash_prefill", flash_prefill,
                                       prefill_plain, 3e-2)}
    saved = {name: getattr(ops, name) for name in routes}
    ops.reset_launch_counts()
    ops.reset_policy_eval_count()
    try:
        for name, fn in routes.items():
            setattr(ops, name, fn)
        for i, n in enumerate((37, 300, 90)):
            eng.submit(Request(i, [(7 * i + 3 * j) % 1000 + 1
                                   for j in range(n)], max_new_tokens=6))
        done = eng.drain()
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
    assert [len(c.tokens) for c in done] == [6, 6, 6]
    counts = ops.launch_counts()
    steps = sum(v for k, v in eng.stats.launches.items()
                if isinstance(k, int))
    quant_cache = kv_quant is not None and cfg.family != "mla"
    decode = "flash_decode_quant" if quant_cache else "flash_decode"
    assert counts[decode] == checks[decode] == cfg.num_layers * steps
    other = "flash_decode" if quant_cache else "flash_decode_quant"
    assert counts[other] == 0
    fused = cfg.family == "mla"
    assert counts["flash_prefill"] == checks["flash_prefill"] == (
        cfg.num_layers * 3 if fused else 0)
    assert ops.policy_eval_count() == 0
    plans = dict(eng.sched.plans.items())
    want = {}
    for key, n in eng.stats.launches.items():
        if isinstance(key, int):
            s = max(1, min(plans[key].plan.num_splits, key))
            want[(key, s)] = want.get((key, s), 0) + cfg.num_layers * n
    assert ops.launch_counts_by_key(decode) == want
    assert eng.sched.decode_spec(128).num_heads_kv == 1


# The decode launches over another length than the frozen plan's:
# whisper-large-v3's 1500-row cross cache (12 KV blocks, the last 92 rows)
# at G 1, H_KV 20, D 64, and recurrentgemma-9b's 2048-row ring at G 16,
# H_KV 1, D 256


@pytest.mark.parametrize("b,s", [(1, 6), (2, 3), (2, 1), (2, 12)])
def test_decode_over_the_encdec_cross_cache(cuda, b, s):
    """The decode kernel over every row of a 1500-row cross cache (kv_len
    1500: the ragged last block read to its end) at the cross side plan's
    splits (S 6 at B 1, S 3 at B 2) and at S 1 and one block a split:
    within 2e-2 of the plain version, and the same bits again."""
    q = _rand(cuda, (b, 20, 1, 64))
    k, v = (_rand(cuda, (b, 1500, 20, 64)) for _ in range(2))
    lens = torch.full((b,), 1500, device="cuda", dtype=torch.int32)
    run = functools.partial(flash_decode, q, k, v, lens, num_splits=s)
    got = run()
    torch.testing.assert_close(
        got.float(), decode_plain(q, k, v, lens, num_splits=s).float(),
        rtol=2e-2, atol=2e-2)
    assert torch.equal(run(), got)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_kernels_over_the_hybrid_ring(cuda, kv_dtype):
    """Both decode kernels over a 2048-row ring at the ring side plan's S
    16: before the wrap (kv_len 315 and 53, the untouched rows NaN / Inf
    or poisoned) and after it (every row live)."""
    _check_wide(cuda, 16, 256, [(2, 2048, (315, 53), 16),
                                (2, 2048, (2048, 2048), 16),
                                (1, 2048, (2047,), 16)], kv_dtype, hkv=1)


@pytest.mark.parametrize("b,lq,lk,causal,window,hq,hkv,d", [
    (2, 1500, 1500, False, None, 20, 20, 64),   # whisper's encoder
    (1, 128, 1500, False, None, 20, 20, 64),    # its cross prefill
    (1, 37, 1500, False, None, 20, 20, 64),     # a ragged prompt
    (1, 1024, 1024, True, None, 20, 20, 64),    # its self prefill
    (1, 2100, 2100, True, 2048, 16, 1, 256),    # the ring wraps
    (1, 300, 300, True, 2048, 16, 1, 256)])     # inside the window
def test_prefill_at_the_encdec_and_hybrid_shapes(cuda, b, lq, lk, causal,
                                                 window, hq, hkv, d):
    """The bf16 prefill kernel non-causal at Lq not a multiple of 64 and
    Lk 1500, and causal with the 2048-row window at D 256 (its KV loop
    starting past row 0): within 3e-2 of the plain version, same bits
    again."""
    q, k, v = _prefill_inputs(cuda, b, lq, lk, hq, hkv, d, torch.bfloat16)
    kw = dict(causal=causal, window=window)
    got = flash_prefill(q, k, v, **kw)
    torch.testing.assert_close(got.float(),
                               prefill_plain(q, k, v, **kw).float(),
                               rtol=3e-2, atol=3e-2)
    assert torch.equal(flash_prefill(q, k, v, **kw), got)


@pytest.mark.parametrize("arch,d_model", [("whisper-large-v3", 256),
                                          ("recurrentgemma-9b", 1024)])
def test_side_plan_engines_on_the_card(cuda, arch, d_model):
    """Reduced whisper-large-v3 (head_dim 64, 16 frames) and
    recurrentgemma-9b (head_dim 256, a 64-row ring, one prompt past it)
    served on the card in float32: the kernels carry every attention
    launch, the launches over the cross cache and the ring at their side
    plan's (view, S), no policy evaluation, and the tokens of a CPU run of
    the same weights."""
    cfg = reduced_config(arch, num_layers=2, d_model=d_model).replace(
        dtype="float32", param_dtype="float32")
    params = build_model(cfg, device="cpu").init_params(0)
    reqs = [Request(i, [(5 * i + j) % 250 + 1 for j in range(n)],
                    max_new_tokens=6) for i, n in enumerate((3, 70, 9))]
    tokens = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        eng = ServingEngine(model, ServeConfig(model=cfg,
                                               kv_cache_dtype="float32"),
                            max_len=256, batch_slots=2, device=dev)
        eng.load(params.to(dev))
        ops.reset_launch_counts()
        ops.reset_policy_eval_count()
        for r in reqs:
            eng.submit(r)
        tokens[dev] = [c.tokens for c in eng.drain()]
    (name, side), = eng.sched.side_plans().items()
    steps = sum(v for k, v in eng.stats.launches.items()
                if isinstance(k, int))
    by_key = ops.launch_counts_by_key("flash_decode")
    view = side.spec.seqlen_k
    if cfg.family == "encdec":
        assert (name, view) == ("cross", 16)
        assert by_key[(view, side.num_splits)] == cfg.num_layers * steps
    else:
        assert (name, view) == ("ring", 64)
        assert by_key == {(view, side.num_splits): steps}   # 1 ring layer
    assert ops.policy_eval_count() == 0
    assert tokens["cuda"] == tokens["cpu"]



# --- the sequence-sharded decode (mesh-native serving) ----------------------


def _seq_shards(x, n):
    return ops.SeqShards.split(x, [torch.device("cuda", 0)] * n, 1)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_sequence_sharded_decode_equals_the_fused_kernel_bits(cuda, kv_dtype,
                                                             n):
    """Over a 4096-row cache cut into n chunks, whose bounds are the fused
    kernel's split bounds at S = n: one partials launch a chunk at one
    split, then one combine launch, give the bits of one fused launch at
    S n over the whole view (bf16, and int8 on the quantized cache's
    kernel), and are within the tolerance of the plain version.  A slot
    whose kv_len ends before the last chunks leaves them empty."""
    from repro_torch.kernels.flash_decode import split_bounds
    b, hkv, g, d, L = 2, 2, 8, 128, 4096
    assert [split_bounds(L, n, i) for i in range(n)] == \
        [(i * L // n, (i + 1) * L // n) for i in range(n)]
    q = _rand(cuda, (b, hkv * g, d))
    k, v = _rand(cuda, (b, L, hkv, d)), _rand(cuda, (b, L, hkv, d))
    lens = torch.tensor([4000, 900], device="cuda", dtype=torch.int32)
    qp = (q.float() * d ** -0.5).to(q.dtype).reshape(b, hkv, g, d)
    ops.reset_launch_counts()
    if kv_dtype is None:
        got = ops.decode_seqsharded(q, _seq_shards(k, n), _seq_shards(v, n),
                                    lens)
        part = "flash_decode"
        fused = flash_decode(qp, k, v, lens, num_splits=n)
        want = decode_plain(qp, k, v, lens, num_splits=n)
        tol = 2e-2
    else:
        qz = Quantizer.from_kv_dtype(kv_dtype)
        (kq, ks), (vq, vs) = qz.quantize(k), qz.quantize(v)
        got = ops.decode_seqsharded(
            q, _seq_shards(kq, n), _seq_shards(vq, n), lens,
            k_scale=_seq_shards(ks, n), v_scale=_seq_shards(vs, n))
        part = "flash_decode_quant"
        fused = flash_decode_quant(qp, kq, vq, ks, vs, lens, num_splits=n)
        want = decode_quant_plain(qp, kq, vq, ks, vs, lens, num_splits=n)
        tol = AB_ATOL[kv_dtype]
    counts = ops.launch_counts()
    assert counts[part] == n + 1 and counts["flash_combine"] == 1
    assert ops.launch_counts_by_key(part) == {(L // n, 1): n,
                                              (L, n): 1}
    got = got.reshape(fused.shape)
    assert torch.equal(got, fused)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_a_shard_holding_no_row_gives_the_empty_partial(cuda, kv_dtype):
    """kv_len 0 over a chunk (a prompt that ends before it): acc 0, l 0,
    m NEG_INF exactly, as ``ref.decode_partial``; a row beside it with
    rows keeps its own partial."""
    b, hkv, g, d, c = 2, 2, 8, 128, 1024
    q = _rand(cuda, (b, hkv, g, d))
    k, v = _rand(cuda, (b, c, hkv, d)), _rand(cuda, (b, c, hkv, d))
    lens = torch.tensor([0, 300], device="cuda", dtype=torch.int32)
    if kv_dtype is None:
        acc, l, m = flash_decode_partials(q, k, v, lens, num_splits=1)
        _, _, want_m = decode_partials_plain(q, k, v, lens, num_splits=1)
    else:
        qz = Quantizer.from_kv_dtype(kv_dtype)
        (kq, ks), (vq, vs) = qz.quantize(k), qz.quantize(v)
        acc, l, m = flash_decode_quant_partials(q, kq, vq, ks, vs, lens,
                                                num_splits=1)
        _, _, want_m = decode_quant_partials_plain(q, kq, vq, ks, vs, lens,
                                                   num_splits=1)
    assert torch.equal(acc[:, 0], torch.zeros_like(acc[:, 0]))
    assert torch.equal(l[:, 0], torch.zeros_like(l[:, 0]))
    assert torch.equal(m[:, 0], torch.full_like(m[:, 0], ref.NEG_INF))
    assert (l[:, 1] > 0).all()
    torch.testing.assert_close(m[:, 1], want_m[:, 1], rtol=2e-2, atol=2e-2)


def test_combine_over_empty_partials_is_zero(cuda):
    """A dead slot whose every shard is empty: the combine kernel merges
    S partials of acc 0, l 0, m NEG_INF into exact zeros, not NaN, as
    ``combine_plain`` does; a live slot beside it is merged as usual."""
    s, b, hkv, g, d = 4, 2, 2, 8, 128
    acc = torch.randn((s, b, hkv, g, d), generator=cuda, device="cuda")
    l = torch.rand((s, b, hkv, g), generator=cuda, device="cuda") + 0.5
    m = torch.randn((s, b, hkv, g), generator=cuda, device="cuda")
    acc[:, 0], l[:, 0], m[:, 0] = 0.0, 0.0, ref.NEG_INF
    for dt in (torch.float32, torch.bfloat16):
        out = flash_combine(acc, l, m, out_dtype=dt)
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        torch.testing.assert_close(out.float(), combine_plain(
            acc, l, m, out_dtype=dt).float(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout,kv_quant", [("dense", None),
                                             ("paged", None),
                                             ("dense", "int8")])
def test_sharded_engines_on_the_card(cuda, layout, kv_quant):
    """Reduced qwen2.5-3b (head_dim 128) in float32 at dp 1 x sp 2 on
    ``[cuda:0] * 2`` and on ``[cpu] * 2``: the same streams; on the card
    every layer of every decode step launches the partials twice at one
    split and the combine once, and the policy never runs in a step."""
    from repro_torch.shard import ShardedServingEngine, ShardSpec
    cfg = reduced_config("qwen2.5-3b", d_model=512).replace(
        dtype="float32", param_dtype="float32")
    kw = dict(cache_layout=layout, kv_quant=kv_quant,
              kv_cache_dtype="float32")
    params = build_model(cfg, device="cpu").init_params(0)
    reqs = [Request(i, [(7 * i + j) % 250 + 1 for j in range(n)],
                    max_new_tokens=6) for i, n in enumerate((3, 150, 40))]
    tokens = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        eng = ShardedServingEngine(
            model, ServeConfig(model=cfg, **kw),
            spec=ShardSpec(sp=2, slots_per_shard=2), max_len=256,
            devices=[torch.device(dev, 0) if dev == "cuda"
                     else torch.device(dev)] * 2)
        eng.load(params.to(dev))
        ops.reset_launch_counts()
        ops.reset_policy_eval_count()
        for r in reqs:
            eng.submit(r)
        tokens[dev] = [c.tokens for c in eng.drain()]
    core = eng.cores[0]
    steps = sum(v for k, v in core.stats.launches.items()
                if isinstance(k, int))
    part = "flash_decode_quant" if kv_quant else "flash_decode"
    counts = ops.launch_counts()
    assert counts[part] == 2 * cfg.num_layers * steps
    assert counts["flash_combine"] == cfg.num_layers * steps
    assert ops.policy_eval_count() == 0
    assert tokens["cuda"] == tokens["cpu"]


# ---------------------------------------------------------------------------
# tensor parallelism and the frozen mesh step builders
# ---------------------------------------------------------------------------


def _grid(n):
    from repro_torch.launch.mesh import make_engine_mesh
    return make_engine_mesh(1, n, [torch.device("cuda", 0)] * n)[0]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_head_sharded_decode_equals_the_whole_launchs_heads(cuda, kv_dtype):
    """The frozen step's head-sharded decode (qwen2.5-3b's shape at model
    2: H_KV 1 and G 8 a device, view 512, S 1): each device's launch over
    its KV head gives, bit for bit, that head's rows of one launch over
    both heads, bf16 and over an int8 cache; the op writes each device's
    part of the new row and launches the kernel once a device."""
    b, hkv, g, d, L = 1, 2, 8, 128, 512
    q = _rand(cuda, (b, hkv * g, d))
    k, v = _rand(cuda, (b, L, hkv, d)), _rand(cuda, (b, L, hkv, d))
    new_k, new_v = _rand(cuda, (b, hkv, d)), _rand(cuda, (b, hkv, d))
    t = torch.tensor([300], device="cuda")
    plan = LaunchPlan(num_splits=1)
    cache = {"k": k.clone(), "v": v.clone()}
    new = {"k": new_k, "v": new_v}
    part = "flash_decode"
    if kv_dtype is not None:
        qz = Quantizer.from_kv_dtype(kv_dtype)
        (cache["k"], cache["k_s"]), (cache["v"], cache["v_s"]) = \
            qz.quantize(k), qz.quantize(v)
        (new["k"], new["k_s"]), (new["v"], new["v_s"]) = \
            qz.quantize(new_k), qz.quantize(new_v)
        part = "flash_decode_quant"
    whole = {name: x.clone() for name, x in cache.items()}
    rows = torch.arange(b, device="cuda")
    for name, x in whole.items():
        ops.bit_view(x)[rows, t] = ops.bit_view(new[name])
    want = ops.decode_attention(q, whole["k"], whole["v"], t + 1,
                                k_scale=whole.get("k_s"),
                                v_scale=whole.get("v_s"), plan=plan)
    devices = _grid(2).rows[0]
    shards = {name: ops.HeadShards.place(x, devices, dim=2)
              for name, x in cache.items()}
    ops.reset_launch_counts()
    got = ops.decode_update_headsharded(q, shards, new, t, t + 1, plan=plan)
    assert ops.launch_counts()[part] == 2
    assert ops.launch_counts_by_key(part) == {(L, 1): 2}
    assert torch.equal(got, want)
    for name, x in whole.items():
        assert torch.equal(ops.bit_view(shards[name].join(x.device)),
                           ops.bit_view(x))


def test_sequence_parallel_prefill_equals_the_whole_launch(cuda):
    """The prefill kernel over 3 chunks of 128 query rows (q_offset 0,
    128, 256) against all 384 keys, joined, gives one whole launch's
    bits (every chunk starts on the kernel's 64-row tile); over 4
    chunks of 96 rows (off the tile) it stays within 3e-2 of it; both
    through ``ops.attention`` under a sequence-parallel prefill plan."""
    q = _rand(cuda, (1, 384, 16, 128))
    k, v = _rand(cuda, (1, 384, 2, 128)), _rand(cuda, (1, 384, 2, 128))
    whole = ops.attention(q, k, v, causal=True)
    want = prefill_plain(
        (q.float() * 128 ** -0.5).to(q.dtype).double(), k.double(),
        v.double(), causal=True)
    for n, bits in ((3, True), (4, False)):
        ops.reset_launch_counts()
        with plan_scope(LaunchPlan(kind="prefill",
                                   seq_shard_mesh=_grid(n))):
            got = ops.attention(q, k, v, causal=True)
        assert ops.launch_counts_by_key("flash_prefill") == {
            ("bfloat16", 384 // n): n}
        if bits:
            assert torch.equal(got, whole)
        torch.testing.assert_close(got.float(), whole.float(), rtol=3e-2,
                                   atol=3e-2)
        torch.testing.assert_close(got.double(), want, rtol=3e-2,
                                   atol=3e-2)


def test_tp_layer_on_the_card(cuda):
    """One tensor-parallel layer of reduced qwen2.5-3b (head_dim 128) in
    bf16 over ``[cuda:0] * 2``, prefill then a decode step, against the
    unsharded layer on the same inputs within 2e-2 of the output's
    largest magnitude."""
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.common import rope_angles
    from repro_torch.sharding.place import place_params
    cfg = reduced_config("qwen2.5-3b", d_model=512, num_layers=1)
    params = build_model(cfg, device="cuda").init_params(0)
    tp = place_params(params, _grid(2))
    x = _rand(cuda, (1, 96, cfg.d_model))
    rope = rope_angles(torch.arange(96, device="cuda")[None],
                       cfg.resolved_head_dim, cfg.rope_theta)
    got, rows = lm_mod.block_prefill(tp.layers[0], cfg, x, rope, "bfloat16")
    want, wrows = lm_mod.block_prefill(params.layers[0], cfg, x, rope,
                                       "bfloat16")
    tol = 2e-2 * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol
    cache = {n: torch.zeros((1, 128) + r.shape[2:], dtype=r.dtype,
                            device="cuda") for n, r in rows.items()}
    for n in cache:
        cache[n][:, :96] = wrows[n]
    copy = {n: c.clone() for n, c in cache.items()}
    t = torch.tensor([96], device="cuda")
    xt = _rand(cuda, (1, 1, cfg.d_model))
    rope = rope_angles(t[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    plan = LaunchPlan(num_splits=1)
    got = lm_mod.block_decode(tp.layers[0], cfg, xt, cache, t, rope,
                              plan=plan)
    want = lm_mod.block_decode(params.layers[0], cfg, xt, copy, t, rope,
                               plan=plan)
    tol = 2e-2 * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol


# The prefill backward's shapes: the training cell, every head width the
# forward takes (MLA's 96 / 64 pair too), causal, windowed and not,
# cross attention's Lq != Lk, q_offset, ragged edges, groups of 1 to 8.
BWD_CASES = [
    (2, 1024, 1024, 16, 2, 128, 128, None, 0, True),   # the training cell
    (1, 37, 37, 16, 2, 128, 128, None, 0, True),       # ragged
    (1, 200, 200, 8, 8, 128, 128, None, 0, True),      # MHA
    (1, 256, 256, 4, 1, 64, 64, 100, 0, True),         # D 64, window
    (1, 300, 300, 6, 2, 64, 64, None, 0, False),       # not causal, G 3
    (2, 100, 356, 8, 1, 160, 160, None, 256, True),    # q_offset, D 160
    (1, 300, 300, 8, 2, 256, 256, 100, 0, True),       # D 256, window
    (1, 200, 1500, 4, 4, 64, 64, None, 0, False),      # cross attention
    (1, 256, 256, 8, 8, 96, 64, None, 0, True),        # MLA's widths
    (1, 130, 130, 5, 1, 128, 128, None, 0, True),      # G 5
    # the tile edges of the bf16 tensor-core bodies (64 x 64 tiles)
    (1, 100, 227, 8, 2, 128, 128, None, 0, True),      # Lq, Lk off-tile
    (1, 1, 300, 8, 1, 128, 128, None, 299, True),      # Lq 1
    (2, 130, 390, 8, 2, 128, 128, None, 260, True),    # q_offset off-tile
    (1, 300, 300, 16, 2, 128, 128, 70, 0, True),       # window edge in tile
    (1, 300, 300, 8, 1, 256, 256, 100, 0, True),       # G 8, D 256, window
    (1, 1024, 1024, 8, 8, 96, 64, None, 0, True),      # MLA's widths, 1024
]
BWD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


def _normwise(got, want):
    return float((got.double() - want).norm() / want.norm().clamp_min(1e-30))


def _bwd_inputs(gen, b, lq, lk, hq, hkv, d, dv, dtype, scale=(1.0, 1.0)):
    q = (_rand(gen, (b, lq, hq, d), torch.float32) * d ** -0.5).to(dtype)
    k = (_rand(gen, (b, lk, hkv, d), torch.float32) * scale[0]).to(dtype)
    v = (_rand(gen, (b, lk, hkv, dv), torch.float32) * scale[1]).to(dtype)
    do = _rand(gen, (b, lq, hq, dv), dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,dv,window,offset,causal",
                         BWD_CASES)
def test_prefill_backward_matches_plain(cuda, b, lq, lk, hq, hkv, d, dv,
                                        window, offset, causal, dtype):
    """The backward kernel's dq, dk, dv against the float64 plain backward
    on the same inputs (o and lse from the plain forward), normwise; the
    same inputs give the same bits."""
    q, k, v, do = _bwd_inputs(cuda, b, lq, lk, hq, hkv, d, dv, dtype)
    kw = dict(causal=causal, window=window, q_offset=offset)
    o = prefill_plain(q, k, v, **kw).contiguous()
    lse = prefill_lse_plain(q, k, **kw).float()
    got = flash_prefill_bwd(q, k, v, o, lse, do, **kw)
    want = prefill_backward_plain(*(t.double() for t in (q, k, v, o, lse,
                                                         do)), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = _normwise(g, w)
        assert err <= BWD_TOL[dtype], (name, err)
    again = flash_prefill_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("b,lq,lk,offset", [(2, 1024, 1024, 0),
                                            (1, 64, 320, 256)])
def test_prefill_backward_over_large_values(cuda, b, lq, lk, offset):
    """K x 10, V x 100 (the full-width model's regime) in bf16: the
    kernel's LSE and its gradient against the float64 plain versions."""
    q, k, v, do = _bwd_inputs(cuda, b, lq, lk, 16, 2, 128, 128,
                              torch.bfloat16, scale=(10.0, 100.0))
    out, lse = flash_prefill_lse(q, k, v, causal=True, q_offset=offset)
    want_lse = prefill_lse_plain(q.double(), k.double(), causal=True,
                                 q_offset=offset)
    assert float((lse.double() - want_lse).abs().max()) \
        <= 1e-4 * max(1.0, float(want_lse.abs().max()))
    got = flash_prefill_bwd(q, k, v, out, lse, do, causal=True,
                            q_offset=offset)
    want = prefill_backward_plain(*(t.double() for t in (q, k, v, out, lse,
                                                         do)),
                                  causal=True, q_offset=offset)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _normwise(g, w) <= BWD_TOL[torch.bfloat16], name


@pytest.mark.parametrize("b,l,hq,hkv,d,several", [
    (2, 1024, 16, 2, 128, True),     # the training cell: 18-step chunks
    (4, 2048, 8, 4, 128, False),     # 512 key blocks: one chunk each
])
def test_prefill_backward_split_repeats_its_bits(cuda, b, l, hq, hkv, d,
                                                 several):
    """The bf16 dk / dv launch with several chunks a key block (f32
    partials merged in chunk order by the CTA that arrives last) and with
    one: against the float64 plain backward, and bit for bit on repeated
    calls."""
    dev = torch.device("cuda", 0)
    split = bwd_work(dev, b, hkv, hq // hkv, l, l, True, 0, 0, d, d)[0]
    assert (max(r[8] for r in split.rows) > 1) == several
    assert split.ctas >= bwd_cta_slots(dev, d, d)
    q, k, v, do = _bwd_inputs(cuda, b, l, l, hq, hkv, d, d, torch.bfloat16)
    o, lse = flash_prefill_lse(q, k, v, causal=True)
    got = flash_prefill_bwd(q, k, v, o, lse, do, causal=True)
    want = prefill_backward_plain(*(t.double() for t in (q, k, v, o, lse,
                                                         do)), causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _normwise(g, w) <= BWD_TOL[torch.bfloat16], name
    for _ in range(3):
        again = flash_prefill_bwd(q, k, v, o, lse, do, causal=True)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


# the forward takes unequal widths (MLA's 96 / 64) in bf16 only
LSE_CASES = [(*c, dtype) for c in BWD_CASES
             for dtype in (torch.bfloat16, torch.float32)
             if c[5] == c[6] or dtype == torch.bfloat16]


@pytest.mark.parametrize("b,lq,lk,hq,hkv,d,dv,window,offset,causal,dtype",
                         LSE_CASES)
def test_prefill_lse_matches_plain_and_keeps_the_output_bits(
        cuda, b, lq, lk, hq, hkv, d, dv, window, offset, causal, dtype):
    """The forward's LSE output against the float64 plain LSE, and the
    output bits with and without it (serving passes no LSE buffer)."""
    q, k, v, _ = _bwd_inputs(cuda, b, lq, lk, hq, hkv, d, dv, dtype)
    kw = dict(causal=causal, window=window, q_offset=offset)
    out, lse = flash_prefill_lse(q, k, v, **kw)
    assert torch.equal(out, flash_prefill(q, k, v, **kw))
    want = prefill_lse_plain(q.double(), k.double(), **kw)
    assert lse.shape == (b, hq, lq) and lse.dtype == torch.float32
    assert float((lse.double() - want).abs().max()) \
        <= 1e-4 * max(1.0, float(want.abs().max()))


def test_autograd_runs_both_kernels(cuda):
    """flash_prefill under autograd on the card: one forward launch with
    the LSE, BWD_LAUNCHES_PER_CALL backward launches, and the gradients
    the backward kernel gives when called directly."""
    q, k, v, do = _bwd_inputs(cuda, 2, 256, 256, 16, 2, 128, 128,
                              torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launch_counts()
    out = flash_prefill(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    counts = ops.launch_counts()
    assert counts["flash_prefill"] == 1
    assert counts["flash_prefill_bwd"] == BWD_LAUNCHES_PER_CALL
    assert ops.launch_counts_by_key("flash_prefill_bwd") == {
        ("bfloat16", 256): BWD_LAUNCHES_PER_CALL}
    o, lse = flash_prefill_lse(q, k, v, causal=True)
    assert torch.equal(out.detach(), o)
    direct = flash_prefill_bwd(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(grads, direct))


def test_prefill_backward_refuses_what_it_does_not_take(cuda):
    """A width the kernels do not take raises under autograd, as it does
    without: nothing falls back to the plain version."""
    q, k, v, do = _bwd_inputs(cuda, 1, 64, 64, 4, 2, 32, 32, torch.bfloat16)
    with pytest.raises(ValueError):
        flash_prefill(q.requires_grad_(True), k, v, causal=True)


def test_seqpar_training_attention_on_the_card(cuda):
    """Sequence-parallel training attention over a (1, 3) grid of the
    card: one K3 launch with its LSE and one K3b call a chunk of 340
    query rows (q_offset 0, 340, 680, against the whole 1020 keys), its
    output and q / k / v gradients (K and V's summed over the chunks)
    within 1e-2 normwise of the float64 plain forward and backward of the
    whole sequence."""
    from repro_torch.launch.mesh import make_host_mesh
    b, L, hq, hkv, d = 2, 1020, 16, 2, 128
    q, k, v, do = _bwd_inputs(cuda, b, L, L, hq, hkv, d, d, torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grid = make_host_mesh(3, [torch.device("cuda", 0)] * 3)
    ops.reset_launch_counts()
    with plan_scope(LaunchPlan(kind="prefill", seq_shard_mesh=grid)):
        out = ops.attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    assert ops.launch_counts_by_key("flash_prefill") == {
        ("bfloat16", 340): 3}
    assert ops.launch_counts_by_key("flash_prefill_bwd") == {
        ("bfloat16", 340): 3 * BWD_LAUNCHES_PER_CALL}
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    q64 = q64.requires_grad_(True)
    k64, v64 = k64.requires_grad_(True), v64.requires_grad_(True)
    qs = q64 * d ** -0.5
    want_out = prefill_plain(qs, k64, v64, causal=True)
    want = torch.autograd.grad(want_out, (q64, k64, v64), do64)

    def normwise(a, w):
        return float((a.double() - w).norm() / w.norm())
    assert normwise(out.detach(), want_out.detach()) <= 1e-2
    for g, w in zip(got, want):
        assert normwise(g, w) <= 1e-2


def test_mesh_train_step_launches_on_the_card(cuda):
    """A (2, 2) train step over ``[cuda:0] * 4`` (heads 4 / KV heads 2 of
    64 over a model axis of 2: each device attends its own heads) under
    remat nothing_saveable launches K3 layers x rows x model devices x
    (1 + remat) times and K3b's call layers x rows x model devices times;
    its loss is finite and within 2e-2 of the one-device step's on the
    same weights and batch."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.train_step import build_train_step
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=256).replace(
        num_kv_heads=2)
    model = build_model(cfg, device="cuda")
    tcfg = TrainConfig(model=cfg, shape=ShapeConfig("t", 256, 4, "train"),
                       remat_policy="nothing_saveable")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 256, 4, seed=0))
    losses = []
    for mesh in (None, make_host_mesh(2, [torch.device("cuda", 0)] * 4)):
        bundle = build_train_step(model, tcfg, mesh)
        params, state = bundle.init(0)
        ops.reset_launch_counts()
        m = bundle.step(params, state,
                        bundle.to_device(data.batch_at(0)))[2]
        torch.cuda.synchronize()
        rows, devs = (1, 1) if mesh is None else (2, 2)
        calls = cfg.num_layers * rows * devs
        assert ops.launch_counts()["flash_prefill"] == 2 * calls
        assert ops.launch_counts()["flash_prefill_bwd"] == \
            BWD_LAUNCHES_PER_CALL * calls
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[1])
    assert abs(losses[1] - losses[0]) <= 2e-2 * abs(losses[0])

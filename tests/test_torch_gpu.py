"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: run them on a machine with an H100 and nvcc with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Elsewhere every test skips, with the reason from
``repro_torch.kernels.build.available()``.  Whether a card is present is
decided inside the ``cuda`` fixture, never at import or collection, so
every pytest worker collects the same tests.

Tolerances: bf16 2e-2 for decode and 3e-2 for prefill (both kernels'
tensor-core bodies carry P as two bf16 terms in P V),
float32 2e-5 for the combine, the f32 decode and the f32 prefill (one
fixed-order sum against another order), ``AB_ATOL`` (2e-2) for the
quantized decode (its tensor-core body also carries P, times each key's
v scale, as two bf16 terms).
"""
import functools

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
from repro_torch.kernels.flash_prefill import flash_prefill, prefill_plain
from repro_torch.models import build_model
from repro_torch.quant import AB_ATOL, QuantizedKV, Quantizer
from repro_torch.serving import Request, ServingEngine

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


def _check_wide(gen, g, d, shapes, kv_dtype=None, mul=(1.0, 1.0, 1.0)):
    """The decode kernel over a bf16 cache with NaN / Inf tails or, with
    ``kv_dtype``, the quantized cache's over poisoned tails, at each of
    ``shapes``: within its tolerance of the plain version, and the same
    bits again.  q, K and V are drawn from normals of standard deviations
    ``mul``."""
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

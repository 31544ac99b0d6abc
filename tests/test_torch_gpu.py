"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: run them on a machine with an H100 and nvcc with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Elsewhere every test skips, with the reason from
``repro_torch.kernels.build.available()``.  Whether a card is present is
decided inside the ``cuda`` fixture, never at import or collection, so
every pytest worker collects the same tests.

Tolerances: bf16 2e-2 for decode and 3e-2 for prefill (the prefill
kernel also rounds P to bf16 before P V, as FA3 does), float32 2e-5 for
the combine and the f32 prefill (one fixed-order sum against another
order), ``AB_ATOL`` (2e-2) for the quantized decode.
"""
import pytest
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_combine import combine_plain, flash_combine
from repro_torch.kernels.flash_decode import (
    decode_partials_plain,
    flash_decode_partials,
)
from repro_torch.kernels.flash_decode_quant import (
    decode_quant_partials_plain,
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


def _poisoned_cache(gen, b, cap, hkv, d, lens, kv_dtype):
    """A quantized cache whose rows past kv_len hold data 127 and scales
    1e4, as the reference's poisoned-tail oracle."""
    art = Quantizer.from_kv_dtype(kv_dtype).quantized_kv(
        _rand(gen, (b, cap, hkv, d), torch.float32),
        _rand(gen, (b, cap, hkv, d), torch.float32))
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
    assert counts["flash_decode"] == counts["flash_combine"] \
        == cfg.num_layers * steps
    assert tokens["cuda"] == tokens["cpu"]


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_engine_on_the_card(cuda, kv_quant):
    """The same model served under kv_quant: the fused-dequant kernel
    carries every decode launch, the bf16 decode kernel none."""
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
    assert counts["flash_decode_quant"] == counts["flash_combine"] \
        == cfg.num_layers * steps
    assert counts["flash_prefill"] == cfg.num_layers * 3
    assert {dt for dt, _ in ops.launch_counts_by_key("flash_prefill")} \
        == {"bfloat16"}

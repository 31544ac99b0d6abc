"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: run them on a machine with an H100 and nvcc with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Elsewhere every test skips, with the reason from
``repro_torch.kernels.build.available()``.  Whether a card is present is
decided inside the ``cuda`` fixture, never at import or collection, so
every pytest worker collects the same tests.

Tolerances: bf16 2e-2 for decode and 3e-2 for prefill, float32 2e-5 for
the combine (one fixed-order sum against another order).
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
from repro_torch.kernels.flash_prefill import flash_prefill, prefill_plain
from repro_torch.models import build_model
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


@pytest.mark.parametrize("lq,lk,hq,hkv,d,window,offset", [
    (128, 128, 16, 2, 128, None, 0),
    (200, 200, 16, 2, 128, None, 0),
    (256, 256, 4, 1, 64, 64, 0),
    (64, 320, 2, 1, 64, None, 256),
])
def test_prefill_matches_plain(cuda, lq, lk, hq, hkv, d, window, offset):
    q = _rand(cuda, (1, lq, hq, d))
    k = _rand(cuda, (1, lk, hkv, d))
    v = _rand(cuda, (1, lk, hkv, d))
    got = flash_prefill(q, k, v, causal=True, window=window, q_offset=offset)
    want = prefill_plain(q, k, v, causal=True, window=window,
                         q_offset=offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2,
                               atol=3e-2)


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
        eng = ServingEngine(model, ServeConfig(model=cfg), max_len=256,
                            batch_slots=2, device=dev)
        eng.load(params.to(dev))
        ops.reset_launch_counts()
        for r in reqs:
            eng.submit(r)
        tokens[dev] = [c.tokens for c in eng.drain()]
        counts = ops.launch_counts()
        steps = sum(v for k, v in eng.stats.launches.items()
                    if isinstance(k, int))
    assert counts["flash_prefill"] == cfg.num_layers * len(reqs)
    assert counts["flash_decode"] == counts["flash_combine"] \
        == cfg.num_layers * steps
    assert tokens["cuda"] == tokens["cpu"]

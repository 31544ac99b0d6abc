"""qwen2.5-3b — dense GQA transformer, kv=2: the paper's target regime.

[dense] 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936 — GQA, QKV bias

H_KV=2 decode at batch 1 gives 2 work tiles, the H_KV=2 rows of the
paper's Table 1.
"""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("qwen2.5-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        d_ff=11008,
        vocab_size=151936,
        mlp_kind="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )

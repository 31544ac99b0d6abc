"""stablelm-12b — dense GQA transformer.

[dense] 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352
[hf:stabilityai/stablelm-2-1_6b family; hf]

G = 4 and head_dim 160: decode and prefill take the kernels' wide
tensor-core bodies.
"""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("stablelm-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        mlp_kind="swiglu",
        qkv_bias=False,
        rope_theta=10000.0,
    )

"""codeqwen1.5-7b — dense MHA transformer (qwen1.5 arch, QKV bias).

[dense] 32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf]

G = 1 query head per KV head: decode takes the decode kernel's narrow
tensor-core body at one query row per CTA.
"""
from repro_torch.configs.base import ModelConfig, register_arch


@register_arch("codeqwen1.5-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        mlp_kind="swiglu",
        qkv_bias=True,            # qwen1.5 uses attention QKV bias
        rope_theta=1_000_000.0,
    )

"""minicpm3-4b — dense transformer with Multi-head Latent Attention (MLA).

[mla] 62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448 — MLA
[hf:openbmb/MiniCPM3-4B; hf]

MLA: queries/keys split into nope+rope parts; the KV cache stores only the
compressed latent (kv_lora_rank) + the shared rope key -> effectively a
single shared KV stream per layer, the most extreme "low head count"
decode case: decode attends q (B, 40, 288) over a (B, L, 1, 288) latent
whose first 256 columns are V.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, register_arch


@register_arch("minicpm3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="mla",
        num_layers=62,
        d_model=2560,
        num_heads=40,
        num_kv_heads=40,          # MLA: full heads reconstructed from latent
        d_ff=6400,
        vocab_size=73448,
        mla=MLAConfig(
            kv_lora_rank=256,
            q_lora_rank=768,
            qk_nope_head_dim=64,
            qk_rope_head_dim=32,
            v_head_dim=64,
        ),
        mlp_kind="swiglu",
        rope_theta=10000.0,
    )

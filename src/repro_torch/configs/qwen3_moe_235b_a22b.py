"""qwen3-moe-235b-a22b — large MoE, 128 experts top-8.

[moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3 MoE family; hf]

Counterpart of ``repro.configs.qwen3_moe_235b_a22b``.  d_ff=1536 is the
PER-EXPERT hidden dim.  G = 16 query heads per KV head at head_dim 128:
the paper's low-head-count regime.  Its 94 layers (about 235e9
parameters, 470 GB in bf16) do not fit one 80 GB card, so a run on the
card cuts the depth (``cfg.replace(num_layers=...)``) and keeps the
widths.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register_arch


@register_arch("qwen3-moe-235b-a22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        d_ff=1536,                # per-expert
        vocab_size=151936,
        head_dim=128,
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536,
                      capacity_factor=1.25,
                      dispatch="ep_shard_map"),
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
    )

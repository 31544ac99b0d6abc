"""granite-moe-3b-a800m — small MoE, 40 experts top-8.

[moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
[hf:ibm-granite family; hf]

Counterpart of ``repro.configs.granite_moe_3b_a800m``.  G = 3 query heads
per KV head at head_dim 64.  ``dispatch="ep_shard_map"`` is the
reference's choice: expert parallel under a grid whose model axis
divides L, ``gather`` elsewhere.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register_arch


@register_arch("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,                 # per-expert
        vocab_size=49155,
        moe=MoEConfig(num_experts=40, top_k=8, d_expert=512,
                      capacity_factor=1.25,
                      dispatch="ep_shard_map"),
        mlp_kind="swiglu",
        rope_theta=10000.0,
    )

"""recurrentgemma-9b — hybrid RG-LRU + local attention, 1:2 attn:recurrent.

[hybrid] 38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000
RG-LRU + local attn, pattern (rglru, rglru, attn)  [arXiv:2402.19427]

Window-2048 local attention over a ring cache plus a linear recurrence.
Attention layers are MQA (kv=1): the paper's extreme low-head-count case
within the window.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, \
    register_arch


@register_arch("recurrentgemma-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        hybrid=HybridConfig(
            pattern=("rglru", "rglru", "attn"),
            window=2048,
            lru_width=4096,
            conv_width=4,
        ),
        mlp_kind="geglu",
        rope_theta=10000.0,
    )

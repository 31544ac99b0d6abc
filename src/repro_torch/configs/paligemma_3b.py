"""paligemma-3b — VLM: SigLIP stub frontend + gemma MQA backbone.

[vlm] 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216
SigLIP + gemma  [arXiv:2407.07726; hf]

The vision tower is a STUB: ``Model.frontend_inputs()`` names 256
precomputed patch embeddings (dim 1152) which the model projects into
d_model and prepends to the text sequence (``Model.prefill``).  MQA
(kv=1) decode at head_dim 256: the paper's most extreme low-head-count
case.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, \
    register_arch


@register_arch("paligemma-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        d_ff=16384,
        vocab_size=257216,
        head_dim=256,             # gemma-style: head_dim != d_model/heads
        frontend=FrontendConfig(kind="vision", num_positions=256,
                                embed_dim=1152),
        mlp_kind="geglu",
        rope_theta=10000.0,
    )

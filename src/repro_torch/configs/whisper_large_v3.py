"""whisper-large-v3 — encoder-decoder with an audio frontend (stub).

[audio] 32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866 — enc-dec
[arXiv:2212.04356]

32 encoder + 32 decoder layers.  The conv frontend is a STUB:
``Model.frontend_inputs()`` names 1500 precomputed frame embeddings (dim
1280).  The decoder cross-attends to the encoder output; its decode
launches read both the growing self-attention cache and the fixed
1500-frame cross cache, each split by the policy.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig, \
    register_arch


@register_arch("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        num_layers=32,            # decoder layers
        num_encoder_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        cross_attention=True,
        encoder_positions=1500,
        frontend=FrontendConfig(kind="audio", num_positions=1500,
                                embed_dim=1280),
        mlp_kind="gelu",
        rope_theta=0.0,           # whisper uses learned/sinusoidal positions
    )

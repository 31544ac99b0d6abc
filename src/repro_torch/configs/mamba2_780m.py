"""mamba2-780m — attention-free SSM (state-space duality / SSD).

[ssm] 48L d_model=1536 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060]

Attention-free: no attention launch, so the paper's split decision has
nothing to decide here.  d_inner = 2 * d_model = 3072, head_dim 64 -> 48
SSD heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register_arch


@register_arch("mamba2-780m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=48,             # SSD heads = d_inner / head_dim
        num_kv_heads=48,
        d_ff=0,                   # no separate MLP; the SSD block is the FFN
        vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, ngroups=1,
                      chunk_size=256, conv_width=4),
    )

"""Reduced (test-size) variants of the ported architectures.

Same family, same block wiring, same GQA group ratio, tiny widths —
the dense, moe, mla, ssm, vision, hybrid and encdec branches of
``repro.configs.reduced.reduced_config``, so one call with the same
arguments gives the same shape in both packages.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import HybridConfig, MLAConfig, \
    ModelConfig, MoEConfig, SSMConfig, check_ported, get_arch


def reduced_config(
    cfg_or_name: ModelConfig | str,
    *,
    num_layers: int = 2,
    d_model: int = 64,
    vocab_size: int = 256,
) -> ModelConfig:
    cfg = (get_arch(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    check_ported(cfg)
    # keep the GQA group ratio (it drives the paper's tile math)
    group = max(1, cfg.num_heads // max(1, cfg.num_kv_heads))
    heads = 4
    kw = dict(
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=max(1, heads // group),
        d_ff=4 * d_model,
        vocab_size=vocab_size,
        head_dim=d_model // heads,
        max_seq_len=4096,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=8, top_k=2, d_expert=d_model,
                              capacity_factor=2.0,
                              dispatch=cfg.moe.dispatch)
        kw["d_ff"] = d_model
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
        kw["num_kv_heads"] = heads            # MLA reconstructs all heads
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2,
                              ngroups=1, chunk_size=32, conv_width=4)
        kw["num_heads"] = 2 * d_model // 16   # d_inner / head_dim
        kw["num_kv_heads"] = kw["num_heads"]
        kw["d_ff"] = 0
    if cfg.hybrid is not None:
        kw["hybrid"] = HybridConfig(pattern=cfg.hybrid.pattern, window=64,
                                    lru_width=d_model, conv_width=4)
        kw["num_layers"] = max(num_layers, 4)  # cover pattern + remainder
    if cfg.frontend.kind == "vision":
        kw["frontend"] = dataclasses.replace(cfg.frontend, num_positions=8,
                                             embed_dim=48)
    if cfg.family == "encdec":
        kw["num_encoder_layers"] = 2
        kw["encoder_positions"] = 16
        kw["frontend"] = dataclasses.replace(cfg.frontend, num_positions=16,
                                             embed_dim=d_model)
        kw["max_seq_len"] = 512
    return dataclasses.replace(cfg, **kw)

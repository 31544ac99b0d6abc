"""Reduced (test-size) variants of the ported architectures.

Same family, same block wiring, same GQA group ratio, tiny widths —
the dense and moe branches of ``repro.configs.reduced.reduced_config``,
so one call with the same arguments gives the same shape in both
packages.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig, \
    check_ported, get_arch


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
    return dataclasses.replace(cfg, **kw)

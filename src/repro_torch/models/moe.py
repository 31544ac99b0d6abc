"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch.

Counterpart of ``repro.models.moe``.  Routing is per *group*, a
contiguous slab of tokens (by default one batch row), so a group's
tokens compete only with each other for an expert's ``capacity`` queue
slots.  Two dispatches compute the same function:

- ``gather``: each kept (token, k) assignment is copied into its
  expert's slot of an ``E x C`` buffer per group, every expert runs its
  SwiGLU over its ``C`` slots, and each token picks its outputs back by
  slot.  Every expert's weights are read whether or not a token chose
  it, as in the reference.
- ``einsum``: Switch-style one-hot dispatch and combine tensors.

``ep_shard_map``, the reference's expert-parallel dispatch over a mesh,
runs as ``gather`` here, as the reference's does without a mesh: the
mesh-native engine replicates a shard's weights (``param_policy=
"replicated"``), and the expert-parallel dispatch comes with the
tensor- and expert-parallel slice (``param_policy="tp"``).

Assignments queue k-major: every token's first choice takes a slot
before any second choice, so capacity overflow drops the least
confident assignments, and a dropped assignment contributes nothing.
The expert matmuls are ``torch.einsum``: the reference computes them
outside any Pallas kernel.  Ties in the router's probabilities go to
the lower expert index, as ``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, SpecModule

DISPATCHES = ("gather", "einsum", "ep_shard_map")


class MoE(SpecModule):
    """One layer's experts, named and shaped as the reference's: the
    float32 router (d, E), ``wi_gate`` / ``wi_up`` (E, d, f) and ``wo``
    (E, f, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
        super().__init__({
            "router": ParamSpec((d, e), dtype="float32"),
            "wi_gate": ParamSpec((e, d, f), fan_in=d),
            "wi_up": ParamSpec((e, d, f), fan_in=d),
            "wo": ParamSpec((e, f, d), fan_in=f),
        }, dtype, device)


def _capacity(group_size: int, num_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = math.ceil(capacity_factor * group_size * top_k / num_experts)
    return max(1, c)


def _route(p: MoE, cfg: ModelConfig, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (G, S, d) -> (gates (G, S, k) f32, experts (G, S, k), the
    router's probabilities (G, S, E) f32)."""
    moe = cfg.moe
    probs = torch.softmax(x.float() @ p.router, dim=-1)         # (G,S,E)
    # a stable descending sort breaks ties by the lower index, as
    # jax.lax.top_k does (torch.topk promises no order on ties)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top.values[..., :moe.top_k]
    experts = top.indices[..., :moe.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, experts, probs


def load_balance_loss(probs: torch.Tensor, experts: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """The Switch load-balance loss of one routing, as the reference's
    ``_route`` returns it: E * sum_e(fraction of top-1 choices * mean
    probability).  Serving does not need it; training will."""
    frac = F.one_hot(experts[..., 0], num_experts).float().mean(dim=(0, 1))
    return num_experts * (frac * probs.mean(dim=(0, 1))).sum()


def _positions_in_expert(experts: torch.Tensor, num_experts: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Queue position of each (token, k) routing decision within its
    expert, k-major: all top-1 choices queue before any top-2 choice.
    Returns (onehot (G, S, k, E), pos (G, S, k))."""
    G, S, K = experts.shape
    onehot = F.one_hot(experts, num_experts)
    flat = onehot.transpose(1, 2).reshape(G, K * S, num_experts)
    pos = (flat.cumsum(1) - 1).reshape(G, K, S, num_experts).transpose(1, 2)
    return onehot, (pos * onehot).sum(-1)


def _expert_ffn(p: MoE, xin: torch.Tensor) -> torch.Tensor:
    """xin: (..., E, C, d) -> (..., E, C, d) through each expert's
    SwiGLU."""
    g = F.silu(torch.einsum("...ecd,edf->...ecf", xin, p.wi_gate))
    u = torch.einsum("...ecd,edf->...ecf", xin, p.wi_up)
    return torch.einsum("...ecf,efd->...ecd", g * u, p.wo)


def _moe_einsum(p: MoE, cfg: ModelConfig, x: torch.Tensor, capacity: int
                ) -> torch.Tensor:
    """x: (G, S, d) -> (G, S, d).  One-hot dispatch and
    combine, one (G, S, E, C) tensor per k."""
    moe = cfg.moe
    G, S, d = x.shape
    E, C = moe.num_experts, capacity
    gates, experts, _ = _route(p, cfg, x)
    onehot, pos = _positions_in_expert(experts, E)
    keep = pos < C
    xin = x.new_zeros(G, E, C, d)
    disp = []
    for ki in range(moe.top_k):
        kept = keep[:, :, ki]
        slot = F.one_hot(torch.where(kept, pos[:, :, ki], 0), C).to(x.dtype)
        disp_k = (onehot[:, :, ki].to(x.dtype)[..., None]
                  * slot[:, :, None, :]
                  * kept[:, :, None, None].to(x.dtype))          # (G,S,E,C)
        disp.append(disp_k)
        xin = xin + torch.einsum("gsec,gsd->gecd", disp_k, x)
    xout = _expert_ffn(p, xin)
    out = torch.zeros_like(x)
    for ki, disp_k in enumerate(disp):
        comb = disp_k * gates[:, :, ki, None, None].to(x.dtype)
        out = out + torch.einsum("gsec,gecd->gsd", comb, xout)
    return out


def _moe_gather(p: MoE, cfg: ModelConfig, x: torch.Tensor, capacity: int
                ) -> torch.Tensor:
    """x: (G, S, d) -> (G, S, d).  Kept assignments are copied
    to slot ``expert * C + pos`` of a per-group buffer; dropped ones go to
    its extra last row, which no expert reads and which combines as
    zeros."""
    moe = cfg.moe
    G, S, d = x.shape
    E, C, K = moe.num_experts, capacity, moe.top_k
    gates, experts, _ = _route(p, cfg, x)
    _, pos = _positions_in_expert(experts, E)
    slot = torch.where(pos < C, experts * C + pos, E * C).reshape(G, S * K)
    rows = torch.arange(G, device=x.device)[:, None]
    buf = x.new_zeros(G, E * C + 1, d)
    buf[rows, slot] = x.repeat_interleave(K, dim=1)             # dispatch
    xout = _expert_ffn(p, buf[:, :E * C].reshape(G, E, C, d))
    xout = torch.cat([xout.reshape(G, E * C, d), x.new_zeros(G, 1, d)], 1)
    picked = xout[rows, slot].reshape(G, S, K, d)               # combine
    return (picked * gates[..., None].to(x.dtype)).sum(2)


def apply_moe(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
              dispatch: Optional[str] = None, group_size: int = 0
              ) -> torch.Tensor:
    """MoE FFN over (B, L, d) activations -> (B, L, d).

    Groups are the (B, L) rows by default; ``group_size`` < L cuts each
    row into groups of that many tokens.  ``dispatch`` defaults to the
    config's.  The reference also returns the load-balance loss, which
    serving discards; ``load_balance_loss`` computes it from ``_route``."""
    B, L, d = x.shape
    moe = cfg.moe
    dispatch = dispatch or moe.dispatch
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; known: "
                         f"{DISPATCHES}")
    if dispatch == "ep_shard_map":
        dispatch = "gather"                 # replicated experts: no mesh
    if group_size and group_size < L:
        xg = x.reshape(B * (L // group_size), group_size, d)
    else:
        group_size = L
        xg = x
    cap = _capacity(group_size, moe.num_experts, moe.top_k,
                    moe.capacity_factor)
    fn = _moe_gather if dispatch == "gather" else _moe_einsum
    return fn(p, cfg, xg, cap).reshape(B, L, d)

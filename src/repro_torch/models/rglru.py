"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``: the temporal-mixing half of a
Griffin block,

    branch_a = conv1d(W_in_a x)  -> RG-LRU linear recurrence
    branch_b = gelu(W_in_b x)
    out      = W_out (branch_a * branch_b)

with ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)`` and ``a_t = exp(-c
softplus(Lambda) r_t)``.  The gates and the recurrence run in float32, as
in the reference.  The reference scans the recurrence with
``jax.lax.associative_scan``; here :func:`linear_scan` runs the same
associative combine as a log-depth (Hillis-Steele) scan in float32, so
the sums differ from the reference's in order only.  A layer's
decode cache is ``state`` (B, w) float32, the last hidden state, and
``conv`` (B, conv_width - 1, w), the causal conv's input tail, oldest row
first; decode updates both in place.  No Pallas kernel of the reference
is reached: the block is GEMMs and elementwise work.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, SpecModule

LayerCache = Dict[str, torch.Tensor]
_C = 8.0                               # RG-LRU decay sharpness constant


def lru_width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


class RGLRU(SpecModule):
    """RG-LRU weights in the reference's layout and names."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        d, w = cfg.d_model, lru_width(cfg)
        cw = cfg.hybrid.conv_width
        super().__init__({
            "w_in_a": ParamSpec((d, w), ("embed", "state")),
            "w_in_b": ParamSpec((d, w), ("embed", "state")),
            "conv_w": ParamSpec((cw, w), (None, "state"), fan_in=cw),
            "conv_b": ParamSpec((w,), ("state",), init="zeros"),
            "lam": ParamSpec((w,), ("state",), init="ones"),
            "w_gate_i": ParamSpec((w, w), ("state", None)),
            "b_gate_i": ParamSpec((w,), ("state",), init="zeros"),
            "w_gate_r": ParamSpec((w, w), ("state", None)),
            "b_gate_r": ParamSpec((w,), ("state",), init="zeros"),
            "w_out": ParamSpec((w, d), ("state", "embed")),
        }, dtype, device)


def cache_shapes(cfg: ModelConfig, batch: int):
    """A layer's decode cache: name -> (shape, dtype).  The conv tail is
    bfloat16 whatever the model's dtype, as the reference's spec."""
    w = lru_width(cfg)
    return {"state": ((batch, w), torch.float32),
            "conv": ((batch, cfg.hybrid.conv_width - 1, w),
                     torch.bfloat16)}


def _gates(p: RGLRU, xa: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (a, the gated input scaled by sqrt(1 - a^2)), float32, shapes
    of ``xa``."""
    xf = xa.float()
    i_t = torch.sigmoid(xf @ p.w_gate_i.float() + p.b_gate_i.float())
    r_t = torch.sigmoid(xf @ p.w_gate_r.float() + p.b_gate_r.float())
    a = torch.exp(-_C * F.softplus(p.lam.float()) * r_t)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_t * xf)
    return a, b


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv along L, x (B, L, W): tap ``w[0]`` pairs with
    the current row, ``w[i]`` with the row i back, in float32, rounded to
    x's dtype."""
    cw, L = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        out = out + pad[:, i:i + L].float() * w[cw - 1 - i].float()
    return (out + b.float()).to(x.dtype)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` along dim 1 from ``h_{-1} = 0``, for
    every t at once: ceil(log2 L) rounds of the associative combine
    ``(a_l, b_l) . (a_r, b_r) = (a_l a_r, b_l a_r + b_r)``, each a few
    elementwise ops over the whole sequence."""
    a, b = a.clone(), b.clone()
    off, L = 1, a.shape[1]
    while off < L:
        b[:, off:] = a[:, off:] * b[:, :-off] + b[:, off:]
        a[:, off:] = a[:, off:] * a[:, :-off]
        off *= 2
    return b


def apply_rglru_train(p: RGLRU, cfg: ModelConfig, x: torch.Tensor, *,
                      return_cache: bool = False):
    """x (B, L, d) -> (B, L, d) through the whole block; with
    ``return_cache`` also the decode cache after row L - 1: ``state`` the
    last hidden state (B, w) f32 and ``conv`` the last ``conv_width - 1``
    rows of ``x W_in_a`` (zero rows in front when L is shorter), in the
    activation dtype, as the reference's prefill emits it."""
    xa_lin = x @ p.w_in_a
    xa = _conv(xa_lin, p.conv_w, p.conv_b)
    xb = F.gelu((x @ p.w_in_b).float(), approximate="tanh")
    h = linear_scan(*_gates(p, xa))
    out = (h * xb).to(x.dtype) @ p.w_out
    if not return_cache:
        return out
    tail = cfg.hybrid.conv_width - 1
    conv = xa_lin[:, -tail:] if tail else xa_lin[:, :0]
    if conv.shape[1] < tail:
        conv = F.pad(conv, (0, 0, tail - conv.shape[1], 0))
    return out, {"state": h[:, -1], "conv": conv.to(getattr(torch,
                                                           cfg.dtype))}


def apply_rglru_decode(p: RGLRU, cfg: ModelConfig, x: torch.Tensor,
                       cache: LayerCache) -> torch.Tensor:
    """One token a slot, x (B, 1, d) -> (B, 1, d).  Updates ``cache`` in
    place: the conv tail shifts by one row (the new row cast to its
    dtype, which the current step's conv reads too, as the reference's
    does) and ``state`` takes the new hidden state.  The tail holds rows
    oldest first, so the taps run flipped against :func:`_conv`'s."""
    xa_lin = x[:, 0] @ p.w_in_a                          # (B, w)
    conv_in = torch.cat([cache["conv"],
                         xa_lin[:, None].to(cache["conv"].dtype)], dim=1)
    xa = torch.einsum("bwc,wc->bc", conv_in.float(),
                      p.conv_w.float().flip(0)) + p.conv_b.float()
    xb = F.gelu((x[:, 0] @ p.w_in_b).float(), approximate="tanh")
    a, bt = _gates(p, xa)
    h = a * cache["state"] + bt
    cache["state"].copy_(h)
    cache["conv"].copy_(conv_in[:, 1:])
    return ((h * xb).to(x.dtype) @ p.w_out)[:, None]

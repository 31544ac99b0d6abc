"""AdamW, the reference's arithmetic, updating the weights in place.

Counterpart of ``repro.training.optimizer``.  A tree here is a flat dict
of tensors keyed by parameter name (the weights' ``named_parameters``).
Moments are float32 whatever the weights' dtype, as in the reference.

:func:`adamw_update` computes what the reference's computes, leaf by
leaf in float32, but writes the new weights and moments into the
existing tensors under ``torch.no_grad()`` instead of returning new
trees: at full width (qwen2.5-3b, 3.4 B weights) a second copy of the
weights and both moments would cost another 34 GB.  Only one leaf's
float32 temporaries live at a time.  One departure: the global norm sums
its squares in float64 (:func:`_norm64`), where the reference's float32
sum overflows to inf, and its clip then zeroes every gradient.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple, Union

import torch

from repro_torch.configs.base import OptimizerConfig

Tree = Mapping[str, torch.Tensor]


def adamw_init(params: Tree) -> Dict[str, object]:
    """Zero float32 moments ``m`` and ``v`` beside every weight, and the
    step ``count`` (int32, on the weights' device)."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"m": zeros, "v": {n: torch.zeros_like(z)
                              for n, z in zeros.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(cfg: OptimizerConfig,
                step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup, then cosine, linear or constant decay, in float32
    (a 0-d tensor on ``step``'s device)."""
    stepf = torch.as_tensor(step).to(torch.float32)
    warm = max(1.0, float(cfg.warmup_steps))
    warmup = stepf / warm
    total = max(1.0, float(cfg.total_steps - cfg.warmup_steps))
    t = torch.clamp((stepf - warm) / total, 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - t
    else:
        decay = torch.ones_like(stepf)
    return cfg.lr * torch.where(stepf < warm, warmup, decay)


def _norm64(tree: Tree) -> torch.Tensor:
    """The 2-norm of every leaf together, its squares summed in float64.
    The reference sums them in float32, which overflows once the norm
    passes about 1.8e19: full-width qwen2.5-3b at its 36 layers with
    seeded random weights has gradients of norm 1e23 at step 0."""
    sums = [torch.sum(torch.square(x.double())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def global_norm(tree: Tree) -> torch.Tensor:
    """The 2-norm of every leaf together, as float32 (summed in float64:
    :func:`_norm64`)."""
    return _norm64(tree).float()


def _clip_scale(norm64: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / norm) in float32, from the float64 norm."""
    return torch.clamp(max_norm / torch.clamp(norm64, min=1e-9),
                       max=1.0).float()


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), rounded to their dtypes;
    the norm before clipping, float32)."""
    norm = _norm64(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: (g.float() * scale).to(g.dtype)
            for n, g in grads.items()}, norm.float()


@torch.no_grad()
def adamw_update(grads: Tree, state: Dict[str, object], params: Tree,
                 cfg: OptimizerConfig) -> Dict[str, torch.Tensor]:
    """One AdamW step, in place: ``params`` and ``state``'s moments and
    count are overwritten.  Gradients are clipped to
    ``cfg.grad_clip_norm`` first (when it is positive).  Returns the
    metrics ``grad_norm`` (before clipping) and ``lr`` (this step's),
    0-d float32 tensors."""
    norm = _norm64(grads)
    scale = (_clip_scale(norm, cfg.grad_clip_norm)
             if cfg.grad_clip_norm > 0 else None)
    state["count"].add_(1)
    countf = state["count"].to(torch.float32)
    lr = lr_schedule(cfg, state["count"])
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, countf)
    bc2 = 1.0 - torch.pow(b2, countf)
    for name, p in params.items():
        g = grads[name]
        gf = g.float()
        if scale is not None:
            gf = (gf * scale).to(g.dtype).float()
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        step = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        pf = p.float()
        step.add_(cfg.weight_decay * pf)
        p.copy_(pf.sub_(lr * step))
    return {"grad_norm": norm.float(), "lr": lr}

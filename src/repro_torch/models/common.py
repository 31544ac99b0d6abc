"""Shared model machinery: parameter specs, norms, RoPE, MLP, embeddings.

Counterpart of ``repro.models.common``.  Parameters keep the reference's
layout and names (``wq`` is (d_model, H, D), ``tok`` is (vocab,
d_model), ...), declared per module as :class:`ParamSpec`\\ s on a
:class:`SpecModule`, so weights pass between the packages unchanged
(:mod:`repro_torch.interop`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor."""
    shape: Tuple[int, ...]
    init: str = "normal"                     # normal | zeros | ones
    fan_in: Optional[int] = None             # stddev = 1/sqrt(fan_in)
    dtype: Optional[str] = None              # None = the module's dtype

    @property
    def std(self) -> float:
        fan_in = self.fan_in if self.fan_in else (
            self.shape[-2] if len(self.shape) >= 2 else self.shape[-1])
        return 1.0 / math.sqrt(max(1, fan_in))


class SpecModule(nn.Module):
    """A module whose parameters are declared by ParamSpecs.  Parameters
    are allocated uninitialised, in the spec's dtype when it names one
    (the MoE router's float32) and in ``dtype`` otherwise;
    :func:`init_params` or a state dict fills them.  They are inference
    weights: no gradients."""

    def __init__(self, specs: Dict[str, ParamSpec], dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.specs = specs
        for name, spec in specs.items():
            dt = getattr(torch, spec.dtype) if spec.dtype else dtype
            self.register_parameter(name, nn.Parameter(
                torch.empty(spec.shape, dtype=dt, device=device),
                requires_grad=False))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every SpecModule parameter of ``module`` from ``generator``:
    normal with std 1/sqrt(fan_in) (fan_in defaults to ``shape[-2]``, as
    in the reference), or zeros / ones.  Draws are made in float32 and
    rounded to the parameter dtype.  The generator must live on the
    parameters' device."""
    for sub in module.modules():
        if not isinstance(sub, SpecModule):
            continue
        for name, spec in sub.specs.items():
            p = getattr(sub, name)
            if spec.init == "zeros":
                p.zero_()
            elif spec.init == "ones":
                p.fill_(1.0)
            else:
                draw = torch.randn(spec.shape, generator=generator,
                                   device=p.device, dtype=torch.float32)
                p.copy_(draw * spec.std)
    return module


class RMSNorm(SpecModule):
    def __init__(self, d: int, dtype, device):
        super().__init__({"scale": ParamSpec((d,), init="ones")}, dtype,
                         device)


class LayerNorm(SpecModule):
    """LayerNorm weights, scale and bias (the encdec family's norm)."""

    def __init__(self, d: int, dtype, device):
        super().__init__({"scale": ParamSpec((d,), init="ones"),
                          "bias": ParamSpec((d,), init="zeros")}, dtype,
                         device)


class MLP(SpecModule):
    """Gated MLP weights (swiglu and geglu share them)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__({
            "wi_gate": ParamSpec((d_model, d_ff)),
            "wi_up": ParamSpec((d_model, d_ff)),
            "wo": ParamSpec((d_ff, d_model)),
        }, dtype, device)


class GeluMLP(SpecModule):
    """Plain gelu MLP weights with biases (Whisper's)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__({
            "wi": ParamSpec((d_model, d_ff)),
            "bi": ParamSpec((d_ff,), init="zeros"),
            "wo": ParamSpec((d_ff, d_model)),
            "bo": ParamSpec((d_model,), init="zeros"),
        }, dtype, device)


def mlp_module(d_model: int, d_ff: int, kind: str, dtype, device):
    """The MLP weights of ``kind``: gated for swiglu / geglu, plain with
    biases for gelu."""
    cls = GeluMLP if kind == "gelu" else MLP
    return cls(d_model, d_ff, dtype, device)


class Embed(SpecModule):
    def __init__(self, vocab: int, d_model: int, tie: bool, dtype, device):
        specs = {"tok": ParamSpec((vocab, d_model), fan_in=d_model)}
        if not tie:
            specs["unembed"] = ParamSpec((d_model, vocab))
        super().__init__(specs, dtype, device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(p: SpecModule, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm when the norm has a bias, RMSNorm otherwise, as the
    reference's ``apply_norm`` branches."""
    if "bias" in p.specs:
        return layer_norm(x, p.scale, p.bias, eps)
    return rms_norm(x, p.scale, eps)


def sinusoidal_positions(length: int, dim: int, device=None
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (length, dim) float32,
    the reference's: frequencies ``exp(-ln(1e4) i / max(1, half - 1))``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=device) / max(1, half - 1))
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embedding (half of head_dim)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Rope:
    """cos and sin of the rotary angles, (..., L, 1, head_dim/2) float32,
    for positions (..., L); None when the model has no RoPE.  Computed
    once per forward pass and shared by every layer's q and k (the
    reference recomputes them inside each ``apply_rope``)."""
    if theta <= 0:
        return None
    inv = rope_frequencies(head_dim, theta, device=positions.device)
    ang = (positions[..., None].float() * inv)[..., None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """Rotary embedding, rotate-half (GPT-NeoX) style, in float32.

    x: (..., L, H, D); rope: :func:`rope_angles` of its positions.
    """
    if rope is None:
        return x
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mlp(p: SpecModule, x: torch.Tensor,
              kind: str = "swiglu") -> torch.Tensor:
    """Gated MLP: silu (swiglu) or gelu (geglu) of the gate, times the up
    projection; or, for ``kind="gelu"`` over :class:`GeluMLP` weights,
    the plain ``gelu(x wi + bi) wo + bo``.  Every gelu is the tanh
    approximation, which is what the reference's ``jax.nn.gelu``
    computes by default."""
    if kind == "gelu" and isinstance(p, GeluMLP):
        h = F.gelu(x @ p.wi + p.bi.to(x.dtype), approximate="tanh")
        return h @ p.wo + p.bo.to(x.dtype)
    if kind == "swiglu":
        g = F.silu(x @ p.wi_gate)
    elif kind == "geglu":
        g = F.gelu(x @ p.wi_gate, approximate="tanh")
    else:
        raise ValueError(f"gated MLP weights take only the swiglu and "
                         f"geglu kinds (gelu takes GeluMLP's), got "
                         f"{kind!r}")
    return (g * (x @ p.wi_up)) @ p.wo


def embed_tokens(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.tok[tokens]


def unembed(p: Embed, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits in float32."""
    w = p.unembed if "unembed" in p.specs else p.tok.T
    return x.float() @ w.float()

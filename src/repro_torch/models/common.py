"""Shared model machinery: parameter specs, norms, RoPE, MLP, embeddings.

Counterpart of ``repro.models.common``.  Parameters keep the reference's
layout and names (``wq`` is (d_model, H, D), ``tok`` is (vocab,
d_model), ...), declared per module as :class:`ParamSpec`\\ s on a
:class:`SpecModule`, so weights pass between the packages unchanged
(:mod:`repro_torch.interop`).

Tensor parallelism: :class:`TPModule` stands in for a module whose
weights :func:`repro_torch.sharding.place.place_params` placed over the
devices of a grid's ``model`` axis.  The model code runs unchanged on
it: the leaf ops that read a sharded weight (the projections here and in
the attention, MLA and MoE modules) run one part a device and join or
sum the parts on the lead device, x's device.  :func:`tp_join` and
:func:`tp_sum` are the two moves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter tensor: its shape, the reference's
    logical axis name per dim (``embed``, ``heads``, ``kv_heads``,
    ``head_dim``, ``ff``, ``vocab``, ``experts``, ``state``, ``seq`` or
    None), which :mod:`repro_torch.sharding.rules` maps onto a device
    grid, and its initialisation."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis per dim
    init: str = "normal"                     # normal | zeros | ones
    fan_in: Optional[int] = None             # stddev = 1/sqrt(fan_in)
    dtype: Optional[str] = None              # None = the module's dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")

    @property
    def std(self) -> float:
        fan_in = self.fan_in if self.fan_in else (
            self.shape[-2] if len(self.shape) >= 2 else self.shape[-1])
        return 1.0 / math.sqrt(max(1, fan_in))


def logical_axes(module: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """Every SpecModule parameter of ``module`` -> its logical axes, keyed
    by the parameter's dotted name in ``module.state_dict()`` (the
    reference's ``logical_axes`` of its spec tree, whose layer stacks
    add a leading ``layers`` axis)."""
    out: Dict[str, Tuple[Optional[str], ...]] = {}
    for prefix, sub in module.named_modules():
        if isinstance(sub, SpecModule):
            for name, spec in sub.specs.items():
                out[f"{prefix}.{name}" if prefix else name] = spec.axes
    return out


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
        super().__init__({"scale": ParamSpec((d,), ("embed",), init="ones")},
                         dtype, device)


class LayerNorm(SpecModule):
    """LayerNorm weights, scale and bias (the encdec family's norm)."""

    def __init__(self, d: int, dtype, device):
        super().__init__({"scale": ParamSpec((d,), ("embed",), init="ones"),
                          "bias": ParamSpec((d,), ("embed",), init="zeros")},
                         dtype, device)


class MLP(SpecModule):
    """Gated MLP weights (swiglu and geglu share them)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__({
            "wi_gate": ParamSpec((d_model, d_ff), ("embed", "ff")),
            "wi_up": ParamSpec((d_model, d_ff), ("embed", "ff")),
            "wo": ParamSpec((d_ff, d_model), ("ff", "embed")),
        }, dtype, device)


class GeluMLP(SpecModule):
    """Plain gelu MLP weights with biases (Whisper's)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__({
            "wi": ParamSpec((d_model, d_ff), ("embed", "ff")),
            "bi": ParamSpec((d_ff,), ("ff",), init="zeros"),
            "wo": ParamSpec((d_ff, d_model), ("ff", "embed")),
            "bo": ParamSpec((d_model,), ("embed",), init="zeros"),
        }, dtype, device)


def mlp_module(d_model: int, d_ff: int, kind: str, dtype, device):
    """The MLP weights of ``kind``: gated for swiglu / geglu, plain with
    biases for gelu."""
    cls = GeluMLP if kind == "gelu" else MLP
    return cls(d_model, d_ff, dtype, device)


class Embed(SpecModule):
    def __init__(self, vocab: int, d_model: int, tie: bool, dtype, device):
        specs = {"tok": ParamSpec((vocab, d_model), ("vocab", "embed"),
                                 fan_in=d_model)}
        if not tie:
            specs["unembed"] = ParamSpec((d_model, vocab), ("embed", "vocab"))
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
    computes by default.  Over ``ff``-sharded weights each device
    computes its slice of the hidden units and the partial outputs sum
    (:func:`tp_sum`); GeluMLP's output bias, which every device holds
    whole, is added once, after the sum."""
    if sharded(p, "wo") is not None:
        if kind == "gelu" and isinstance(p.mods[0], GeluMLP):
            return tp_sum(p, _gelu_hidden_out, x) + p.bo.to(x.dtype)
        return tp_sum(p, lambda mod, xs: apply_mlp(mod, xs, kind), x)
    if kind == "gelu" and isinstance(p, GeluMLP):
        return _gelu_hidden_out(p, x) + p.bo.to(x.dtype)
    if kind == "swiglu":
        g = F.silu(x @ p.wi_gate)
    elif kind == "geglu":
        g = F.gelu(x @ p.wi_gate, approximate="tanh")
    else:
        raise ValueError(f"gated MLP weights take only the swiglu and "
                         f"geglu kinds (gelu takes GeluMLP's), got "
                         f"{kind!r}")
    return (g * (x @ p.wi_up)) @ p.wo


def _gelu_hidden_out(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """``gelu(x wi + bi) wo``: GeluMLP's output before its bias."""
    h = F.gelu(x @ p.wi + p.bi.to(x.dtype), approximate="tanh")
    return h @ p.wo


def embed_tokens(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``.  Over a vocab-sharded table each device
    looks up its range of rows, zero outside it, and the parts sum on
    the lead device: exactly one part holds each row."""
    if sharded(p, "tok") is None:
        return p.tok[tokens]

    out = None
    for s, (mod, dev) in enumerate(zip(p.mods, p.devices)):
        rows = mod.tok.shape[0]
        local = tokens.to(dev) - s * rows
        own = (local >= 0) & (local < rows)
        e = mod.tok[local.clamp(0, rows - 1)] * own[..., None].to(
            mod.tok.dtype)
        e = e.to(tokens.device)
        out = e if out is None else out + e
    return out


def unembed(p: Embed, x: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits in float32.  Over a vocab-sharded table
    each device computes its vocab range's logits, joined on the lead."""
    name = "unembed" if "unembed" in p.specs else "tok"
    if sharded(p, name) is None:
        w = p.unembed if name == "unembed" else p.tok.T
        return x.float() @ w.float()
    return tp_join(p, lambda mod, xs: xs.float() @ (
        mod.unembed if name == "unembed" else mod.tok.T).float(), x,
        dim=-1)


# ---------------------------------------------------------------------------
# Tensor parallelism over a grid's model axis
# ---------------------------------------------------------------------------


class TPModule:
    """A module's weights placed over the ``model`` axis of one grid row.

    ``mods[s]`` is a module of the original's class whose parameters are
    device ``s``'s: its slice of each parameter the axis cuts (``dims``
    names the cut dim, None where the parameter stays whole), the whole
    of every other.  Submodules are TPModules too (``children``; a
    ``ModuleList`` is a list of them).  Attribute reads resolve to a
    child, to a whole parameter (the lead device's copy) or to the
    original's ``kind``; reading a cut parameter whole raises, so code
    that has no tensor-parallel form fails instead of computing on a
    slice.  :meth:`whole` joins a cut parameter on the lead device."""

    def __init__(self, mods: Sequence[nn.Module],
                 devices: Sequence[torch.device],
                 dims: Dict[str, Optional[int]],
                 children: Dict[str, object], kind: Optional[str] = None):
        self.__dict__.update(mods=tuple(mods), devices=tuple(devices),
                             dims=dict(dims), children=dict(children),
                             kind=kind)

    def __getattr__(self, name: str):
        d = self.__dict__
        if name in d["children"]:
            return d["children"][name]
        if name in d["dims"]:
            if d["dims"][name] is not None:
                raise AttributeError(
                    f"{name} is cut over the model axis (dim "
                    f"{d['dims'][name]}); use TPModule.whole or a "
                    "tensor-parallel op")
            return getattr(d["mods"][0], name)
        raise AttributeError(name)

    @property
    def specs(self) -> Dict[str, ParamSpec]:
        return self.mods[0].specs

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def whole(self, name: str) -> torch.Tensor:
        """Parameter ``name`` whole on the lead device (a join of the
        devices' slices where the axis cuts it)."""
        dim = self.dims[name]
        if dim is None:
            return getattr(self.mods[0], name)
        return torch.cat([getattr(m, name).to(self.lead)
                          for m in self.mods], dim)


def sharded(p, name: str) -> Optional[int]:
    """The dim of ``p``'s parameter ``name`` that the model axis cuts, or
    None (a plain module, or a parameter every device holds whole)."""
    return p.dims.get(name) if isinstance(p, TPModule) else None


def whole(p, name: str) -> torch.Tensor:
    """Parameter ``name`` of a module or a TPModule, whole, on the lead."""
    return p.whole(name) if isinstance(p, TPModule) else getattr(p, name)


def tp_parts(p: TPModule, fn: Callable, *args: torch.Tensor,
             split: Optional[Tuple[int, ...]] = None) -> List[torch.Tensor]:
    """``fn(mods[s], *args_s)`` for every device ``s`` in order, each
    part moved to the lead device (args[0]'s).  ``args_s`` are ``args``
    moved to device ``s``; with ``split``, ``args[i]`` is first cut into
    equal chunks along dim ``split[i]`` (None: passed whole) and device
    ``s`` takes chunk ``s``."""
    lead = args[0].device
    n = len(p.devices)
    out = []
    for s, (mod, dev) in enumerate(zip(p.mods, p.devices)):
        local = []
        for i, a in enumerate(args):
            dim = split[i] if split is not None else None
            if dim is not None:
                c = a.shape[dim] // n
                a = a.narrow(dim, s * c, c)
            local.append(a.to(dev))
        out.append(fn(mod, *local).to(lead))
    return out


def tp_join(p: TPModule, fn: Callable, *args: torch.Tensor, dim: int,
            split: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The devices' parts of :func:`tp_parts` joined along ``dim`` on
    the lead device (a column-parallel op: each device computes its
    heads, its vocab range, its experts)."""
    return torch.cat(tp_parts(p, fn, *args, split=split), dim)


def tp_sum(p: TPModule, fn: Callable, *args: torch.Tensor,
           split: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The devices' parts of :func:`tp_parts` summed on the lead device
    in device order (a row-parallel op: each device's partial product
    over its slice of the contracted dim)."""
    parts = tp_parts(p, fn, *args, split=split)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out

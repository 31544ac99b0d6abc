"""Mamba-2 block: State-Space Duality (SSD), chunked matmul form.

Counterpart of ``repro.models.ssd``.  Prefill runs the chunked SSD
algorithm (arXiv:2405.21060 §6): within a chunk the recurrence is
expanded into attention-like matmuls; across chunks a Python loop over
the ``nc`` chunks carries the (H, P, N) state, where the reference runs a
``lax.scan``.  Decode is the pure recurrence, one state update a token:
no attention, no KV cache, so no kernel launch and no split to plan.
The scan, the state and the decode step compute in float32 whatever the
model's dtype, as the reference's do.  A layer's decode cache is
``state`` (B, H, P, N) float32 and ``conv`` (B, conv_width - 1,
conv_dim), the causal conv's input tail, oldest row first; decode
updates both in place.  No Pallas kernel of the reference is reached.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, SpecModule, rms_norm

LayerCache = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, SSD heads, conv channels)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.ngroups * s.state_dim
    return d_inner, nheads, conv_dim


def ssd_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """The block's weights, in the reference's names and shapes."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * s.ngroups * s.state_dim + nheads
    return {
        "in_proj": ParamSpec((d, d_in_proj), ("embed", "state")),
        "conv_w": ParamSpec((s.conv_width, conv_dim), (None, "state"),
                            fan_in=s.conv_width),
        "conv_b": ParamSpec((conv_dim,), ("state",), init="zeros"),
        "A_log": ParamSpec((nheads,), ("heads",), init="zeros"),
        "D": ParamSpec((nheads,), ("heads",), init="ones"),
        "dt_bias": ParamSpec((nheads,), ("heads",), init="zeros"),
        "norm": ParamSpec((d_inner,), ("state",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("state", "embed")),
    }


class SSD(SpecModule):
    """Mamba-2 SSD weights (:func:`ssd_specs`)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(ssd_specs(cfg), dtype, device)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """The input projection's output -> (z, xBC, dt)."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    gn = s.ngroups * s.state_dim
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]
    dt = zxbcdt[..., -nheads:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along L, then SiLU; xbc (B, L, C), w (W, C).
    Tap ``w[0]`` pairs with the current row, ``w[i]`` with the row i
    back, in float32, rounded to xbc's dtype."""
    W, L = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(W):                        # static small loop (W = 4)
        out = out + pad[:, i:i + L].float() * w[W - 1 - i].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise sums: out[..., i, j] = sum a[j+1..i],
    -inf above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C_: torch.Tensor, *, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x (B, L, H, P), dt (B, L, H) after softplus, A (H,)
    negative, B_ / C_ (B, L, G, N), L a multiple of ``chunk``.  Returns
    (y (B, L, H, P) in x's dtype, the final state (B, H, P, N) float32);
    ``init_state`` (B, H, P, N) is the state before row 0."""
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if L % chunk:
        raise ValueError(f"pad L={L} to chunk={chunk}")
    nc = L // chunk
    rep = H // G
    f32 = torch.float32
    xf = x.to(f32).reshape(Bb, nc, chunk, H, P)
    dtf = dt.to(f32).reshape(Bb, nc, chunk, H)
    Bh = B_.to(f32).reshape(Bb, nc, chunk, G, N).repeat_interleave(rep, 3)
    Ch = C_.to(f32).reshape(Bb, nc, chunk, G, N).repeat_interleave(rep, 3)

    a = (dtf * A.to(f32)).permute(0, 3, 1, 2)          # (B, H, nc, q)
    a_cs = torch.cumsum(a, dim=-1)
    xdt = xf * dtf[..., None]                          # (B, nc, q, H, P)

    # 1. within each chunk (the diagonal blocks)
    Lmat = torch.exp(_segsum(a))                       # (B, H, nc, q, q)
    scores = torch.einsum("bcqhn,bcshn->bhcqs", Ch, Bh)
    y_diag = torch.einsum("bhcqs,bcshp->bcqhp", scores * Lmat, xdt)

    # 2. each chunk's state: every row decayed to the chunk's end
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)    # (B, H, nc, q)
    states = torch.einsum("bcshn,bhcs,bcshp->bchpn", Bh, decay_states, xdt)

    # 3. the recurrence over chunks; each chunk reads the state before it
    chunk_decay = torch.exp(a_cs[..., -1])             # (B, H, nc)
    carry = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)             # (B, nc, H, P, N)

    # 4. the carried state's contribution to each row of its chunk
    y_off = torch.einsum("bcqhn,bchpn,bhcq->bcqhp", Ch, prev_states,
                         torch.exp(a_cs))
    y = (y_diag + y_off).reshape(Bb, L, H, P)
    return y.to(x.dtype), carry


def ssd_recurrent(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B_: torch.Tensor, C_: torch.Tensor, *,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence one row at a time, the function
    :func:`ssd_chunked` computes: ``state_t = exp(dt_t A) state_{t-1} +
    dt_t x_t B_t^T`` and ``y_t = state_t C_t``, with :func:`ssd_chunked`'s
    shapes and no chunk.  It computes in float64 when x is float64 (an
    oracle for the chunked scan), else in float32; returns (y, the final
    state) in that dtype."""
    dt_ = torch.float64 if x.dtype == torch.float64 else torch.float32
    Bb, L, H, P = x.shape
    rep = H // B_.shape[2]
    Bh = B_.to(dt_).repeat_interleave(rep, 2)          # (B, L, H, N)
    Ch = C_.to(dt_).repeat_interleave(rep, 2)
    xf, dtf, Af = x.to(dt_), dt.to(dt_), A.to(dt_)
    state = (torch.zeros((Bb, H, P, B_.shape[3]), dtype=dt_,
                         device=x.device)
             if init_state is None else init_state.to(dt_))
    ys = []
    for t in range(L):
        state = state * torch.exp(dtf[:, t] * Af)[..., None, None] \
            + torch.einsum("bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t],
                           Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1), state


def _tail_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last n rows along dim 1, zero rows in front if L < n."""
    L = x.shape[1]
    if L >= n:
        return x[:, L - n:]
    return F.pad(x, (0, 0, n - L, 0))


def scan_inputs(p: SSD, cfg: ModelConfig, x: torch.Tensor):
    """The block's prologue over x (B, L, d): (z, the conv's input xBC,
    the scan's x (B, L, d_inner) after the conv, dt (B, L, H) after
    softplus in float32, A (H,) float32, B_ and C_ (B, L, G, N)), the
    operands :func:`ssd_chunked` takes once x is cut into heads."""
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    gn = s.ngroups * s.state_dim
    Bb, L = x.shape[:2]
    z, xbc_raw, dt = _split_proj(cfg, x @ p.in_proj)
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    xs = xbc[..., :d_inner]
    B_ = xbc[..., d_inner:d_inner + gn].reshape(Bb, L, s.ngroups,
                                                s.state_dim)
    C_ = xbc[..., d_inner + gn:].reshape(Bb, L, s.ngroups, s.state_dim)
    dt = F.softplus(dt.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    return z, xbc_raw, xs, dt, A, B_, C_


def apply_ssd_train(p: SSD, cfg: ModelConfig, x: torch.Tensor, *,
                    init_state: Optional[torch.Tensor] = None,
                    return_state: bool = False,
                    return_cache: bool = False):
    """The whole Mamba-2 block over x (B, L, d) -> (B, L, d); with
    ``return_state`` also the final SSD state (B, H, P, N) float32, with
    ``return_cache`` the decode cache after row L - 1 instead (``state``
    and the conv input's last ``conv_width - 1`` rows in the activation
    dtype).  ``init_state`` is the state before row 0."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    Bb, L = x.shape[:2]
    z, xbc_raw, xs, dt, A, B_, C_ = scan_inputs(p, cfg, x)

    chunk = min(s.chunk_size, L)
    pad = (-L) % chunk
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    else:
        xs_p = xs
    xh = xs_p.reshape(Bb, L + pad, nheads, s.head_dim)
    y, state = ssd_chunked(xh, dt, A, B_, C_, chunk=chunk,
                           init_state=init_state)
    y = y[:, :L].reshape(Bb, L, d_inner)
    y = y + xs * p.D.float().repeat_interleave(s.head_dim)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p.norm, cfg.norm_eps)
    out = y.to(x.dtype) @ p.out_proj
    if return_cache:
        conv = _tail_rows(xbc_raw, s.conv_width - 1)
        return out, {"state": state,
                     "conv": conv.to(getattr(torch, cfg.dtype))}
    if return_state:
        return out, state
    return out


# --- decode ------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int):
    """A layer's decode cache: name -> (shape, dtype).  The conv tail is
    bfloat16 whatever the model's dtype, as the reference's spec."""
    s = cfg.ssm
    _, nheads, conv_dim = _dims(cfg)
    return {"state": ((batch, nheads, s.head_dim, s.state_dim),
                      torch.float32),
            "conv": ((batch, s.conv_width - 1, conv_dim), torch.bfloat16)}


def init_ssd_cache(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device=None) -> LayerCache:
    """Zeroed decode cache of one layer, the conv tail in ``dtype``."""
    shapes = cache_shapes(cfg, batch)
    return {"state": torch.zeros(shapes["state"][0], dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros(shapes["conv"][0], dtype=dtype,
                                device=device)}


def apply_ssd_decode(p: SSD, cfg: ModelConfig, x: torch.Tensor,
                     cache: LayerCache) -> torch.Tensor:
    """One token a slot, x (B, 1, d) -> (B, 1, d).  Updates ``cache`` in
    place: the conv tail shifts by one row (the new row cast to its
    dtype, which the current step's conv reads too, as the reference's
    does) and ``state`` takes the new state.  The tail holds rows oldest
    first while :func:`_causal_conv` pairs ``w[0]`` with the current row,
    so the taps run flipped here."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    gn = s.ngroups * s.state_dim
    z, xbc, dt = _split_proj(cfg, x[:, 0] @ p.in_proj)

    conv_in = torch.cat([cache["conv"],
                         xbc[:, None].to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", conv_in.float(),
                            p.conv_w.float().flip(0))
    xbc_c = F.silu(conv_out + p.conv_b.float())

    xs = xbc_c[..., :d_inner]
    B_ = xbc_c[..., d_inner:d_inner + gn].reshape(-1, s.ngroups,
                                                  s.state_dim)
    C_ = xbc_c[..., d_inner + gn:].reshape(-1, s.ngroups, s.state_dim)
    dt = F.softplus(dt.float() + p.dt_bias.float())           # (B, H)
    A = -torch.exp(p.A_log.float())

    rep = nheads // s.ngroups
    Bh = B_.repeat_interleave(rep, 1)                         # (B, H, N)
    Ch = C_.repeat_interleave(rep, 1)
    xh = xs.reshape(-1, nheads, s.head_dim)                   # (B, H, P)

    decay = torch.exp(dt * A)                                 # (B, H)
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xh, Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + xh * p.D.float()[None, :, None]
    y = y.reshape(-1, d_inner)
    y = rms_norm(y * F.silu(z.float()), p.norm, cfg.norm_eps)
    out = (y @ p.out_proj.to(y.dtype)).to(x.dtype)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_in[:, 1:])
    return out[:, None]

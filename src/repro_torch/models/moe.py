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

``ep_shard_map`` is the reference's expert-parallel dispatch over a
mesh: it runs exactly where the reference's does, under a bound
activation mesh (:func:`repro_torch.sharding.activation_mesh`) whose
``model`` axis ``n`` is above 1 and divides L, and as ``gather``
elsewhere (decode's L 1, no mesh), in serving and in training alike.
Its semantics are the reference's (:func:`_moe_ep_shard_map`): the
experts padded to a multiple of ``n``, each device's chunk of L / n
tokens routed as one group with its own capacity, expert group ``j``'s
slabs from every chunk moved to device ``j``, which runs its experts,
and moved back.  So where capacity drops tokens it drops other tokens
than ``gather`` over the whole row does.

Under tensor parallelism (``param_policy="tp"``) the expert stacks are
cut over the model axis (:class:`~repro_torch.models.common.TPModule`):
on the ``experts`` dim, device ``j`` holding expert group ``j``, or on
``ff`` where the axis does not divide the expert count.  Expert
parallelism then runs each group on the device holding it, and gather
runs each group's FFN (or each ``ff`` slice's partial) on its device.

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
from repro_torch.models.common import ParamSpec, SpecModule, sharded, \
    tp_join, tp_sum, whole
from repro_torch.sharding.ctx import current_mesh

DISPATCHES = ("gather", "einsum", "ep_shard_map")


class MoE(SpecModule):
    """One layer's experts, named and shaped as the reference's: the
    float32 router (d, E), ``wi_gate`` / ``wi_up`` (E, d, f) and ``wo``
    (E, f, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
        super().__init__({
            "router": ParamSpec((d, e), ("embed", "experts"),
                                dtype="float32"),
            "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "ff"),
                                 fan_in=d),
            "wi_up": ParamSpec((e, d, f), ("experts", "embed", "ff"),
                               fan_in=d),
            "wo": ParamSpec((e, f, d), ("experts", "ff", "embed"), fan_in=f),
        }, dtype, device)


def _capacity(group_size: int, num_experts: int, top_k: int,
              capacity_factor: float) -> int:
    c = math.ceil(capacity_factor * group_size * top_k / num_experts)
    return max(1, c)


def _route(p: MoE, cfg: ModelConfig, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (G, S, d) -> (gates (G, S, k) f32, experts (G, S, k), the
    router's probabilities (G, S, E) f32)."""
    return _route_with(whole(p, "router"), cfg.moe.top_k, x)


def _route_with(router: torch.Tensor, top_k: int, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_route` with an explicit (d, E) router, in its dtype (the
    float32 of the weights; float64 in a float64 check)."""
    probs = torch.softmax(x.to(router.dtype) @ router, dim=-1)  # (G,S,E)
    # a stable descending sort breaks ties by the lower index, as
    # jax.lax.top_k does (torch.topk promises no order on ties)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top.values[..., :top_k]
    experts = top.indices[..., :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, experts, probs


def routing_stats(probs: torch.Tensor, experts: torch.Tensor
                  ) -> torch.Tensor:
    """(g, 2, E): for each of g routings (``probs`` (g, S, E),
    ``experts`` (g, S, k)), the fraction of top-1 choices and the mean
    probability of each expert, the two factors of the Switch
    load-balance loss (:func:`balance_loss`).  The training forward
    returns them in place of the loss, so that mesh training can join
    its data rows' routings into the whole batch's, as the reference's
    loss is over the whole batch."""
    frac = F.one_hot(experts[..., 0], probs.shape[-1]).float().mean(1)
    return torch.stack([frac.to(probs.dtype), probs.mean(1)], 1)


def balance_loss(stats: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss from :func:`routing_stats` (...,
    g, 2, E): E * sum_e(fraction of top-1 choices * mean probability)
    of each routing, averaged over the g routings and summed over the
    leading dims (the layers).  0 for an empty (model without MoE)."""
    E = stats.shape[-1]
    return (E * (stats[..., 0, :] * stats[..., 1, :]).sum(-1)).mean(-1).sum()


def load_balance_loss(probs: torch.Tensor, experts: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """The Switch load-balance loss of one routing over ``num_experts``
    experts, as the reference's ``_route`` returns it."""
    return balance_loss(routing_stats(
        probs.reshape(1, -1, num_experts),
        experts.reshape(1, -1, experts.shape[-1])))


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


def _swiglu(wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor,
            xin: torch.Tensor) -> torch.Tensor:
    """xin: (..., E, C, d) -> (..., E, C, d) through each expert's
    SwiGLU, the weights (E, d, f), (E, d, f), (E, f, d)."""
    g = F.silu(torch.einsum("...ecd,edf->...ecf", xin, wg))
    u = torch.einsum("...ecd,edf->...ecf", xin, wu)
    return torch.einsum("...ecf,efd->...ecd", g * u, wo)


def _expert_ffn(p: MoE, xin: torch.Tensor) -> torch.Tensor:
    """xin: (..., E, C, d) -> (..., E, C, d) through each expert's
    SwiGLU.  Over experts-sharded weights each device runs its expert
    group on its slabs of ``xin`` (dim -3) and the groups join on the
    lead device; over ``ff``-sharded ones each device's partial sums
    there."""
    def one(mod, xs):
        return _swiglu(mod.wi_gate, mod.wi_up, mod.wo, xs)
    cut = sharded(p, "wi_gate")
    if cut is None:
        return one(p, xin)
    if cut == 0:
        dim = xin.dim() - 3
        return tp_join(p, one, xin, dim=dim, split=(dim,))
    return tp_sum(p, one, xin)


def _moe_einsum(p: MoE, cfg: ModelConfig, x: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (G, S, d) -> ((G, S, d), the router's probabilities, the
    experts chosen).  One-hot dispatch and combine, one (G, S, E, C)
    tensor per k."""
    moe = cfg.moe
    G, S, d = x.shape
    E, C = moe.num_experts, capacity
    gates, experts, probs = _route(p, cfg, x)
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
    return out, probs, experts


def _moe_gather(p: MoE, cfg: ModelConfig, x: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (G, S, d) -> ((G, S, d), the router's probabilities, the
    experts chosen).  Kept assignments are copied
    to slot ``expert * C + pos`` of a per-group buffer; dropped ones go to
    its extra last row, which no expert reads and which combines as
    zeros."""
    moe = cfg.moe
    G, S, d = x.shape
    E, C, K = moe.num_experts, capacity, moe.top_k
    gates, experts, probs = _route(p, cfg, x)
    _, pos = _positions_in_expert(experts, E)
    slot = torch.where(pos < C, experts * C + pos, E * C).reshape(G, S * K)
    rows = torch.arange(G, device=x.device)[:, None]
    buf = x.new_zeros(G, E * C + 1, d)
    buf[rows, slot] = x.repeat_interleave(K, dim=1)             # dispatch
    xout = _expert_ffn(p, buf[:, :E * C].reshape(G, E, C, d))
    xout = torch.cat([xout.reshape(G, E * C, d), x.new_zeros(G, 1, d)], 1)
    picked = xout[rows, slot].reshape(G, S, K, d)               # combine
    return (picked * gates[..., None].to(x.dtype)).sum(2), probs, experts


def _expert_group(p: MoE, j: int, g: int, device: torch.device
                  ) -> Tuple[torch.Tensor, ...]:
    """Experts [j g, (j + 1) g) of ``p`` (those below E) on ``device``:
    the slices device ``j`` holds where the experts are sharded in groups
    of ``g``, else a slice of the whole stacks (joined first where
    ``ff`` is sharded)."""
    names = ("wi_gate", "wi_up", "wo")
    if sharded(p, "wi_gate") == 0 and p.mods[j].wi_gate.shape[0] == g:
        return tuple(getattr(p.mods[j], n) for n in names)
    E = whole(p, "wi_gate").shape[0]
    lo, hi = min(j * g, E), min((j + 1) * g, E)
    return tuple(whole(p, n)[lo:hi].to(device) for n in names)


def _moe_ep_shard_map(p: MoE, cfg: ModelConfig, x: torch.Tensor, mesh,
                      axis: str = "model"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expert parallelism over ``mesh``'s ``axis`` (size n): the
    reference's ``_moe_ep_shard_map``, its two ``all_to_all``\\ s made
    explicit moves.  x (B, L, d) on the lead device -> ((B, L, d), the
    router's probabilities (chunks, S, e_pad), the experts chosen
    (chunks, S, k)).

    The batch rides the data rows where their count divides B (row ``r``
    takes B_loc = B / rows of them), else the first row takes all B, the
    batch being replicated.  In a row, chunk ``i`` holds the tokens [i L / n, (i +
    1) L / n) of its B_loc rows, S = B_loc L / n tokens routed as one
    group over ``e_pad = ceil(E / n) n`` experts (the router padded with
    -1e9 columns, so no token picks a pad expert) with capacity
    ``_capacity(S, e_pad, K, capacity_factor)`` and the reference's
    k-major queue; assignment (token, k) takes slot ``expert * cap +
    pos``, or the drop slot ``e_pad cap`` past capacity.  Device ``j``
    receives expert group ``j``'s slabs of every chunk, (e_pad / n, n
    cap, d) in chunk order, runs its experts on them, and its outputs go
    back, each chunk's rows of every group joined in group order, where
    every kept assignment picks its output by slot, weighted by its gate.
    A pad expert's slab is zeros and reads no weight.  Each chunk is a
    routing of its own (every chunk of every row, in order), whose
    load-balance loss is over its tokens and the ``e_pad`` experts, as
    the reference's local estimate that it averages over the devices."""
    moe = cfg.moe
    B, L, d = x.shape
    n = mesh.shape[axis]
    E, K = moe.num_experts, moe.top_k
    e_pad = -(-E // n) * n
    g = e_pad // n
    router = whole(p, "router")
    if e_pad != E:
        router = torch.cat([router, router.new_full(
            (router.shape[0], e_pad - E), -1e9)], dim=1)
    rows = mesh.rows if B % len(mesh.rows) == 0 else mesh.rows[:1]
    b_loc, lc = B // len(rows), L // n
    cap = _capacity(b_loc * lc, e_pad, K, moe.capacity_factor)
    out_rows, route = [], []
    for r, devices in enumerate(rows):
        xr = x[r * b_loc:(r + 1) * b_loc]
        bufs, slots, gates_all = [], [], []
        for i in range(n):
            xt = xr[:, i * lc:(i + 1) * lc].reshape(b_loc * lc, d)
            gates, experts, probs = _route_with(router, K, xt[None])
            route.append((probs[0], experts[0]))
            _, pos = _positions_in_expert(experts, e_pad)
            slot = torch.where(pos < cap, experts * cap + pos,
                               e_pad * cap).reshape(-1)
            buf = xt.new_zeros(e_pad * cap + 1, d)
            buf[slot] = xt.repeat_interleave(K, dim=0)
            bufs.append(buf[:-1].reshape(e_pad, cap, d))
            slots.append(slot)
            gates_all.append(gates[0])
        # the first move: group j's slabs of every chunk to device j
        outs = []
        for j, dev in enumerate(devices):
            recv = torch.cat([b[j * g:(j + 1) * g] for b in bufs],
                             dim=1).to(dev)                   # (g, n cap, d)
            wg, wu, wo = _expert_group(p, j, g, dev)
            y = recv.new_zeros(recv.shape)
            if wg.shape[0]:
                y[:wg.shape[0]] = _swiglu(wg, wu, wo, recv[:wg.shape[0]])
            outs.append(y.to(x.device))
        # the second move: chunk i's rows of every group, in group order
        chunks = []
        for i in range(n):
            back = torch.cat([y[:, i * cap:(i + 1) * cap] for y in outs],
                             dim=0).reshape(e_pad * cap, d)
            back = torch.cat([back, back.new_zeros(1, d)])
            picked = back[slots[i]].reshape(b_loc * lc, K, d)
            o = (picked * gates_all[i][..., None].to(x.dtype)).sum(1)
            chunks.append(o.reshape(b_loc, lc, d))
        out_rows.append(torch.cat(chunks, dim=1))
    probs, experts = (torch.stack(t) for t in zip(*route))
    return torch.cat(out_rows, dim=0), probs, experts


def ep_applies(x: torch.Tensor) -> bool:
    """Whether ``ep_shard_map`` runs expert parallelism on (B, L, d)
    activations ``x``: the reference's rule, a bound activation mesh
    whose ``model`` axis is above 1 and divides L."""
    mesh = current_mesh()
    return (mesh is not None and "model" in mesh.axis_names
            and mesh.shape["model"] > 1
            and x.shape[1] % mesh.shape["model"] == 0)


def apply_moe(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
              dispatch: Optional[str] = None, group_size: int = 0
              ) -> torch.Tensor:
    """MoE FFN over (B, L, d) activations -> (B, L, d), serving's form:
    :func:`apply_moe_train` without the routing stats, which serving
    discards, as the reference's serving paths do.

    Groups are the (B, L) rows by default; ``group_size`` < L cuts each
    row into groups of that many tokens.  ``dispatch`` defaults to the
    config's."""
    dispatch = _dispatch(cfg, dispatch)
    if dispatch == "ep_shard_map" and ep_applies(x):
        return _moe_ep_shard_map(p, cfg, x, current_mesh())[0]
    return apply_moe_train(p, cfg, x, dispatch=dispatch,
                           group_size=group_size)[0]


def _dispatch(cfg: ModelConfig, dispatch: Optional[str]) -> str:
    dispatch = dispatch or cfg.moe.dispatch
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; known: "
                         f"{DISPATCHES}")
    return dispatch


def apply_moe_train(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                    dispatch: Optional[str] = None, group_size: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over (B, L, d) -> (out (B, L, d), the :func:`routing_stats`
    (g, 2, E) f32), the reference's ``apply_moe`` (whose loss is
    :func:`balance_loss` of them): the training path's form.  A gather
    or einsum dispatch is one routing (g 1) over all its groups; expert
    parallelism over a bound mesh (``ep_shard_map`` where
    :func:`ep_applies`) gives one a chunk; elsewhere ``ep_shard_map``
    runs ``gather``, as the reference's."""
    B, L, d = x.shape
    moe = cfg.moe
    dispatch = _dispatch(cfg, dispatch)
    if dispatch == "ep_shard_map":
        if ep_applies(x):
            out, probs, experts = _moe_ep_shard_map(p, cfg, x,
                                                    current_mesh())
            return out, routing_stats(probs, experts)
        dispatch = "gather"
    if group_size and group_size < L:
        xg = x.reshape(B * (L // group_size), group_size, d)
    else:
        group_size = L
        xg = x
    cap = _capacity(group_size, moe.num_experts, moe.top_k,
                    moe.capacity_factor)
    fn = _moe_gather if dispatch == "gather" else _moe_einsum
    out, probs, experts = fn(p, cfg, xg, cap)
    stats = routing_stats(probs.reshape(1, -1, moe.num_experts),
                          experts.reshape(1, -1, moe.top_k))
    return out.reshape(B, L, d), stats

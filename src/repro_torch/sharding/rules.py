"""Logical-axis -> mesh-axis rules, with a divisibility-safe fallback.

Counterpart of ``repro.sharding.rules``: one place says how a tensor's
logical dims (``batch``, ``heads``, ``seq``, ...) map onto the axes of a
device grid (:class:`~repro_torch.launch.mesh.EngineMesh`, axes
``("data", "model")``).  A spec is a plain tuple with one entry per dim,
trailing unsharded dims dropped: ``None`` (replicated), one axis name, or
a tuple of axis names, where the reference builds a ``PartitionSpec``.

A dim is sharded only if its size divides the product of the axes it
takes, and each mesh axis is used at most once per tensor (the first dim
in order wins); otherwise the dim stays replicated.  :func:`tree_specs`
gives every leaf's spec, and :func:`dim_slice` / :func:`local_slices`
the part of each dim a device holds under a spec.

- **Params**: ``param_rules`` is FSDP + TP (training, with the tools);
  ``serve_param_rules`` is the inference layout, TP on ``model``.
- **Activations**: ``batch`` over the data axes, heads over ``model``.
- **KV caches**: ``batch`` over data; on ``model`` either the KV heads
  or, under the paper's mesh-level decision (``cache_rules(True)``), the
  sequence, which the serving engine realizes by holding each shard's
  cache as one chunk of rows a device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, \
    Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes)."""
    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def lookup(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        m = self.rules.get(logical)
        if m is None:
            return ()
        return (m,) if isinstance(m, str) else tuple(m)


def _axes_in_mesh(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in axes if a in mesh.axis_names)


def spec_for(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
             rules: ShardingRules, mesh) -> Spec:
    """The divisibility- and conflict-safe spec of one tensor over
    ``mesh`` (anything with ``axis_names`` and a ``shape`` dict)."""
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        # drop axes an earlier dim of this tensor already took
        want = tuple(a for a in _axes_in_mesh(mesh, rules.lookup(name))
                     if a not in used)
        # the longest prefix whose product divides the dim
        chosen: Tuple[str, ...] = ()
        size = 1
        for a in want:
            nsz = size * mesh.shape[a]
            if dim % nsz:
                break
            chosen += (a,)
            size = nsz
        used.update(chosen)
        out.append(None if not chosen else
                   chosen[0] if len(chosen) == 1 else chosen)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def tree_specs(mesh, shapes: Mapping[str, Any],
               axes: Mapping[str, Tuple[Optional[str], ...]],
               rules: ShardingRules) -> Dict[str, Spec]:
    """:func:`spec_for` of every leaf: the counterpart of the reference's
    ``tree_shardings``.  ``shapes`` maps a leaf name to its shape (or to
    anything with a ``shape``), ``axes`` the same names to their logical
    axes; a leaf without axes raises rather than falling back to
    replicated."""
    out = {}
    for name, leaf in shapes.items():
        if name not in axes:
            raise KeyError(f"no logical axes for {name!r}")
        shape = tuple(getattr(leaf, "shape", leaf))
        out[name] = spec_for(shape, axes[name], rules, mesh)
    return out


def device_coords(mesh, i: int) -> Dict[str, int]:
    """Device ``i`` of ``mesh``, counted row by row, as its index along
    each axis."""
    coords = {}
    for a in reversed(mesh.axis_names):
        i, coords[a] = divmod(i, mesh.shape[a])
    return coords


def dim_slice(size: int, entry: MeshAxes, mesh,
              coords: Mapping[str, int]) -> Tuple[int, int]:
    """(start, length) of the part of a dim of ``size`` that the device
    at ``coords`` holds, for the dim's spec ``entry``: the whole dim for
    None, else ``size`` cut into as many equal parts as the product of
    the entry's axes, the first axis major, as a ``PartitionSpec``
    cuts."""
    axes = () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)
    index, parts = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + coords[a]
        parts *= mesh.shape[a]
    length = size // parts
    return index * length, length


def local_slices(shape: Tuple[int, ...], spec: Spec, mesh,
                 coords: Mapping[str, int]) -> Tuple[Tuple[int, int], ...]:
    """:func:`dim_slice` of every dim of a tensor of ``shape`` under
    ``spec`` (whose trailing unsharded dims may be dropped)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(dim_slice(n, e, mesh, coords)
                 for n, e in zip(shape, entries))


# ---------------------------------------------------------------------------
# Standard rule sets
# ---------------------------------------------------------------------------


def param_rules() -> ShardingRules:
    return ShardingRules({
        "embed": ("pod", "data"),          # FSDP
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "experts": "model",
        "state": "model",
        # layers / head_dim / seq: replicated
    })


def serve_param_rules() -> ShardingRules:
    """Inference layout: TP on ``model``, no FSDP; expert weights also
    spread over the data axes."""
    return ShardingRules({
        "embed": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "state": "model",
        "experts": ("pod", "data", "model"),
    })


def activation_rules() -> ShardingRules:
    return ShardingRules({
        "batch": ("pod", "data"),
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "experts": "model",
        "state": "model",
    })


def cache_rules(seq_split: bool) -> ShardingRules:
    """KV-cache rules; ``seq_split`` is the paper's mesh-level decision."""
    return ShardingRules({
        "batch": ("pod", "data"),
        "kv_heads": None if seq_split else "model",
        "heads": "model",                  # ssm state heads
        "state": "model",
        "seq": "model" if seq_split else None,
    })


def batch_spec(mesh) -> Spec:
    """The spec of a tensor whose first dim is the batch."""
    axes = _axes_in_mesh(mesh, ("pod", "data"))
    return (axes if axes else None,)


def replicated(mesh) -> Spec:
    """The spec of a tensor every device holds whole."""
    return ()

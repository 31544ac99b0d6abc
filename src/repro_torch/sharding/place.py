"""Weight placement over one grid row's ``model`` axis.

Counterpart of the reference's ``jax.device_put(params,
tree_shardings(mesh, params, model.param_axes(), serve_param_rules()))``
(``serving/engine.py``'s ``param_policy="tp"`` and the frozen
``serve_step`` builders).  :func:`place_params` reads every parameter's
logical axes (:func:`repro_torch.models.common.logical_axes`), gives it
its :func:`~repro_torch.sharding.rules.spec_for` spec over the row's
``(1, sp)`` grid, and returns a
:class:`~repro_torch.models.common.TPModule` tree mirroring the module:
device ``s`` holds its slice of every dim the spec cuts, a contiguous
tensor of its own, and the whole of every other parameter (the lead
device's tensor itself where the grid repeats a device).  The model code
runs on the tree unchanged; the leaf ops that read a cut weight run one
part a device (``models/common.py``).

A grid with a ``model`` axis of 1 cuts nothing: the module itself comes
back (a copy where it lives on another device), as the reference's TP
layout is the replicated one there.

Training places a model over a whole ``(data, model)`` grid by
``param_rules()`` instead (:func:`place_trainable`, the counterpart of
the reference train step's ``tree_shardings(mesh, params,
model.param_axes(), param_rules())``): ``embed`` cut over the data rows
(FSDP), heads, KV heads, ff, vocab and experts over the model axis.  A
:class:`MeshParams` holds one trainable leaf per distinct slice: where
the grid leaves a weight whole on several devices (a norm's scale on
every device of a data row, say), that slice is one leaf, owned by the
first of those devices, and the others read it through a differentiable
``.to``.  Its gradient is then the sum over its readers, the explicit
form of the reference's all-reduce, and a global norm over the leaves
counts each logical weight once.  :meth:`MeshParams.view` gives data row
``d`` the tree its forward runs on: device ``(d, s)`` reads every weight
gathered over the data axis (a ``torch.cat`` of the row slices, moved to
it) and cut as the model axis cuts it, a
:class:`~repro_torch.models.common.TPModule` tree over the row's devices
(a module tree of the original classes where the model axis is 1).  The
gather runs where a weight is read, so under a remat wrapper a layer's
gathered weights live only inside its block.
"""
from __future__ import annotations

import copy
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.common import SpecModule, TPModule, logical_axes
from repro_torch.sharding.rules import ShardingRules, device_coords, \
    local_slices, param_rules, serve_param_rules, tree_specs


def param_specs(params: nn.Module, mesh,
                rules: Optional[ShardingRules] = None) -> Dict[str, tuple]:
    """Every parameter's spec over ``mesh`` (``serve_param_rules`` by
    default), keyed by its dotted name."""
    shapes = {name: tuple(t.shape)
              for name, t in params.state_dict().items()}
    return tree_specs(mesh, shapes, logical_axes(params),
                      rules or serve_param_rules())


def _cut_dim(spec: tuple, mesh) -> Optional[int]:
    """The dim a spec cuts into more than one part (the model axis is
    taken by one dim at most), or None."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if size > 1:
            return dim
    return None


def _shard_module(module: SpecModule,
                  tensors: Dict[str, torch.Tensor]) -> SpecModule:
    """A module of ``module``'s class holding ``tensors`` as its
    parameters (no allocation beyond them)."""
    out = type(module).__new__(type(module))
    nn.Module.__init__(out)
    out.specs = module.specs
    for name, t in tensors.items():
        out.register_parameter(name, nn.Parameter(t, requires_grad=False))
    return out


def place_params(params: nn.Module, mesh,
                 rules: Optional[ShardingRules] = None):
    """``params`` placed over ``mesh``, one row's ``(1, sp)`` grid
    (:meth:`~repro_torch.launch.mesh.EngineMesh.sub`): a
    :class:`TPModule` tree, or the module itself on the row's device when
    the ``model`` axis is 1."""
    if mesh.shape["data"] != 1:
        raise ValueError(
            "weights are placed over one grid row's (1, sp) grid; pass "
            "mesh.sub(d)")
    devices = tuple(mesh.rows[0])
    if len(devices) == 1:
        if next(params.parameters()).device == devices[0]:
            return params
        return copy.deepcopy(params).to(devices[0])
    specs = param_specs(params, mesh, rules)
    coords = [device_coords(mesh, s) for s in range(len(devices))]

    def mirror(prefix: str, module: nn.Module):
        if isinstance(module, nn.ModuleList):
            return [mirror(f"{prefix}{i}.", m) for i, m in enumerate(module)]
        children = {name: mirror(f"{prefix}{name}.", child)
                    for name, child in module.named_children()}
        dims: Dict[str, Optional[int]] = {}
        mods: List[SpecModule] = []
        if isinstance(module, SpecModule):
            per_dev: List[Dict[str, torch.Tensor]] = [{} for _ in devices]
            for name in module.specs:
                full = getattr(module, name).detach()
                spec = specs[prefix + name]
                dims[name] = _cut_dim(spec, mesh)
                for s, dev in enumerate(devices):
                    if dims[name] is None:
                        per_dev[s][name] = full.to(dev)
                        continue
                    t = full
                    for dim, (start, length) in enumerate(local_slices(
                            tuple(full.shape), spec, mesh, coords[s])):
                        if length != full.shape[dim]:
                            t = t.narrow(dim, start, length)
                    per_dev[s][name] = t.to(dev).clone(
                        memory_format=torch.contiguous_format)
            mods = [_shard_module(module, t) for t in per_dev]
        return TPModule(mods, devices, dims, children,
                        kind=getattr(module, "kind", None))

    return mirror("", params)


def device_param_bytes(placed) -> List[int]:
    """The bytes of weights each device of a placed tree holds (a whole
    parameter counts on every device, as each holds it)."""
    if not isinstance(placed, TPModule):
        return [sum(t.numel() * t.element_size()
                    for t in placed.parameters())]
    total = [0] * len(placed.devices)

    def walk(node):
        if isinstance(node, list):
            for n in node:
                walk(n)
            return
        for s, mod in enumerate(node.mods):
            total[s] += sum(t.numel() * t.element_size()
                            for t in mod.parameters())
        for child in node.children.values():
            walk(child)

    walk(placed)
    return total


# ---------------------------------------------------------------------------
# Training: trainable weights over a (data, model) grid by param_rules()
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LeafLayout:
    """How one weight lies on the grid: the dim the data axis cuts and
    the dim the model axis cuts (None where that axis has one device or
    leaves the weight whole)."""
    data_dim: Optional[int]
    model_dim: Optional[int]


def _axis_dim(spec: tuple, mesh, axis: str) -> Optional[int]:
    """The dim whose spec entry holds ``axis``, where the axis has more
    than one device."""
    if mesh.shape[axis] == 1:
        return None
    for dim, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        if axis in axes:
            return dim
    return None


def leaf_key(name: str, d: Optional[int], s: Optional[int]) -> str:
    """A leaf's key: the weight's name, and where an axis cuts it, the
    slice's index along the data and model axes (``:`` for an axis that
    leaves it whole): ``layers.0.mix.wq[1,0]``, ``final_norm.scale[1,:]``."""
    if d is None and s is None:
        return name
    return (f"{name}[{':' if d is None else d},"
            f"{':' if s is None else s}]")


class _Gathered:
    """Mixin of a view module: a weight read by name comes from its
    getter (a gather of leaves), computed at each read."""

    def __getattr__(self, name: str):
        get = self.__dict__.get("_getters", {}).get(name)
        if get is not None:
            return get()
        return super().__getattr__(name)


@functools.lru_cache(maxsize=None)
def _gathered_class(cls: type) -> type:
    """The view class of module class ``cls`` (a subclass, so the model
    code's ``isinstance`` checks hold)."""
    return type(cls.__name__, (_Gathered, cls), {})


def _view_module(module: nn.Module, getters: Dict[str, Callable]
                 ) -> nn.Module:
    """A module of ``module``'s class (through :func:`_gathered_class`)
    with its plain attributes (``specs``, ``kind``), no parameters of its
    own and ``getters`` for its weights."""
    out = _gathered_class(type(module)).__new__(
        _gathered_class(type(module)))
    nn.Module.__init__(out)
    for k, v in module.__dict__.items():
        if not k.startswith("_") and k != "training":
            out.__dict__[k] = v
    out.__dict__["_getters"] = getters
    return out


class MeshParams:
    """A model's trainable weights over a ``(data, model)`` grid, placed
    by ``param_rules()`` (:func:`place_trainable`).

    ``leaves`` maps each :func:`leaf_key` to its tensor, a leaf that
    requires a gradient, on its owner device (the first device of the
    grid, row by row, whose slice it is); ``layout`` gives each weight's
    :class:`LeafLayout`.  The AdamW moments of a bundle over this tree
    are keyed by the same leaf keys.  :meth:`state_dict` joins the
    leaves into the dense weights, :meth:`load_dense` cuts dense weights
    into the leaves in place."""

    def __init__(self, skeleton: nn.Module, mesh,
                 layout: Dict[str, LeafLayout],
                 leaves: Dict[str, torch.Tensor]):
        self.skeleton = skeleton
        self.mesh = mesh
        self.layout = layout
        self.leaves = leaves
        self._views: Dict[int, object] = {}

    def blocks(self, name: str) -> List[Tuple[Optional[int], Optional[int]]]:
        """The (data, model) slice indices of ``name``'s leaves."""
        lay = self.layout[name]
        ds = range(self.mesh.shape["data"]) if lay.data_dim is not None \
            else [None]
        ss = range(self.mesh.shape["model"]) if lay.model_dim is not None \
            else [None]
        return [(d, s) for d in ds for s in ss]

    def held(self, name: str, d: int, s: int) -> torch.Tensor:
        """The slice of ``name`` that grid device (d, s) holds."""
        lay = self.layout[name]
        return self.leaves[leaf_key(
            name, d if lay.data_dim is not None else None,
            s if lay.model_dim is not None else None)]

    def _cut(self, name: str, full: torch.Tensor, d: Optional[int],
             s: Optional[int]) -> torch.Tensor:
        lay = self.layout[name]
        t = full
        for dim, idx, n in ((lay.data_dim, d, self.mesh.shape["data"]),
                            (lay.model_dim, s, self.mesh.shape["model"])):
            if dim is not None:
                c = full.shape[dim] // n
                t = t.narrow(dim, idx * c, c)
        return t

    def _join(self, name: str, parts: Mapping) -> torch.Tensor:
        """``name``'s dense tensor from its leaf-keyed ``parts``, on the
        grid's lead device."""
        lay = self.layout[name]
        lead = self.mesh.lead
        rows = []
        for d in (range(self.mesh.shape["data"]) if lay.data_dim is not None
                  else [None]):
            cols = [parts[leaf_key(name, d, s)].detach().to(lead)
                    for s in (range(self.mesh.shape["model"])
                              if lay.model_dim is not None else [None])]
            rows.append(cols[0] if len(cols) == 1
                        else torch.cat(cols, lay.model_dim))
        return rows[0] if len(rows) == 1 else torch.cat(rows, lay.data_dim)

    def join(self, tree: Mapping[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """A leaf-keyed tree (the leaves, a gradient, a moment) as dense
        tensors keyed by weight name, on the grid's lead device."""
        return {name: self._join(name, tree) for name in self.layout}

    def cut(self, dense: Mapping[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
        """Dense tensors keyed by weight name as a leaf-keyed tree, each
        slice contiguous on its leaf's device."""
        out = {}
        for name in self.layout:
            for d, s in self.blocks(name):
                out[leaf_key(name, d, s)] = self._cut(
                    name, dense[name], d, s).to(self.mesh.rows[d or 0][
                        s or 0]).clone(memory_format=torch.contiguous_format)
        return out

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The dense weights, keyed as the module's ``state_dict``."""
        return self.join(self.leaves)

    @torch.no_grad()
    def load_dense(self, dense: Mapping[str, torch.Tensor]) -> "MeshParams":
        """Cut dense weights (keyed by name) into the leaves, in place."""
        for name in self.layout:
            for d, s in self.blocks(name):
                self.leaves[leaf_key(name, d, s)].copy_(
                    self._cut(name, dense[name], d, s))
        return self

    def device_bytes(self, tree: Optional[Mapping] = None) -> List[int]:
        """Bytes each grid device (row by row) owns of a leaf-keyed tree
        (default: the leaves): each leaf counts once, on its owner."""
        tree = self.leaves if tree is None else tree
        n = self.mesh.shape["model"]
        total = [0] * (self.mesh.shape["data"] * n)
        for name in self.layout:
            for d, s in self.blocks(name):
                t = tree[leaf_key(name, d, s)]
                total[(d or 0) * n + (s or 0)] += t.numel() * t.element_size()
        return total

    def _getter(self, name: str, d: int, s: int) -> Callable:
        """A weight as device (d, s) reads it: gathered over the data
        axis, its own model slice, on that device."""
        lay = self.layout[name]
        dev = self.mesh.rows[d][s]
        ms = s if lay.model_dim is not None else None
        if lay.data_dim is None:
            leaf = self.leaves[leaf_key(name, None, ms)]
            return lambda: leaf.to(dev)
        parts = [self.leaves[leaf_key(name, dd, ms)]
                 for dd in range(self.mesh.shape["data"])]
        return lambda: torch.cat([p.to(dev) for p in parts], lay.data_dim)

    def view(self, d: int):
        """Data row ``d``'s tree for the model code: a
        :class:`~repro_torch.models.common.TPModule` tree over the row's
        devices, or, where the model axis is 1, a tree of the original
        module classes on the row's device.  Its weights are gathered at
        each read (the model code runs under the remat wrapper, so a
        layer's gathered weights are not kept)."""
        if d not in self._views:
            self._views[d] = self._mirror(d, "", self.skeleton)
        return self._views[d]

    def _mirror(self, d: int, prefix: str, module: nn.Module):
        n = self.mesh.shape["model"]
        if isinstance(module, nn.ModuleList):
            items = [self._mirror(d, f"{prefix}{i}.", m)
                     for i, m in enumerate(module)]
            return nn.ModuleList(items) if n == 1 else items
        specs = module.specs if isinstance(module, SpecModule) else {}
        children = {name: self._mirror(d, f"{prefix}{name}.", child)
                    for name, child in module.named_children()}
        if n == 1:
            out = _view_module(module, {w: self._getter(prefix + w, d, 0)
                                        for w in specs})
            for name, child in children.items():
                out.add_module(name, child)
            return out
        mods = [_view_module(module, {w: self._getter(prefix + w, d, s)
                                      for w in specs}) for s in range(n)] \
            if specs else []
        dims = {w: self.layout[prefix + w].model_dim for w in specs}
        return TPModule(mods, self.mesh.rows[d], dims, children,
                        kind=getattr(module, "kind", None))


def place_trainable(params: nn.Module, mesh,
                    rules: Optional[ShardingRules] = None) -> MeshParams:
    """``params`` (dense weights on any device) placed over the whole
    ``(data, model)`` grid ``mesh`` by ``rules`` (``param_rules()``):
    a :class:`MeshParams` whose leaves are new tensors that require a
    gradient.  The module's structure is kept on the meta device."""
    specs = param_specs(params, mesh, rules or param_rules())
    dense = {n: t.detach() for n, t in params.state_dict().items()}
    layout = {n: LeafLayout(_axis_dim(specs[n], mesh, "data"),
                            _axis_dim(specs[n], mesh, "model"))
              for n in dense}
    # the module's structure, its weights on the meta device (no copy)
    skeleton = copy.deepcopy(params, {id(t): nn.Parameter(
        torch.empty_like(t, device="meta"), requires_grad=False)
        for t in params.parameters()})
    tree = MeshParams(skeleton, mesh, layout, {})
    tree.leaves = {k: v.requires_grad_(True)
                   for k, v in tree.cut(dense).items()}
    return tree

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
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.models.common import SpecModule, TPModule, logical_axes
from repro_torch.sharding.rules import ShardingRules, device_coords, \
    local_slices, serve_param_rules, tree_specs


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

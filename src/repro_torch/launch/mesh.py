"""The mesh-native serving topology's device grid and planner.

Counterpart of ``repro.launch.mesh``'s serving half.  A single controller
drives the grid: an :class:`EngineMesh` is a ``(dp, sp)`` grid of torch
devices over the axes ``("data", "model")``, built from an explicit
device list, so shard ``d`` always owns ``devices[d * sp:(d + 1) *
sp]``.  The list may repeat a device: ``[torch.device("cpu")] * n`` runs
every topology in one process on the CPU, and ``[cuda:0] * n`` runs every
shard's launches on one card.

``planner_for_mesh`` gives the :class:`~repro_torch.plan.Planner` whose
machine is one axis of a grid: the policy's ``num_cores`` becomes the
device count on that axis, the paper's decision with devices in place of
SMs.  :func:`make_host_mesh` is a grid over the visible devices (or a
given list), as the reference's is over its host's.  The reference's
``make_production_mesh`` (the TPU pod of its dry run) comes with the
tools.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.plan import Planner

AXES = ("data", "model")


@dataclass(frozen=True)
class EngineMesh:
    """A ``(dp, sp)`` grid of devices: ``rows[d][s]`` is device ``s`` of
    shard ``d``.  ``shape`` maps each axis name to its size, as a JAX
    mesh's does."""
    rows: Tuple[Tuple[torch.device, ...], ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.rows), "model": len(self.rows[0])}

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Every device of the grid, row by row."""
        return tuple(d for row in self.rows for d in row)

    @property
    def lead(self) -> torch.device:
        """The grid's first device: where a shard's non-attention work
        runs and its sequence shards' partials merge."""
        return self.rows[0][0]

    def sub(self, d: int) -> "EngineMesh":
        """Shard ``d``'s ``(1, sp)`` slice of the grid."""
        return EngineMesh((self.rows[d],))


def visible_devices() -> Tuple[torch.device, ...]:
    """The visible CUDA devices, each once.  Without one it raises:
    nothing falls back to the CPU unless a device list asks for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass devices=[torch.device('cpu')]"
            " * n to run a topology on the CPU")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def make_engine_mesh(dp: int, sp: int,
                     devices: Optional[Sequence] = None
                     ) -> Tuple[EngineMesh, Tuple[EngineMesh, ...]]:
    """The serving topology: a ``(dp, sp)`` grid over ``devices`` (None:
    :func:`visible_devices`) and shard ``d``'s ``(1, sp)`` sub-grid for
    each ``d``.  Shard ``d`` owns ``devices[d * sp:(d + 1) * sp]``; an
    explicit list may repeat a device."""
    devs = (list(visible_devices()) if devices is None
            else [torch.device(d) for d in devices])
    need = dp * sp
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp}, sp={sp}")
    if len(devs) < need:
        raise ValueError(
            f"shard topology dp={dp} x sp={sp} needs {need} devices, "
            f"{len(devs)} visible — pass an explicit device list that "
            f"repeats a device (e.g. [torch.device('cuda', 0)] * {need}, "
            "or --device on the serving CLI) to run it on fewer")
    mesh = EngineMesh(tuple(tuple(devs[d * sp:(d + 1) * sp])
                            for d in range(dp)))
    return mesh, tuple(mesh.sub(d) for d in range(dp))


def make_host_mesh(model_axis: int = 1,
                   devices: Optional[Sequence] = None) -> EngineMesh:
    """A ``(data, model_axis)`` grid over ``devices`` (None: the visible
    CUDA devices, :func:`visible_devices`), ``data = n // model_axis``:
    the reference's ``make_host_mesh``.  The list may repeat a device."""
    devs = (list(visible_devices()) if devices is None
            else [torch.device(d) for d in devices])
    data = len(devs) // model_axis
    if model_axis < 1 or data < 1:
        raise ValueError(f"a model axis of {model_axis} does not fit "
                         f"{len(devs)} devices")
    return make_engine_mesh(data, model_axis, devs)[0]


def mesh_name(mesh: EngineMesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def planner_for_mesh(mesh: EngineMesh, *, policy: str = "paper",
                     axis: str = "model",
                     num_splits_override: Optional[int] = None) -> Planner:
    """The planner whose machine model is ``axis`` of ``mesh``."""
    return Planner(policy=policy, num_cores=mesh.shape[axis],
                   num_splits_override=num_splits_override)

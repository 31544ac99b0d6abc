"""ShardResolver: ShardSpec -> ShardPlan (device grids + plan-cache identity).

Counterpart of ``repro.shard.resolver``.  The resolver is where a
:class:`~repro_torch.shard.ShardSpec` meets the device list: it checks
divisibility against the cache layout the engine will run (before it
looks at any device), builds the ``(dp, sp)`` grid and the per-shard
``(1, sp)`` sub-grids over an explicit device list
(:func:`~repro_torch.launch.mesh.make_engine_mesh`), and fingerprints the
result, so one :class:`~repro_torch.plan.PlanCache` per (topology,
shard, engine identity) is shared by every engine resolved to the same
topology in a process.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import EngineMesh, make_engine_mesh
from repro_torch.plan import PlanCache
from repro_torch.shard.spec import ShardSpec

# process-wide registry: one PlanCache (plans and bound steps) per
# (topology fingerprint, shard index, engine identity).  Shard d of a
# topology always owns the same devices, so a bound step's devices are
# those of every later engine with the same identity.
_PLAN_CACHES: Dict[Tuple, PlanCache] = {}


def shard_plan_cache(key: Tuple, capacity: Optional[int] = None
                     ) -> PlanCache:
    """The registry entry for ``key``, created on first use."""
    cache = _PLAN_CACHES.get(key)
    if cache is None:
        cache = PlanCache(capacity)
        _PLAN_CACHES[key] = cache
    return cache


def clear_shard_plan_caches() -> None:
    """Drop every registered per-topology PlanCache."""
    _PLAN_CACHES.clear()


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


@dataclass(frozen=True)
class ShardPlan:
    """The resolved topology: ``mesh`` spans all ``dp * sp`` devices on
    the axes ``("data", "model")`` and ``submeshes[d]`` is shard ``d``'s
    ``(1, sp)`` row of it.  ``fingerprint`` extends the spec's with the
    device type (``cuda`` or ``cpu``), the device's name and the device
    count, so plans never survive a change of devices."""
    spec: ShardSpec
    mesh: EngineMesh
    submeshes: Tuple[EngineMesh, ...]
    devices: Tuple[torch.device, ...]
    fingerprint: str = field(default="")

    def shard_devices(self, d: int) -> Tuple[torch.device, ...]:
        """The devices shard ``d`` owns (row ``d`` of the grid)."""
        sp = self.spec.sp
        return self.devices[d * sp:(d + 1) * sp]

    def plan_cache(self, shard: int, ident: Tuple = (),
                   capacity: Optional[int] = None) -> PlanCache:
        """Shard ``shard``'s per-topology PlanCache, shared by every
        engine of the same ``ident`` (the knobs its bound steps close
        over: model, policy, layout, sampler, ...)."""
        return shard_plan_cache(
            (self.fingerprint, shard) + tuple(ident), capacity)

    def describe(self) -> Dict[str, Any]:
        d = dict(self.spec.describe())
        d["fingerprint"] = self.fingerprint
        d["devices"] = [str(x) for x in self.devices]
        return d


@dataclass(frozen=True)
class ShardResolver:
    """Resolves a :class:`ShardSpec` against a device list."""
    spec: ShardSpec

    def resolve(self, *, max_len: int, cache_layout: str = "dense",
                page_size: int = 64,
                devices: Optional[Sequence[Any]] = None) -> ShardPlan:
        """Check divisibility, then build the grids.  The sequence-sharded
        decode cuts the cache's L dim into ``sp`` chunks: ``max_len`` for
        dense storage, the gathered view (a ``page_size`` multiple) for
        paged.  ``devices`` None means the visible CUDA devices, each
        once; an explicit list may repeat a device."""
        s = self.spec
        if s.sp > 1:
            if cache_layout == "paged":
                if page_size % s.sp:
                    raise ValueError(
                        f"page_size ({page_size}) must divide over "
                        f"sp={s.sp} for sequence-sharded paged decode")
            elif max_len % s.sp:
                raise ValueError(
                    f"max_len ({max_len}) must divide over sp={s.sp} "
                    "for sequence-sharded decode")
        mesh, submeshes = make_engine_mesh(s.dp, s.sp, devices)
        used = mesh.devices
        d0 = used[0]
        fp = f"{s.fingerprint}.{d0.type}.{_device_name(d0)}.{len(used)}"
        return ShardPlan(spec=s, mesh=mesh, submeshes=submeshes,
                         devices=used, fingerprint=fp)

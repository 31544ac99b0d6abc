"""LaunchPlan: the frozen output of the planner.

Counterpart of ``repro.plan.plan``.  ``num_splits is None`` marks a
context-only plan: nothing is frozen and the policy runs inside the
launch with the plan's ``policy`` / ``num_cores`` (the paper's
internal-heuristic path).  ``bucket`` is the cache-length bucket the
plan covers; the decode op attends over the cache's first ``bucket``
rows, so the split partitions what is resident, not the whole capacity.

``tuned`` and ``table_version`` record a ``measured`` plan's provenance:
``tuned=True`` when a calibrated :class:`~repro_torch.tune.SplitTable`
cell decided, ``False`` when the table did not cover the shape and its
fallback policy did.  ``pack_gqa`` is the reference's flag; the port's
decode kernels pack the G query heads of a KV head into one CTA either
way, and only the cost model reads it.

The mesh fields are the paper's decision over devices in place of SMs
(``Planner.mesh_plan``): ``mesh_splits`` is how many ways the ``model``
axis sequence-shards the KV cache, ``seq_shard_axis`` the axis the plan
was made for (None on a plan made without a mesh, where the reference
defaults to ``"model"``), and ``seq_shard_mesh`` the shard's device
grid (:class:`repro_torch.launch.mesh.EngineMesh`) that a decode plan
realizes them over: set, the decode op runs one partials launch a
device over its chunk and merges them with the combine kernel
(``kernels.ops.decode_seqsharded``).  ``min_splits`` is carried as the
reference's.  The reference's ``impl`` and ``block_k`` (the Pallas
kernel's choice and KV block) and ``split_constraint`` (a GSPMD layout
hook) have no counterpart: the kernel follows the tensor's device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

from repro_torch.core.split_policy import DecodeWorkload
from repro_torch.plan.spec import AttentionSpec


@dataclass(frozen=True)
class LaunchPlan:
    kind: str = "decode"                  # decode | prefill | verify
    spec: Optional[AttentionSpec] = None
    num_splits: Optional[int] = None      # None = not frozen
    pack_gqa: bool = False
    policy: str = "paper"
    num_cores: Optional[int] = None       # None = policy default
    bucket: Optional[int] = None          # cache-length bucket covered
    tuned: bool = False                   # a SplitTable cell decided
    table_version: Optional[str] = None   # the SplitTable that decided
    # --- mesh-level realization (Planner.mesh_plan) ------------------------
    mesh_splits: int = 1                  # ways the model axis seq-shards KV
    min_splits: int = 1                   # kernel split rounded up to this
    seq_shard_mesh: Optional[Any] = None  # the shard's EngineMesh
    seq_shard_axis: Optional[str] = None  # the axis a mesh plan was made for

    @property
    def frozen(self) -> bool:
        """True when the split decision is precomputed (metadata path)."""
        return self.num_splits is not None

    @property
    def uses_split(self) -> bool:
        return self.num_splits is not None and self.num_splits > 1

    @property
    def workload(self) -> Optional[DecodeWorkload]:
        """The policy-facing shape tuple."""
        return None if self.spec is None else self.spec.workload()

    def context_only(self) -> "LaunchPlan":
        """Drop the frozen decision, keep the policy overrides."""
        return dataclasses.replace(self, spec=None, num_splits=None,
                                   bucket=None, tuned=False,
                                   table_version=None)

    def describe(self) -> Dict[str, Any]:
        """JSON-safe summary, with the reference's keys."""
        d: Dict[str, Any] = {
            "kind": self.kind, "policy": self.policy,
            "num_splits": self.num_splits, "pack_gqa": self.pack_gqa,
            "mesh_splits": self.mesh_splits,
        }
        if self.num_cores is not None:
            d["num_cores"] = self.num_cores
        if self.bucket is not None:
            d["bucket"] = self.bucket
        if self.table_version is not None:
            d["tuned"] = self.tuned
            d["table_version"] = self.table_version
        if self.spec is not None:
            w = self.spec.workload()
            d["shape"] = (f"B{w.batch} Lq{w.seqlen_q} Lk{w.seqlen_k} "
                          f"Hq{w.num_heads_q} Hkv{w.num_heads_kv} "
                          f"D{w.head_dim}")
            if w.dtype_bytes != 2:
                d["kv_dtype"] = w.kv_dtype_name
                d["dtype_bytes"] = w.dtype_bytes
        return d

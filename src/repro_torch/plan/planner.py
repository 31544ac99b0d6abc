"""Planner: compiles an AttentionSpec into a frozen LaunchPlan.

Counterpart of ``repro.plan.planner`` (kernel-level planning).  The
policy backend is chosen by name from ``repro_torch.core.split_policy``
(``fa3_baseline`` / ``paper`` / ``tpu_adaptive`` / ``measured``) or
bypassed with ``num_splits_override`` (FA3's explicit ``num_splits``).
The ``measured`` backend decides from an injected
:class:`~repro_torch.tune.SplitTable` (``Planner(policy="measured",
table=...)``), and its plans record ``tuned`` / ``table_version``.

``impl`` names the table family a measured plan looks up.  The port has
no implementation knob, so ``None`` means its own family, ``"cuda"``
(``repro_torch.tune.table.PORT_IMPL``); ``"xla"`` reads a reference
table's cells.  :meth:`Planner.mesh_plan` adds the mesh-level decision
of a sequence-sharded topology: whether the ``model`` axis shards the
KV cache's sequence, the paper's decision with devices in place of SMs.
The reference's ``block_k`` (the Pallas kernel's KV block) has no
counterpart.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.split_policy import (
    DEFAULT_NUM_CORES,
    analytic_policies,
    choose_mesh_splits,
    choose_num_splits,
    get_policy,
)
from repro_torch.plan.plan import LaunchPlan
from repro_torch.plan.spec import AttentionSpec


@dataclass(frozen=True)
class Planner:
    """Policy backend -> frozen launch plans.  ``num_cores = None`` means
    :data:`DEFAULT_NUM_CORES` (the H100's 132 SMs).  ``table`` is the
    calibrated SplitTable the ``measured`` backend decides from
    (required for it, ignored by the analytic backends)."""
    policy: str = "paper"
    num_cores: Optional[int] = None
    num_splits_override: Optional[int] = None
    pack_gqa: Optional[bool] = None       # None = pack iff H_Q > H_KV
    impl: Optional[str] = None            # SplitTable family; None = "cuda"
    table: Optional[object] = None        # repro_torch.tune.SplitTable

    def __post_init__(self):
        fn = get_policy(self.policy)      # fail fast on unknown backends
        if getattr(fn, "needs_table", False) and self.table is None:
            raise ValueError(
                f"split policy {self.policy!r} decides from a calibrated "
                "repro_torch.tune SplitTable: pass Planner(table="
                "SplitTable.load(path)) (serving: ServeConfig."
                "tune_table_path / serve --tune-table); analytic "
                f"backends needing no table: {analytic_policies()}")

    def plan(self, spec: AttentionSpec, *,
             bucket: Optional[int] = None) -> LaunchPlan:
        """Freeze the launch decision for one attention shape."""
        w = spec.workload()
        cores = self.num_cores if self.num_cores is not None \
            else DEFAULT_NUM_CORES
        tuned, table_version = False, None
        if spec.kind == "prefill":
            s = 1                         # prefill never splits KV
        elif self.num_splits_override is not None:
            s = max(1, min(int(self.num_splits_override), w.num_n_blocks))
        elif self.table is not None and \
                getattr(get_policy(self.policy), "needs_table", False):
            s, tuned = self.table.choose(w, impl=self.impl,
                                         num_cores=cores)
            table_version = self.table.version
        else:
            s = choose_num_splits(w, policy=self.policy, num_cores=cores)
        if self.pack_gqa is not None:
            pack = self.pack_gqa
        elif spec.kind == "prefill":
            pack = False                  # full L_Q rows already fill tiles
        else:
            pack = spec.num_heads_q > spec.num_heads_kv
        return LaunchPlan(kind=spec.kind, spec=spec, num_splits=s,
                          pack_gqa=pack, policy=self.policy,
                          num_cores=cores, bucket=bucket, tuned=tuned,
                          table_version=table_version)

    def context(self, kind: str = "decode", **overrides) -> LaunchPlan:
        """A context-only plan: nothing frozen, the policy runs inside
        the launch with this planner's backend."""
        return LaunchPlan(kind=kind, policy=self.policy,
                          num_cores=self.num_cores, **overrides)

    # --- mesh-level planning -----------------------------------------------

    def mesh_plan(self, spec: AttentionSpec, *, axis_size: int,
                  axis: str = "model",
                  bucket: Optional[int] = None) -> LaunchPlan:
        """Kernel plan plus the mesh-level sequence-shard decision.

        Two reasons shard the cache over ``axis`` (``mesh_splits`` = the
        axis size): (a) the occupancy policy finds the axis starved, the
        paper's grid starvation with devices in place of SMs; or (b)
        storage: H_KV does not divide the axis, so head sharding would
        replicate, and the kernel plan takes the axis size as its forced
        split.  The kernel plan is made with ``num_cores`` = the axis
        size, as the reference's.  The split is binary on a fixed mesh:
        any split shards the whole axis.  ``bucket`` passes through to
        :meth:`plan`, so the serving engine's bucket-keyed plans carry
        the mesh provenance."""
        w = spec.workload()
        mesh_spec = dataclasses.replace(spec, mesh_axis=axis,
                                        mesh_axis_size=axis_size)
        planner = dataclasses.replace(self, num_cores=axis_size)
        if spec.num_heads_kv % axis_size != 0:      # storage-driven (b)
            planner = dataclasses.replace(planner,
                                          num_splits_override=axis_size)
            p = planner.plan(mesh_spec, bucket=bucket)
            return dataclasses.replace(p, mesh_splits=axis_size,
                                       seq_shard_axis=axis)
        p = planner.plan(mesh_spec, bucket=bucket)
        s_mesh = choose_mesh_splits(w, axis_size, policy=self.policy,
                                    table=self.table, impl=self.impl)
        return dataclasses.replace(
            p, mesh_splits=axis_size if s_mesh > 1 else 1,
            seq_shard_axis=axis)

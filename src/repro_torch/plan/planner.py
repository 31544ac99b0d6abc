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
table's cells.  The reference's ``block_k`` and mesh planning
(``mesh_plan``) are TPU-only and not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.split_policy import (
    DEFAULT_NUM_CORES,
    analytic_policies,
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

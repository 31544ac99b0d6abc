"""Planner: compiles an AttentionSpec into a frozen LaunchPlan.

Counterpart of ``repro.plan.planner`` (kernel-level planning).  The
policy backend is chosen by name from ``repro_torch.core.split_policy``
or bypassed with ``num_splits_override`` (FA3's explicit ``num_splits``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.split_policy import (
    DEFAULT_NUM_CORES,
    choose_num_splits,
    get_policy,
)
from repro_torch.plan.plan import LaunchPlan
from repro_torch.plan.spec import AttentionSpec


@dataclass(frozen=True)
class Planner:
    """Policy backend -> frozen launch plans.  ``num_cores = None`` means
    :data:`DEFAULT_NUM_CORES` (the H100's 132 SMs)."""
    policy: str = "paper"
    num_cores: Optional[int] = None
    num_splits_override: Optional[int] = None

    def __post_init__(self):
        get_policy(self.policy)           # fail fast on unknown backends

    def plan(self, spec: AttentionSpec, *,
             bucket: Optional[int] = None) -> LaunchPlan:
        """Freeze the launch decision for one attention shape."""
        w = spec.workload()
        cores = self.num_cores if self.num_cores is not None \
            else DEFAULT_NUM_CORES
        if spec.kind == "prefill":
            s = 1                         # prefill never splits KV
        elif self.num_splits_override is not None:
            s = max(1, min(int(self.num_splits_override), w.num_n_blocks))
        else:
            s = choose_num_splits(w, policy=self.policy, num_cores=cores)
        return LaunchPlan(kind=spec.kind, spec=spec, num_splits=s,
                          policy=self.policy, num_cores=cores, bucket=bucket)

    def context(self, kind: str = "decode") -> LaunchPlan:
        """A context-only plan: the policy runs inside the launch."""
        return LaunchPlan(kind=kind, policy=self.policy,
                          num_cores=self.num_cores)

"""LaunchPlan: the frozen output of the planner.

Counterpart of ``repro.plan.plan``.  ``num_splits is None`` marks a
context-only plan: nothing is frozen and the policy runs inside the
launch with the plan's ``policy`` / ``num_cores`` (the paper's
internal-heuristic path).  ``bucket`` is the cache-length bucket the
plan covers; the decode op attends over the cache's first ``bucket``
rows, so the split partitions what is resident, not the whole capacity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.plan.spec import AttentionSpec


@dataclass(frozen=True)
class LaunchPlan:
    kind: str = "decode"                  # decode | prefill
    spec: Optional[AttentionSpec] = None
    num_splits: Optional[int] = None      # None = not frozen
    policy: str = "paper"
    num_cores: Optional[int] = None       # None = policy default
    bucket: Optional[int] = None          # cache-length bucket covered

    @property
    def frozen(self) -> bool:
        """True when the split decision is precomputed (metadata path)."""
        return self.num_splits is not None

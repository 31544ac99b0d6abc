"""Launch planning: AttentionSpec -> Planner -> LaunchPlan -> PlanCache.

Counterpart of ``repro.plan``.  Plans are passed explicitly to every op
that consumes one; there is no ambient plan scope.
"""
from repro_torch.plan.cache import PlanCache, PlanCacheStats  # noqa: F401
from repro_torch.plan.plan import LaunchPlan  # noqa: F401
from repro_torch.plan.planner import Planner  # noqa: F401
from repro_torch.plan.spec import (  # noqa: F401
    KINDS,
    AttentionSpec,
    bucket_seqlen,
)

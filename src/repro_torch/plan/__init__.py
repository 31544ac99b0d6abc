"""Launch planning: AttentionSpec -> Planner -> LaunchPlan -> PlanCache.

Counterpart of ``repro.plan``.  The serving engine passes plans
explicitly to every op that consumes one; :func:`plan_scope` is the
ambient stack an op without an explicit plan reads.
"""
from repro_torch.plan.cache import (  # noqa: F401
    CacheInfo,
    PlanCache,
    PlanCacheStats,
    merge_stats_snapshots,
)
from repro_torch.plan.plan import LaunchPlan  # noqa: F401
from repro_torch.plan.planner import Planner  # noqa: F401
from repro_torch.plan.scope import current_plan, plan_scope  # noqa: F401
from repro_torch.plan.spec import (  # noqa: F401
    KINDS,
    AttentionSpec,
    bucket_seqlen,
)

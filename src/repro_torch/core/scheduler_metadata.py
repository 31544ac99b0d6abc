"""The paper's metadata-enabled path: FA3-style ``get_scheduler_metadata``.

Counterpart of ``repro.core.scheduler_metadata``.  A decode shape is
planned once through a :class:`~repro_torch.plan.Planner` behind a
bounded process-wide :class:`~repro_torch.plan.PlanCache`, keyed as the
reference keys it, and the frozen :class:`~repro_torch.plan.LaunchPlan`
(``SchedulerMetadata``) is handed to the launch.  The inline decode path
of :func:`repro_torch.kernels.ops.decode_attention` resolves its plan
here, so :func:`metadata_cache_info` counts its calls as the reference's
does.

The port's decode kernels always pack the G query heads of one KV head
into one CTA, so ``pack_gqa`` takes ``None`` or ``True`` and raises on
``False``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.split_policy import DEFAULT_NUM_CORES, get_policy
from repro_torch.plan import AttentionSpec, LaunchPlan, PlanCache, Planner
from repro_torch.plan import bucket_seqlen  # noqa: F401  (re-export)

SchedulerMetadata = LaunchPlan

# process-wide plan cache
_PLAN_CACHE = PlanCache(capacity=4096)


def get_scheduler_metadata(
    batch: int,
    seqlen_q: int,
    seqlen_k: int,
    num_heads_q: int,
    num_heads_kv: int,
    head_dim: int = 128,
    *,
    policy: str = "paper",
    num_cores: int = DEFAULT_NUM_CORES,
    num_splits_override: Optional[int] = None,
    pack_gqa: Optional[bool] = None,
) -> LaunchPlan:
    """Compute (and cache) the frozen launch plan of a decode shape.

    ``num_splits_override`` mirrors FA3's explicit ``num_splits``: it
    forces a split count, where production callers leave it ``None`` and
    get the policy's choice."""
    if pack_gqa is False:
        raise ValueError("the port's decode kernels always pack the query "
                         "heads of a KV head into one CTA: pack_gqa must be "
                         "None or True")
    fn = get_policy(policy)
    if getattr(fn, "needs_table", False):
        # a table-backed policy decides from a planner's table, which this
        # entry point does not hold: take its analytic fallback
        policy = getattr(fn, "fallback", "paper")
    key = (batch, seqlen_q, seqlen_k, num_heads_q, num_heads_kv, head_dim,
           policy, num_cores, num_splits_override, pack_gqa)

    def build() -> LaunchPlan:
        spec = AttentionSpec("decode", batch, seqlen_q, seqlen_k,
                             num_heads_q, num_heads_kv, head_dim)
        return Planner(policy=policy, num_cores=num_cores,
                       num_splits_override=num_splits_override).plan(spec)

    return _PLAN_CACHE.get_or_build(key, build)


def metadata_cache_info():
    """Hit and miss counters of the process-wide plan cache."""
    return _PLAN_CACHE.cache_info()

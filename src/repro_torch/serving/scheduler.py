"""Scheduler: slot admission, per-slot request state, bucketed plans.

Counterpart of ``repro.serving.scheduler`` (dense, single device).  It
owns the fixed pool of decode slots, the pending queue, and, through the
:class:`~repro_torch.plan.Planner` and one
:class:`~repro_torch.plan.PlanCache`, every launch-plan decision the
engine consumes:

- decode plans, keyed by the int resident-length bucket;
- prefill plans, keyed by ``("prefill", bucket)`` with the prompt length
  rounded up to ``prefill_bucket``.

``num_cores`` is the machine the policy plans for: the card's SM count
when the engine runs on one.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.plan import AttentionSpec, LaunchPlan, PlanCache, Planner, \
    bucket_seqlen
from repro_torch.serving.sampling import GREEDY, SamplingParams


@dataclass
class Request:
    """One generation request."""
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    sampling: SamplingParams = GREEDY


@dataclass
class Completion:
    """One finished (or in-flight) request's output."""
    request_id: int
    prompt: List[int]
    tokens: List[int] = field(default_factory=list)
    steps: int = 0
    finish_reason: Optional[str] = None


@dataclass
class SlotState:
    """Per-slot request state (host side).  The slot's next write
    position and next fed token live only in the engine's arrays."""
    handle: int
    request: Request
    completion: Completion
    prompt_left: List[int] = field(default_factory=list)  # loop prefill


@dataclass(frozen=True)
class PlanEntry:
    """One plan-cache entry: a frozen plan and the step bound to it."""
    key: Any
    plan: LaunchPlan
    step: Any


class Scheduler:
    """Slot admission + per-slot state + bucketed plan selection."""

    def __init__(self, cfg: ModelConfig, *, batch_slots: int, max_len: int,
                 policy: str, num_cores: Optional[int] = None,
                 num_splits_override: Optional[int] = None,
                 bucket_width: int = 128,
                 prefill_bucket: Optional[int] = None,
                 plan_capacity: Optional[int] = None,
                 kv_dtype: str = "bfloat16"):
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        self.bucket_width = bucket_width
        self.prefill_bucket_width = prefill_bucket or bucket_width
        self.kv_dtype = kv_dtype
        self.planner = Planner(policy=policy, num_cores=num_cores,
                               num_splits_override=num_splits_override)
        self.plans = PlanCache(plan_capacity)
        self.slots: List[Optional[SlotState]] = [None] * batch_slots
        self.pending: Deque[SlotState] = deque()

    # --- admission ----------------------------------------------------------

    def validate(self, req: Request) -> None:
        """Fail fast on requests that could never run."""
        if not req.prompt:
            raise ValueError(f"request {req.request_id}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.request_id}: max_new_tokens must be >= 1, "
                f"got {req.max_new_tokens}")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.request_id}: prompt length "
                f"{len(req.prompt)} >= max_len ({self.max_len})")

    def submit(self, handle: int, req: Request) -> SlotState:
        """Enqueue a request the engine has already validated."""
        st = SlotState(handle, req,
                       Completion(req.request_id, list(req.prompt)))
        self.pending.append(st)
        return st

    def admit_next(self) -> Optional[Tuple[int, SlotState]]:
        """Pop the queue head into the lowest free slot (None when no
        slot is free or nothing is pending)."""
        if not self.pending:
            return None
        for i, slot in enumerate(self.slots):
            if slot is None:
                st = self.pending.popleft()
                self.slots[i] = st
                return i, st
        return None

    def finish(self, i: int) -> None:
        self.slots[i] = None

    def live(self) -> List[Tuple[int, SlotState]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def has_work(self) -> bool:
        return bool(self.pending) or any(s is not None for s in self.slots)

    # --- decode planning ----------------------------------------------------

    def decode_bucket(self, t_max: int) -> int:
        """Resident-length bucket of the longest live position: what keys
        decode plans, never the engine's padded ``max_len``."""
        return bucket_seqlen(min(int(t_max) + 1, self.max_len),
                             self.bucket_width)

    def decode_spec(self, bucket: int) -> AttentionSpec:
        cfg = self.cfg
        return AttentionSpec.decode(self.B, bucket, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.resolved_head_dim,
                                    kv_dtype=self.kv_dtype)

    def decode_entry(self, t_max: int,
                     build: Callable[[LaunchPlan], Any]) -> PlanEntry:
        """Plan-cache lookup: one frozen plan and bound step per bucket."""
        bucket = self.decode_bucket(t_max)

        def miss() -> PlanEntry:
            plan = self.planner.plan(self.decode_spec(bucket), bucket=bucket)
            return PlanEntry(bucket, plan, build(plan))

        return self.plans.get_or_build(bucket, miss)

    # --- prefill planning ---------------------------------------------------

    def prefill_len(self, prompt_len: int) -> int:
        """Prompt length rounded up to its prefill bucket, capped at the
        cache length."""
        return min(bucket_seqlen(prompt_len, self.prefill_bucket_width),
                   self.max_len)

    def prefill_spec(self, bucket: int) -> AttentionSpec:
        cfg = self.cfg
        return AttentionSpec.prefill(1, bucket, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.resolved_head_dim)

    def prefill_entry(self, prompt_len: int,
                      build: Callable[[LaunchPlan], Any]) -> PlanEntry:
        """One planned prefill entry per prompt-length bucket, in the same
        PlanCache as the decode plans."""
        bucket = self.prefill_len(prompt_len)
        key = ("prefill", bucket)

        def miss() -> PlanEntry:
            plan = self.planner.plan(self.prefill_spec(bucket), bucket=bucket)
            return PlanEntry(key, plan, build(plan))

        return self.plans.get_or_build(key, miss)

    # --- observability ------------------------------------------------------

    def planned_splits(self) -> Dict[int, int]:
        """bucket -> frozen num_splits, for every resident decode plan."""
        return {k: e.plan.num_splits for k, e in self.plans.items()
                if isinstance(k, int)}

    def planned_prefill_buckets(self) -> List[int]:
        return sorted(k[1] for k in self.plans.keys()
                      if isinstance(k, tuple) and k[0] == "prefill")

"""Scheduler: slot admission, per-slot request state, bucketed plans.

Counterpart of ``repro.serving.scheduler``.  It
owns the fixed pool of decode slots, the pending queue, and, through the
:class:`~repro_torch.plan.Planner` and one
:class:`~repro_torch.plan.PlanCache`, every launch-plan decision the
engine consumes:

- decode plans, keyed by the int resident-length bucket (under the paged
  layout that bucket is also the view every decode launch gathers);
- prefill plans, keyed by ``("prefill", bucket)`` with the prompt length
  rounded up to ``prefill_bucket``;
- suffix-prefill plans (prefix sharing), keyed by ``("sprefill",
  view_bucket, suffix_bucket)``;
- verify plans (speculative decoding), keyed by ``("verify", k,
  bucket)``;
- side plans (:meth:`Scheduler.side_plans`), one per decode launch of
  the family that attends a length other than the bucket's: encdec's
  cross attention over the encoder length, a hybrid's windowed layers
  over the ring.  The reference evaluates the policy for them inside
  each compiled step; here each is frozen once, when the first decode
  step is built, so no decode step evaluates the policy.

``num_cores`` is the machine the policy plans for: the card's SM count
when the engine runs on one.  In a sequence-sharded shard of a
mesh-native topology (``seq_shards > 1``) every plan goes through
``Planner.mesh_plan``, so it carries ``mesh_splits`` provenance, and a
decode plan whose ``mesh_splits`` is above 1 is realized over the
shard's grid ``mesh`` (``seq_shard_mesh``): its launches run one
partials launch a device, merged.  ``plans`` lets the shards of one
topology share a PlanCache.  ``table`` is the calibrated
:class:`~repro_torch.tune.SplitTable` the ``measured`` policy decides
from (``table_impl`` its family, ``None`` the port's own); its lookups
and fallbacks are counted in the plan cache's stats.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.split_policy import get_policy
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
                 kv_dtype: str = "bfloat16",
                 table: Optional[Any] = None,
                 table_impl: Optional[str] = None,
                 mesh: Optional[Any] = None,
                 seq_shards: int = 1,
                 plans: Optional[PlanCache] = None):
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        self.bucket_width = bucket_width
        self.prefill_bucket_width = prefill_bucket or bucket_width
        self.kv_dtype = kv_dtype
        self.mesh = mesh
        self.seq_shards = seq_shards
        self.planner = Planner(policy=policy, num_cores=num_cores,
                               num_splits_override=num_splits_override,
                               impl=table_impl, table=table)
        self.plans = plans if plans is not None else PlanCache(plan_capacity)
        if table is not None:
            # measured lookups land in the same stats as plan-cache hits
            table.attach_stats(self.plans.stats)
        self.slots: List[Optional[SlotState]] = [None] * batch_slots
        self.pending: Deque[SlotState] = deque()
        self._side: Optional[Dict[str, LaunchPlan]] = None

    # --- planning core ------------------------------------------------------

    def _plan(self, spec: AttentionSpec, bucket: int) -> LaunchPlan:
        """The planner entry of every plan family: in a sequence-sharded
        shard, ``Planner.mesh_plan`` over its ``seq_shards`` devices."""
        if self.seq_shards > 1:
            return self.planner.mesh_plan(spec, axis_size=self.seq_shards,
                                          bucket=bucket)
        return self.planner.plan(spec, bucket=bucket)

    def _realize(self, plan: LaunchPlan) -> LaunchPlan:
        """A decode plan whose ``mesh_splits`` is above 1 runs sequence-
        sharded over the shard's grid.  Verify and prefill plans keep
        their provenance and run whole on the shard's lead device."""
        if self.mesh is not None and plan.mesh_splits > 1:
            return dataclasses.replace(plan, min_splits=1,
                                       seq_shard_mesh=self.mesh,
                                       seq_shard_axis="model")
        return plan

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

    def admit_next(self, admissible: Optional[
            Callable[[SlotState], bool]] = None
            ) -> Optional[Tuple[int, SlotState]]:
        """Pop the queue head into the lowest free slot (None when no
        slot is free or nothing is pending).  ``admissible`` gates the
        head on a resource the scheduler does not own (the engine passes
        the cache manager's free-page check); a refused head blocks the
        queue, FIFO, until a finish frees its pages."""
        if not self.pending:
            return None
        for i, slot in enumerate(self.slots):
            if slot is None:
                if admissible is not None \
                        and not admissible(self.pending[0]):
                    return None
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

    def _kv_heads(self) -> int:
        """H_KV as the decode workload sees it (MLA: one shared latent).
        The plan keys keep ``cfg.resolved_head_dim`` (minicpm3-4b: 64)
        although MLA's launch reads 288-wide latent rows, as the
        reference's do."""
        return 1 if self.cfg.mla else self.cfg.num_kv_heads

    def decode_bucket(self, t_max: int) -> int:
        """Resident-length bucket of the longest live position: what keys
        decode plans, never the engine's padded ``max_len``."""
        return bucket_seqlen(min(int(t_max) + 1, self.max_len),
                             self.bucket_width)

    def decode_spec(self, bucket: int) -> AttentionSpec:
        cfg = self.cfg
        return AttentionSpec.decode(self.B, bucket, cfg.num_heads,
                                    self._kv_heads(), cfg.resolved_head_dim,
                                    kv_dtype=self.kv_dtype)

    def decode_plan(self, t_max: int) -> LaunchPlan:
        """Compute (not cache) the frozen decode plan for ``t_max``."""
        bucket = self.decode_bucket(t_max)
        return self._realize(self._plan(self.decode_spec(bucket), bucket))

    def decode_entry(self, t_max: int,
                     build: Callable[[LaunchPlan], Any]) -> PlanEntry:
        """Plan-cache lookup: one frozen plan and bound step per bucket."""
        bucket = self.decode_bucket(t_max)

        def miss() -> PlanEntry:
            plan = self._realize(self._plan(self.decode_spec(bucket),
                                            bucket))
            return PlanEntry(bucket, plan, build(plan))

        return self.plans.get_or_build(bucket, miss)

    # --- side plans: decode launches over another length -------------------

    def side_plans(self) -> Dict[str, LaunchPlan]:
        """Frozen plans of the decode launches of a step whose L_K is not
        the bucket's, by name: encdec's ``"cross"`` (the whole encoder
        memory) and a hybrid's ``"ring"`` (the whole ring, ``min(window,
        max_len)`` rows); none for the other families.  Made once, with
        the decisions the reference's inline evaluation makes: the
        engine's policy and core count (a table-backed policy's analytic
        fallback, as ``get_scheduler_metadata`` takes it), no
        ``num_splits_override`` (the reference keeps only a plan's policy
        overrides there), a bfloat16 key also over an int8 ring, and no
        bucket, so the launch splits the whole cache it reads."""
        if self._side is None:
            cfg = self.cfg
            lengths = {}
            if cfg.family == "encdec":
                lengths["cross"] = cfg.encoder_positions
            elif cfg.family == "hybrid":
                lengths["ring"] = min(cfg.hybrid.window, self.max_len)
            policy = self.planner.policy
            fn = get_policy(policy)
            if getattr(fn, "needs_table", False):
                policy = getattr(fn, "fallback", "paper")
            planner = Planner(policy=policy,
                              num_cores=self.planner.num_cores)
            self._side = {name: planner.plan(AttentionSpec.decode(
                self.B, length, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim)) for name, length in lengths.items()}
        return self._side

    # --- speculative verify planning ----------------------------------------

    def verify_spec(self, k: int, bucket: int) -> AttentionSpec:
        """The verify-kind spec: a ``k + 1``-row query block (current
        token and k drafts) against the resident-length bucket."""
        cfg = self.cfg
        return AttentionSpec.verify(self.B, k + 1, bucket, cfg.num_heads,
                                    self._kv_heads(), cfg.resolved_head_dim,
                                    kv_dtype=self.kv_dtype)

    def verify_entry(self, k: int, t_max: int,
                     build: Callable[[LaunchPlan], Any]) -> PlanEntry:
        """One planned verify entry per ``("verify", k, bucket)`` key, in
        the same PlanCache as decode and prefill plans.  ``t_max`` is the
        largest position any row of the launch writes (each slot's
        position plus its draft count), so the bucket covers the
        speculative extent; the same sequence-aware policy as decode
        plans the splits, on the k + 1-row workload."""
        bucket = self.decode_bucket(t_max)
        key = ("verify", k, bucket)

        def miss() -> PlanEntry:
            plan = self._plan(self.verify_spec(k, bucket), bucket)
            return PlanEntry(key, plan, build(plan))

        return self.plans.get_or_build(key, miss)

    # --- prefill planning ---------------------------------------------------

    def prefill_len(self, prompt_len: int) -> int:
        """Prompt length rounded up to its prefill bucket, capped at the
        cache length."""
        return min(bucket_seqlen(prompt_len, self.prefill_bucket_width),
                   self.max_len)

    def prefill_spec(self, bucket: int) -> AttentionSpec:
        cfg = self.cfg
        return AttentionSpec.prefill(1, bucket, cfg.num_heads,
                                     self._kv_heads(), cfg.resolved_head_dim)

    def prefill_entry(self, prompt_len: int,
                      build: Callable[[LaunchPlan], Any]) -> PlanEntry:
        """One planned prefill entry per prompt-length bucket, in the same
        PlanCache as the decode plans."""
        bucket = self.prefill_len(prompt_len)
        key = ("prefill", bucket)

        def miss() -> PlanEntry:
            plan = self._plan(self.prefill_spec(bucket), bucket)
            return PlanEntry(key, plan, build(plan))

        return self.plans.get_or_build(key, miss)

    def suffix_prefill_entry(self, suffix_len: int, total_len: int,
                             build: Callable[[LaunchPlan], Any]
                             ) -> PlanEntry:
        """Suffix-only prefill (prefix sharing): queries span the
        unshared suffix, bucketed to ``mb``, and keys the whole resident
        prompt, the view bucket ``vb``, so entries key on the pair
        ``("sprefill", vb, mb)``.  Launches under these keys are what
        show that a shared admission ran no full prefill."""
        mb = min(bucket_seqlen(suffix_len, self.prefill_bucket_width),
                 self.max_len)
        vb = self.prefill_len(total_len)
        key = ("sprefill", vb, mb)

        def miss() -> PlanEntry:
            cfg = self.cfg
            spec = AttentionSpec("prefill", 1, mb, vb, cfg.num_heads,
                                 self._kv_heads(), cfg.resolved_head_dim)
            plan = self._plan(spec, vb)
            return PlanEntry(key, plan, build(plan))

        return self.plans.get_or_build(key, miss)

    # --- observability ------------------------------------------------------

    def queue_depth(self) -> int:
        """Requests still waiting for a slot (a repro_torch.obs gauge)."""
        return len(self.pending)

    def occupancy(self) -> Tuple[int, int]:
        """``(live_slots, total_slots)`` (repro_torch.obs gauges)."""
        return sum(s is not None for s in self.slots), self.B

    def planned_splits(self) -> Dict[int, int]:
        """bucket -> frozen num_splits, for every resident decode plan."""
        return {k: e.plan.num_splits for k, e in self.plans.items()
                if isinstance(k, int)}

    def planned_prefill_buckets(self) -> List[int]:
        return sorted(k[1] for k in self.plans.keys()
                      if isinstance(k, tuple) and k[0] == "prefill")

    def planned_suffix_buckets(self) -> List[Tuple[int, int]]:
        """Resident suffix-prefill (view, suffix) bucket pairs, sorted."""
        return sorted((k[1], k[2]) for k in self.plans.keys()
                      if isinstance(k, tuple) and k[0] == "sprefill")

    def planned_verify_keys(self) -> List[Tuple[int, int]]:
        """Resident verify-plan (k, bucket) pairs, sorted."""
        return sorted((k[1], k[2]) for k in self.plans.keys()
                      if isinstance(k, tuple) and k[0] == "verify")

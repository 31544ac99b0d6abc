"""Request-lifecycle serving engine: submit / step / stream / drain.

Counterpart of ``repro.serving.engine.ServingEngine`` on one device with
the dense cache.  A fixed pool of ``B`` decode slots runs in lockstep;
each slot carries its own position.

- :meth:`ServingEngine.submit` enqueues a :class:`Request` and returns a
  handle.
- :meth:`ServingEngine.step` admits pending requests into free slots and
  runs one lockstep decode launch; it returns the :class:`Event`\\ s it
  produced.
- :meth:`ServingEngine.stream` iterates one handle's events.
- :meth:`ServingEngine.drain` runs to completion.

Admission runs fused bucketed prefill: the prompt is padded to its
``prefill_bucket`` and computed in one planned launch, keyed
``("prefill", bucket)`` in the scheduler's :class:`PlanCache`.  Every
decode launch takes its split count from the frozen
:class:`~repro_torch.plan.LaunchPlan` of the live slots' resident-length
bucket, so the policy runs zero times inside a launch
(``kernels.ops.policy_eval_count`` stays flat).  On the card the plans
are made for the card's SM count.

The K/V caches are static buffers of the engine, written in place by
prefill and decode; the reference instead threads updated copies
through donated jitted steps.
"""
from __future__ import annotations

import functools
import warnings
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.models.registry import DeviceLike, Model, resolve_device
from repro_torch.plan import LaunchPlan, PlanCacheStats
from repro_torch.quant import QUANT_DTYPES
from repro_torch.serving.events import (
    FINISH_CACHE_CAPACITY,
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_STOP,
    FINISHED,
    TOKEN,
    Event,
)
from repro_torch.serving.sampling import GreedySampler, Sampler
from repro_torch.serving.scheduler import Completion, Request, Scheduler, \
    SlotState

PREFILL_MODES = ("auto", "fused", "loop")


class ServingEngine:
    """Request-lifecycle engine over one device (the card unless
    ``device="cpu"`` is passed)."""

    def __init__(self, model: Model, scfg: ServeConfig, *,
                 max_len: int = 256, batch_slots: int = 4,
                 policy: Optional[str] = None,
                 sampler: Optional[Sampler] = None,
                 prefill_mode: Optional[str] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = model.cfg
        self.policy = policy or scfg.split_policy
        self.max_len = max_len
        self.B = batch_slots
        self.use_metadata = scfg.use_scheduler_metadata
        self.sampler = sampler if sampler is not None else GreedySampler()

        mode = prefill_mode or scfg.prefill_mode
        if mode not in PREFILL_MODES:
            raise ValueError(f"unknown prefill_mode {mode!r}; "
                             f"known: {PREFILL_MODES}")
        if mode == "auto":
            mode = "fused" if (self.use_metadata
                               and model.supports_fused_prefill) else "loop"
        elif mode == "fused" and not self.use_metadata:
            raise ValueError(
                "fused prefill admission rides the metadata-enabled plan "
                "path; set use_scheduler_metadata=True or "
                "prefill_mode='loop'")
        self.prefill_mode = mode
        if scfg.kv_quant is not None and scfg.kv_quant not in QUANT_DTYPES:
            raise ValueError(f"unknown kv_quant {scfg.kv_quant!r}; "
                             f"known: {sorted(QUANT_DTYPES)}")
        # the cache's storage dtype (a KV_DTYPES name); kv_quant wins
        self.kv_dtype = scfg.kv_quant or scfg.kv_cache_dtype

        num_cores = None
        if self.device.type == "cuda":
            num_cores = torch.cuda.get_device_properties(
                self.device).multi_processor_count
        self.sched = Scheduler(
            self.cfg, batch_slots=batch_slots, max_len=max_len,
            policy=self.policy, num_cores=num_cores,
            num_splits_override=scfg.num_splits_override,
            bucket_width=scfg.seqlen_bucket,
            prefill_bucket=scfg.prefill_bucket,
            plan_capacity=scfg.plan_cache_capacity,
            kv_dtype=self.kv_dtype)
        # the internal-heuristic baseline: one context-only plan for every
        # length, so the policy runs inside each launch on max_len
        self._fallback_plan = self.sched.planner.context()

        self._params = None
        self._caches: Optional[Dict[str, torch.Tensor]] = None
        # the only copy of each slot's next write position and next fed
        # token; a dead slot keeps its last values (its lockstep rows are
        # computed and ignored)
        self._pos = np.zeros(self.B, np.int64)
        self._next_token = np.zeros(self.B, np.int64)
        self._next_handle = 0
        self._queues: Dict[int, Deque[Event]] = {}
        self._completions: Dict[int, Completion] = {}
        self._undrained: List[int] = []
        self._warned_len_capacity = False

    # --- observability ------------------------------------------------------

    @property
    def stats(self) -> PlanCacheStats:
        return self.sched.plans.stats

    def planned_splits(self) -> Dict[int, int]:
        """bucket -> frozen num_splits, for every resident decode plan."""
        return self.sched.planned_splits()

    def planned_prefill_buckets(self) -> List[int]:
        return self.sched.planned_prefill_buckets()

    # --- state --------------------------------------------------------------

    def load(self, params) -> None:
        """Bind weights and allocate fresh zeroed caches (a new session)."""
        dev = next(params.parameters()).device
        if dev.type != self.device.type:
            raise ValueError(f"params live on {dev}, engine on "
                             f"{self.device}")
        self._params = params
        self._caches = self.model.init_cache(self.B, self.max_len,
                                             kv_dtype=self.kv_dtype)

    # --- bound steps --------------------------------------------------------

    def _decode_impl(self, token: torch.Tensor, t: torch.Tensor,
                     plan: LaunchPlan) -> torch.Tensor:
        logits = self.model.decode_step(self._params, self._caches, token, t,
                                        plan=plan)
        return self.sampler.sample(logits)

    def _prefill_impl(self, tokens: torch.Tensor, slot: int, length: int,
                      plan: LaunchPlan) -> int:
        logits = self.model.prefill_slot(self._params, self._caches, tokens,
                                         slot, length, plan=plan)
        return int(self.sampler.sample(logits[None])[0])

    def _build_decode(self, plan: LaunchPlan):
        return functools.partial(self._decode_impl, plan=plan)

    def _build_prefill(self, plan: LaunchPlan):
        return functools.partial(self._prefill_impl, plan=plan)

    # --- request lifecycle --------------------------------------------------

    def validate(self, req: Request) -> None:
        """Raise on requests that could never run (no state mutated)."""
        self.sched.validate(req)
        self.sampler.check(req.sampling)

    def submit(self, req: Request) -> int:
        """Enqueue a request; returns its handle (admission happens on a
        later :meth:`step`)."""
        self.validate(req)
        handle = self._next_handle
        st = self.sched.submit(handle, req)
        self._next_handle += 1
        self._completions[handle] = st.completion
        self._queues[handle] = deque()
        self._undrained.append(handle)
        return handle

    def has_work(self) -> bool:
        return self.sched.has_work()

    def step(self) -> List[Event]:
        """Admit pending requests into free slots (one planned prefill
        launch each), then one lockstep decode launch over the live slots."""
        if self._params is None:
            raise RuntimeError("call load(params) first")
        events: List[Event] = []
        while True:
            adm = self.sched.admit_next()
            if adm is None:
                break
            self._admit(*adm, events)
        live = self.sched.live()
        if live:
            self._decode_launch(live, events)
        return events

    def stream(self, handle: int) -> Iterator[Event]:
        """Iterate one handle's events in order, stepping as needed.  Once
        FINISHED is yielded the handle is released."""
        if handle not in self._queues:
            raise ValueError(
                f"handle {handle} is unknown, already streamed to "
                "FINISHED, or drained")
        while True:
            q = self._queues.get(handle)
            if q is None:
                return
            if q:
                ev = q.popleft()
                yield ev
                if ev.kind == FINISHED:
                    self._queues.pop(handle, None)
                    self._completions.pop(handle, None)
                    if handle in self._undrained:
                        self._undrained.remove(handle)
                    return
            elif not self.sched.has_work():
                return
            else:
                self.step()

    def drain(self) -> List[Completion]:
        """Run to completion; returns every not-yet-drained request's
        :class:`Completion`, sorted by request_id, and releases them."""
        while self.sched.has_work():
            self.step()
        done = [self._completions.pop(h) for h in self._undrained]
        for h in self._undrained:
            self._queues.pop(h, None)
        self._undrained = []
        done.sort(key=lambda c: c.request_id)
        return done

    # --- internals ----------------------------------------------------------

    def _admit(self, i: int, st: SlotState, events: List[Event]) -> None:
        if self.prefill_mode == "fused":
            self._admit_fused(i, st, events)
            return
        # loop admission teacher-forces the prompt through decode steps;
        # the slot's rows (data and scales) are zeroed first, as the
        # reference does
        for c in self._caches.values():
            c[:, i].zero_()
        st.prompt_left = list(st.request.prompt)
        self._pos[i] = 0
        self._next_token[i] = st.prompt_left.pop(0)

    def _admit_fused(self, i: int, st: SlotState,
                     events: List[Event]) -> None:
        """Prefill the prompt in one planned launch; the slot joins the
        decode lockstep holding its first token."""
        prompt = st.request.prompt
        n = len(prompt)
        entry = self.sched.prefill_entry(n, self._build_prefill)
        toks = np.zeros(entry.key[1], np.int64)
        toks[:n] = prompt
        tok = entry.step(torch.from_numpy(toks).to(self.device), i, n)
        self._pos[i] = n
        st.completion.steps += 1
        self._emit_token(i, st, tok, events)

    def _decode_launch(self, live, events: List[Event]) -> None:
        tok = torch.from_numpy(self._next_token).to(self.device)
        t = torch.from_numpy(self._pos).to(self.device)
        t_max = max(int(self._pos[i]) for i, _ in live)
        if self.use_metadata:
            step = self.sched.decode_entry(t_max, self._build_decode).step
        else:
            step = functools.partial(self._decode_impl,
                                     plan=self._fallback_plan)
            self.stats.record_fallback(t_max + 1, self.max_len)
        out = step(tok, t).cpu().numpy()    # host copy waits for the launch
        for i, st in live:
            self._advance(i, st, int(out[i]), events)

    def _advance(self, i: int, st: SlotState, tok_out: int,
                 events: List[Event]) -> None:
        self._pos[i] += 1
        st.completion.steps += 1
        if st.prompt_left:                      # loop-mode prefilling
            self._next_token[i] = st.prompt_left.pop(0)
            return
        self._emit_token(i, st, tok_out, events)

    def _finish(self, i: int, st: SlotState, reason: str,
                events: List[Event]) -> None:
        comp = st.completion
        comp.finish_reason = reason
        fin = Event(FINISHED, st.handle, comp.request_id,
                    finish_reason=reason)
        events.append(fin)
        self._queues[st.handle].append(fin)
        self.sched.finish(i)

    def _finish_reason(self, i: int, st: SlotState,
                       token: int) -> Optional[str]:
        req = st.request
        if req.eos_id is not None and token == req.eos_id:
            return FINISH_EOS
        if token in req.sampling.stop:
            return FINISH_STOP
        if len(st.completion.tokens) >= req.max_new_tokens:
            return FINISH_LENGTH
        if self._pos[i] >= self.max_len - 1:
            if not self._warned_len_capacity:
                self._warned_len_capacity = True
                warnings.warn(
                    f"request {req.request_id} hit the KV cache capacity "
                    f"(max_len={self.max_len}) mid-generation; finishing "
                    "with finish_reason='cache_capacity' (further "
                    "max_len hits on this engine are silent)",
                    RuntimeWarning, stacklevel=3)
            return FINISH_CACHE_CAPACITY
        return None

    def _emit_token(self, i: int, st: SlotState, token: int,
                    events: List[Event]) -> None:
        comp = st.completion
        comp.tokens.append(token)
        ev = Event(TOKEN, st.handle, comp.request_id, token=token,
                   index=len(comp.tokens) - 1)
        events.append(ev)
        self._queues[st.handle].append(ev)
        reason = self._finish_reason(i, st, token)
        if reason is not None:
            self._finish(i, st, reason, events)
        else:
            self._next_token[i] = token

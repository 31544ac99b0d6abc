"""Request-lifecycle serving engine: submit / step / stream / drain.

Counterpart of ``repro.serving.engine``, on one device or as one shard
of a mesh-native topology (``mesh=``, below).  A fixed pool of
``B`` decode slots runs in lockstep; each slot carries its own position.

- :meth:`ServingEngine.submit` enqueues a :class:`Request` and returns a
  handle.
- :meth:`ServingEngine.step` admits pending requests into free slots and
  runs one lockstep decode launch; it returns the :class:`Event`\\ s it
  produced.
- :meth:`ServingEngine.stream` iterates one handle's events.
- :meth:`ServingEngine.drain` runs to completion.

Admission runs fused bucketed prefill: the prompt is padded to its
``prefill_bucket`` and computed in one planned launch, keyed
``("prefill", bucket)`` in the scheduler's :class:`PlanCache`; a model
without fused prefill (vlm, hybrid) admits through the teacher-forcing
loop, one decode step a prompt token.  A slot is reset (its tensors
that do not page zeroed) before loop admission, and before fused
admission when the model's prefill leaves part of the slot unwritten
(encdec's cross cache).  Every decode launch takes its split count from
the frozen :class:`~repro_torch.plan.LaunchPlan` of the live slots'
resident-length bucket, or, where a launch reads another length
(encdec's cross attention, a hybrid's ring), from the scheduler's side
plan for it (:meth:`~repro_torch.serving.scheduler.Scheduler.
side_plans`), so the policy runs zero times inside a launch
(``kernels.ops.policy_eval_count`` stays flat).  On the card the plans
are made for the card's SM count.

Cache layouts (``repro_torch.cache``): a
:class:`~repro_torch.cache.manager.CacheManager` resolves the engine's
:class:`~repro_torch.cache.spec.CacheSpec` into a layout; the engine
holds the storage tensors, which prefill and decode write in place (the
reference threads updated copies through donated jitted steps).
Both layouts run through the same layout calls.  ``dense`` is one
``(layers, B, max_len, ...)`` tensor per cache tensor, its own decode
view.  ``paged`` stores them as fixed-size pages with per-slot page tables:
each decode launch gathers the resident bucket's pages of every slot,
runs the planned step on that view and writes back the page each slot
wrote; admission is gated on free pages, and a request whose next page
the pool cannot cover finishes alone with ``finish_reason=
"cache_capacity"``.  Under ``share_prefix`` admission adopts the pages
of an already-prefilled prompt prefix (refcounts, copy-on-write) and
prefills only the unshared suffix, keyed ``("sprefill", view_bucket,
suffix_bucket)``; queued page copies land before any launch that
gathers.

Sampling: a :class:`~repro_torch.serving.sampling.Sampler` keeps one
host row of state per slot (temperature, top-k, top-p, seed), written
at admission; :class:`~repro_torch.serving.sampling.CategoricalSampler`
is the default, so a request with ``temperature > 0`` is served.

Speculative decoding (``repro_torch.spec``): a request opting in through
``SamplingParams.speculation`` (or the engine-wide
``ServeConfig.speculation``) decodes through planned verify launches.
A host-side :class:`~repro_torch.spec.Drafter` proposes up to ``k`` draft
tokens from the slot's history; the model scores the slot's current
token and its drafts in one ``("verify", k, bucket)`` launch; the sampler
accepts the longest valid draft prefix (argmax match for greedy rows,
rejection sampling for sampled ones).  Accepted rows commit (paged:
``PagedKVCache.write_rows`` writes back only their pages), rejected rows
die by rolling ``kv_len`` back (``CacheManager.truncate``), so page
conservation holds under any accept/reject sequence and greedy output
is sequential greedy decode's by construction.  ``SpecConfig.max_rejects``
consecutive zero-accept steps turn speculation off for that request.

Measured splits (``repro_torch.tune``): under ``split_policy=
"measured"`` the planner decides every decode and verify plan from a
calibrated :class:`~repro_torch.tune.SplitTable`, passed as
``tune_table=`` or loaded from ``ServeConfig.tune_table_path`` (a file,
or a registry directory whose table matching the live device wins); the
table is read when a plan freezes, never inside a launch, so the policy
needs the metadata path.  Its lookups and fallbacks land in
:attr:`ServingEngine.stats`, and ``ServeConfig.stats_path`` makes
:meth:`ServingEngine.drain` write them (:meth:`dump_stats`).

Observability (``repro_torch.obs``): ``ServeConfig.trace_path`` /
``metrics_path`` resolve an :class:`~repro_torch.obs.Observer` (an
``obs=`` argument wins, and its injector owns the dump), which the
engine calls at the reference's sites: submit, admission start and end
(``full`` / ``suffix`` / ``loop``, with the shared prefix rows and their
KV bytes), each prefill, suffix-prefill, decode and verify launch
(stamped with its plan's provenance; decode and verify also on each
rider's request track), each token, each finish, the structured
warnings, and the occupancy gauges at the end of every :meth:`step`.  A
launch span closes at the host copy that already waits for the launch:
nothing is synchronized for it.  :meth:`ServingEngine.drain` writes the
artifacts (:meth:`dump_obs`).  Disabled, the engine holds
``NULL_OBSERVER`` and each site costs one attribute read.

Mesh-native serving (``repro_torch.shard``): with ``mesh=`` the engine
is one shard of a :class:`~repro_torch.shard.ShardedServingEngine`, bound
to its ``(1, sp)`` grid (:class:`~repro_torch.launch.mesh.EngineMesh`),
which every model call binds as the activation mesh (so a MoE model's
``ep_shard_map`` dispatch runs expert parallelism where L divides the
axis, as the reference's does).  Its weights live on the grid's lead
device (``param_policy="replicated"``) or tensor-parallel over its
devices (``"tp"``: :func:`repro_torch.sharding.place.place_params`,
each device its slices, the projections' parts joined or summed on the
lead); every other non-attention op runs on the lead device.
With ``sp > 1`` (``seq_shards``) the dense cache is held in ``sp``
chunks of rows, one a device (:class:`~repro_torch.kernels.ops.
SeqShards`); the paged pool stays on the lead device and each launch's
gathered view is cut into ``sp`` chunks.  Every plan is frozen through
``Planner.mesh_plan`` (``mesh_splits`` provenance), and a decode plan
with ``mesh_splits`` above 1 launches one partials launch a device over
its chunk at one split, merged by one combine-kernel launch.  Verify
steps run on the chunks joined on the lead device.  ``plan_cache``
shares one PlanCache across same-topology engines (its steps take the
engine as an argument, so a shared entry serves any of them);
``shard_id`` labels the cache manager.

:class:`DecodeEngine` is the batch-synchronous facade
(``generate(requests) -> completions``): loop admission and greedy
sampling, as the reference's.
"""
from __future__ import annotations

import functools
import warnings
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ServeConfig
from repro_torch.core.split_policy import KV_DTYPES, get_policy
from repro_torch.kernels import ops
from repro_torch.models.registry import DeviceLike, Model, resolve_device
from repro_torch.obs import atomic_write_json, resolve_obs
from repro_torch.plan import LaunchPlan, PlanCacheStats, Planner
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
from repro_torch.serving.sampling import CategoricalSampler, \
    GreedySampler, Sampler
from repro_torch.sharding import activation_mesh
from repro_torch.serving.scheduler import Completion, Request, Scheduler, \
    SlotState
from repro_torch.spec import Drafter, SpecConfig, get_drafter

PREFILL_MODES = ("auto", "fused", "loop")


class ServingEngine:
    """Request-lifecycle engine over one device (the card unless
    ``device="cpu"`` is passed), or over one shard's grid ``mesh``."""

    def __init__(self, model: Model, scfg: ServeConfig, *,
                 max_len: int = 256, batch_slots: int = 4,
                 policy: Optional[str] = None,
                 sampler: Optional[Sampler] = None,
                 prefill_mode: Optional[str] = None,
                 tune_table: Optional[Any] = None,
                 tune_impl: Optional[str] = None,
                 device: DeviceLike = None,
                 mesh: Optional[Any] = None,
                 plan_cache: Optional[Any] = None,
                 shard_id: Optional[int] = None,
                 param_policy: str = "replicated",
                 obs: Optional[Any] = None):
        from repro_torch.shard.spec import PARAM_POLICIES
        if param_policy not in PARAM_POLICIES:
            raise ValueError(f"unknown param_policy {param_policy!r}; "
                             f"known: {PARAM_POLICIES}")
        self.mesh = mesh
        self.shard_id = shard_id
        self.param_policy = param_policy
        self.seq_shards = int(mesh.shape["model"]) if mesh is not None \
            else 1
        if mesh is not None:
            # the shard's lead device runs every non-attention op
            if device is not None and resolve_device(device) != mesh.lead:
                raise ValueError(f"device {device} is not the lead device "
                                 f"{mesh.lead} of the shard's grid")
            self.device = mesh.lead
            if model.device != self.device:
                model = Model(model.cfg, self.device)
        else:
            self.device = resolve_device(device)
            if model.device != self.device:
                raise ValueError(f"model lives on {model.device}, engine "
                                 f"on {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.policy = policy or scfg.split_policy
        self.max_len = max_len
        self.B = batch_slots
        self.use_metadata = scfg.use_scheduler_metadata
        if self.seq_shards > 1:
            if not self.use_metadata:
                raise ValueError(
                    "sequence-sharded decode rides the metadata-enabled "
                    "plan path (the sharded launches are pinned on frozen "
                    "plans); set use_scheduler_metadata=True or a model "
                    "axis of 1")
            if self.cfg.family not in ("dense", "moe", "mla"):
                raise ValueError(
                    f"{self.cfg.family} models cannot sequence-shard "
                    "their decode (needs a position-linear k/v cache "
                    "consumed by the split-KV combine); use a model axis "
                    "of 1")
        self._stats_path = scfg.stats_path
        # an injected observer wins, and its injector owns the artifact
        # dumps; otherwise the config's paths resolve one, NULL_OBSERVER
        # when both are unset
        self._trace_path = scfg.trace_path
        self._metrics_path = scfg.metrics_path
        if obs is not None:
            self._obs = obs
            self._owns_obs = False
        else:
            self._obs = resolve_obs(scfg)
            self._owns_obs = self._obs.enabled
        # the measured policy's table, resolved once: an explicit table
        # wins over the config's path, which may be a registry directory
        # (the table matching this engine's device is picked, with a
        # counted warning when none matches).  ``tune_impl`` is the table
        # family the plans look up (None: the port's own, "cuda").
        self.tune_table = tune_table
        self._table_registry_fallback = False
        if self.tune_table is None and scfg.tune_table_path:
            from repro_torch.tune import select_table
            self.tune_table, matched = select_table(
                scfg.tune_table_path, device=self.device)
            self._table_registry_fallback = not matched
        if getattr(get_policy(self.policy), "needs_table", False) \
                and not self.use_metadata:
            raise ValueError(
                f"split_policy={self.policy!r} rides the metadata-enabled "
                "plan path (the SplitTable is read when plans freeze, "
                "never inside a launch); set use_scheduler_metadata=True "
                "or an analytic policy")
        # CategoricalSampler by default, so every request's SamplingParams
        # are honoured; a batch with no sampled row costs one argmax, as
        # GreedySampler's, which instead refuses sampled requests at submit
        self.sampler = sampler if sampler is not None else \
            CategoricalSampler()

        mode = prefill_mode or scfg.prefill_mode
        if mode not in PREFILL_MODES:
            raise ValueError(f"unknown prefill_mode {mode!r}; "
                             f"known: {PREFILL_MODES}")
        if mode == "auto":
            mode = "fused" if (self.use_metadata
                               and model.supports_fused_prefill) else "loop"
        elif mode == "fused":
            if not model.supports_fused_prefill:
                raise ValueError(
                    f"{self.cfg.family} models cannot fused-prefill a "
                    "padded prompt (recurrent state / non-token "
                    "frontend); use prefill_mode='loop'")
            if not self.use_metadata:
                raise ValueError(
                    "fused prefill admission rides the metadata-enabled "
                    "plan path; set use_scheduler_metadata=True or "
                    "prefill_mode='loop'")
        self.prefill_mode = mode
        if scfg.kv_quant is not None and scfg.kv_quant not in QUANT_DTYPES:
            raise ValueError(f"unknown kv_quant {scfg.kv_quant!r}; "
                             f"known: {sorted(QUANT_DTYPES)}")
        # the cache's storage dtype (a KV_DTYPES name); kv_quant wins
        self.kv_dtype = scfg.kv_quant or scfg.kv_cache_dtype
        # KV bytes one shared prompt row saves (K and V over the layers,
        # at the storage dtype; MLA at one KV head, as the reference
        # counts it): the prefix-shared-bytes counter
        kvh = 1 if self.cfg.mla else self.cfg.num_kv_heads
        self._kv_row_bytes = (2 * self.cfg.num_layers * kvh
                              * self.cfg.resolved_head_dim
                              * KV_DTYPES.get(self.kv_dtype, 2))

        layout = scfg.cache_layout
        if layout == "paged":
            if not self.use_metadata:
                raise ValueError(
                    "the paged cache layout rides the metadata-enabled "
                    "plan path (views are gathered per resident-length "
                    "bucket); set use_scheduler_metadata=True or "
                    "cache_layout='dense'")
            for width in (scfg.seqlen_bucket,
                          scfg.prefill_bucket or scfg.seqlen_bucket):
                if width % scfg.cache_page_size:
                    raise ValueError(
                        f"cache_page_size ({scfg.cache_page_size}) must "
                        f"divide the plan bucket widths (got {width})")
        if self.seq_shards > 1:
            # the sharded decode cuts the cache's L dim: max_len (dense),
            # the gathered view, a page multiple (paged)
            if layout == "paged":
                if scfg.cache_page_size % self.seq_shards:
                    raise ValueError(
                        f"cache_page_size ({scfg.cache_page_size}) must "
                        f"divide over the model axis ({self.seq_shards}) "
                        "for sequence-sharded paged decode")
            elif max_len % self.seq_shards:
                raise ValueError(
                    f"max_len ({max_len}) must divide over the model axis "
                    f"({self.seq_shards}) for sequence-sharded decode")
        self.share_prefix = scfg.share_prefix
        if self.share_prefix:
            if layout != "paged":
                raise ValueError(
                    "share_prefix maps prompts onto existing pages; set "
                    "cache_layout='paged'")
            if self.prefill_mode != "fused":
                raise ValueError(
                    "prefix sharing admits through the fused prefill "
                    "path (suffix prefill is its restartable form); "
                    "prefill_mode='loop' cannot start from adopted pages")
            if not model.supports_prefix_sharing:
                raise ValueError(
                    f"{self.cfg.family} models cannot share prefix pages "
                    "(needs a uniform full-attention stack over the "
                    "standard k/v cache)")
        self._cache_kw = dict(kv_dtype=self.kv_dtype, layout=layout,
                              page_size=scfg.cache_page_size,
                              page_budget=scfg.cache_page_budget,
                              share_prefix=scfg.share_prefix,
                              prefix_capacity=scfg.prefix_capacity,
                              label=(f"shard{shard_id}"
                                     if shard_id is not None else ""))
        # residency bookkeeping and the layout; load() makes a fresh one
        # together with fresh storage
        self.cache = model.cache_manager(self.B, self.max_len,
                                         **self._cache_kw)

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
            kv_dtype=self.kv_dtype, table=self.tune_table,
            table_impl=tune_impl, mesh=self.mesh,
            seq_shards=self.seq_shards, plans=plan_cache)
        if self._table_registry_fallback:
            self.stats.table_registry_fallbacks += 1
            if self._obs.enabled:
                self._obs.on_warning(
                    "table_registry_fallback",
                    f"no table in {scfg.tune_table_path} matches the "
                    "live backend fingerprint; using the registry's "
                    "first table")
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
        # the sampler's per-slot rows, written at admission
        self._state = self.sampler.init_state(self.B)

        # engine-wide speculation default (a request's SamplingParams
        # wins); per-slot drafters and zero-accept streaks
        self._default_spec: Optional[SpecConfig] = None
        if scfg.speculation:
            self._default_spec = SpecConfig(
                method=scfg.speculation, k=scfg.speculation_k,
                max_rejects=scfg.speculation_max_rejects)
            self._check_speculation(self._default_spec, "ServeConfig")
        self._spec_cfg: List[Optional[SpecConfig]] = [None] * self.B
        self._drafters: List[Optional[Drafter]] = [None] * self.B
        self._spec_rejects = [0] * self.B
        self._next_handle = 0
        self._queues: Dict[int, Deque[Event]] = {}
        self._completions: Dict[int, Completion] = {}
        self._undrained: List[int] = []
        # once-per-engine warnings, one flag per capacity condition
        self._warned_len_capacity = False
        self._warned_page_capacity = False

    # --- observability ------------------------------------------------------

    @property
    def stats(self) -> PlanCacheStats:
        return self.sched.plans.stats

    @property
    def planner(self) -> Planner:
        return self.sched.planner

    def planned_splits(self) -> Dict[int, int]:
        """bucket -> frozen num_splits, for every resident decode plan."""
        return self.sched.planned_splits()

    def planned_prefill_buckets(self) -> List[int]:
        return self.sched.planned_prefill_buckets()

    def planned_suffix_buckets(self) -> List[Any]:
        return self.sched.planned_suffix_buckets()

    def cache_stats(self) -> Dict[str, Any]:
        """The cache manager's layout / residency / page-pool summary."""
        return self.cache.describe()

    # --- state --------------------------------------------------------------

    def load(self, params) -> None:
        """Bind weights and allocate fresh zeroed storage with fresh
        residency and page tables (a new session).  A shard keeps the
        weights on its lead device (a copy where they live elsewhere) and
        its dense storage sequence-sharded over its grid."""
        dev = next(params.parameters()).device
        if self.mesh is not None:
            params = self._place_params(params)
        elif dev.type != self.device.type:
            raise ValueError(f"params live on {dev}, engine on "
                             f"{self.device}")
        self._params = params
        self.cache = self.model.cache_manager(self.B, self.max_len,
                                              **self._cache_kw)
        self._caches = self.cache.init_storage()
        if self.seq_shards > 1 and not self.cache.is_paged:
            self._caches = {name: ops.SeqShards.place(
                t, self.mesh.rows[0], dim=2)
                for name, t in self._caches.items()}
        self._state = self.sampler.init_state(self.B)

    def _place_params(self, params):
        """Land the weights on the shard's grid, as the reference's
        ``_place_params``: tensor-parallel over the model axis under
        ``param_policy="tp"`` (:func:`repro_torch.sharding.place.
        place_params` by ``serve_param_rules``), else on the lead device:
        the same module when they are there already (a grid that repeats
        a device holds one copy), else a copy."""
        if self.param_policy == "tp":
            from repro_torch.sharding.place import place_params
            return place_params(params, self.mesh)
        if next(params.parameters()).device == self.device:
            return params
        copy = type(params)(self.cfg, self.device)
        copy.load_state_dict(params.state_dict())
        return copy

    # --- bound steps --------------------------------------------------------

    def _decode_impl(self, token: torch.Tensor, t: torch.Tensor,
                     plan: LaunchPlan, num_pages: int,
                     side_plans=None) -> torch.Tensor:
        """Lockstep decode over the resident bucket's view.  Paged: one
        gather per cache tensor that pages (every layer at once), the
        planned step on the view, then only the page holding each slot's
        new row goes back.  Dense: the storage is the view and the step
        writes it.  ``side_plans`` are the launches over another length
        (:meth:`Scheduler.side_plans`)."""
        lay = self.cache.layout
        table = self.cache.table_device()
        t = lay.decode_positions(t, num_pages)
        view, joined = self._whole(
            lay.gather_view(self._caches, table, num_pages), plan)
        with activation_mesh(self.mesh):
            logits = self.model.decode_step(self._params, view, token, t,
                                            plan=plan, side_plans=side_plans)
        if joined:
            self._put_back(view)
        lay.write_token(self._caches, view, table, t, num_pages)
        return self.sampler.sample(logits, self._state, self._pos)

    def _whole(self, view, plan: LaunchPlan):
        """(``view``, False), or, where the dense storage is held in
        sequence chunks and ``plan`` does not run sequence-sharded (a
        verify plan, or a decode plan whose ``mesh_splits`` is 1), (the
        chunks joined on the lead device, True): :meth:`_put_back`
        returns the rows the step writes."""
        if plan.seq_shard_mesh is not None or not ops.seq_sharded(view):
            return view, False
        return {name: leaf.join(self.device)
                for name, leaf in view.items()}, True

    def _put_back(self, view) -> None:
        for name, leaf in self._caches.items():
            leaf.copy_(view[name])

    def _prefill_impl(self, tokens: torch.Tensor, slot: int, length: int,
                      plan: LaunchPlan, num_pages: int) -> int:
        """Fused single-slot prefill; the layout lands the rows."""
        with activation_mesh(self.mesh):
            logits, view = self.model.prefill_slot_view(
                self._params, tokens, length, caches=self._caches,
                slot=slot, plan=plan, kv_dtype=self.kv_dtype)
        self.cache.layout.write_slot(self._caches, view,
                                     self.cache.table_device(), slot,
                                     num_pages)
        return self._sample_row(logits, slot, length - 1)

    def _suffix_prefill_impl(self, tokens: torch.Tensor, slot: int,
                             start: int, length: int, plan: LaunchPlan,
                             num_pages: int) -> int:
        """Suffix-only prefill (prefix sharing): gather the slot's view,
        whose rows [0, start) arrived with adopted pages, compute only
        the unshared suffix against it, and scatter back the pages from
        the one holding row ``start`` on: the slot's own, since the
        boundary page was copied on adoption.  The adopted full pages,
        which other slots and the trie read, are not written."""
        lay = self.cache.layout
        table = self.cache.table_device()
        view = lay.slot_view(self._caches, table, slot, num_pages)
        with activation_mesh(self.mesh):
            logits = self.model.prefill_suffix_view(
                self._params, view, tokens, start, length, plan=plan,
                kv_dtype=self.kv_dtype)
        lay.write_slot(self._caches, view, table, slot, num_pages,
                       first_page=start // self.cache.spec.page_size)
        return self._sample_row(logits, slot, length - 1)

    def _sample_row(self, logits: torch.Tensor, slot: int, pos: int) -> int:
        """Sample one slot's token from its logits (vocab,) at ``pos``."""
        state = {name: a[slot:slot + 1] for name, a in self._state.items()}
        return int(self.sampler.sample(logits[None], state, [pos])[0])

    def _verify_impl(self, tokens: torch.Tensor, t: torch.Tensor,
                     dlen: torch.Tensor, plan: LaunchPlan, num_pages: int):
        """Speculative verify over the resident bucket's view: score the
        (B, M = K + 1) token rows in one planned pass and accept or
        reject them as a batch.  ``dlen`` (B,) is each slot's true draft
        count: the sampler sees the rows past it as padding, and
        ``accepted`` is clamped by it, so padding rows never commit.
        Paged: only the pages overlapping each slot's accepted rows [t, t
        + accepted + 1) go back to storage; the rest of the span goes to
        the trash page.  Dense: the step wrote the storage, and the host
        rolls ``kv_len`` back over the rejected rows."""
        lay = self.cache.layout
        table = self.cache.table_device()
        view, joined = self._whole(
            lay.gather_view(self._caches, table, num_pages), plan)
        with activation_mesh(self.mesh):
            logits = self.model.verify_step(self._params, view, tokens, t,
                                            plan=plan)
        if joined:
            self._put_back(view)
        row = torch.arange(tokens.shape[1] - 1, device=tokens.device)
        draft = torch.where(row < dlen[:, None], tokens[:, 1:], -1)
        toks, acc = self.sampler.verify(logits, draft, self._state,
                                        self._pos)
        acc = torch.minimum(acc, dlen)
        lay.write_rows(self._caches, view, table, t, acc + 1,
                       tokens.shape[1], num_pages)
        return toks, acc

    def _build(self, impl, plan: LaunchPlan, **kw):
        # plan.bucket spans the whole view: the resident length for
        # decode, the prompt for prefill and suffix prefill.  The step
        # takes the engine as its first argument, so a PlanCache shared
        # by same-topology engines serves each of them its own storage.
        return functools.partial(impl.__func__, plan=plan,
                                 num_pages=self.cache.spec.view_pages(
                                     plan.bucket), **kw)

    def _build_decode(self, plan: LaunchPlan):
        """A decode step bound to its plan and to the side plans, which
        are resolved here, once, never inside a step."""
        return self._build(self._decode_impl, plan,
                           side_plans=self.sched.side_plans())

    def _apply_copies(self) -> None:
        """Apply the cache manager's queued (src, dst) page copies.  Runs
        before any launch that could gather a copied-into page: until its
        copy lands, a page fresh from the free list holds garbage."""
        for src, dst in self.cache.drain_copies():
            self.cache.layout.copy_page(self._caches, src, dst)

    # --- request lifecycle --------------------------------------------------

    def _check_speculation(self, spec: SpecConfig, who: str) -> None:
        """The submit-time and engine-default speculation gate: the
        drafter name must resolve, the model must support verify steps,
        and verify launches are planned, so they need the metadata
        path."""
        try:
            get_drafter(spec.method)
        except KeyError as e:
            raise ValueError(f"{who}: {e.args[0]}") from None
        if not self.model.supports_speculation:
            raise ValueError(
                f"{who}: {self.cfg.family} models cannot run speculative "
                "verify steps (needs a uniform full-attention stack over "
                "the standard k/v cache; see Model.supports_speculation)")
        if not self.use_metadata:
            raise ValueError(
                f"{who}: speculative decoding rides the metadata-enabled "
                "plan path (verify launches are planned under "
                "('verify', k, bucket) keys); set "
                "use_scheduler_metadata=True or drop the speculation knob")

    def validate(self, req: Request) -> None:
        """Raise on requests that could never run (no state mutated)."""
        self.sched.validate(req)
        self.sampler.check(req.sampling)
        spec = req.sampling.speculation or self._default_spec
        if spec is not None:
            self._check_speculation(spec, f"request {req.request_id}")
        if self.cache.is_paged:
            # +1: the request must also fit its first decode row, or a
            # prompt whose pages fill the pool would admit and then wait
            # forever on a page no finish can free
            need = self.cache.pages_for(len(req.prompt) + 1)
            limit = self.cache.max_request_pages()
            if need > limit:
                raise ValueError(
                    f"request {req.request_id}: prompt plus its first "
                    f"decode row needs {need} pages, page budget allows "
                    f"{limit} per request "
                    f"(page_size={self.cache.spec.page_size})")

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
        if self._obs.enabled:
            self._obs.on_submit(handle, req.request_id, len(req.prompt))
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
            adm = self.sched.admit_next(self._admissible)
            if adm is None:
                break
            self._admit(*adm, events)
        live = self.sched.live()
        if live:
            self._decode_launch(live, events)
        if self._obs.enabled:
            occ, slots = self.sched.occupancy()
            kw = (dict(free_pages=self.cache.free_pages,
                       total_pages=self.cache.spec.total_pages)
                  if self.cache.is_paged else {})
            self._obs.sample_occupancy(occ, slots,
                                       self.sched.queue_depth(), **kw)
        return events

    def _admissible(self, st: SlotState) -> bool:
        """Page-budget admission gate (dense always admits): the queue
        head needs its whole prompt's pages free; under prefix sharing,
        only those its shared prefix does not already cover."""
        if self.share_prefix:
            return self.cache.can_admit(st.request.prompt)
        return self.cache.can_reserve(len(st.request.prompt))

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
        :class:`Completion`, sorted by request_id, and releases them.
        With ``ServeConfig.stats_path`` set, the stats snapshot is written
        there (:meth:`dump_stats`); with ``trace_path`` / ``metrics_path``
        set, the observability artifacts (:meth:`dump_obs`)."""
        while self.sched.has_work():
            self.step()
        done = [self._completions.pop(h) for h in self._undrained]
        for h in self._undrained:
            self._queues.pop(h, None)
        self._undrained = []
        done.sort(key=lambda c: c.request_id)
        if self._stats_path:
            self.dump_stats(self._stats_path)
        if self._owns_obs:
            self.dump_obs()
        return done

    def stats_snapshot(self) -> Dict[str, Any]:
        """``PlanCacheStats.to_json()`` plus the engine's policy, its shard
        index in a sharded topology and, with a table, its version."""
        snap = self.stats.to_json()
        if self.shard_id is not None:
            snap["shard"] = self.shard_id
        snap["policy"] = self.policy
        if self.tune_table is not None:
            snap["table_version"] = self.tune_table.version
        return snap

    def dump_stats(self, path) -> None:
        """Write :meth:`stats_snapshot` as JSON, atomically: a temp file
        in the target directory, then ``os.replace``."""
        atomic_write_json(path, self.stats_snapshot())

    def dump_obs(self) -> None:
        """Write the trace and metrics artifacts the engine's own
        ``ServeConfig`` paths ask for, the metrics with
        :meth:`stats_snapshot` as their ``plan_cache`` section (nothing
        when neither path is set or the observer is disabled)."""
        if self._obs.enabled and (self._trace_path or self._metrics_path):
            self._obs.dump(self._trace_path, self._metrics_path,
                           plan_stats=self.stats_snapshot())

    # --- internals ----------------------------------------------------------

    def _admit(self, i: int, st: SlotState, events: List[Event]) -> None:
        if self._obs.enabled:           # closes the queue_wait span
            self._obs.on_admit_start(st.handle)
        # the whole prompt's pages are reserved up front (all-or-nothing;
        # _admissible already checked the free list, so this cannot fail)
        prompt = st.request.prompt
        if self.share_prefix:
            shared = self.cache.admit_prompt(i, prompt)
            if shared is None:
                raise RuntimeError("admission raced the page free list")
        else:
            if not self.cache.reserve(i, len(prompt)):
                raise RuntimeError("admission raced the page free list")
            shared = 0
        for name, value in self.sampler.slot_state(
                st.request.sampling).items():
            self._state[name][i] = value
        spec = st.request.sampling.speculation or self._default_spec
        self._spec_cfg[i] = spec
        self._drafters[i] = get_drafter(spec.method)() if spec else None
        self._spec_rejects[i] = 0
        # the slot is reset when admission leaves any of its rows
        # unwritten: always for the loop, which teacher-forces the prompt
        # through decode steps, and for fused prefill when the model says
        # so (encdec's cross cache), as the reference does
        if (self.prefill_mode != "fused"
                or not self.model.prefill_writes_full_slot):
            self.cache.layout.zero_slot(self._caches, i)
        if self.prefill_mode == "fused":
            self._admit_fused(i, st, events, shared)
            return
        st.prompt_left = list(prompt)
        self._pos[i] = 0
        self._next_token[i] = st.prompt_left.pop(0)
        if self._obs.enabled:
            self._obs.on_admit_end(st.handle, "loop")

    def _admit_fused(self, i: int, st: SlotState, events: List[Event],
                     shared: int = 0) -> None:
        """Prefill the prompt in one planned launch; the slot joins the
        decode lockstep holding its first token.  With ``shared`` > 0
        (prefix sharing) the launch is the suffix-only one: rows [0,
        shared) came with the adopted pages, and it counts under an
        ``("sprefill", ...)`` key, never ``("prefill", ...)``."""
        prompt = st.request.prompt
        n = len(prompt)
        if shared:
            # adopted boundary rows travel by page copy: land them before
            # the suffix launch gathers the slot's view
            self._apply_copies()
            entry = self.sched.suffix_prefill_entry(
                n - shared, n,
                functools.partial(self._build, self._suffix_prefill_impl))
            toks = np.zeros(entry.key[2], np.int64)
            toks[:n - shared] = prompt[shared:]
            args = (torch.from_numpy(toks).to(self.device), i, shared, n)
        else:
            entry = self.sched.prefill_entry(
                n, functools.partial(self._build, self._prefill_impl))
            toks = np.zeros(entry.key[1], np.int64)
            toks[:n] = prompt
            args = (torch.from_numpy(toks).to(self.device), i, n)
        t0 = self._obs.now_us() if self._obs.enabled else 0
        tok = entry.step(self, *args)   # its host int waits for the launch
        if self._obs.enabled:
            self._obs.on_launch("sprefill" if shared else "prefill",
                                entry.key, entry.plan, t0)
        self.cache.note_write(i, n - 1)
        if self.share_prefix:
            # index the now-resident full pages so the next request that
            # shares the prefix adopts them
            self.cache.register_prefix(i, prompt)
        self._pos[i] = n
        st.completion.steps += 1
        if self._obs.enabled:
            # the admit span closes before the first token, which may
            # finish the request, whose span must contain it
            self._obs.on_admit_end(st.handle,
                                   "suffix" if shared else "full",
                                   shared, shared * self._kv_row_bytes)
        self._emit_token(i, st, tok, events)

    def _decode_launch(self, live, events: List[Event]) -> None:
        drafts = self._collect_drafts(live)
        if drafts:
            self._verify_launch(live, drafts, events)
        else:
            self._plain_launch(live, events)

    def _plain_launch(self, live, events: List[Event]) -> None:
        # every live slot is about to write row _pos[i]: allocate its
        # page now (paged), and finish (only) the requests whose page the
        # pool cannot cover.  A finish releases pages, so a later slot may
        # succeed because an earlier one was culled.
        for i, st in live:
            if not self.cache.ensure(i, int(self._pos[i])):
                self._finish_capacity(i, st, events)
        live = self.sched.live()
        if not live:
            return
        # ensure() may have copy-on-written a shared page; its contents
        # must land before this launch's gather
        self._apply_copies()
        for i, _ in live:
            self.cache.note_write(i, int(self._pos[i]))
        tok = torch.from_numpy(self._next_token).to(self.device)
        t = torch.from_numpy(self._pos).to(self.device)
        t_max = max(int(self._pos[i]) for i, _ in live)
        if self.use_metadata:
            entry = self.sched.decode_entry(t_max, self._build_decode)
            step = functools.partial(entry.step, self)
        else:
            # dense only (paged needs the metadata path): the whole cache
            entry = None
            step = functools.partial(self._decode_impl,
                                     plan=self._fallback_plan,
                                     num_pages=self.cache.spec.slot_pages)
            self.stats.record_fallback(t_max + 1, self.max_len)
        t0 = self._obs.now_us() if self._obs.enabled else 0
        out = step(tok, t).cpu().numpy()    # host copy waits for the launch
        if self._obs.enabled:
            self._obs.on_launch(
                "decode", entry.key if entry is not None else None,
                entry.plan if entry is not None else None, t0,
                handles=[s.handle for _, s in live])
        for i, st in live:
            self._advance(i, st, int(out[i]), events)

    # --- speculative verify launch ------------------------------------------

    def _collect_drafts(self, live) -> Dict[int, List[int]]:
        """Ask each speculating slot's drafter for draft tokens.  Only
        slots past their prompt, still speculating and with budget left
        draft; the others ride the launch as 1-token rows.  Returns only
        non-empty drafts: an empty dict makes this step a plain decode
        launch."""
        drafts: Dict[int, List[int]] = {}
        for i, st in live:
            spec, drafter = self._spec_cfg[i], self._drafters[i]
            if spec is None or drafter is None or st.prompt_left:
                continue
            # a draft row past the request's remaining budget could never
            # emit.  The cache-wall bound is one stricter than decode's
            # (max_len - 2): the whole accepted run must land below the
            # capacity-finish position, or a multi-token emit would hit
            # the wall after fewer tokens than sequential decode
            budget = st.request.max_new_tokens \
                - len(st.completion.tokens) - 1
            room = self.max_len - 2 - int(self._pos[i])
            k = min(spec.k, budget, room)
            if k < 1:
                continue
            history = st.completion.prompt + st.completion.tokens
            d = list(drafter.propose(history, k))[:k]
            if d:
                drafts[i] = d
        return drafts

    def _verify_launch(self, live, drafts: Dict[int, List[int]],
                       events: List[Event]) -> None:
        """One planned verify launch: every live slot rides (lockstep),
        speculating slots carry their drafts, the rest take 1-token rows
        (``dlen = 0``, a decode row in effect)."""
        # each slot writes rows [pos, pos + dlen]: make row pos writable
        # as decode does (failure finishes the request), then the draft
        # rows page by page, cutting the draft at the first row the pool
        # cannot cover (speculation must not take a page a plain decode
        # step would have had)
        for i, st in live:
            p = int(self._pos[i])
            if not self.cache.ensure(i, p):
                drafts.pop(i, None)
                self._finish_capacity(i, st, events)
                continue
            d = drafts.get(i)
            if not d:
                continue
            kept = 0
            while kept < len(d) and self.cache.ensure(i, p + kept + 1):
                kept += 1
            drafts[i] = d[:kept]
        live = self.sched.live()
        if not live:
            return
        # ensure() may have copy-on-written a shared page
        self._apply_copies()
        K = max(len(drafts.get(i, [])) for i, _ in live)
        if K == 0:                      # every draft cut: a plain step
            self._plain_launch(live, events)
            return
        toks = np.zeros((self.B, K + 1), np.int64)
        dlen = np.zeros(self.B, np.int64)
        toks[:, 0] = self._next_token
        t_max = 0
        for i, _ in live:
            d = drafts.get(i, [])
            dlen[i] = len(d)
            toks[i, 1:1 + len(d)] = d
            self.cache.note_write(i, int(self._pos[i]) + len(d))
            t_max = max(t_max, int(self._pos[i]) + len(d))
        entry = self.sched.verify_entry(
            K, t_max, functools.partial(self._build, self._verify_impl))
        dev = self.device
        args = (torch.from_numpy(toks).to(dev),
                torch.from_numpy(self._pos).to(dev),
                torch.from_numpy(dlen).to(dev))
        t0 = self._obs.now_us() if self._obs.enabled else 0
        out, acc = entry.step(self, *args)
        out, acc = out.cpu().numpy(), acc.cpu().numpy()
        if self._obs.enabled:
            self._obs.on_launch("verify", entry.key, entry.plan, t0,
                                handles=[s.handle for _, s in live])
        for i, st in live:
            self._advance_verified(i, st, drafts.get(i, []), int(acc[i]),
                                   out[i], events)

    def _advance_verified(self, i: int, st: SlotState, d: List[int],
                          a: int, row: np.ndarray,
                          events: List[Event]) -> None:
        """After a verify launch, for one slot: commit the accepted
        positions, emit ``d[:a]`` and the correction or bonus token, roll
        ``kv_len`` back over the rejected rows, and count acceptance and
        the ``max_rejects`` streak."""
        st.completion.steps += 1
        if st.prompt_left:              # loop-mode prefill rider
            self._pos[i] += 1
            self._next_token[i] = st.prompt_left.pop(0)
            return
        self._pos[i] += a + 1
        self.cache.truncate(i, int(self._pos[i]))
        emitted = 0
        for tok in d[:a] + [int(row[a])]:
            self._emit_token(i, st, tok, events)
            emitted += 1
            if st.completion.finish_reason is not None:
                break
        if not d:                       # a non-speculating rider
            return
        spec = self._spec_cfg[i]
        self.stats.record_spec_step(len(d), a, emitted)
        drafter = self._drafters[i]
        if drafter is not None:
            drafter.observe(a, len(d))
        if a == 0:
            self._spec_rejects[i] += 1
            if spec is not None and spec.max_rejects is not None \
                    and self._spec_rejects[i] >= spec.max_rejects:
                # this request's traffic does not draft well: stop paying
                # for verify rows it keeps rejecting
                self._spec_cfg[i] = None
                self._drafters[i] = None
                self.stats.record_spec_disabled()
        else:
            self._spec_rejects[i] = 0

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
        """Stamp the reason, emit FINISHED to the step's events and the
        handle's queue, release the slot and its cache residency (its
        table row goes back to the trash page)."""
        comp = st.completion
        comp.finish_reason = reason
        fin = Event(FINISHED, st.handle, comp.request_id,
                    finish_reason=reason)
        events.append(fin)
        self._queues[st.handle].append(fin)
        self.sched.finish(i)
        self.cache.release(i)
        if self._obs.enabled:
            self._obs.on_finish(st.handle, reason)

    def _finish_capacity(self, i: int, st: SlotState,
                         events: List[Event]) -> None:
        """Finish one request on page-pool exhaustion, before the launch:
        no token is produced this step, since its K/V row has nowhere to
        go.  The rest of the batch keeps decoding."""
        if not self._warned_page_capacity:
            self._warned_page_capacity = True
            warnings.warn(
                f"request {st.request.request_id} exhausted the KV page "
                f"pool ({self.cache.spec.total_pages} pages of "
                f"{self.cache.spec.page_size}) mid-generation; finishing "
                "with finish_reason='cache_capacity' (further page "
                "exhaustions on this engine are silent)",
                RuntimeWarning, stacklevel=3)
            if self._obs.enabled:
                self._obs.on_warning(
                    "page_capacity",
                    f"request {st.request.request_id} exhausted the "
                    f"{self.cache.spec.total_pages}-page KV pool")
        self._finish(i, st, FINISH_CACHE_CAPACITY, events)

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
                if self._obs.enabled:
                    self._obs.on_warning(
                        "len_capacity",
                        f"request {req.request_id} hit the KV cache "
                        f"capacity (max_len={self.max_len})")
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
        if self._obs.enabled:
            self._obs.on_token(st.handle, ev.index)
        reason = self._finish_reason(i, st, token)
        if reason is not None:
            self._finish(i, st, reason, events)
        else:
            self._next_token[i] = token


class DecodeEngine:
    """Batch-synchronous facade: ``generate(requests)``.

    A thin wrapper over :class:`ServingEngine` pinned to loop admission
    (teacher-forcing the prompt through decode steps) and
    :class:`~repro_torch.serving.sampling.GreedySampler` (argmax, no vocab
    sort), as the reference's; :meth:`generate` validates every request
    before it submits any, so a bad request fails fast instead of
    aborting the batch mid-flight.
    """

    def __init__(self, model: Model, scfg: ServeConfig, *,
                 max_len: int = 256, batch_slots: int = 4,
                 policy: Optional[str] = None,
                 tune_table: Optional[Any] = None,
                 device: DeviceLike = None):
        self.engine = ServingEngine(model, scfg, max_len=max_len,
                                    batch_slots=batch_slots, policy=policy,
                                    prefill_mode="loop",
                                    sampler=GreedySampler(),
                                    tune_table=tune_table, device=device)
        self.planner = self.engine.planner

    @property
    def stats(self) -> PlanCacheStats:
        return self.engine.stats

    def load(self, params) -> None:
        self.engine.load(params)

    def planned_splits(self) -> Dict[int, int]:
        return self.engine.planned_splits()

    def generate(self, requests: Sequence[Request]) -> List[Completion]:
        for req in requests:
            self.engine.validate(req)
        for req in requests:
            self.engine.submit(req)
        return self.engine.drain()

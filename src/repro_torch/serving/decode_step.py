"""Frozen mesh step builders: one planned decode (or prefill) step over a
device grid.

Counterpart of ``repro.serving.decode_step``, the paper's decision
lifted to a device grid (:class:`~repro_torch.launch.mesh.EngineMesh`,
axes ``("data", "model")``).  The batch rides the ``data`` rows; the
``model`` axis is where starvation lives:

- head-sharded KV (the ``fa3_baseline`` analogue): each device holds its
  KV heads' cache and launches the decode kernel over them, so the
  axis's parallelism is H_KV: a model with fewer KV heads than devices
  cannot use them all, and at B 1 each device runs one CTA;
- sequence-sharded KV (the sequence-aware path): each device holds one
  chunk of the cache's rows and launches the decode kernel's partials
  over it, merged by the combine kernel (the LSE algebra of split-KV,
  with devices in place of SMs).

:func:`build_mesh_decode_step` freezes one
:class:`~repro_torch.plan.LaunchPlan` through the mesh
:class:`~repro_torch.plan.Planner` (:func:`~repro_torch.launch.mesh.
planner_for_mesh`), lays the cache out by its ``mesh_splits`` decision
(``cache_rules``), places the weights tensor-parallel
(``serve_param_rules``, :func:`~repro_torch.sharding.place.place_params`)
and pins the plan into the step through :func:`~repro_torch.plan.
plan_scope`.  ``decode_impl="auto"`` keeps the sequence-sharded cache
but runs one launch on the lead device over the chunks joined there,
its split rounded up to a multiple of the axis (``min_splits``): what the
reference's GSPMD partitioning does with its all-gathered cache.

A single controller runs the grid: row ``d`` runs its B / dp batch rows
on its own devices, its weights placed over its own ``(1, sp)`` grid
(where the reference's expert stacks also spread over the data axis,
here each row holds its own), and every non-attention op runs on the
row's lead device.  Tensor-parallel decode covers the families whose
decode can sequence-shard (dense, moe, mla); at a model axis of 1 every
family runs.

The builder is the frozen, single-launch form (one shape, one plan); the
request-lifecycle form is :class:`repro_torch.shard.ShardedServingEngine`,
which supersedes the old ``build_serve_step`` name (a warn-once shim).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ServeConfig, ShapeConfig
from repro_torch.core.split_policy import DecodeWorkload
from repro_torch.kernels import ops
from repro_torch.launch.mesh import EngineMesh, planner_for_mesh
from repro_torch.models.registry import Model
from repro_torch.plan import AttentionSpec, LaunchPlan, plan_scope
from repro_torch.sharding.ctx import activation_mesh
from repro_torch.sharding.place import param_specs, place_params
from repro_torch.sharding.rules import (
    batch_spec,
    cache_rules,
    serve_param_rules,  # noqa: F401  (the reference re-exports it here)
    spec_for,
    tree_specs,
)

TP_FAMILIES = ("dense", "moe", "mla")


def effective_kv_heads(cfg: ModelConfig) -> int:
    """H_KV as the decode workload sees it (MLA: one shared latent)."""
    if cfg.mla is not None:
        return 1
    return cfg.num_kv_heads


def attention_spec(cfg: ModelConfig, shape: ShapeConfig) -> AttentionSpec:
    """The per-replica decode launch spec of one (arch, shape) cell."""
    return AttentionSpec.decode(
        1,                                    # per-replica view of the axis
        shape.seq_len,
        cfg.num_heads,
        effective_kv_heads(cfg),
        cfg.resolved_head_dim,
        window=cfg.hybrid.window if cfg.family == "hybrid" else None,
        v_width=cfg.mla.kv_lora_rank if cfg.mla is not None else None,
    )


def decode_workload(cfg: ModelConfig, shape: ShapeConfig) -> DecodeWorkload:
    return attention_spec(cfg, shape).workload()


def mesh_launch_plan(cfg: ModelConfig, shape: ShapeConfig, mesh: EngineMesh,
                     policy: str) -> Optional[LaunchPlan]:
    """The mesh-level launch plan, frozen once at build time: the mesh
    planner's split decision for the (arch, shape) cell, which both the
    cache layout (``mesh_splits``) and the decode ops (the plan scope)
    read.  None for attention-free families."""
    if cfg.family == "ssm":
        return None
    return planner_for_mesh(mesh, policy=policy).mesh_plan(
        attention_spec(cfg, shape), axis_size=mesh.shape["model"],
        axis="model")


def mesh_plan(cfg: ModelConfig, shape: ShapeConfig, mesh: EngineMesh,
              policy: str) -> Tuple[Optional[LaunchPlan], int]:
    """Legacy surface: (frozen plan, sequence-shard ways)."""
    plan = mesh_launch_plan(cfg, shape, mesh, policy)
    return plan, (plan.mesh_splits if plan is not None else 1)


def mesh_split_decision(cfg: ModelConfig, shape: ShapeConfig,
                        mesh: EngineMesh, policy: str) -> int:
    """How many ways the model axis sequence-shards the KV cache (1 =
    off)."""
    return mesh_plan(cfg, shape, mesh, policy)[1]


# ---------------------------------------------------------------------------
# placement over the grid's rows
# ---------------------------------------------------------------------------


def _check_family(model: Model, mesh: EngineMesh) -> None:
    if mesh.shape["model"] > 1 and model.cfg.family not in TP_FAMILIES:
        raise ValueError(
            f"tensor-parallel decode over a model axis of "
            f"{mesh.shape['model']} runs the {TP_FAMILIES} families, not "
            f"{model.cfg.family}; use a model axis of 1")


@dataclass
class _Placement:
    """How a bundle lays its weights and caches over the grid."""
    mesh: EngineMesh
    batch: int
    seq_split: bool
    kv_dtype: str

    @property
    def rows(self) -> List[int]:
        """The grid rows that run the batch: every row when their count
        divides it (each its B / dp rows), else the first row alone, the
        batch being replicated."""
        dp = self.mesh.shape["data"]
        return list(range(dp)) if self.batch % dp == 0 else [0]

    def params(self, model: Model, params) -> List[Any]:
        """One placed tree (or module) a row, over the row's grid."""
        return [place_params(params, self.mesh.sub(d)) for d in self.rows]

    def caches(self, model: Model, dense: Dict[str, torch.Tensor]
               ) -> List[Dict[str, ops.CacheLeaf]]:
        """Dense caches (layers, B, L, ...) cut into each row's batch rows
        and laid out over its devices by ``cache_rules``: a leaf whose
        spec cuts the sequence is held in :class:`~repro_torch.kernels.
        ops.SeqShards`, one whose spec cuts the KV heads in
        :class:`~repro_torch.kernels.ops.HeadShards`, any other whole on
        the row's lead device."""
        rows = self.rows
        b = self.batch // len(rows)
        rules = cache_rules(self.seq_split)
        axes = model.cache_axes(b, 1, self.kv_dtype)
        out = []
        for d in rows:
            sub = self.mesh.sub(d)
            devices = sub.rows[0]
            row = {}
            for name, leaf in dense.items():
                part = leaf[:, d * b:(d + 1) * b] \
                    if len(rows) > 1 else leaf
                spec = spec_for(tuple(part.shape), axes[name], rules, sub)
                cut = _model_dim(spec) if len(devices) > 1 else None
                if cut == 2:
                    row[name] = ops.SeqShards.place(part, devices, dim=2)
                elif cut == 3:
                    row[name] = ops.HeadShards.place(part, devices, dim=3)
                else:
                    row[name] = part.to(devices[0])
            out.append(row)
        return out


def _model_dim(spec: tuple) -> Optional[int]:
    """The dim a spec gives the ``model`` axis, or None."""
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if "model" in axes:
            return dim
    return None


def join_caches(placed: List[Dict[str, ops.CacheLeaf]],
                device: torch.device) -> Dict[str, torch.Tensor]:
    """A bundle's placed caches as dense tensors (layers, B, L, ...) on
    ``device``: each row's leaves joined, the rows concatenated."""
    names = list(placed[0])
    out = {}
    for name in names:
        parts = [row[name].join(device)
                 if isinstance(row[name], ops.Shards)
                 else row[name].to(device) for row in placed]
        out[name] = torch.cat(parts, dim=1)
    return out


def _meta_params(model: Model):
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import lm as lm_mod
    cls = encdec_mod.EncDec if model.cfg.family == "encdec" else lm_mod.LM
    return cls(model.cfg, torch.device("meta"))


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------


@dataclass
class ServeStepBundle:
    model: Model
    scfg: ServeConfig
    mesh: EngineMesh
    step: Callable
    param_shardings: Dict[str, tuple]     # specs over one row's grid
    cache_shardings: Dict[str, tuple]     # specs over the whole grid
    max_len: int
    mesh_splits: int                      # 1 = head-sharded path
    # the plan the step was specialized on (context-only on the
    # internal-heuristic path; None for attention-free families)
    plan: Optional[LaunchPlan] = None
    placement: Optional[_Placement] = None

    @property
    def metadata(self) -> Optional[LaunchPlan]:
        """Legacy name: the frozen plan (None when nothing is frozen)."""
        return self.plan if (self.plan is not None
                             and self.plan.frozen) else None

    def abstract_args(self):
        """(params, caches, token, t) as meta tensors: nothing
        allocated."""
        B = self.scfg.shape.global_batch
        kv = self.scfg.kv_quant or self.scfg.kv_cache_dtype
        caches = {name: torch.empty(shape, dtype=dt, device="meta")
                  for name, (shape, dt) in self.model.cache_shapes(
                      B, self.max_len, kv).items()}
        tok = torch.empty((B,), dtype=torch.int64, device="meta")
        t = torch.empty((), dtype=torch.int64, device="meta")
        return _meta_params(self.model), caches, tok, t

    def place_params(self, params) -> List[Any]:
        """``params`` placed for :attr:`step`: one tree a grid row."""
        return self.placement.params(self.model, params)

    def place_caches(self, dense: Dict[str, torch.Tensor]
                     ) -> List[Dict[str, ops.CacheLeaf]]:
        """Dense caches (layers, B, max_len, ...) laid out for
        :attr:`step`."""
        return self.placement.caches(self.model, dense)


def build_mesh_decode_step(model: Model, scfg: ServeConfig,
                           mesh: EngineMesh) -> ServeStepBundle:
    """The frozen decode step of ``scfg.shape`` over ``mesh``:
    ``bundle.step(params, caches, token, t) -> (next_tok, caches)``,
    greedy, every slot at position ``t``.  ``params`` is what
    :meth:`ServeStepBundle.place_params` returns (an unplaced module is
    placed on each call); ``caches`` what :meth:`ServeStepBundle.
    place_caches` returns (a dense dict is placed on each call), updated
    in place and returned."""
    cfg = model.cfg
    _check_family(model, mesh)
    B, L = scfg.shape.global_batch, scfg.shape.seq_len
    model_ax = mesh.shape["model"]
    # cache length padded so a whole-axis sequence shard divides evenly
    max_len = -(-L // model_ax) * model_ax
    kv = scfg.kv_quant or scfg.kv_cache_dtype

    plan = mesh_launch_plan(cfg, scfg.shape, mesh, scfg.split_policy)
    splits = plan.mesh_splits if plan is not None else 1
    if plan is not None and not scfg.use_scheduler_metadata:
        # internal-heuristic A/B path: drop the frozen decision, keep the
        # policy / num_cores overrides and the mesh realization
        plan = plan.context_only()
    seq_split = splits > 1
    placement = _Placement(mesh, B, seq_split, kv)

    pspecs = param_specs(_meta_params(model), mesh.sub(0))
    cshard = tree_specs(
        mesh, {name: shape for name, (shape, _) in
               model.cache_shapes(B, max_len, kv).items()},
        model.cache_axes(B, max_len, kv), cache_rules(seq_split))

    # the scope realizes the plan's mesh decision on each row: fused = a
    # partials launch a device over its sequence chunk + the combine
    # kernel; auto = one launch on the lead at a split rounded up to the
    # axis, over the chunks joined there
    use_fused = seq_split and scfg.decode_impl == "fused"
    base = plan if plan is not None else LaunchPlan(
        kind="decode", policy=scfg.split_policy, num_cores=model_ax)
    base = dataclasses.replace(base, min_splits=1 if use_fused else splits,
                               seq_shard_axis="model")
    scopes = [dataclasses.replace(
        base, seq_shard_mesh=mesh.sub(d) if use_fused else None)
        for d in range(mesh.shape["data"])]
    rows = placement.rows
    b = B // len(rows)

    def step(params, caches, token: torch.Tensor, t):
        if not isinstance(params, list):
            params = placement.params(model, params)
        if isinstance(caches, dict):
            caches = placement.caches(model, caches)
        out = []
        for r, d in enumerate(rows):
            scope, row = scopes[d], caches[r]
            tok = token[r * b:(r + 1) * b].to(mesh.rows[d][0])
            pos = torch.full((b,), int(t), dtype=torch.int64,
                             device=tok.device)
            joined = seq_split and not use_fused
            view = {name: leaf.join(tok.device) for name, leaf in
                    row.items()} if joined else row
            with plan_scope(scope), activation_mesh(mesh.sub(d)):
                logits = model.decode_step(params[r], view, tok, pos,
                                           plan=scope)
            if joined:
                for name, leaf in row.items():
                    leaf.copy_(view[name])
            out.append(logits.argmax(-1).to(token.device))
        return torch.cat(out), caches

    return ServeStepBundle(model, scfg, mesh, step, pspecs, cshard, max_len,
                           splits, scopes[0], placement)


_BUILD_SERVE_STEP_WARNED = False


def build_serve_step(model: Model, scfg: ServeConfig, mesh: EngineMesh
                     ) -> ServeStepBundle:
    """Deprecated name for :func:`build_mesh_decode_step` (warns once per
    process, then delegates).  Request-lifecycle serving on a grid is
    :class:`repro_torch.shard.ShardedServingEngine` (or a single-shard
    ``ServingEngine(mesh=...)``)."""
    global _BUILD_SERVE_STEP_WARNED
    if not _BUILD_SERVE_STEP_WARNED:
        _BUILD_SERVE_STEP_WARNED = True
        warnings.warn(
            "build_serve_step is deprecated: use build_mesh_decode_step "
            "(same frozen single-launch builder), or serve requests "
            "through repro_torch.shard.ShardedServingEngine / "
            "ServingEngine(mesh=...)",
            DeprecationWarning, stacklevel=2)
    return build_mesh_decode_step(model, scfg, mesh)


# ---------------------------------------------------------------------------
# the prefill step
# ---------------------------------------------------------------------------


@dataclass
class PrefillStepBundle:
    model: Model
    scfg: ServeConfig
    mesh: EngineMesh
    step: Callable
    param_shardings: Dict[str, tuple]
    cache_shardings: Dict[str, tuple]
    max_len: int
    batch_shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
    batch_shardings: Dict[str, tuple]
    plan: Optional[LaunchPlan] = None
    placement: Optional[_Placement] = None

    def abstract_args(self):
        """(params, batch) as meta tensors: nothing allocated."""
        batch = {name: torch.empty(shape, dtype=dt, device="meta")
                 for name, (shape, dt) in self.batch_shapes.items()}
        return _meta_params(self.model), batch

    def place_params(self, params) -> List[Any]:
        return self.placement.params(self.model, params)


def build_prefill_step(model: Model, scfg: ServeConfig, mesh: EngineMesh
                       ) -> PrefillStepBundle:
    """The prompt prefill step of ``scfg.shape`` over ``mesh``:
    ``bundle.step(params, batch) -> (next_tok, caches)``, the batch
    ``tokens`` (B, Lt) plus the model's ``frontend_inputs``.  Weights are
    tensor-parallel (no FSDP), and the caches come out laid out as
    :func:`build_mesh_decode_step` reads them, so prefill then decode
    needs no relayout.  Where the model axis does not divide the query
    heads, prefill attention runs sequence-parallel
    (:func:`repro_torch.kernels.ops._attention_seqpar`, the prefill
    kernel a chunk of query rows a device)."""
    cfg = model.cfg
    _check_family(model, mesh)
    B, L = scfg.shape.global_batch, scfg.shape.seq_len
    model_ax = mesh.shape["model"]
    max_len = -(-L // model_ax) * model_ax
    kv = scfg.kv_quant or scfg.kv_cache_dtype

    splits = mesh_split_decision(cfg, scfg.shape, mesh, scfg.split_policy)
    placement = _Placement(mesh, B, splits > 1, kv)
    pspecs = param_specs(_meta_params(model), mesh.sub(0))
    cshard = tree_specs(
        mesh, {name: shape for name, (shape, _) in
               model.cache_shapes(B, max_len, kv).items()},
        model.cache_axes(B, max_len, kv), cache_rules(splits > 1))

    Lt = model.text_len(L)
    bshapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {
        "tokens": ((B, Lt), torch.int64)}
    for k, (shp, dt) in model.frontend_inputs(B, L).items():
        bshapes[k] = (tuple(shp), getattr(torch, dt))
    bshard = {name: batch_spec(mesh) for name in bshapes}

    # prefill-kind plan: sequence-parallel attention where the heads do
    # not divide the model axis (minicpm3-4b's 40, whisper's 20)
    seqpar = cfg.num_heads % model_ax != 0
    scopes = [LaunchPlan(kind="prefill",
                         seq_shard_mesh=mesh.sub(d) if seqpar else None,
                         seq_shard_axis="model")
              for d in range(mesh.shape["data"])]
    rows = placement.rows
    b = B // len(rows)

    def step(params, batch: Dict[str, torch.Tensor]):
        if not isinstance(params, list):
            params = placement.params(model, params)
        toks, dense = [], []
        for r, d in enumerate(rows):
            lead = mesh.rows[d][0]
            part = {name: x[r * b:(r + 1) * b].to(lead)
                    for name, x in batch.items()}
            with activation_mesh(mesh.sub(d)), plan_scope(scopes[d]):
                logits, caches = model.prefill(params[r], part, max_len,
                                               kv_dtype=kv)
            toks.append(logits.argmax(-1).to(batch["tokens"].device))
            dense.append(caches)
        out = []
        for r, d in enumerate(rows):
            out.extend(_Placement(mesh.sub(d), b, splits > 1, kv).caches(
                model, dense[r]))
        return torch.cat(toks), out

    return PrefillStepBundle(model, scfg, mesh, step, pspecs, cshard,
                             max_len, bshapes, bshard, scopes[0], placement)

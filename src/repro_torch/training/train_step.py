"""The train step: loss, microbatch accumulation, AdamW, over a grid.

Counterpart of ``repro.training.train_step``.  ``build_train_step(model,
tcfg, mesh)`` returns a :class:`TrainStepBundle` whose ``step(params,
opt_state, batch)`` runs the forward (under the remat policy), the
backward (autograd; on the card attention's gradient is the prefill
backward kernel), microbatch accumulation and one in-place AdamW
update, and returns ``(params, opt_state, metrics)`` with the same
params and state objects, updated.

The reference's step is a ``jit`` over a ``(data, model)`` mesh.  On a
grid of one device the port's step runs the model's own module.  On a
larger grid (:class:`~repro_torch.launch.mesh.EngineMesh`, whose device
list may repeat a device) the weights and the AdamW moments are placed
by ``param_rules()`` (:func:`~repro_torch.sharding.place.place_trainable`:
a :class:`~repro_torch.sharding.place.MeshParams` of leaves, the moments
keyed like them), and the batch is cut over the data rows along its
batch dim.  Data row ``d`` runs the forward of its rows on its
:meth:`~repro_torch.sharding.place.MeshParams.view`, which reads each
weight gathered over the data axis and cut over the model axis, so the
ops that read a cut weight run one part a device of the row (tensor
parallelism, expert parallelism where the reference's ``ep_shard_map``
runs, attention a launch a device where the query and KV heads are both
cut).  Where the model axis does not divide the query heads, attention
runs sequence-parallel, each device of the row over its chunk of query
rows (``ops._attention_seqpar``), as the reference binds a prefill plan
whose ``seq_shard_mesh`` is the grid.  The loss is the global one: the
rows' summed negative log-likelihood over the batch's token count, and a
MoE model's load-balance loss taken over the whole batch (from the rows'
routing stats, or the average of the chunks' own where experts run in
parallel), so the gradient is the reference's.  The vlm, encdec, hybrid
and ssm families have no tensor-parallel forward in the port and refuse
a model axis above 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch.mesh import EngineMesh, make_host_mesh
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.registry import Model
from repro_torch.plan import LaunchPlan, plan_scope
from repro_torch.sharding.ctx import activation_mesh
from repro_torch.sharding.place import MeshParams, param_specs, \
    place_trainable
from repro_torch.sharding.rules import param_rules
from repro_torch.training import remat as remat_mod
from repro_torch.training.optimizer import adamw_init, adamw_update

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]

# the families whose forward runs over a model axis above 1 (the
# others have no tensor-parallel forward in the port)
TP_FAMILIES = ("dense", "moe", "mla")


def lm_loss(model: Model, params, batch: Batch, *,
            block_wrapper: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Metrics]:
    """Next-token cross entropy over the label positions: (the total
    loss, {"loss", "aux_loss", "tokens"}).  ``labels`` align with the
    LAST ``labels.shape[1]`` positions of the logits (vlm: the text tail
    after the patch prefix); ``label < 0`` masks a position out.  The
    total adds the MoE load-balance loss times its weight."""
    logits, stats = model.forward(params, batch,
                                  block_wrapper=block_wrapper)
    aux = moe_mod.balance_loss(stats)
    nll, tokens = _nll(logits, batch["labels"])
    loss = nll / torch.clamp(tokens, min=1.0)
    aux_w = model.cfg.moe.aux_loss_weight if model.cfg.moe else 0.0
    return loss + aux_w * aux, {"loss": loss, "aux_loss": aux,
                                "tokens": tokens}


def _nll(logits: torch.Tensor, labels: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the summed next-token negative log-likelihood, the count of
    unmasked label positions), both float32: :func:`lm_loss`'s two
    sums."""
    lg = logits[:, -labels.shape[1]:][:, :-1]          # (B, Lt - 1, V) f32
    tgt = labels[:, 1:].long()
    mask = (tgt >= 0).to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, tgt.clamp_min(0)[..., None])[..., 0]
    return ((logz - ll) * mask).sum(), mask.sum()


def make_batch_shapes(model: Model, shape: ShapeConfig
                      ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """A train cell's inputs: name -> (shape, dtype name)."""
    B, L = shape.global_batch, shape.seq_len
    Lt = model.text_len(L)
    return {"tokens": ((B, Lt), "int32"), "labels": ((B, Lt), "int32"),
            **model.frontend_inputs(B, L)}


def param_tree(params) -> Dict[str, torch.Tensor]:
    """The trainable tensors as a flat dict: a module's weights keyed by
    their ``state_dict`` names, or a :class:`MeshParams`'s leaves keyed
    by :func:`~repro_torch.sharding.place.leaf_key`."""
    if isinstance(params, MeshParams):
        return params.leaves
    return dict(params.named_parameters())


@dataclass
class TrainStepBundle:
    """``step(params, opt_state, batch)`` -> (params, opt_state, metrics),
    updated in place; ``grads(params, batch)`` -> (total loss, metrics,
    gradients keyed as :func:`param_tree`), the step's gradients without
    the update.  ``mesh`` is the grid (one device: the model's own
    module; more: a :class:`MeshParams`), ``param_specs`` each weight's
    spec over it and ``opt_specs`` the moments' (the reference's
    ``param_shardings`` / ``opt_shardings``; None on one device)."""
    model: Model
    tcfg: TrainConfig
    step: Callable
    grads: Callable
    batch_shapes: Dict[str, Tuple[Tuple[int, ...], str]]
    mesh: Optional[EngineMesh] = None
    param_specs: Optional[Dict[str, tuple]] = None

    @property
    def sharded(self) -> bool:
        """Whether the weights are a :class:`MeshParams` over the grid."""
        return self.param_specs is not None

    @property
    def opt_specs(self) -> Optional[Dict[str, object]]:
        if self.param_specs is None:
            return None
        return {"m": self.param_specs, "v": self.param_specs, "count": ()}

    @property
    def device(self) -> torch.device:
        """Where the batch goes and the metrics come back: the grid's
        lead device."""
        return self.mesh.lead if self.sharded else self.model.device

    def _module(self, seed: Optional[int]):
        cfg = self.model.cfg
        if seed is not None:
            return self.model.init_params(seed)
        cls = encdec_mod.EncDec if cfg.family == "encdec" else lm_mod.LM
        return cls(cfg, self.model.device)

    def _state(self, module):
        if self.sharded:
            params = place_trainable(module, self.mesh, param_rules())
        else:
            params = Model.trainable(module)
        return params, adamw_init(param_tree(params))

    def init(self, seed: int = 0):
        """(trainable weights from ``seed``, fresh AdamW state), placed
        on the grid."""
        return self._state(self._module(seed))

    def empty_state(self):
        """(trainable weights and AdamW state of the right shapes and
        dtypes, unfilled: what a checkpoint restores into)."""
        return self._state(self._module(None))

    def checkpoint_tree(self, params, opt) -> Dict[str, object]:
        """The dense, grid-agnostic tree a checkpoint holds: ``{"params":
        name -> weight, "opt": {"m", "v", "count"}}``, a sharded tree's
        leaves and moments joined."""
        if not self.sharded:
            return {"params": param_tree(params), "opt": opt}
        return {"params": params.state_dict(),
                "opt": {"m": params.join(opt["m"]),
                        "v": params.join(opt["v"]), "count": opt["count"]}}

    @torch.no_grad()
    def load_checkpoint_tree(self, params, opt, tree) -> None:
        """Copy a dense :meth:`checkpoint_tree` into ``params`` and
        ``opt`` in place, cut onto this bundle's grid."""
        if not self.sharded:
            for n, t in param_tree(params).items():
                t.copy_(tree["params"][n])
            for k in ("m", "v"):
                for n, t in opt[k].items():
                    t.copy_(tree["opt"][k][n])
        else:
            params.load_dense(tree["params"])
            for k in ("m", "v"):
                for n, t in params.cut(tree["opt"][k]).items():
                    opt[k][n].copy_(t)
        opt["count"].copy_(tree["opt"]["count"])

    def to_device(self, batch) -> Batch:
        """A host batch (numpy or tensors) on the grid's lead device:
        token ids as int64, other inputs in the model's activation
        dtype."""
        act = getattr(torch, self.model.cfg.dtype)
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            t = t.long() if k in ("tokens", "labels") else t.to(act)
            out[k] = t.to(self.device)
        return out


def _resolve_mesh(model: Model, mesh: Optional[EngineMesh],
                  model_axis: int) -> EngineMesh:
    """The step's grid: ``mesh``, else :func:`make_host_mesh` of
    ``model_axis`` over the visible CUDA devices for a model on the
    card, over the model's device otherwise."""
    if mesh is not None:
        return mesh
    return make_host_mesh(model_axis, None if model.device.type == "cuda"
                          else [model.device])


def _bound(fn: Callable, mesh: EngineMesh, plan: LaunchPlan) -> Callable:
    """``fn`` run with ``mesh`` bound as the activation mesh and ``plan``
    as the ambient prefill plan.  A remat wrapper runs the body again in
    the backward pass, where the forward's bindings are gone (on the
    card autograd runs it on a thread of its own), so each layer body
    binds them itself."""
    def run(*args):
        with activation_mesh(mesh), plan_scope(plan):
            return fn(*args)
    return run


def build_train_step(model: Model, tcfg: TrainConfig,
                     mesh: Optional[EngineMesh] = None, *,
                     model_axis: int = 1) -> TrainStepBundle:
    """The train step of ``tcfg`` over ``mesh`` (None: the grid of
    ``model_axis``, see :func:`_resolve_mesh`): remat
    by ``tcfg.remat_policy``, ``tcfg.microbatches`` microbatches summed
    in float32, scaled by 1 / micro and cast to the weights' dtypes,
    then AdamW.  A grid of one device trains the model's module; a
    larger one a :class:`MeshParams` (see the module docstring).  A
    model axis above 1 raises for a family outside
    :data:`TP_FAMILIES`."""
    mesh = _resolve_mesh(model, mesh, model_axis)
    cfg = model.cfg
    if mesh.shape["model"] > 1 and cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"training over a model axis of {mesh.shape['model']} runs the "
            f"{TP_FAMILIES} families; the {cfg.family} family has no "
            "tensor-parallel forward in the port (ROADMAP Queue 1, mesh "
            "training); use a model axis of 1")
    remat = remat_mod.block_wrapper(tcfg.remat_policy)
    micro = max(1, tcfg.microbatches)
    sharded = len(mesh.devices) > 1
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0

    def loss_fn(params, batch):
        if not sharded:
            return lm_loss(model, params, batch, block_wrapper=remat)
        return _mesh_loss(model, mesh, params, batch, remat, aux_w)

    def grads_of(params, tree, batch):
        total, metrics = loss_fn(params, batch)
        names = list(tree)
        grads = torch.autograd.grad(total, [tree[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(tree[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def compute_grads(params, batch, tree=None):
        tree = param_tree(params) if tree is None else tree
        if micro == 1:
            return grads_of(params, tree, batch)
        B = next(iter(batch.values())).shape[0]
        if B % micro:
            raise ValueError(f"global batch {B} does not split into "
                             f"{micro} microbatches")
        gacc = {n: torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for n, p in tree.items()}
        z = torch.zeros((), dtype=torch.float32,
                        device=mesh.lead if sharded else model.device)
        tot, loss, aux, ntok = z, z, z, z
        for i in range(micro):
            mb = {k: v.reshape(micro, B // micro, *v.shape[1:])[i]
                  for k, v in batch.items()}
            t, m, g = grads_of(params, tree, mb)
            for n in gacc:
                gacc[n].add_(g[n].float())
            del g
            tot, loss = tot + t, loss + m["loss"]
            aux, ntok = aux + m["aux_loss"], ntok + m["tokens"]
        inv = 1.0 / micro
        grads = {n: (g * inv).to(tree[n].dtype) for n, g in gacc.items()}
        return tot * inv, {"loss": loss * inv, "aux_loss": aux * inv,
                           "tokens": ntok}, grads

    def step(params, opt_state, batch):
        tree = param_tree(params)
        total, metrics, grads = compute_grads(params, batch, tree)
        opt_metrics = adamw_update(grads, opt_state, tree, tcfg.optimizer)
        del grads
        return params, opt_state, dict(metrics, total_loss=total,
                                       **opt_metrics)

    specs = None
    if sharded:
        cls = encdec_mod.EncDec if cfg.family == "encdec" else lm_mod.LM
        specs = param_specs(cls(cfg, torch.device("meta")), mesh,
                            param_rules())
    return TrainStepBundle(model, tcfg, step, compute_grads,
                           make_batch_shapes(model, tcfg.shape), mesh,
                           specs)


def _mesh_loss(model: Model, mesh: EngineMesh, params: MeshParams,
               batch: Batch, remat: Optional[Callable], aux_w: float
               ) -> Tuple[torch.Tensor, Metrics]:
    """:func:`lm_loss` of the whole batch over the grid: data row ``d``
    runs the forward of its B / rows batch rows on its view of
    ``params``, under its ``(1, model)`` grid as the activation mesh and
    a prefill plan that shards attention's query rows over it where the
    model axis does not divide the query heads.  The row sums join on
    the lead: the loss is the global negative log-likelihood over the
    global token count.  A MoE layer's load-balance loss is the
    reference's: a gather or einsum dispatch routes the whole batch as
    one, so the rows' routing stats (every row routes as many tokens)
    average into the batch's; expert-parallel chunks are routings of
    their own, as the reference's devices, and are kept apart."""
    cfg = model.cfg
    rows = mesh.shape["data"]
    B = batch["tokens"].shape[0]
    if B % rows:
        raise ValueError(f"a batch of {B} does not cut over {rows} data "
                         "rows")
    b = B // rows
    lead = mesh.lead
    nll, tokens, stats = [], [], []
    for d in range(rows):
        row = mesh.sub(d)
        plan = LaunchPlan(kind="prefill", seq_shard_mesh=(
            row if cfg.num_heads % mesh.shape["model"] else None))

        def wrap(body, row=row, plan=plan):
            body = _bound(body, row, plan)
            return remat(body) if remat is not None else body

        part = {k: v[d * b:(d + 1) * b].to(row.lead)
                for k, v in batch.items()}
        with activation_mesh(row), plan_scope(plan):
            logits, st = model.forward(params.view(d), part,
                                       block_wrapper=wrap)
        n, t = _nll(logits, part["labels"])
        nll.append(n.to(lead))
        tokens.append(t.to(lead))
        stats.append(st.to(lead))
    tokens = torch.stack(tokens).sum()
    loss = torch.stack(nll).sum() / torch.clamp(tokens, min=1.0)
    st = torch.stack(stats)                           # (rows, layers, g, 2, E)
    st = st.mean(0) if st.shape[2] == 1 else torch.cat(list(st), 1)
    aux = moe_mod.balance_loss(st)
    return loss + aux_w * aux, {"loss": loss, "aux_loss": aux,
                                "tokens": tokens}

"""Train-step builder: loss, microbatch accumulation, AdamW, one device.

Counterpart of ``repro.training.train_step``.  ``build_train_step(model,
tcfg)`` returns a :class:`TrainStepBundle` whose ``step(params,
opt_state, batch)`` runs the forward (under the remat policy), the
backward (autograd; on the card attention's gradient is the prefill
backward kernel), microbatch accumulation and one in-place AdamW
update, and returns ``(params, opt_state, metrics)`` with the same
params and state objects, updated.  The reference's step is a ``jit``
over a device mesh; the port's runs on one device, and a model axis
above 1 raises (mesh training is ROADMAP Queue 1's next item).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.registry import Model
from repro_torch.training import remat as remat_mod
from repro_torch.training.optimizer import adamw_init, adamw_update

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]

MESH_TRAINING = ("mesh training (param_rules sharding of weights and "
                 "moments, the data axis, sequence-parallel training "
                 "attention) is not ported: ROADMAP Queue 1, mesh training")


def lm_loss(model: Model, params, batch: Batch, *,
            block_wrapper: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Metrics]:
    """Next-token cross entropy over the label positions: (the total
    loss, {"loss", "aux_loss", "tokens"}).  ``labels`` align with the
    LAST ``labels.shape[1]`` positions of the logits (vlm: the text tail
    after the patch prefix); ``label < 0`` masks a position out.  The
    total adds the MoE load-balance loss times its weight."""
    logits, aux = model.forward(params, batch, block_wrapper=block_wrapper)
    labels = batch["labels"]
    lg = logits[:, -labels.shape[1]:][:, :-1]          # (B, Lt - 1, V) f32
    tgt = labels[:, 1:].long()
    mask = (tgt >= 0).to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, tgt.clamp_min(0)[..., None])[..., 0]
    nll = (logz - ll) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    aux_w = model.cfg.moe.aux_loss_weight if model.cfg.moe else 0.0
    return loss + aux_w * aux, {"loss": loss, "aux_loss": aux,
                                "tokens": mask.sum()}


def make_batch_shapes(model: Model, shape: ShapeConfig
                      ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """A train cell's inputs: name -> (shape, dtype name)."""
    B, L = shape.global_batch, shape.seq_len
    Lt = model.text_len(L)
    return {"tokens": ((B, Lt), "int32"), "labels": ((B, Lt), "int32"),
            **model.frontend_inputs(B, L)}


def param_tree(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The weights as a flat dict, keyed by their ``state_dict`` names."""
    return dict(params.named_parameters())


@dataclass
class TrainStepBundle:
    """``step(params, opt_state, batch)`` -> (params, opt_state, metrics),
    updated in place; ``grads(params, batch)`` -> (total loss, metrics,
    gradients by weight name), the step's gradients without the update."""
    model: Model
    tcfg: TrainConfig
    step: Callable
    grads: Callable
    batch_shapes: Dict[str, Tuple[Tuple[int, ...], str]]

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init(self, seed: int = 0):
        """(trainable weights from ``seed``, fresh AdamW state)."""
        params = Model.trainable(self.model.init_params(seed))
        return params, adamw_init(param_tree(params))

    def empty_state(self):
        """(trainable weights and AdamW state of the right shapes and
        dtypes, unfilled: what a checkpoint restores into)."""
        cfg = self.model.cfg
        cls = encdec_mod.EncDec if cfg.family == "encdec" else lm_mod.LM
        params = Model.trainable(cls(cfg, self.device))
        return params, adamw_init(param_tree(params))

    def to_device(self, batch) -> Batch:
        """A host batch (numpy or tensors) on the model's device: token
        ids as int64, other inputs in the model's activation dtype."""
        act = getattr(torch, self.model.cfg.dtype)
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            t = t.long() if k in ("tokens", "labels") else t.to(act)
            out[k] = t.to(self.device)
        return out


def build_train_step(model: Model, tcfg: TrainConfig, *,
                     model_axis: int = 1) -> TrainStepBundle:
    """The one-device train step of ``tcfg``: remat by
    ``tcfg.remat_policy``, ``tcfg.microbatches`` microbatches summed in
    float32, scaled by 1 / micro and cast to the weights' dtypes, then
    AdamW.  ``model_axis`` > 1 (the reference's tensor-parallel mesh,
    and with it its sequence-parallel training attention) raises."""
    if model_axis > 1:
        raise NotImplementedError(MESH_TRAINING)
    wrapper = remat_mod.block_wrapper(tcfg.remat_policy)
    micro = max(1, tcfg.microbatches)

    def loss_fn(params, batch):
        return lm_loss(model, params, batch, block_wrapper=wrapper)

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
        z = torch.zeros((), dtype=torch.float32, device=model.device)
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

    return TrainStepBundle(model, tcfg, step, compute_grads,
                           make_batch_shapes(model, tcfg.shape))

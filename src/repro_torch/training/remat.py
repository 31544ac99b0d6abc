"""Activation-checkpoint (remat) policies for the layer bodies.

Counterpart of ``repro.training.remat``.  The reference wraps its scan
body (one repetition of a layer group's pattern) with ``jax.checkpoint``
under a named policy; the port wraps the same body, one call of it per
repetition (:func:`repro_torch.models.lm.lm_forward`), with
``torch.utils.checkpoint`` (non-reentrant):

- ``none``: no remat, every activation is saved;
- ``nothing_saveable``: only the body's inputs are saved and the whole
  body runs again in the backward pass (so each attention layer
  launches the prefill kernel twice a step on the card);
- ``dots_saveable``: selective checkpointing that saves the output of
  every matrix product (``mm``, ``bmm``, ``addmm``) and recomputes the
  rest;
- ``dots_with_no_batch_dims``: the same, saving ``mm`` and ``addmm`` but
  not the batched ``bmm``.

Recomputation runs the same ops on the same inputs, so on the CPU every
policy gives ``none``'s gradients bit for bit.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils import checkpoint as ckpt

_aten = torch.ops.aten

# policy name -> the aten ops whose outputs are saved (None: no remat;
# an empty set: save nothing)
POLICIES = {
    "none": None,
    "nothing_saveable": frozenset(),
    "dots_saveable": frozenset({_aten.mm.default, _aten.bmm.default,
                                _aten.addmm.default}),
    "dots_with_no_batch_dims": frozenset({_aten.mm.default,
                                          _aten.addmm.default}),
}


def _policy(saved, ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def block_wrapper(policy: str) -> Optional[Callable]:
    """-> a wrapper for a layer body ``fn(*tensors)``, or None for no
    remat.  An unknown name raises ``KeyError``, as the reference's."""
    if policy not in POLICIES:
        raise KeyError(f"unknown remat policy {policy!r}; "
                       f"known: {sorted(POLICIES)}")
    saved = POLICIES[policy]
    if saved is None:
        return None
    context_fn = (functools.partial(
        ckpt.create_selective_checkpoint_contexts,
        functools.partial(_policy, saved)) if saved
        else ckpt.noop_context_fn)

    def wrap(fn: Callable) -> Callable:
        def wrapped(*args):
            return ckpt.checkpoint(fn, *args, use_reentrant=False,
                                   context_fn=context_fn)
        return wrapped
    return wrap

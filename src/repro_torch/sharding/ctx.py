"""Activation-sharding context.

Counterpart of ``repro.sharding.ctx``.  ``activation_mesh`` binds a grid
and its rules for the code inside it and ``current_mesh`` reads the
binding, as the reference's do.  ``shard_activation`` is the identity
here: a sharding constraint changes only how an array is laid out over
the devices, and a single controller that runs every non-attention op
of a shard on its lead device has no layout to constrain.  The one
layout the serving engine does hold, the sequence-sharded KV cache, is
explicit: each device holds its chunk of rows
(``repro_torch.kernels.ops.SeqShards``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

from repro_torch.sharding.rules import ShardingRules, activation_rules

_BOUND: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_activation_mesh", default=None)


@contextlib.contextmanager
def activation_mesh(mesh, rules: Optional[ShardingRules] = None):
    """Bind ``mesh`` (and ``rules``, default :func:`activation_rules`)
    inside the block; ``mesh=None`` binds nothing, so mesh-optional
    callers wrap unconditionally."""
    if mesh is None:
        yield
        return
    token = _BOUND.set((mesh, rules or activation_rules()))
    try:
        yield
    finally:
        _BOUND.reset(token)


def shard_activation(x, logical: Tuple[Optional[str], ...]):
    """The identity (see the module docstring)."""
    return x


def current_mesh():
    """The bound activation mesh, or None outside any context."""
    bound = _BOUND.get()
    return bound[0] if bound is not None else None

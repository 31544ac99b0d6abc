"""Weights from the JAX package's parameter tree, as numpy arrays.

``params_from_numpy(tree, cfg)`` takes the reference's dense-LM param
tree (``{"embed": ..., "final_norm": ..., "groups": ((layer_stack,),)}``
with every leaf converted to a numpy array) and returns the port's
:class:`~repro_torch.models.lm.LM`.  The reference stacks the layers of
its scan group along a leading axis (``params["groups"][0][0]``); here
they are unstacked into one :class:`~repro_torch.models.lm.Block` each.
bfloat16 arrays (dtype name ``bfloat16``) are read through a ``uint16``
view, so neither JAX nor ``ml_dtypes`` is imported.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.models.registry import DeviceLike, resolve_device


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of the array's dtype (bfloat16 via a uint16 view)."""
    a = np.array(a, copy=True, order="C")     # writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree: Mapping[str, Any], prefix: str = ""
             ) -> Iterator[Tuple[str, np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> LM:
    """The port's parameters from the reference's numpy param tree, cast
    to ``cfg.param_dtype`` on ``device`` (the card unless asked)."""
    groups = tree["groups"]
    if len(groups) != 1 or len(groups[0]) != 1:
        raise ValueError("expected one scan group of one block kind "
                         "(a dense LM)")
    state: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten({"embed": tree["embed"],
                               "final_norm": tree["final_norm"]}):
        state[name] = tensor_from_numpy(np.asarray(arr))
    for name, arr in _flatten(groups[0][0]):
        stacked = np.asarray(arr)
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"{name}: {stacked.shape[0]} stacked layers, "
                             f"config has {cfg.num_layers}")
        for li in range(cfg.num_layers):
            state[f"layers.{li}.{name}"] = tensor_from_numpy(stacked[li])
    dev = resolve_device(device)
    lm = LM(cfg, dev)
    dtype = getattr(torch, cfg.param_dtype)
    lm.load_state_dict({k: v.to(dtype) for k, v in state.items()})
    return lm

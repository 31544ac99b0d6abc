"""Weights and caches from the JAX package's trees, as numpy arrays.

``params_from_numpy(tree, cfg)`` takes the reference's LM param tree of
a ported config (``{"embed": ..., "final_norm": ..., "groups":
((layer_stack,),)}`` with every leaf converted to a numpy array; a moe
block's ``ffn`` holds ``router``, ``wi_gate``, ``wi_up`` and ``wo``, an
mla block's ``mix`` ``q_down``, ``q_norm``, ``q_up``, ``kv_down``,
``kv_norm``, ``k_up``, ``v_up`` and ``wo``, and a vlm tree adds the
top-level ``patch_proj``) and returns the port's
:class:`~repro_torch.models.lm.LM`.  The reference
stacks the layers of its scan group along a leading axis
(``params["groups"][0][0]``); here they are unstacked into one
:class:`~repro_torch.models.lm.Block` each.
``cache_from_numpy(tree, cfg)`` takes the reference's dense cache tree
(``((layer_stack,),)`` of ``{"k", "v"}`` plus ``{"k_s", "v_s"}`` for a
quantized cache, or mla's ``{"latent"}``) and returns the port's cache
dict, layers still stacked.  bfloat16 arrays (dtype name ``bfloat16``) are read through a
``uint16`` view and float8_e4m3fn ones through a ``uint8`` view, so
neither JAX nor ``ml_dtypes`` is imported.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.models.registry import DeviceLike, resolve_device


# dtypes numpy knows only through ml_dtypes: read as raw bits of equal
# width, then viewed as the torch dtype of the same name
_BIT_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of the array's dtype (bfloat16 and float8_e4m3fn via
    an unsigned view of their bits)."""
    a = np.array(a, copy=True, order="C")     # writable, contiguous
    if a.dtype.name in _BIT_VIEWS:
        raw, dt = _BIT_VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(raw)).view(dt)
    return torch.from_numpy(a)


def _flatten(tree: Mapping[str, Any], prefix: str = ""
             ) -> Iterator[Tuple[str, np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _one_group(tree: Any) -> Any:
    if len(tree) != 1 or len(tree[0]) != 1:
        raise ValueError("expected one scan group of one block kind "
                         "(an LM of a ported family)")
    return tree[0][0]


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> LM:
    """The port's parameters from the reference's numpy param tree, cast
    to ``cfg.param_dtype`` on ``device`` (the card unless asked)."""
    layers = _one_group(tree["groups"])
    state: Dict[str, torch.Tensor] = {}
    top = {name: tree[name] for name in ("embed", "final_norm",
                                         "patch_proj") if name in tree}
    for name, arr in _flatten(top):
        state[name] = tensor_from_numpy(np.asarray(arr))
    for name, arr in _flatten(layers):
        stacked = np.asarray(arr)
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"{name}: {stacked.shape[0]} stacked layers, "
                             f"config has {cfg.num_layers}")
        for li in range(cfg.num_layers):
            state[f"layers.{li}.{name}"] = tensor_from_numpy(stacked[li])
    dev = resolve_device(device)
    lm = LM(cfg, dev)
    # each leaf in its parameter's dtype: cfg.param_dtype, except the MoE
    # router, which stays float32 as in the reference
    want = lm.state_dict()
    lm.load_state_dict({k: v.to(want[k].dtype) for k, v in state.items()})
    return lm


def cache_from_numpy(tree: Any, cfg: ModelConfig,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The port's dense cache from the reference's numpy cache tree:
    ``k`` / ``v`` (layers, B, max_len, Hkv, D) in their stored dtype
    (bf16, f32, int8 or fp8) and, when present, ``k_s`` / ``v_s`` (layers,
    B, max_len, Hkv) f32; or mla's ``latent`` (layers, B, max_len, 1,
    kv_lora_rank + rope); on ``device`` (the card unless asked)."""
    leaves = _one_group(tree)
    if set(leaves) not in ({"k", "v"}, {"k", "v", "k_s", "v_s"},
                           {"latent"}):
        raise ValueError(f"expected a dense cache {{k, v[, k_s, v_s]}} or "
                         f"{{latent}}, got {sorted(leaves)}")
    dev = resolve_device(device)
    out = {name: tensor_from_numpy(np.asarray(arr)).to(dev)
           for name, arr in leaves.items()}
    layers = next(iter(out.values())).shape[0]
    if layers != cfg.num_layers:
        raise ValueError(f"cache has {layers} stacked layers, config has "
                         f"{cfg.num_layers}")
    return out

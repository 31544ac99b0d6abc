"""Weights and caches from the JAX package's trees, as numpy arrays.

``params_from_numpy(tree, cfg)`` takes the reference's param tree of a
ported config, every leaf converted to a numpy array, and returns the
port's weights.  An LM tree is ``{"embed": ..., "final_norm": ...,
"groups": ...}``: the reference stacks the layers of each scan group
along a leading axis, one stack per kind of its pattern
(``groups[g][k]``, :func:`repro_torch.models.lm.layer_groups`: one group
of one kind for the uniform families; the hybrid's repeated (rglru,
rglru, attn_window) pattern and its remainder), and here they are
unstacked into one :class:`~repro_torch.models.lm.Block` a layer.  A moe
block's ``ffn`` holds ``router``, ``wi_gate``, ``wi_up`` and ``wo``, an
mla block's ``mix`` ``q_down``, ``q_norm``, ``q_up``, ``kv_down``,
``kv_norm``, ``k_up``, ``v_up`` and ``wo``, an rglru block's ``mix`` the
RG-LRU weights, an ssd block only ``ln1`` and a ``mix`` of ``in_proj``,
``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``norm`` and
``out_proj``, and a vlm tree adds the top-level ``patch_proj``.  An
encdec tree (``embed``, ``pos_dec``, ``enc_layers``, ``enc_norm``,
``dec_layers`` with ``self`` / ``lnx`` / ``cross``, ``final_norm``)
gives an :class:`~repro_torch.models.encdec.EncDec`, its two stacks
unstacked likewise.
``cache_from_numpy(tree, cfg)`` takes the reference's dense cache tree
and returns the port's cache dict, layers still stacked: from groups of
``{"k", "v"}`` (plus ``{"k_s", "v_s"}`` for a quantized cache), mla's
``{"latent"}``, the hybrid's ring ``{"k", "v"...}`` and recurrent
``{"state", "conv"}`` (each leaf stacked over the layers that hold it,
in layer order), an ssm model's ``{"state", "conv"}``; or encdec's
``{"self": {"k", "v"}, "cross": {"k", "v"}}`` as ``k`` / ``v`` /
``cross_k`` / ``cross_v``.  bfloat16 arrays
(dtype name ``bfloat16``) are read through a ``uint16`` view and
float8_e4m3fn ones through a ``uint8`` view, so neither JAX nor
``ml_dtypes`` is imported.
``params_to_numpy(params, cfg)`` is ``params_from_numpy``'s inverse: the
reference's tree from the port's weights, or from a dict of tensors
under the weights' names (their gradients), each group's layers stacked
again; bfloat16 leaves come back as the float32 of the same values.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.lm import LM, layer_groups
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


def _unstack(stack: Mapping[str, Any], n: int, what: str
             ) -> Iterator[Tuple[int, str, np.ndarray]]:
    """(layer, leaf name, array) of ``n`` layers stacked along axis 0."""
    for name, arr in _flatten(stack):
        stacked = np.asarray(arr)
        if stacked.shape[0] != n:
            raise ValueError(f"{what} {name}: {stacked.shape[0]} stacked "
                             f"layers, expected {n}")
        for li in range(n):
            yield li, name, stacked[li]


def _grouped_layers(groups: Any, cfg: ModelConfig
                    ) -> Iterator[Tuple[int, str, np.ndarray]]:
    """(layer, leaf name, array) of every layer of the reference's scan
    groups: ``groups[g][k]`` stacks repeat r of pattern position k of
    group g, which is layer ``offset_g + r * len(pattern) + k``."""
    plan = layer_groups(cfg)
    if len(groups) != len(plan) or any(
            len(g) != len(p) for g, (p, _) in zip(groups, plan)):
        raise ValueError(f"expected the scan groups {plan} of "
                         f"{cfg.name}, got {len(groups)} groups")
    offset = 0
    for g, (pattern, reps) in zip(groups, plan):
        for k, stack in enumerate(g):
            for r, name, arr in _unstack(stack, reps, pattern[k]):
                yield offset + r * len(pattern) + k, name, arr
        offset += reps * len(pattern)


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None):
    """The port's parameters from the reference's numpy param tree, cast
    to ``cfg.param_dtype`` on ``device`` (the card unless asked): an
    :class:`EncDec` for an encdec config, else an :class:`LM`."""
    state: Dict[str, torch.Tensor] = {}
    stacks = ("enc_layers", "dec_layers") if cfg.family == "encdec" \
        else ("groups",)
    for name, arr in _flatten({k: v for k, v in tree.items()
                               if k not in stacks}):
        state[name] = tensor_from_numpy(np.asarray(arr))
    if cfg.family == "encdec":
        for stack, n in (("enc_layers", cfg.num_encoder_layers),
                         ("dec_layers", cfg.num_layers)):
            for li, name, arr in _unstack(tree[stack], n, stack):
                state[f"{stack}.{li}.{name}"] = tensor_from_numpy(arr)
    else:
        for li, name, arr in _grouped_layers(tree["groups"], cfg):
            state[f"layers.{li}.{name}"] = tensor_from_numpy(arr)
    dev = resolve_device(device)
    module = (EncDec if cfg.family == "encdec" else LM)(cfg, dev)
    # each leaf in its parameter's dtype: cfg.param_dtype, except the MoE
    # router, which stays float32 as in the reference
    want = module.state_dict()
    module.load_state_dict({k: v.to(want[k].dtype)
                            for k, v in state.items()})
    return module


def _nest(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Dotted names -> nested dicts (``mix.wq`` -> {"mix": {"wq": ..}})."""
    out: Dict[str, Any] = {}
    for name, arr in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return out


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; bfloat16 becomes float32,
    which holds every bfloat16 value exactly (numpy has no bfloat16), so
    :func:`params_from_numpy`'s cast to bfloat16 gives the same bits
    back."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_numpy(params: Any, cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of :func:`params_from_numpy`: the reference's param tree
    of numpy arrays from the port's weights (an :class:`LM` or
    :class:`EncDec`), or from any dict keyed by their ``state_dict``
    names (gradients, for one).  Each scan group's layers are stacked
    back along a leading axis, ``groups[g][k]`` for pattern position k
    (encdec: ``enc_layers`` and ``dec_layers``), and the result is a
    nested dict with a tuple of tuples under ``groups``.  bfloat16
    leaves come back as float32 of the same values (exact); float32 ones
    as float32."""
    flat = (params.state_dict() if isinstance(params, torch.nn.Module)
            else dict(params))
    flat = {n: tensor_to_numpy(t) for n, t in flat.items()}
    top = {n: a for n, a in flat.items() if not n.startswith(
        ("layers.", "enc_layers.", "dec_layers."))}
    tree = _nest(top)

    def stacked(prefix: str, layer_ids) -> Dict[str, Any]:
        names = sorted({n.split(".", 2)[2] for n in flat
                        if n.startswith(f"{prefix}.{layer_ids[0]}.")})
        return _nest({name: np.stack([flat[f"{prefix}.{li}.{name}"]
                                      for li in layer_ids])
                      for name in names})

    if cfg.family == "encdec":
        tree["enc_layers"] = stacked("enc_layers",
                                     list(range(cfg.num_encoder_layers)))
        tree["dec_layers"] = stacked("dec_layers",
                                     list(range(cfg.num_layers)))
        return tree
    groups = []
    first = 0
    for pattern, reps in layer_groups(cfg):
        groups.append(tuple(
            stacked("layers", [first + r * len(pattern) + k
                               for r in range(reps)])
            for k in range(len(pattern))))
        first += reps * len(pattern)
    tree["groups"] = tuple(groups)
    return tree


def cache_from_numpy(tree: Any, cfg: ModelConfig,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The port's dense cache from the reference's numpy cache tree, in
    the stored dtypes (bf16, f32, int8 or fp8), on ``device`` (the card
    unless asked): ``k`` / ``v`` (layers, B, max_len, Hkv, D) and, when
    present, ``k_s`` / ``v_s`` (layers, B, max_len, Hkv) f32; mla's
    ``latent`` (layers, B, max_len, 1, kv_lora_rank + rope); encdec's
    ``k`` / ``v`` and ``cross_k`` / ``cross_v``; a hybrid's ring ``k`` /
    ``v`` (scales) over its windowed layers and ``state`` / ``conv`` over
    its recurrent ones; an ssm model's ``state`` / ``conv``."""
    dev = resolve_device(device)
    if cfg.family == "encdec":
        flat = {("cross_" if part == "cross" else "") + name: arr
                for part in ("self", "cross")
                for name, arr in tree[part].items()}
        out = {name: tensor_from_numpy(np.asarray(arr)).to(dev)
               for name, arr in flat.items()}
        bad = [n for n, t in out.items() if t.shape[0] != cfg.num_layers]
        if set(out) != {"k", "v", "cross_k", "cross_v"} or bad:
            raise ValueError(f"expected an encdec cache of {cfg.num_layers}"
                             f" layers, got {sorted(out)}")
        return out
    per_name: Dict[str, Dict[int, np.ndarray]] = {}
    for li, name, arr in _grouped_layers(tree, cfg):
        per_name.setdefault(name, {})[li] = arr
    names = set(per_name)
    if names not in ({"k", "v"}, {"k", "v", "k_s", "v_s"}, {"latent"},
                     {"state", "conv"}, {"k", "v", "state", "conv"},
                     {"k", "v", "k_s", "v_s", "state", "conv"}):
        raise ValueError(f"expected a dense cache {{k, v[, k_s, v_s]}}, "
                         f"{{latent}}, {{state, conv}} or a hybrid's, got "
                         f"{sorted(names)}")
    return {name: tensor_from_numpy(np.stack(
        [rows[li] for li in sorted(rows)])).to(dev)
        for name, rows in per_name.items()}

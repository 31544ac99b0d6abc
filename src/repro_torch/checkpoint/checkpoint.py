"""Checkpoints of a tree of tensors: atomic, keep-last-k, async.

Counterpart of ``repro.checkpoint.checkpoint``, in its on-disk layout, so
either package restores what the other wrote::

    <dir>/step_00000123/
        manifest.json       # step, each leaf's key, shape and dtype
        shard_00000.npz     # the leaves, flat, keyed by path

A tree is nested dicts (keys in sorted order, as JAX flattens them),
lists and tuples; a leaf is a tensor or a numpy array, keyed by its path
joined with ``/`` (``/`` becomes ``__`` inside the npz).  bfloat16 and
float8_e4m3fn leaves are stored as their raw bits (uint16, uint8) with
the true dtype in the manifest, as the reference stores them.  Writes go
to ``step_N.tmp/`` and are renamed into place, so a crashed writer never
leaves a half checkpoint where :func:`latest_step` looks.
:class:`AsyncCheckpointer` copies the leaves to the host, then writes on
a worker thread while training goes on.

The reference's restore re-shards leaves onto a new mesh; the port's
places them on one device, the restoring tree's (the one-card
counterpart), and casts each to the restoring leaf's dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

# numpy cannot hold these dtypes without ml_dtypes: the unsigned type of
# their bits on disk, a type of that width torch reads from numpy, and the
# torch dtype of the name the manifest gives
_BITS = {"bfloat16": (np.uint16, np.int16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, np.uint8, torch.float8_e4m3fn)}
_BY_TORCH = {dt: name for name, (_, _, dt) in _BITS.items()}


def _flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _unflatten(like: Tree, leaves: dict, prefix: str = "") -> Tree:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return leaves[prefix[:-1]]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(the array stored, the true dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype in _BY_TORCH:
            name = _BY_TORCH[t.dtype]
            disk, side, _ = _BITS[name]
            return t.view(torch.int16 if side == np.int16
                          else torch.uint8).numpy().view(disk), name
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save(path, step: int, tree: Tree, keep: int = 3) -> Path:
    """Blocking checkpoint write with atomic rename and retention of the
    newest ``keep`` steps."""
    base = Path(path)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = {}
    manifest = {"step": step, "leaves": []}
    for key, leaf in _flatten(tree):
        arr, dtype = _host(leaf)
        if dtype not in _BITS and arr.dtype.kind not in "biuf":
            raise TypeError(f"cannot checkpoint {key} of dtype {dtype}")
        arrays[key.replace("/", "__")] = arr
        manifest["leaves"].append(
            {"key": key, "shape": list(arr.shape), "dtype": dtype})
    np.savez(tmp / "shard_00000.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(base, keep)
    return final


def _retain(base: Path, keep: int) -> None:
    steps = sorted(p for p in base.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(path) -> Optional[int]:
    """The newest complete step under ``path``, or None."""
    base = Path(path)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")
             and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its true dtype."""
    if dtype in _BITS:
        _, side, dt = _BITS[dtype]
        return torch.from_numpy(np.array(arr).view(side)).view(dt)
    return torch.from_numpy(np.array(arr, dtype=dtype))


def restore(path, like: Tree, *, step: Optional[int] = None,
            inplace: bool = False) -> Tuple[int, Tree]:
    """(step, a tree of ``like``'s structure read from the checkpoint of
    ``step``, the newest by default).  Each leaf takes the dtype and the
    device of ``like``'s leaf (a tensor, or a numpy array).  With
    ``inplace`` the values are copied into ``like``'s tensors, which are
    returned."""
    base = Path(path)
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {base}")
    d = base / f"step_{step:08d}"
    data = np.load(d / "shard_00000.npz")
    manifest = json.loads((d / "manifest.json").read_text())
    saved = {e["key"]: e["dtype"] for e in manifest["leaves"]}
    leaves = {}
    for key, proto in _flatten(like):
        t = _leaf(data[key.replace("/", "__")], saved[key])
        if isinstance(proto, torch.Tensor):
            t = t.to(device=proto.device, dtype=proto.dtype)
            if inplace:
                with torch.no_grad():
                    proto.copy_(t)
                t = proto
        else:
            if t.dtype in _BY_TORCH:      # numpy has no such dtype
                t = t.float()
            t = t.numpy().astype(np.asarray(proto).dtype)
        leaves[key] = t
    return step, _unflatten(like, leaves)


class AsyncCheckpointer:
    """One write in flight at a time; ``wait()`` before the process
    exits.  ``save`` copies every leaf to the host before it returns (so
    training may overwrite the tensors in place right after) and writes
    on a worker thread."""

    def __init__(self, path, keep: int = 3):
        self.path = Path(path)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Tree) -> None:
        self.wait()
        host = _unflatten(tree, {k: _host_copy(v)
                                 for k, v in _flatten(tree)})

        def work():
            try:
                save(self.path, step, host, keep=self.keep)
            except BaseException as e:                  # pragma: no cover
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _host_copy(leaf):
    """A host copy of a leaf that later in-place updates cannot touch."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)

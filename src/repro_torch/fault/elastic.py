"""Resume a training run from its newest checkpoint.

Counterpart of ``repro.fault.elastic``.  What makes a resumed run equal
the uninterrupted one:

1. a checkpoint holds the weights, both AdamW moments and the step
   count, bit for bit (:mod:`repro_torch.checkpoint`);
2. the data pipeline is stateless (``batch_at(step)``), so skipping to
   step N replays and drops nothing;
3. the train step keeps no other state.

``resumable_train_loop`` is the crash-safe loop ``launch/train.py``
runs; ``fail_at_step`` injects a crash.  The reference can also restart
on a different mesh; the port trains on one device, so a restart
restores onto the bundle's device (restoring onto another grid is
ROADMAP Queue 1's mesh-training item).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.fault.watchdog import StragglerDetector
from repro_torch.training.train_step import param_tree


def train_state(params, opt) -> Dict[str, object]:
    """The tree a checkpoint holds: ``{"params": name -> weight, "opt":
    {"m", "v", "count"}}``."""
    return {"params": param_tree(params), "opt": opt}


def elastic_restore(path: str, bundle, seed: int = 0) -> Tuple[int, object,
                                                               object]:
    """(start step, params, opt_state): from the newest checkpoint under
    ``path`` (the step after it), restored onto the bundle's device, or a
    fresh ``bundle.init(seed)`` when there is none."""
    step = ckpt.latest_step(path)
    if step is None:
        params, opt = bundle.init(seed)
        return 0, params, opt
    params, opt = bundle.empty_state()
    ckpt.restore(path, train_state(params, opt), step=step, inplace=True)
    return step + 1, params, opt


def resumable_train_loop(
    bundle,
    data: SyntheticLM,
    *,
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    keep: int = 3,
    log_every: int = 10,
    async_ckpt: bool = True,
    fail_at_step: Optional[int] = None,
    log_fn: Callable[[str], None] = print,
) -> Dict[str, float]:
    """Run (or resume) training to ``total_steps``; returns the last
    metrics as floats."""
    start, params, opt = elastic_restore(ckpt_dir, bundle,
                                         bundle.tcfg.seed)
    if start > 0:
        log_fn(f"[elastic] resumed at step {start} on {bundle.device}")
    writer = ckpt.AsyncCheckpointer(ckpt_dir, keep=keep) if async_ckpt \
        else None
    straggler = StragglerDetector()
    metrics: Dict[str, float] = {}
    m = {}
    for step in range(start, total_steps):
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.monotonic()
        batch = bundle.to_device(data.batch_at(step))
        params, opt, m = bundle.step(params, opt, batch)
        dt = time.monotonic() - t0
        straggler.record("worker_0", dt)
        if step % log_every == 0:
            metrics = {k: float(v) for k, v in m.items()}
            log_fn(f"step {step:5d} loss {metrics['loss']:.4f} "
                   f"gnorm {metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
        if ckpt_every and (step + 1) % ckpt_every == 0:
            state = train_state(params, opt)
            if writer:
                writer.save(step, state)
            else:
                ckpt.save(ckpt_dir, step, state, keep=keep)
    if writer:
        writer.wait()
    if start < total_steps:
        # a resume landing exactly at total_steps runs zero steps; the
        # last logged metrics (possibly empty) are all there is
        metrics = {k: float(v) for k, v in m.items()}
    return metrics

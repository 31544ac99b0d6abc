"""Resume a training run from its newest checkpoint.

Counterpart of ``repro.fault.elastic``: resume the same logical run,
on the grid it ran on or on another.  What makes a resumed run equal
the uninterrupted one:

1. a checkpoint holds the weights, both AdamW moments and the step
   count, bit for bit, dense and grid-agnostic: a sharded tree is
   joined on save (:meth:`~repro_torch.training.train_step.
   TrainStepBundle.checkpoint_tree`) and cut onto the restoring
   bundle's grid on restore, whatever grid wrote it;
2. the data pipeline is stateless (``batch_at(step)``), so skipping to
   step N replays and drops nothing;
3. the train step keeps no other state.

``resumable_train_loop`` is the crash-safe loop ``launch/train.py``
runs; ``fail_at_step`` injects a crash.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.fault.watchdog import StragglerDetector


def elastic_restore(path: str, bundle, seed: int = 0) -> Tuple[int, object,
                                                               object]:
    """(start step, params, opt_state): from the newest checkpoint under
    ``path`` (the step after it), restored onto the bundle's grid, or a
    fresh ``bundle.init(seed)`` when there is none.  The reference's
    restore places each dense leaf by the new mesh's shardings; here a
    one-device bundle's tensors are filled in place and a sharded
    bundle's leaves and moments are cut from the dense tree."""
    step = ckpt.latest_step(path)
    if step is None:
        params, opt = bundle.init(seed)
        return 0, params, opt
    params, opt = bundle.empty_state()
    like = bundle.checkpoint_tree(params, opt)
    if not bundle.sharded:
        ckpt.restore(path, like, step=step, inplace=True)
    else:
        _, tree = ckpt.restore(path, like, step=step)
        bundle.load_checkpoint_tree(params, opt, tree)
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
        shape = (bundle.mesh.shape["data"], bundle.mesh.shape["model"])
        log_fn(f"[elastic] resumed at step {start} on mesh {shape}")
    writer = ckpt.AsyncCheckpointer(ckpt_dir, keep=keep) if async_ckpt \
        else None
    straggler = StragglerDetector()
    metrics: Dict[str, float] = {}
    m = {}
    try:
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
                state = bundle.checkpoint_tree(params, opt)
                if writer:
                    writer.save(step, state)
                else:
                    ckpt.save(ckpt_dir, step, state, keep=keep)
    finally:
        # a failing step lets the checkpoint in flight finish
        if writer:
            writer.wait()
    if start < total_steps:
        # a resume landing exactly at total_steps runs zero steps; the
        # last logged metrics (possibly empty) are all there is
        metrics = {k: float(v) for k, v in m.items()}
    return metrics

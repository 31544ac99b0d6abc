"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro.launch.train``: a reduced or full config,
synthetic data, AdamW, remat, microbatching, async checkpoints and
resumption, through :func:`run_training`.  It runs on the CUDA card
unless given ``device="cpu"`` (``--device cpu``), and raises without a
card otherwise.  Training runs on one device: ``--model-axis`` above 1
raises (mesh training is ROADMAP Queue 1's next item).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict, Optional

from repro_torch.configs import get_arch
from repro_torch.configs.base import OptimizerConfig, ShapeConfig, \
    TrainConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.fault.elastic import resumable_train_loop
from repro_torch.models.registry import DeviceLike, build_model
from repro_torch.training.train_step import build_train_step

def run_training(
    arch: str,
    *,
    steps: int = 200,
    reduced: bool = True,
    d_model: int = 128,
    num_layers: int = 4,
    seq_len: int = 128,
    global_batch: int = 8,
    microbatches: int = 1,
    lr: float = 1e-3,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    model_axis: int = 1,
    remat_policy: str = "none",
    fail_at_step: Optional[int] = None,
    log_fn=print,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir`` when
    it holds a checkpoint; by default ``repro_torch_ckpt`` under the temp
    directory, where the reference writes /tmp/repro_ckpt); returns the
    last step's metrics."""
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    cfg = get_arch(arch)
    if reduced:
        cfg = reduced_config(cfg, num_layers=num_layers, d_model=d_model)
    model = build_model(cfg, device=device)
    shape = ShapeConfig("cli", seq_len, global_batch, "train")
    tcfg = TrainConfig(
        model=cfg, shape=shape,
        optimizer=OptimizerConfig(lr=lr, warmup_steps=max(1, steps // 20),
                                  total_steps=steps),
        microbatches=microbatches, remat_policy=remat_policy,
        checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every)
    bundle = build_train_step(model, tcfg, model_axis=model_axis)
    if model.frontend_inputs(global_batch, seq_len):
        raise NotImplementedError(
            "CLI training drives text-only archs; frontend-stub archs "
            "train through build_train_step with their stub inputs")
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=model.text_len(seq_len),
        global_batch=global_batch, seed=tcfg.seed))
    return resumable_train_loop(
        bundle, data, total_steps=steps, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, fail_at_step=fail_at_step, log_fn=log_fn)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced smoke config)")
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--num-layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "under the temp directory)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args()
    metrics = run_training(
        args.arch, steps=args.steps, reduced=not args.full,
        d_model=args.d_model, num_layers=args.num_layers,
        seq_len=args.seq_len, global_batch=args.global_batch,
        microbatches=args.microbatches, lr=args.lr,
        ckpt_dir=args.ckpt_dir, model_axis=args.model_axis,
        remat_policy=args.remat, device=args.device)
    print("final:", metrics)


if __name__ == "__main__":
    main()

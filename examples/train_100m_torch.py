"""End-to-end training example of the PyTorch port: the reference's
``examples/train_100m.py`` dims (8 layers x d_model 256, GQA, reduced
vocab) for a few hundred steps on synthetic data, with checkpoints and
resumption, on the CUDA card unless given ``--device cpu``.  Raise
``--data-axis`` / ``--model-axis`` to train over a grid (on one card,
every device of the grid is the card).

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 300]
        [--device cpu] [--data-axis 2 --model-axis 2]
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import run_training


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    args = ap.parse_args()

    metrics = run_training(
        "qwen2.5-3b",            # family and wiring; dims set below
        steps=args.steps,
        d_model=256,             # 4 heads of 64
        num_layers=8,
        seq_len=256,
        global_batch=8,
        microbatches=2,
        lr=1e-3,
        remat_policy="nothing_saveable",
        ckpt_dir=args.ckpt,
        ckpt_every=100,
        data_axis=args.data_axis,
        model_axis=args.model_axis,
        device=args.device or "cuda",
    )
    print("final metrics:", {k: round(v, 4) for k, v in metrics.items()})
    assert metrics["loss"] < 6.0, "training should make progress"


if __name__ == "__main__":
    main()

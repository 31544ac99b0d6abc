"""Quickstart of the PyTorch port: the paper's policy, training, serving.

1. The FA3 guard flaw and the sequence-aware fix on the paper's own
   shapes (policy decisions and modeled latency on the H100 model).
2. A few training steps of a small GQA model (synthetic data, AdamW,
   remat, checkpoints), over a ``(data, model)`` grid when asked.
3. Serving through the split-policy decode engine under the paper
   policy.

It runs on the CUDA card (the hand-written kernels) unless given
``--device cpu`` (their plain PyTorch versions).  Head dim 64, so the
card's kernels take every shape.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
        [--data-axis 2 --model-axis 2]
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.occupancy import H100_SXM, modeled_latency_us
from repro_torch.core.split_policy import (
    DecodeWorkload,
    fa3_baseline,
    paper_policy,
)
from repro_torch.launch.train import run_training
from repro_torch.models import build_model
from repro_torch.serving import DecodeEngine, Request

D_MODEL = 256           # 4 heads of 64


def policy_demo():
    print("== 1. the paper's boundary bucket (B=1, L_K=512, D=128) ==")
    for hkv in (1, 2, 8):
        w = DecodeWorkload(1, 1, 512, 64, hkv, 128)
        s0, s1 = fa3_baseline(w, 132), paper_policy(w, 132)
        t0 = modeled_latency_us(w, s0, hw=H100_SXM, num_cores=132)
        t1 = modeled_latency_us(w, s1, hw=H100_SXM, num_cores=132)
        print(f"  H_KV={hkv}: baseline s={s0} ({t0:.2f}us) -> "
              f"paper s={s1} ({t1:.2f}us)  x{t0/t1:.2f}")


def train_demo(device, steps, data_axis, model_axis):
    print(f"\n== 2. train a small qwen2.5-style model (synthetic data, "
          f"grid {data_axis} x {model_axis}) ==")
    metrics = run_training(
        "qwen2.5-3b", steps=steps, d_model=D_MODEL, num_layers=2,
        seq_len=64, global_batch=8, lr=3e-3,
        ckpt_dir=os.path.join(tempfile.mkdtemp(), "quickstart_torch"),
        ckpt_every=steps // 2, data_axis=data_axis,
        model_axis=model_axis, device=device, log_fn=lambda line: None)
    print(f"  final loss {metrics['loss']:.3f}")


def serve_demo(device):
    print("\n== 3. serve through the split-policy decode engine ==")
    cfg = reduced_config(get_arch("qwen2.5-3b"), num_layers=2,
                         d_model=D_MODEL)
    model = build_model(cfg, device=device)
    eng = DecodeEngine(model, ServeConfig(model=cfg, split_policy="paper"),
                       max_len=128, batch_slots=3, device=device)
    eng.load(model.init_params(0))
    outs = eng.generate([Request(i, [1 + i, 2, 3], max_new_tokens=8)
                         for i in range(5)])
    for c in outs:
        print(f"  req {c.request_id}: {c.tokens}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    args = ap.parse_args()
    device = args.device or "cuda"
    policy_demo()
    train_demo(device, args.steps, args.data_axis, args.model_axis)
    serve_demo(device)
    print("\nquickstart OK")


if __name__ == "__main__":
    main()

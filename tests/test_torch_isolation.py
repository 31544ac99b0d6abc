"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or the ``repro`` package; and its entry
points refuse to fall back to the CPU when no card is present."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "repro" or m.startswith("repro."))
    print(json.dumps({"modules": names, "bad": bad}))
""")


def test_no_module_imports_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for want in ("repro_torch.kernels.ops", "repro_torch.serving.engine",
                 "repro_torch.interop", "repro_torch.kernels.build",
                 "repro_torch.quant.quantizer",
                 "repro_torch.kernels.flash_decode_quant",
                 "repro_torch.core.occupancy",
                 "repro_torch.core.scheduler_metadata"):
        assert want in res["modules"]


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    cfg = reduced_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, ServeConfig(model=cfg))

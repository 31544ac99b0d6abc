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
                 "repro_torch.core.scheduler_metadata",
                 "repro_torch.cache.manager", "repro_torch.cache.layout",
                 "repro_torch.launch.serve", "repro_torch.spec.config",
                 "repro_torch.spec.drafter", "repro_torch.spec.outcome",
                 "repro_torch.serving.sampling",
                 "repro_torch.configs.codeqwen15_7b",
                 "repro_torch.configs.stablelm_12b",
                 "repro_torch.tune", "repro_torch.tune.spec",
                 "repro_torch.tune.table", "repro_torch.tune.calibrator",
                 "repro_torch.plan.scope", "repro_torch.launch.tune",
                 "repro_torch.obs", "repro_torch.obs.io",
                 "repro_torch.obs.metrics", "repro_torch.obs.trace",
                 "repro_torch.obs.observer", "repro_torch.obs.config",
                 "repro_torch.models.moe",
                 "repro_torch.configs.granite_moe_3b_a800m",
                 "repro_torch.configs.qwen3_moe_235b_a22b",
                 "repro_torch.models.mla",
                 "repro_torch.configs.minicpm3_4b",
                 "repro_torch.configs.paligemma_3b",
                 "repro_torch.models.encdec", "repro_torch.models.rglru",
                 "repro_torch.configs.whisper_large_v3",
                 "repro_torch.configs.recurrentgemma_9b",
                 "repro_torch.models.ssd",
                 "repro_torch.configs.mamba2_780m",
                 "repro_torch.shard", "repro_torch.shard.spec",
                 "repro_torch.shard.resolver", "repro_torch.shard.engine",
                 "repro_torch.sharding", "repro_torch.sharding.rules",
                 "repro_torch.sharding.ctx", "repro_torch.launch.mesh",
                 "repro_torch.sharding.place",
                 "repro_torch.serving.decode_step",
                 "repro_torch.training", "repro_torch.training.optimizer",
                 "repro_torch.training.remat",
                 "repro_torch.training.train_step",
                 "repro_torch.checkpoint",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.fault", "repro_torch.fault.elastic",
                 "repro_torch.fault.watchdog", "repro_torch.data",
                 "repro_torch.data.synthetic", "repro_torch.launch.train"):
        assert want in res["modules"]


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.models import build_model
    from repro_torch.launch.serve import run_serving
    from repro_torch.serving import DecodeEngine, ServingEngine
    cfg = reduced_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    for engine in (ServingEngine, DecodeEngine):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            engine(model, ServeConfig(model=cfg))
        engine(model, ServeConfig(model=cfg), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving("qwen2.5-3b", num_requests=1, max_new=1)
    assert len(run_serving("qwen2.5-3b", num_requests=1, max_new=1,
                           d_model=64, device="cpu",
                           log_fn=lambda line: None)) == 1
    # training: the launcher and the bundle's model take the card unless
    # asked for the CPU
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.train import run_training
    from repro_torch.training import build_train_step
    tcfg = TrainConfig(model=cfg, shape=ShapeConfig("t", 16, 2, "train"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(build_model(cfg), tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training("qwen2.5-3b", steps=1, d_model=64)
    bundle = build_train_step(model, tcfg)
    params, state = bundle.init(0)
    assert bundle.device == torch.device("cpu")
    assert {p.device for p in params.parameters()} == {torch.device("cpu")}
    assert state["count"].device == torch.device("cpu")


def test_mesh_entry_points_raise_without_cuda():
    """The mesh-native entry points take the visible CUDA devices unless
    given a device list, and never fall back to the CPU: the grid, the
    resolver, the sharded engine and the CLI's ``--mesh`` raise without a
    card, and serve over an explicit CPU list."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.reduced import reduced_config
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.launch.serve import run_serving
    from repro_torch.models import build_model
    from repro_torch.shard import ShardedServingEngine, ShardResolver, \
        ShardSpec
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardResolver(ShardSpec()).resolve(max_len=64)
    cfg = reduced_config("qwen2.5-3b")
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedServingEngine(model, ServeConfig(model=cfg, shard="1,1"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving("qwen2.5-3b", num_requests=1, max_new=1, mesh="1,1",
                    d_model=64)
    eng = ShardedServingEngine(model, ServeConfig(model=cfg, shard="2,1"),
                               devices=[torch.device("cpu")] * 2)
    assert eng.plan.mesh.devices == (torch.device("cpu"),) * 2

"""The port's checkpoints, fault handling and resumable training loop
against the reference's, on the CPU.

A tree saved by either package's ``checkpoint.save`` restores through the
other's ``restore`` bit for bit (bfloat16 leaves stored as bits with the
true dtype in the manifest, in the same ``step_%08d/`` layout); the
reference's ``tests/test_checkpoint_fault.py`` cases carried over
(keep-last-k, a crashed ``.tmp`` directory, ``AsyncCheckpointer``, the
dtype cast on restore); the watchdog and straggler detector on a fake
clock; ``resumable_train_loop`` crashed at a step and resumed, equal to
the uninterrupted run bit for bit (the same ops on the same restored bits
on the CPU); and the training CLI on the CPU.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import OptimizerConfig, ShapeConfig, \
    TrainConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.fault import Heartbeat, StragglerDetector, Watchdog
from repro_torch.fault.elastic import elastic_restore, resumable_train_loop
from repro_torch.models import build_model
from repro_torch.training.train_step import build_train_step, param_tree

ROOT = Path(__file__).resolve().parents[1]


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.randn(4, generator=torch.Generator()
                                        .manual_seed(0)).bfloat16(),
                       "c": torch.tensor(7, dtype=torch.int32)},
            "seq": (torch.ones(2, dtype=torch.float32) * 3,
                    torch.zeros((1, 2), dtype=torch.bfloat16))}


def _jtree(t):
    """The same tree as JAX arrays (bfloat16 leaves through float32, which
    holds them exactly)."""
    def conv(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())
    return jax.tree.map(conv, t, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


def _bits(x):
    """A leaf's raw bytes and dtype name, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        dt = str(x.dtype).replace("torch.", "")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return np.asarray(x.numpy()).tobytes(), dt
    a = np.asarray(x)
    return a.tobytes(), str(a.dtype)


def _leaves(tree):
    return [leaf for _, leaf in ckpt._flatten(tree)]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    t = _tree()
    jckpt.save(tmp_path, 4, _jtree(t))
    step, r = ckpt.restore(tmp_path, t)
    assert step == 4
    for a, b in zip(_leaves(t), _leaves(r)):
        assert _bits(a) == _bits(b)
    manifest = json.loads((tmp_path / "step_00000004" /
                           "manifest.json").read_text())
    assert [e["key"] for e in manifest["leaves"]] == \
        [k for k, _ in ckpt._flatten(t)]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 9, t)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000009"]
    assert sorted(p.name for p in (tmp_path / "step_00000009").iterdir()) \
        == ["manifest.json", "shard_00000.npz"]
    step, r = jckpt.restore(tmp_path, _jtree(t))
    assert step == 9
    for a, b in zip(_leaves(t), jax.tree.leaves(r)):
        assert _bits(a) == _bits(b)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 3, t)
    step, r = ckpt.restore(tmp_path, t)
    assert step == 3
    for a, b in zip(_leaves(t), _leaves(r)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_keep_last_k(tmp_path):
    for s in range(6):
        ckpt.save(tmp_path, s, _tree(), keep=2)
    steps = sorted(p.name for p in tmp_path.iterdir())
    assert steps == ["step_00000004", "step_00000005"]


def test_crashed_tmp_dir_ignored(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    (tmp_path / "step_00000002.tmp").mkdir()    # a crashed mid-write
    assert ckpt.latest_step(tmp_path) == 1
    step, _ = ckpt.restore(tmp_path, _tree())
    assert step == 1
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "empty", _tree())


def test_async_checkpointer_copies_before_returning(tmp_path):
    """Writes on a thread; the leaves are copied first, so an in-place
    update right after ``save`` does not reach the checkpoint."""
    w = ckpt.AsyncCheckpointer(tmp_path, keep=3)
    t = _tree()
    for s in range(3):
        w.save(s, t)
        t["a"].add_(1.0)
    w.wait()
    assert ckpt.latest_step(tmp_path) == 2
    _, r = ckpt.restore(tmp_path, _tree())
    assert torch.equal(r["a"], torch.arange(6.0).reshape(2, 3) + 2)


def test_restore_dtype_cast_and_inplace(tmp_path):
    """Restore casts to the target tree's dtypes; ``inplace`` fills the
    target's tensors."""
    ckpt.save(tmp_path, 0, {"w": torch.full((3,), 1.5)})
    _, r = ckpt.restore(tmp_path, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"].float(), torch.full((3,), 1.5))
    target = {"w": torch.zeros(3)}
    _, r = ckpt.restore(tmp_path, target, inplace=True)
    assert r["w"] is target["w"] and float(target["w"][0]) == 1.5


def test_watchdog_detects_stale_heartbeat():
    now = [0.0]
    clock = lambda: now[0]
    dead = []
    wd = Watchdog(timeout_s=5.0, on_dead=dead.append, clock=clock)
    hbs = [Heartbeat(f"w{i}", clock) for i in range(3)]
    for hb in hbs:
        wd.register(hb)
    now[0] = 4.0
    hbs[0].beat()
    hbs[1].beat()              # w2 never beats
    now[0] = 6.0
    assert wd.check_once() == ["w2"]
    assert dead == ["w2"]
    now[0] = 20.0              # everyone stale now; w2 not re-reported
    assert sorted(wd.check_once()) == ["w0", "w1"]
    assert hbs[0].age() == 16.0


def test_straggler_detector():
    det = StragglerDetector(window=16, threshold=2.0, min_samples=4)
    for _ in range(8):
        for w in range(4):
            det.record(f"w{w}", 0.1)
        det.record("w_slow", 0.5)
    assert det.stragglers() == ["w_slow"]
    det2 = StragglerDetector(min_samples=4)
    for _ in range(3):
        det2.record("a", 0.1)
        det2.record("b", 1.0)
    assert det2.stragglers() == []          # too few samples yet


def _bundle():
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    tcfg = TrainConfig(model=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                       optimizer=OptimizerConfig(warmup_steps=2,
                                                 total_steps=30))
    return build_train_step(build_model(cfg, device="cpu"), tcfg), cfg


def test_crash_resume_matches_uninterrupted(tmp_path):
    """Crash at step 7, resume from the step-3 checkpoint (the last one
    written, every 4 steps): the final
    metrics and the final weights and moments equal the uninterrupted
    run's bit for bit."""
    bundle, cfg = _bundle()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=5))
    quiet = lambda s: None
    kw = dict(total_steps=12, ckpt_every=4, async_ckpt=False, log_fn=quiet)
    ref = resumable_train_loop(bundle, data, ckpt_dir=str(tmp_path / "ref"),
                               **kw)
    with pytest.raises(RuntimeError, match="injected failure"):
        resumable_train_loop(bundle, data, ckpt_dir=str(tmp_path / "cr"),
                             fail_at_step=7, **kw)
    lines = []
    out = resumable_train_loop(bundle, data, ckpt_dir=str(tmp_path / "cr"),
                               **dict(kw, log_fn=lines.append))
    assert lines[0].startswith("[elastic] resumed at step 4")
    assert out == ref
    _, p_ref, o_ref = elastic_restore(str(tmp_path / "ref"), bundle)
    _, p_cr, o_cr = elastic_restore(str(tmp_path / "cr"), bundle)
    want = {"params": param_tree(p_ref), "opt": o_ref}
    got = {"params": param_tree(p_cr), "opt": o_cr}
    for (ka, a), (kb, b) in zip(ckpt._flatten(want), ckpt._flatten(got)):
        assert ka == kb and torch.equal(a, b), ka


def test_resume_at_the_end_runs_nothing(tmp_path):
    bundle, cfg = _bundle()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=5))
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=2, async_ckpt=True,
              log_fn=lambda s: None)
    first = resumable_train_loop(bundle, data, total_steps=4, **kw)
    assert ckpt.latest_step(tmp_path) == 3
    assert resumable_train_loop(bundle, data, total_steps=4, **kw) == {}
    assert set(first) == {"loss", "aux_loss", "tokens", "total_loss",
                          "grad_norm", "lr"}


def test_training_cli_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` trains and
    prints the final metrics."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--device", "cpu", "--steps", "3", "--d-model", "64",
         "--num-layers", "2", "--seq-len", "32", "--global-batch", "2",
         "--ckpt-dir", str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("final: {'loss': ")
    assert ckpt.latest_step(tmp_path) is None   # ckpt_every 50 > 3 steps

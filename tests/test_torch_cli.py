"""The port's DecodeEngine and serving CLI against the reference's, on
the CPU.

Same weights (JAX-initialised, passed through ``repro_torch.interop``)
or, for the CLI, the reference's own seeded request stream: the
completions, plan counters and summary lines must be identical.  The
training launcher over a CPU grid (crash and resume, and the module as
a subprocess) and ``examples/quickstart_torch.py`` on the CPU run too.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs.base import ServeConfig
from repro_torch.serving import DecodeEngine, Request, SamplingParams
from test_torch_serving import _reqs, tiny  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import prometheus_series  # noqa: E402


def test_decode_engine_generate_matches_reference(tiny):
    """The batch-synchronous facade: loop admission, greedy; the
    reference's completions, and a bad request refused before any runs."""
    jcfg, jmodel, jparams, cfg, model, params = tiny
    jeng = JDecodeEngine(jmodel, JServeConfig(model=jcfg), max_len=64,
                         batch_slots=2)
    jeng.load(jparams)
    eng = DecodeEngine(model, ServeConfig(model=cfg), max_len=64,
                       batch_slots=2, device="cpu")
    eng.load(params)
    assert eng.engine.prefill_mode == jeng.engine.prefill_mode == "loop"
    jdone = jeng.generate(_reqs(JRequest, JSamplingParams))
    done = eng.generate(_reqs(Request, SamplingParams))
    assert [(c.tokens, c.finish_reason, c.steps) for c in done] == \
        [(c.tokens, c.finish_reason, c.steps) for c in jdone]
    assert eng.stats.launches == jeng.stats.launches
    assert eng.planned_splits() == jeng.planned_splits()
    bad = _reqs(Request, SamplingParams) + [Request(9, [])]
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate(bad)
    assert not eng.engine.has_work()


def _summary(log):
    return [x for x in log if x.startswith(
        ("paged cache:", "prefix sharing:", "frozen plans",
         "fused prefill buckets", "kv quant:"))]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(cache_layout="paged"),
    dict(cache_layout="paged", share_prefix=True),
    dict(cache_layout="paged", kv_quant="int8"),
    dict(prefill_mode="loop", policy="fa3_baseline"),
    dict(cache_layout="paged", speculate="prompt_lookup", speculate_k=3,
         max_new=24),
], ids=["dense", "paged", "paged_shared", "paged_int8", "loop_fa3",
        "paged_speculate"])
def test_run_serving_reports_the_reference_counts(kw):
    """``run_serving`` on the CPU over the reference's seeded request
    stream: the same prompts and completion lengths, and the same frozen
    plans, prefill buckets, page counts and prefix hits in the summary
    lines as the reference's ``run_serving``.  The two packages draw
    other weights from the seed, so a speculating run's counts are the
    port's own: it prints the reference's speculation line, and its
    streams are the port's spec-off streams."""
    from repro.launch.serve import run_serving as j_run_serving
    from repro_torch.launch.serve import run_serving
    kw = {"num_requests": 6, "max_new": 6, "d_model": 64, **kw}
    jlines, lines = [], []
    jouts = j_run_serving("qwen2.5-3b", log_fn=jlines.append, **kw)
    outs = run_serving("qwen2.5-3b", device="cpu", log_fn=lines.append, **kw)
    assert [c.prompt for c in outs] == [c.prompt for c in jouts]
    assert [len(c.tokens) for c in outs] == [len(c.tokens) for c in jouts]
    assert _summary(lines) == _summary(jlines)
    if kw.get("share_prefix"):
        assert "prefix sharing: 5 hits" in _summary(lines)[2]
    if kw.get("speculate"):
        head = "speculation (prompt_lookup, k=3): "
        spec = [x for x in lines if x.startswith(head)]
        assert len(spec) == 1 and "verify plans [(" in spec[0]
        assert any(x.startswith(head) for x in jlines)
        plain = {k: v for k, v in kw.items() if not k.startswith("spec")}
        assert [c.tokens for c in run_serving(
            "qwen2.5-3b", device="cpu", log_fn=lambda line: None,
            **plain)] == [c.tokens for c in outs]


@pytest.mark.parametrize("kw", [dict(), dict(cache_layout="paged")],
                         ids=["dense", "paged"])
def test_run_serving_mesh_reports_the_reference_counts(kw):
    """``run_serving(mesh="1,1")``, the port's over a grid of the CPU and
    the reference's over its one host device: the same prompts and
    completion lengths, the same summary lines, and the same topology
    and per-shard lines but for the fingerprint's device part."""
    from repro.launch.serve import run_serving as j_run_serving
    from repro_torch.launch.serve import run_serving
    kw = {"num_requests": 5, "max_new": 4, "d_model": 64, "mesh": "1,1",
          "batch_slots": 2, **kw}
    jlines, lines = [], []
    jouts = j_run_serving("qwen2.5-3b", log_fn=jlines.append, **kw)
    outs = run_serving("qwen2.5-3b", device="cpu", log_fn=lines.append, **kw)
    assert [c.prompt for c in outs] == [c.prompt for c in jouts]
    assert [len(c.tokens) for c in outs] == [len(c.tokens) for c in jouts]
    assert _summary(lines) == _summary(jlines)

    def shard_lines(log):
        out = [x for x in log if x.startswith(("shard topology", "  shard"))]
        return [re.sub(r"(shard\.[0-9a-f]{12})\.[^)]*\)", r"\1)", x)
                for x in out]
    assert len(shard_lines(lines)) == 2
    assert shard_lines(lines) == shard_lines(jlines)


@pytest.mark.parametrize("kw", [dict(), dict(cache_layout="paged",
                                            kv_quant="int8")],
                         ids=["dense", "paged_int8"])
def test_run_serving_mla_reports_the_reference_counts(kw):
    """``run_serving("minicpm3-4b")`` on the CPU: the reference's prompts,
    completion lengths and summary lines (frozen plans at H_KV 1, fused
    prefill buckets, pages, the int8 plan family).  The port keeps the
    full config's latent ranks (a 288-wide latent row where the reduced
    config's is 40 wide), which only the weights and the cache's bytes
    see: the paged line's bytes are the port's own."""
    from repro.launch.serve import run_serving as j_run_serving
    from repro_torch.launch.serve import run_serving
    kw = {"num_requests": 4, "max_new": 4, "d_model": 64, **kw}
    jlines, lines = [], []
    jouts = j_run_serving("minicpm3-4b", log_fn=jlines.append, **kw)
    outs = run_serving("minicpm3-4b", device="cpu", log_fn=lines.append,
                       **kw)
    assert [c.prompt for c in outs] == [c.prompt for c in jouts]
    assert [len(c.tokens) for c in outs] == [len(c.tokens) for c in jouts]
    nbytes = re.compile(r" \((\d+) B vs dense (\d+) B\)")
    assert [nbytes.sub("", x) for x in _summary(lines)] == \
        [nbytes.sub("", x) for x in _summary(jlines)]
    assert any(x.startswith("fused prefill buckets") for x in lines)
    for x in _summary(lines):
        if nbytes.search(x):     # 2 layers x 4 slots x 256 rows, bf16
            assert int(nbytes.search(x)[2]) == 2 * 4 * 256 * 288 * 2


def test_run_serving_measured_policy_writes_stats(tmp_path):
    """``run_serving`` with ``policy="measured"`` on the committed
    reference table, in both packages: the port prints the reference's
    "measured policy" and stats lines and writes a snapshot with the
    reference's keys.  The port looks up its own ``cuda`` family, which
    the reference's table does not hold, so every lookup is a counted
    fallback to ``paper`` and the frozen plans are ``paper``'s."""
    from repro.launch.serve import run_serving as j_run_serving
    from repro_torch.launch.serve import run_serving
    from repro_torch.tune import REFERENCE_TABLE_PATH
    kw = dict(num_requests=4, max_new=4, d_model=64, policy="measured",
              tune_table=REFERENCE_TABLE_PATH)
    jstats, stats = tmp_path / "j.json", tmp_path / "t.json"
    jlines, lines, plain = [], [], []
    j_run_serving("qwen2.5-3b", log_fn=jlines.append, stats_path=jstats,
                  **kw)
    outs = run_serving("qwen2.5-3b", device="cpu", log_fn=lines.append,
                       stats_path=stats, **kw)
    assert len(outs) == 4 and all(len(c.tokens) == 4 for c in outs)
    snap, jsnap = (json.loads(p.read_text()) for p in (stats, jstats))
    assert set(snap) == set(jsnap)
    assert snap["policy"] == "measured"
    assert snap["table_version"] == jsnap["table_version"] == \
        "2.2cfa2296473e"
    assert snap["measured_lookups"] == snap["measured_fallbacks"] >= 1
    assert jsnap["measured_lookups"] >= 1
    assert jsnap["measured_fallbacks"] == 0
    head = "measured policy: table 2.2cfa2296473e, "
    n = snap["measured_lookups"]
    assert f"{head}{n} lookups, {n} fallbacks to 'paper'" in lines
    assert any(x.startswith(head) for x in jlines)
    assert f"plan-cache stats snapshot: {stats}" in lines
    run_serving("qwen2.5-3b", device="cpu", log_fn=plain.append,
                **dict(kw, policy="paper", tune_table=None))
    frozen = [x for x in lines if x.startswith("frozen plans")]
    assert frozen == [x for x in plain if x.startswith("frozen plans")]


def test_serve_module_runs_and_refuses_unported_flags(tmp_path):
    """``python -m repro_torch.launch.serve`` runs on the CPU and prints
    the reference's summary wording, also sampled and speculating;
    ``--policy measured --tune-table --stats-path`` serves from a table
    and writes the snapshot; ``--mesh`` serves a topology over the
    repeated ``--device`` and refuses a malformed one with the
    reference's message."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve",
            "--arch", "qwen2.5-3b", "--device", "cpu", "--requests", "3",
            "--max-new", "3"]
    out = subprocess.run(base + ["--cache-layout", "paged",
                                 "--share-prefix", "--stream"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "policy=paper: 3 requests, 9 tokens" in out.stdout
    assert "prefix sharing: 2 hits" in out.stdout
    assert "req 0 finished (length)" in out.stdout
    out = subprocess.run(base + ["--arch", "stablelm-12b", "--speculate",
                                 "ngram", "--temperature", "0.8"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "policy=paper: 3 requests, 9 tokens" in out.stdout
    assert "speculation (ngram, k=4): " in out.stdout
    table = ROOT / "experiments" / "tune" / "reference_reduced.json"
    out = subprocess.run(base + ["--policy", "measured", "--tune-table",
                                 str(table), "--stats-path", "s.json"],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "measured policy: table 2.2cfa2296473e, " in out.stdout
    assert json.loads((tmp_path / "s.json").read_text())["policy"] == \
        "measured"
    out = subprocess.run(base + ["--mesh", "2,2", "--slots", "1"],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "policy=paper: 3 requests, 9 tokens" in out.stdout
    assert "shard topology dp=2 x sp=2 (2 slots over 4 devices" \
        in out.stdout
    bad = subprocess.run(base + ["--mesh", "2,2,2"], capture_output=True,
                         text=True, env=env, timeout=120)
    assert bad.returncode == 1
    assert "positional shard topology takes 'dp' or 'dp,sp'" in bad.stderr


def test_serve_module_writes_trace_and_metrics_for_moe(tmp_path):
    """``--arch granite-moe-3b-a800m --trace t.json --metrics m.prom`` on
    the CPU: exit 0, the reference's two artifact lines, a trace that
    validates with one request span a request, and Prometheus text that
    parses, with 3 TTFT samples and the plan-cache counters."""
    from repro_torch.obs import TraceArtifact, validate_trace
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-moe-3b-a800m", "--device", "cpu", "--requests", "3",
         "--max-new", "3", "--slots", "2",
         "--trace", "t.json", "--metrics", "m.prom"],
        capture_output=True, text=True, env=env, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "policy=paper: 3 requests, 9 tokens" in out.stdout
    assert "request-lifecycle trace (load at https://ui.perfetto.dev): " \
        "t.json" in out.stdout
    assert "serving metrics snapshot: m.prom" in out.stdout
    trace = json.loads((tmp_path / "t.json").read_text())
    validate_trace(trace)
    art = TraceArtifact(trace["traceEvents"])
    assert len(art.spans("request")) == 3
    assert len(art.spans("prefill", cat="launch")) == 3
    prom = prometheus_series((tmp_path / "m.prom").read_text())
    assert prom["repro_ttft_ms_count"] == 3
    assert prom["repro_tokens_total"] == 9
    assert prom['repro_requests_finished_total{reason="length"}'] == 3
    assert prom["repro_plan_cache_total_launches"] == \
        len(art.spans(cat="launch"))


def test_run_serving_trace_matches_the_references_shape(tmp_path):
    """``run_serving`` with ``trace_path`` and ``metrics_path`` (JSON) on
    reduced granite-moe-3b-a800m in both packages: the reference's
    artifact lines, and the same spans and launches by name (the
    request stream and completion lengths are the reference's, the
    weights each package's own)."""
    from repro.launch.serve import run_serving as j_run_serving
    from repro_torch.launch.serve import run_serving
    kw = dict(num_requests=4, max_new=4, d_model=64, batch_slots=2)
    arts, lines = [], []
    for pkg, fn in (("j", j_run_serving), ("t", run_serving)):
        log = []
        extra = {} if pkg == "j" else dict(device="cpu")
        fn("granite-moe-3b-a800m", log_fn=log.append,
           trace_path=tmp_path / f"{pkg}.json",
           metrics_path=tmp_path / f"{pkg}_m.json", **kw, **extra)
        arts.append(json.loads((tmp_path / f"{pkg}.json").read_text()))
        lines.append([x.replace(f"{pkg}.json", "T").replace(
            f"{pkg}_m.json", "M") for x in log if x.startswith(
                ("request-lifecycle trace", "serving metrics snapshot"))])
    assert lines[0] == lines[1] and len(lines[0]) == 2

    def shape(trace):
        return sorted((e["name"], e["ph"], e.get("cat"))
                      for e in trace["traceEvents"])
    assert shape(arts[0]) == shape(arts[1])
    snaps = [json.loads((tmp_path / f"{p}_m.json").read_text())
             for p in ("j", "t")]
    assert snaps[0]["metrics"].keys() == snaps[1]["metrics"].keys()
    for name in ("tokens_total", "requests_finished_total",
                 "requests_submitted_total"):
        assert snaps[0]["metrics"][name]["series"] == \
            snaps[1]["metrics"][name]["series"]


# ---------------------------------------------------------------------------
# training over a grid, and the examples
# ---------------------------------------------------------------------------


def test_run_training_over_a_grid_resumes(tmp_path):
    """``run_training`` at model axis 2 over four CPU devices (a (2, 2)
    grid): three steps, crashed at step 2 and resumed from the step-1
    checkpoint onto the same grid, end at the uninterrupted run's
    metrics bit for bit."""
    from repro_torch.launch.train import run_training
    kw = dict(steps=3, d_model=32, num_layers=2, seq_len=16,
              global_batch=4, model_axis=2, devices=["cpu"] * 4,
              ckpt_every=2, remat_policy="nothing_saveable")
    whole = run_training("qwen2.5-3b", ckpt_dir=str(tmp_path / "whole"),
                         log_fn=lambda line: None, **kw)
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        run_training("qwen2.5-3b", ckpt_dir=str(tmp_path / "crash"),
                     fail_at_step=2, log_fn=lambda line: None, **kw)
    lines = []
    resumed = run_training("qwen2.5-3b", ckpt_dir=str(tmp_path / "crash"),
                           log_fn=lines.append, **kw)
    assert lines[0] == "[elastic] resumed at step 2 on mesh (2, 2)"
    assert resumed == whole and set(whole) == {
        "loss", "aux_loss", "tokens", "total_loss", "grad_norm", "lr"}


def test_run_training_grid_takes_its_data_axis(tmp_path, monkeypatch):
    """With ``data_axis`` set the grid is the first data x model devices
    of the list (here eight stand-in visible devices: (2, 2), not
    (4, 2)), and a list that is too short raises."""
    from repro_torch.launch import train as train_mod
    monkeypatch.setattr(train_mod, "visible_devices",
                        lambda: (torch.device("cpu"),) * 8)
    kw = dict(d_model=32, num_layers=2, seq_len=16, global_batch=4,
              model_axis=2, data_axis=2, ckpt_every=1,
              ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="needs 4 devices, 2 given"):
        train_mod.run_training("qwen2.5-3b", steps=1,
                               devices=["cpu"] * 2, **kw)
    train_mod.run_training("qwen2.5-3b", steps=1, log_fn=lambda line: None,
                           **kw)
    lines = []
    train_mod.run_training("qwen2.5-3b", steps=2, log_fn=lines.append, **kw)
    assert lines[0] == "[elastic] resumed at step 1 on mesh (2, 2)"


def test_train_module_runs_over_a_cpu_grid(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --data-axis 2
    --model-axis 2`` trains and prints the final metrics."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--device", "cpu", "--data-axis", "2",
         "--model-axis", "2", "--steps", "2", "--d-model", "32",
         "--num-layers", "2", "--seq-len", "16", "--global-batch", "4",
         "--ckpt-dir", str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("final: {'loss': ")


def test_quickstart_example_runs_on_the_cpu():
    """``examples/quickstart_torch.py --device cpu``: the policy demo, 4
    training steps over a (2, 2) CPU grid, then serving, ending with its
    OK line.  Two intra-op threads: the suite's workers share the
    machine's cores, and a subprocess that takes them all crawls."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "examples/quickstart_torch.py", "--device", "cpu",
         "--steps", "4", "--data-axis", "2", "--model-axis", "2"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "quickstart OK"
    assert any(x.startswith("  final loss ") for x in lines)
    assert sum(x.startswith("  req ") for x in lines) == 5

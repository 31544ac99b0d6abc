"""The port's DecodeEngine and serving CLI against the reference's, on
the CPU.

Same weights (JAX-initialised, passed through ``repro_torch.interop``)
or, for the CLI, the reference's own seeded request stream: the
completions, plan counters and summary lines must be identical.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs.base import ServeConfig as JServeConfig
from repro.serving import DecodeEngine as JDecodeEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs.base import ServeConfig
from repro_torch.serving import DecodeEngine, Request, SamplingParams
from test_torch_serving import _reqs, tiny  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


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
    the reference's summary wording, also sampled and speculating; flags
    for what the port does not serve yet (tracing, metrics, mesh) are not
    in its parser, and ``--policy measured --tune-table --stats-path``
    serves from a table and writes the snapshot."""
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
    for flag in (["--trace", "t.json"], ["--mesh", "1,1"],
                 ["--metrics", "m.json"]):
        bad = subprocess.run(base + flag, capture_output=True, text=True,
                             env=env, timeout=120)
        assert bad.returncode == 2, flag
        assert "unrecognized arguments" in bad.stderr, flag

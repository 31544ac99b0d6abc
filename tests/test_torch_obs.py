"""The port's observability (``repro_torch.obs``) against the reference's
``repro.obs``, on the CPU.

The reference's ``tests/test_obs.py`` cases run on the port's package:
metrics instruments and Prometheus text, the tracer and its schema gate,
atomic writes, plan provenance, the disabled ``NULL_OBSERVER``, the
observer lifecycle and shard views, the engine's traces, dumps and
structured warnings, and tracing on and off giving the same tokens and
stats.  Then the two engines run one script each with a fake clock
(reduced qwen2.5-3b in float32, one set of JAX-initialised weights):
both write the same trace events and the same metrics snapshot.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.models import build_model as j_build_model
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import ObsConfig as JObsConfig
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.spec import SpecConfig as JSpecConfig
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.obs import (
    NULL_OBSERVER,
    MetricsRegistry,
    NullObserver,
    ObsConfig,
    TraceArtifact,
    Tracer,
    atomic_write_json,
    atomic_write_text,
    plan_provenance,
    validate_trace,
)
from repro_torch.obs.metrics import _percentile
from repro_torch.plan import AttentionSpec, Planner
from repro_torch.serving import (
    GreedySampler,
    Request,
    SamplingParams,
    ServingEngine,
)
from repro_torch.spec import SpecConfig
from repro_torch.tune import REFERENCE_TABLE_PATH

F32 = dict(dtype="float32", param_dtype="float32")
# prompts the n-gram drafter drafts well (tests/test_torch_spec.py's)
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [1, 2, 3, 4, 1, 2, 3],
           [9, 9, 8, 9, 9, 8, 9], [2, 4, 6, 8, 2, 4, 6, 8, 2]]
SHARED = [(3 * j) % 40 + 11 for j in range(16)]


class FakeClock:
    """Deterministic monotonic clock: +1 ms per reading."""

    def __init__(self, step: float = 1e-3):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


@pytest.fixture(scope="module")
def pair():
    """Reduced qwen2.5-3b (2 layers, d_model 32) in float32 in both
    packages, with one set of JAX-initialised weights."""
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2,
                            d_model=32).replace(**F32)
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32).replace(
        **F32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jmodel.init_params(jax.random.PRNGKey(0)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


def _reqs(cls=Request, sp_cls=SamplingParams, prompts=PROMPTS,
          max_new=(6, 4, 8, 5), spec=None):
    return [cls(i, list(p), max_new_tokens=m, sampling=sp_cls(
        speculation=spec)) for i, (p, m) in enumerate(zip(prompts, max_new))]


def _serve(pair, reqs, *, obs=None, max_len=64, slots=2, **scfg_kw):
    """The port's engine over ``reqs`` (greedy, float32 cache)."""
    cfg, model, params = pair[3:]
    eng = ServingEngine(model, ServeConfig(model=cfg,
                                           kv_cache_dtype="float32",
                                           **scfg_kw),
                        max_len=max_len, batch_slots=slots,
                        sampler=GreedySampler(), obs=obs, device="cpu")
    eng.load(params)
    for r in reqs:
        eng.submit(r)
    return eng, eng.drain()


def _fake_obs(pkg=ObsConfig):
    return pkg(trace=True, metrics=True, clock=FakeClock()).resolve()


# ---------------------------------------------------------------------------
# metrics: instruments, families, registry, prometheus exposition
# ---------------------------------------------------------------------------


def test_percentile_matches_numpy_interpolation():
    samples = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0]
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        assert _percentile(samples, q) == pytest.approx(
            float(np.percentile(samples, 100 * q)))
    assert _percentile([], 0.5) == 0.0


def test_histogram_snapshot_counts_sum_and_cumulative_buckets():
    m = MetricsRegistry()
    h = m.histogram("lat_ms", "latency", buckets=(1.0, 10.0, 100.0))
    for x in (0.5, 5.0, 5.0, 50.0, 5000.0):
        h.observe(x)
    s = m.snapshot()["lat_ms"]
    assert s["kind"] == "histogram"
    agg = s["aggregate"]
    assert agg["count"] == 5
    assert agg["sum"] == pytest.approx(5060.5)
    assert agg["min"] == 0.5 and agg["max"] == 5000.0
    assert agg["buckets"] == {"1": 1, "10": 3, "100": 4, "+Inf": 5}
    assert agg["p50"] == pytest.approx(5.0)


def test_registry_memoizes_families_and_rejects_kind_mismatch():
    m = MetricsRegistry()
    assert m.counter("a", "one") is m.counter("a")
    with pytest.raises(ValueError, match="already registered"):
        m.gauge("a")


def test_family_label_series_and_aggregate_merge():
    m = MetricsRegistry()
    c = m.counter("launches_total", "launches")
    c.inc(3, shard="0")
    c.inc(4, shard="1")
    snap = m.snapshot()["launches_total"]
    assert snap["series"] == {"shard=0": 3, "shard=1": 4}
    assert snap["aggregate"] == 7
    h = m.histogram("t_ms", "t", buckets=(10.0,))
    h.observe(1.0, shard="0")
    h.observe(100.0, shard="1")
    agg = m.snapshot()["t_ms"]["aggregate"]
    assert agg["count"] == 2 and agg["buckets"] == {"10": 1, "+Inf": 2}


def test_prometheus_text_exposition_format():
    m = MetricsRegistry()
    m.counter("tokens_total", "tokens").inc(5)
    m.histogram("ttft_ms", "ttft", buckets=(10.0, 100.0)) \
        .observe(50.0, shard="0")
    text = m.prometheus()
    assert "# HELP repro_tokens_total tokens" in text
    assert "# TYPE repro_tokens_total counter" in text
    assert "repro_tokens_total 5" in text
    assert 'repro_ttft_ms_bucket{shard="0",le="10"} 0' in text
    assert 'repro_ttft_ms_bucket{shard="0",le="100"} 1' in text
    assert 'repro_ttft_ms_bucket{shard="0",le="+Inf"} 1' in text
    assert 'repro_ttft_ms_sum{shard="0"} 50' in text
    assert 'repro_ttft_ms_count{shard="0"} 1' in text


def test_registry_snapshot_and_prometheus_equal_the_references():
    """The same instrument calls on both packages' registries give the
    same JSON snapshot and the same Prometheus text."""
    rng = np.random.default_rng(0)
    xs = rng.exponential(40.0, size=200).tolist()
    snaps, texts = [], []
    for cls in (MetricsRegistry, JMetricsRegistry):
        m = cls()
        h = m.histogram("ttft_ms", "ttft")
        c = m.counter("launches_total", "launches")
        g = m.gauge("slots_live", "slots")
        for i, x in enumerate(xs):
            h.observe(x, kind=("decode", "prefill")[i % 2])
            c.inc(1 + i % 3, kind="decode")
            g.set(i % 4)
        snaps.append(m.snapshot())
        texts.append(m.prometheus())
    assert snaps[0] == snaps[1]
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# tracer + TraceArtifact + validate_trace (the schema gate)
# ---------------------------------------------------------------------------


def test_tracer_roundtrip_and_helpers(tmp_path):
    tr = Tracer()
    tr.ensure_process(0, "serve")
    tr.ensure_process(0, "serve")               # idempotent
    tr.ensure_thread(0, 1, "req0")
    tr.complete(0, 1, "request", "request", 10, 100, {"tokens": 3})
    tr.complete(0, 1, "admit", "request", 20, 30)
    tr.instant(0, 1, "first_token", "request", 60)
    art = tr.artifact()
    assert sum(e["ph"] == "M" for e in art.events) == 2  # proc + thread
    art.validate()
    p = tmp_path / "trace.json"
    art.save(p)
    back = TraceArtifact.load(p)
    assert back.events == art.events
    assert len(back.spans("admit")) == 1
    assert len(back.spans(cat="request")) == 2
    assert back.instants("first_token")[0]["ts"] == 60


@pytest.mark.parametrize("mutate, msg", [
    (lambda o: o.pop("traceEvents"), "traceEvents"),
    (lambda o: o["traceEvents"].append({"ph": "X"}), "missing/invalid"),
    (lambda o: o["traceEvents"].append(
        {"name": "x", "ph": "Q", "pid": 0, "tid": 0, "ts": 0}),
     "unknown ph"),
    (lambda o: o["traceEvents"].append(
        {"name": "x", "ph": "X", "pid": 0, "tid": 0, "ts": -1, "dur": 1}),
     "negative ts"),
    (lambda o: o["traceEvents"].append(
        {"name": "x", "ph": "X", "pid": 0, "tid": 0, "ts": 0}),
     "dur >= 0"),
    (lambda o: o["traceEvents"].append(
        {"name": "bogus", "ph": "M", "pid": 0, "tid": 0, "ts": 0,
         "args": {"name": "n"}}), "metadata"),
])
def test_validate_trace_rejects_schema_violations(mutate, msg):
    obj = {"traceEvents": []}
    mutate(obj)
    with pytest.raises(ValueError, match=msg):
        validate_trace(obj)


def test_validate_trace_rejects_partial_overlap_but_allows_nesting():
    def span(name, ts, dur):
        return {"name": name, "ph": "X", "pid": 0, "tid": 1,
                "ts": ts, "dur": dur}
    validate_trace({"traceEvents": [span("parent", 0, 100),
                                    span("a", 10, 20),
                                    span("b", 40, 50)]})
    with pytest.raises(ValueError, match="partially overlaps"):
        validate_trace({"traceEvents": [span("parent", 0, 100),
                                        span("bad", 10, 110)]})


# ---------------------------------------------------------------------------
# atomic artifact writes
# ---------------------------------------------------------------------------


def test_atomic_write_replaces_and_leaves_no_temp(tmp_path):
    p = tmp_path / "deep" / "stats.json"
    atomic_write_json(p, {"a": 1})
    atomic_write_json(p, {"a": 2})
    assert json.loads(p.read_text()) == {"a": 2}
    atomic_write_text(tmp_path / "m.prom", "x 1\n")
    assert (tmp_path / "m.prom").read_text() == "x 1\n"
    leftovers = list(tmp_path.rglob("*.tmp"))
    assert not leftovers, f"temp files left behind: {leftovers}"


def test_atomic_write_failure_preserves_existing_file(tmp_path):
    p = tmp_path / "stats.json"
    atomic_write_json(p, {"ok": True})
    with pytest.raises(TypeError):
        atomic_write_json(p, {"bad": object()})
    assert json.loads(p.read_text()) == {"ok": True}
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# plan provenance + ObsConfig resolution
# ---------------------------------------------------------------------------


def test_plan_provenance_always_carries_acceptance_keys():
    plan = Planner(policy="paper").plan(
        AttentionSpec.decode(2, 256, 16, 1, 64), bucket=256)
    d = plan_provenance(("verify", 2, 256), plan)
    assert d["key"] == "verify/2/256"
    assert d["num_splits"] == plan.num_splits
    assert d["kv_dtype"] == "bfloat16"
    assert d["policy"] == "paper" and d["bucket"] == 256
    # a plan made without a mesh: null, not absent
    assert d["mesh_splits"] is None and d["seq_shard_axis"] is None
    assert "table_version" in d
    d0 = plan_provenance(None, None)
    assert d0["key"] == "fallback"
    for k in ("num_splits", "mesh_splits", "kv_dtype", "table_version"):
        assert d0[k] is None


def test_obsconfig_disabled_resolves_to_null_singleton():
    obs = ObsConfig().resolve()
    assert obs is NULL_OBSERVER and not obs.enabled
    obs.on_submit(0, 0, 1)
    obs.on_launch("decode", None, None, 0)
    assert obs.metrics_snapshot() == {} and obs.prometheus() == ""
    assert obs.shard_view(3) is obs
    on = ObsConfig(trace=True).resolve()
    assert on.enabled and on.tracer is not None and on.metrics is None
    assert ObsConfig(metrics_path="x.json").resolve().metrics is not None


# ---------------------------------------------------------------------------
# Observer lifecycle on a fake clock (deterministic spans + metrics)
# ---------------------------------------------------------------------------


def test_observer_lifecycle_spans_and_metrics():
    obs = _fake_obs()
    obs.on_submit(0, 7, 5)
    obs.on_admit_start(0)
    t0 = obs.now_us()
    obs.on_launch("prefill", ("prefill", 128), None, t0, handles=(0,))
    obs.on_admit_end(0, "full")
    obs.on_token(0, 0)
    obs.on_token(0, 1)
    obs.on_finish(0, "length")
    art = obs.tracer.artifact()
    art.validate()
    req = art.spans("request")[0]
    qw, admit = art.spans("queue_wait")[0], art.spans("admit")[0]
    for child in (qw, admit, art.spans("prefill", cat="step")[0]):
        assert req["ts"] <= child["ts"]
        assert child["ts"] + child["dur"] <= req["ts"] + req["dur"]
    assert req["args"] == {"request_id": 7, "prompt_len": 5,
                           "prefill": "full", "finish_reason": "length",
                           "tokens": 2}
    assert art.instants("first_token")
    launch = art.spans("prefill", cat="launch")[0]
    assert launch["tid"] == 0 and launch["args"]["key"] == "prefill/128"
    mx = obs.metrics_snapshot()["metrics"]
    assert mx["requests_submitted_total"]["aggregate"] == 1
    assert mx["requests_finished_total"]["series"] == {"reason=length": 1}
    assert mx["tokens_total"]["aggregate"] == 2
    assert mx["ttft_ms"]["aggregate"]["count"] == 1
    assert mx["tpot_ms"]["aggregate"]["count"] == 1
    assert mx["queue_wait_ms"]["aggregate"]["count"] == 1
    assert mx["ttft_ms"]["aggregate"]["sum"] > \
        mx["queue_wait_ms"]["aggregate"]["sum"]


def test_shard_views_share_one_clock_and_label_series():
    obs = _fake_obs()
    v0, v1 = obs.shard_view(0), obs.shard_view(1)
    seq = [v0.now_us(), v1.now_us(), obs.now_us(), v1.now_us()]
    assert seq == sorted(seq), "shard views must merge on one timeline"
    v0.on_submit(0, 0, 3)
    v1.on_submit(0, 1, 3)
    v0.on_token(0, 0)
    v1.on_token(0, 0)
    mx = obs.metrics_snapshot()["metrics"]
    sub = mx["requests_submitted_total"]
    assert sub["series"]["shard=0"] == 1 and sub["series"]["shard=1"] == 1
    assert sub["aggregate"] == 2
    pids = {e["pid"] for e in obs.tracer.artifact().events}
    assert {0, 1} <= pids


def test_prometheus_absorbs_plan_cache_scalars():
    obs = ObsConfig(metrics=True, clock=FakeClock()).resolve()
    text = obs.prometheus({"hits": 3, "misses": 1, "policy": "paper"})
    assert "repro_plan_cache_hits 3" in text
    assert "repro_plan_cache_misses 1" in text
    assert "policy" not in text.split("repro_plan_cache_")[-1]
    sharded = obs.prometheus({
        "shards": [{"shard": 0, "hits": 2}, {"shard": 1, "hits": 5}],
        "aggregate": {"hits": 7}})
    assert 'repro_plan_cache_hits{shard="0"} 2' in sharded
    assert 'repro_plan_cache_hits{shard="1"} 5' in sharded
    assert "repro_plan_cache_hits 7" in sharded


# ---------------------------------------------------------------------------
# engine integration: deterministic traces, bit-identity, dumps
# ---------------------------------------------------------------------------


def test_engine_trace_is_deterministic_under_fake_clock(pair):
    runs = []
    for _ in range(2):
        obs = _fake_obs()
        _serve(pair, _reqs(), obs=obs, prefill_mode="fused")
        runs.append(obs)
    a, b = runs
    ea = a.tracer.artifact()
    assert ea.events == b.tracer.artifact().events
    ea.validate()
    assert len(ea.spans("request")) == 4
    for sp in ea.spans(cat="launch"):
        for k in ("key", "num_splits", "mesh_splits", "kv_dtype",
                  "table_version"):
            assert k in sp["args"], f"launch span missing {k}"
    assert {"prefill", "decode"} <= {sp["name"]
                                     for sp in ea.spans(cat="launch")}
    assert a.metrics_snapshot() == b.metrics_snapshot()


def test_disabled_engine_holds_the_null_observer(pair, tmp_path,
                                                monkeypatch):
    """No path set: NULL_OBSERVER, whose hooks and clock the engine never
    calls (it branches on ``enabled``), and nothing written.  An injected
    observer is used but not dumped: its injector owns the artifacts."""
    def boom(*a, **k):
        raise AssertionError("a disabled observer was called")
    for name in ("now_us", "on_submit", "on_admit_start", "on_admit_end",
                 "on_launch", "on_token", "on_finish", "on_warning",
                 "sample_occupancy", "dump"):
        monkeypatch.setattr(NullObserver, name, boom)
    eng, _ = _serve(pair, _reqs(spec=SpecConfig(method="ngram", k=4)),
                    cache_layout="paged", cache_page_size=16)
    assert eng._obs is NULL_OBSERVER and not eng._owns_obs
    monkeypatch.undo()
    obs = _fake_obs()
    eng, _ = _serve(pair, _reqs(), obs=obs,
                    trace_path=str(tmp_path / "t.json"))
    assert eng._obs is obs and not eng._owns_obs
    assert not (tmp_path / "t.json").exists()
    assert len(obs.tracer.artifact().spans("request")) == 4


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("spec", [None, "ngram"])
def test_tracing_on_off_bit_identical(pair, layout, spec):
    """Greedy streams, finish reasons, PlanCacheStats, launch counts and
    policy evaluations (0) are the same with tracing and metrics on and
    off."""
    kw = dict(cache_layout=layout, cache_page_size=16)
    knob = SpecConfig(method=spec, k=4) if spec else None
    news = (16, 12, 16, 14)
    out = []
    for obs in (None, _fake_obs()):
        ops.reset_policy_eval_count()
        ops.reset_launch_counts()
        eng, done = _serve(pair, _reqs(max_new=news, spec=knob), obs=obs,
                           **kw)
        out.append(([c.tokens for c in done],
                    [c.finish_reason for c in done], eng.stats.to_json(),
                    ops.launch_counts(), ops.policy_eval_count()))
        if obs is not None:
            obs.tracer.artifact().validate()
    assert out[0] == out[1]
    assert out[0][4] == 0
    if spec:
        assert out[0][2]["spec_steps"] > 0


def test_engine_owned_dump_writes_both_artifacts(pair, tmp_path):
    _serve(pair, _reqs(),
           stats_path=str(tmp_path / "stats.json"),
           trace_path=str(tmp_path / "trace.json"),
           metrics_path=str(tmp_path / "metrics.prom"))
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["policy"] == "paper"
    validate_trace(json.loads((tmp_path / "trace.json").read_text()))
    prom = (tmp_path / "metrics.prom").read_text()
    assert "# TYPE repro_ttft_ms histogram" in prom
    assert "repro_plan_cache_total_launches" in prom
    assert not list(tmp_path.glob("*.tmp"))
    _serve(pair, _reqs(), metrics_path=str(tmp_path / "metrics.json"))
    snap = json.loads((tmp_path / "metrics.json").read_text())
    assert snap["metrics"]["ttft_ms"]["aggregate"]["count"] == 4
    assert snap["plan_cache"]["policy"] == "paper"


# ---------------------------------------------------------------------------
# structured warning events (exactly once, the python warning kept)
# ---------------------------------------------------------------------------


def test_len_capacity_warning_fires_exactly_once(pair):
    obs = _fake_obs()
    reqs = [Request(i, [7, 8, 9], max_new_tokens=64) for i in range(2)]
    with pytest.warns(RuntimeWarning, match="KV cache capacity"):
        _, outs = _serve(pair, reqs, obs=obs, max_len=16)
    assert all(c.finish_reason == "cache_capacity" for c in outs)
    warn = obs.metrics_snapshot()["metrics"]["engine_warnings_total"]
    assert warn["series"] == {"code=len_capacity": 1}
    assert len(obs.tracer.artifact().instants("warning:len_capacity")) == 1


def test_page_capacity_warning_fires_exactly_once(pair):
    """Two requests outgrow a 6-page pool of 4-row pages mid-generation:
    one python warning and one structured event, however many
    exhaustions follow."""
    obs = _fake_obs()
    reqs = [Request(i, [7, 8, 9, 10, 11], max_new_tokens=40)
            for i in range(3)]
    with pytest.warns(RuntimeWarning, match="exhausted the KV page pool"):
        _, outs = _serve(pair, reqs, obs=obs, cache_layout="paged",
                         cache_page_size=4, cache_page_budget=6,
                         seqlen_bucket=16)
    assert sum(c.finish_reason == "cache_capacity" for c in outs) >= 2
    warn = obs.metrics_snapshot()["metrics"]["engine_warnings_total"]
    assert warn["series"] == {"code=page_capacity": 1}
    assert len(obs.tracer.artifact().instants("warning:page_capacity")) == 1
    gauges = obs.metrics_snapshot()["metrics"]
    assert gauges["pages_total"]["aggregate"] == 6


def test_registry_fallback_warning_fires_exactly_once(pair, tmp_path):
    cfg, model = pair[3], pair[4]
    for name, backend, device in (("a_tpu.json", "tpu", "TPU v5e"),
                                  ("b_gpu.json", "gpu", "H100")):
        d = json.loads(REFERENCE_TABLE_PATH.read_text())
        d["fingerprint"]["backend"] = backend
        d["fingerprint"]["device"] = device
        (tmp_path / name).write_text(json.dumps(d))
    obs = _fake_obs()
    with pytest.warns(RuntimeWarning, match="no table in registry"):
        eng = ServingEngine(
            model, ServeConfig(model=cfg, split_policy="measured",
                               tune_table_path=str(tmp_path)),
            max_len=64, batch_slots=1, obs=obs, device="cpu")
    assert eng.stats.table_registry_fallbacks == 1
    warn = obs.metrics_snapshot()["metrics"]["engine_warnings_total"]
    assert warn["series"] == {"code=table_registry_fallback": 1}
    assert len(obs.tracer.artifact()
               .instants("warning:table_registry_fallback")) == 1


# ---------------------------------------------------------------------------
# parity: the same script through both engines, each on a fake clock
# ---------------------------------------------------------------------------

# launch-span args the two packages may stamp differently, with why
ALLOWED_ARG_DIFFS = {
    # the reference stamps a plan's mesh_splits, 1 on one device; the
    # port stamps it only on a plan made for a mesh, null otherwise
    "mesh_splits": "the port stamps mesh_splits on mesh plans only",
}


def _strip(events):
    out = []
    for e in events:
        e = dict(e)
        if e.get("cat") == "launch":
            e["args"] = {k: v for k, v in e["args"].items()
                         if k not in ALLOWED_ARG_DIFFS}
        out.append(e)
    return out


@pytest.mark.parametrize("case", ["fused", "loop", "share_prefix",
                                  "ngram"])
def test_trace_and_metrics_match_the_reference(pair, case):
    """4 requests over 2 slots, greedy, float32 cache, each engine with
    its own fake clock: the same trace events (name, cat, ph, ts, dur,
    pid, tid, args; launch args but ALLOWED_ARG_DIFFS) and the same
    metrics snapshot with the same plan-cache section."""
    jcfg, jmodel, jparams = pair[:3]
    scfg_kw = {"fused": dict(prefill_mode="fused"),
               "loop": dict(prefill_mode="loop"),
               "share_prefix": dict(cache_layout="paged",
                                    cache_page_size=4, share_prefix=True),
               "ngram": dict()}[case]
    prompts = ([SHARED + p for p in PROMPTS] if case == "share_prefix"
               else PROMPTS)
    news = (16, 12, 16, 14) if case == "ngram" else (6, 4, 8, 5)
    spec = case == "ngram"

    jobs = _fake_obs(JObsConfig)
    jeng = JServingEngine(jmodel, JServeConfig(
        model=jcfg, kv_cache_dtype="float32", **scfg_kw), max_len=64,
        batch_slots=2, sampler=JGreedySampler(), obs=jobs)
    jeng.load(jparams)
    for r in _reqs(JRequest, JSamplingParams, prompts, news,
                   JSpecConfig(method="ngram", k=4) if spec else None):
        jeng.submit(r)
    jdone = jeng.drain()

    obs = _fake_obs()
    eng, done = _serve(pair, _reqs(Request, SamplingParams, prompts, news,
                                   SpecConfig(method="ngram", k=4)
                                   if spec else None), obs=obs, **scfg_kw)
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    events, jevents = obs.tracer.artifact().events, \
        jobs.tracer.artifact().events
    names = {e["name"] for e in events}
    assert {"request", "queue_wait", "admit", "first_token"} <= names
    if spec:
        assert "verify" in names
    if case == "share_prefix":
        assert "sprefill" in names
    for e, je in zip(events, jevents):
        if e.get("cat") == "launch":
            assert e["args"]["mesh_splits"] is None
            assert je["args"]["mesh_splits"] == 1
    assert _strip(events) == _strip(jevents)
    assert obs.metrics_snapshot(eng.stats_snapshot()) == \
        jobs.metrics_snapshot(jeng._stats_snapshot())
    validate_trace(obs.tracer.artifact().to_json())

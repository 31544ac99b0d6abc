"""The port's measured split autotuning (``repro_torch.tune``, the
``measured`` policy, ``launch/tune.py``) against the reference's
``repro.tune``, on the CPU.

- Modeled at the reference's machine (``TPU_V5E``, 8 cores), the port's
  calibrator reproduces the committed reference table bit for bit: the
  same entries and the same content-derived version.
- A ``SplitTable`` behaves as the reference's on one small table: round
  trip, schema and version refusals, merge, validate, nearest-bucket
  lookup with counted fallbacks; each package loads the other's file.
- Measured plans carry their provenance and survive plan-cache eviction
  bit for bit; the measured policy refuses to run without a table.
- The serving engine on the reduced qwen2.5-3b in float32 with the
  committed table (its ``xla`` family) gives the JAX engine's frozen
  splits, greedy streams and lookup counts, loads the table from its
  config path, and dumps the reference's stats keys.
- Wallclock mode on a CPU device times the plain path; ``auto`` is
  modeled there.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.core.split_policy import DecodeWorkload as JWorkload
from repro.models import build_model as j_build_model
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.tune import Calibrator as JCalibrator
from repro.tune import REFERENCE_SPEC as J_REFERENCE_SPEC
from repro.tune import SplitTable as JSplitTable
from repro.tune import TuneSpec as JTuneSpec
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.occupancy import H100_SXM, TPU_V5E
from repro_torch.core.split_policy import DecodeWorkload, choose_num_splits
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.tune import main as tune_main
from repro_torch.models import build_model
from repro_torch.plan import AttentionSpec, PlanCache, Planner
from repro_torch.serving import (
    DecodeEngine,
    GreedySampler,
    Request,
    ServingEngine,
)
from repro_torch.tune import (
    DTYPE_BYTES,
    H100_SPEC,
    H100_TABLE_DIR,
    PORT_IMPL,
    REFERENCE_SPEC,
    REFERENCE_TABLE_PATH,
    SCHEMA_VERSION,
    Calibrator,
    SplitTable,
    TuneSpec,
    select_table,
)

REFERENCE_VERSION = "2.2cfa2296473e"
SMALL = dict(lk_buckets=(128, 256, 512), batches=(1, 2),
             head_shapes=((4, 1, 8), (64, 1, 128)))
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def reference_table() -> SplitTable:
    return SplitTable.load(REFERENCE_TABLE_PATH)


@pytest.fixture(scope="module")
def small_pair():
    """One small grid calibrated by each package, modeled at TPU_V5E."""
    port = Calibrator(TuneSpec(num_cores=8, **SMALL), mode="modeled",
                      hw=TPU_V5E).calibrate()
    ref = JCalibrator(JTuneSpec(**SMALL), mode="modeled").calibrate()
    return port, ref


def _workloads(rng, n):
    """Random decode workloads over the small grid's families and a few
    it does not cover, in both packages."""
    heads = [(4, 1, 8), (64, 1, 128), (16, 2, 128), (5, 1, 8)]
    out = []
    for _ in range(n):
        b = int(rng.choice([1, 2, 3]))
        lk = int(rng.integers(1, 9000))
        hq, hkv, hd = heads[int(rng.integers(len(heads)))]
        dt = str(rng.choice(["bfloat16", "int8", "fp8"]))
        kw = dict(dtype_bytes=DTYPE_BYTES[dt], kv_dtype=dt)
        out.append((DecodeWorkload(b, 1, lk, hq, hkv, hd, **kw),
                    JWorkload(b, 1, lk, hq, hkv, hd, **kw)))
    return out


# ---------------------------------------------------------------------------
# the reference's grid, modeled: the committed table bit for bit
# ---------------------------------------------------------------------------


def test_reference_spec_is_the_references():
    assert REFERENCE_SPEC.describe() == J_REFERENCE_SPEC.describe()
    assert DTYPE_BYTES == dict(__import__(
        "repro.tune.spec", fromlist=["DTYPE_BYTES"]).DTYPE_BYTES)
    got = [(w, impl) for w, impl in REFERENCE_SPEC.workloads()]
    want = list(J_REFERENCE_SPEC.workloads())
    assert len(got) == len(want) == REFERENCE_SPEC.grid_size() == 336
    for (w, impl), (jw, jimpl) in zip(got, want):
        assert impl == jimpl
        assert (w.batch, w.seqlen_k, w.num_heads_q, w.num_heads_kv,
                w.head_dim, w.kv_dtype) == (
            jw.batch, jw.seqlen_k, jw.num_heads_q, jw.num_heads_kv,
            jw.head_dim, jw.kv_dtype)
        assert REFERENCE_SPEC.candidate_splits(w) == \
            J_REFERENCE_SPEC.candidate_splits(jw)


def test_modeled_calibration_reproduces_the_reference_table(
        reference_table):
    fresh = Calibrator(REFERENCE_SPEC, mode="modeled", hw=TPU_V5E).calibrate()
    assert fresh.version == reference_table.version == REFERENCE_VERSION
    assert fresh.entries == reference_table.entries
    assert fresh.fingerprint["hw"] == "tpu_v5e"
    assert fresh.fingerprint["mode"] == "modeled"
    # the port's own machine decides otherwise somewhere: a model, not a
    # measurement, and not the reference's
    h100 = Calibrator(REFERENCE_SPEC, mode="modeled").calibrate()
    assert h100.version != REFERENCE_VERSION
    assert Calibrator(REFERENCE_SPEC, mode="modeled",
                      hw=H100_SXM).calibrate().version == h100.version


def test_tune_cli_reference_reproduces_the_table(tmp_path):
    out = tmp_path / "ref.json"
    tune_main(["--reference", "--out", str(out)])
    assert SplitTable.load(out).version == REFERENCE_VERSION
    assert JSplitTable.load(out).version == REFERENCE_VERSION
    with pytest.raises(SystemExit, match="--reference fixes"):
        tune_main(["--reference", "--lk", "128", "--out", str(out)])


def test_h100_spec_is_the_ports_grid():
    assert H100_SPEC.num_cores == 132 and H100_SPEC.impls == (PORT_IMPL,)
    assert set(H100_SPEC.head_shapes) == {
        (16, 2, 128), (32, 32, 128), (32, 8, 160), (64, 1, 128),
        (64, 2, 128), (32, 4, 128), (4, 1, 128)}
    assert H100_SPEC.lk_buckets == (128, 256, 384, 512, 640, 1024, 2048,
                                    4096)
    assert H100_SPEC.batches == (1, 2, 4, 8)
    assert H100_SPEC.dtypes == ("bfloat16", "int8")
    w = DecodeWorkload(1, 1, 4096, 16, 2, 128)
    assert H100_SPEC.candidate_splits(w) == (1, 2, 3, 4, 5, 6, 7, 8, 11,
                                             16, 32)


def test_committed_h100_table_is_a_wallclock_table_of_the_grid():
    """``experiments/tune/h100/`` holds a wallclock table of ``H100_SPEC``
    whose fingerprint names the card and its power limit; both packages
    load it, and the reference's registry (the top level of
    ``experiments/tune/``) does not see it."""
    paths = sorted(H100_TABLE_DIR.glob("*.json"))
    assert paths
    for path in paths:
        table = SplitTable.load(path)
        table.validate()
        fp = table.fingerprint
        assert fp["mode"] == "wallclock" and fp["sources"] == "measured"
        assert fp["backend"] == "cuda" and "H100" in fp["device"]
        assert fp["card"].startswith(fp["device"]) and \
            fp["card"].endswith(" W")
        assert {"torch", "cuda", "seed", "num_cores"} <= set(fp)
        assert table.spec == H100_SPEC.describe()
        assert len(table) == H100_SPEC.grid_size()
        assert all(e["source"] == "wallclock" for e in table.entries)
        assert JSplitTable.load(path).version == table.version
    assert H100_TABLE_DIR.parent == REFERENCE_TABLE_PATH.parent
    assert not list(H100_TABLE_DIR.parent.glob("h100*.json"))


# ---------------------------------------------------------------------------
# SplitTable against the reference's
# ---------------------------------------------------------------------------


def test_small_tables_agree_and_cross_load(tmp_path, small_pair):
    port, ref = small_pair
    assert port.version == ref.version
    assert port.entries == ref.entries
    p = port.save(tmp_path / "port.json")
    j = ref.save(tmp_path / "ref.json")
    for path in (p, j):
        a, b = SplitTable.load(path), JSplitTable.load(path)
        assert a.version == b.version and a.entries == b.entries
        assert a.fingerprint == b.fingerprint
        a.validate()
        b.validate()


def test_table_refusals_as_the_reference(tmp_path, small_pair):
    port, ref = small_pair
    for pkg, cls, table in (("torch", SplitTable, port),
                            ("jax", JSplitTable, ref)):
        d = table.to_json()
        d["schema"] = 99
        del d["version"]
        bad = tmp_path / f"schema_{pkg}.json"
        bad.write_text(json.dumps(d))
        with pytest.raises(ValueError, match="schema mismatch"):
            SplitTable.load(bad)
        with pytest.raises(ValueError, match="schema mismatch"):
            JSplitTable.load(bad)
        d = table.to_json()
        d["entries"][0]["best_split"] = 1 + d["entries"][0]["best_split"] % 2
        bad = tmp_path / f"tampered_{pkg}.json"
        bad.write_text(json.dumps(d))
        for loader in (SplitTable, JSplitTable):
            with pytest.raises(ValueError, match="version mismatch"):
                loader.load(bad)
        # validate: infeasible, non-argmin, duplicate cells
        e = [dict(x) for x in table.entries]
        e[0] = dict(e[0], best_split=99)
        with pytest.raises(ValueError, match="infeasible"):
            cls(e, table.fingerprint).validate()
        e = [dict(x) for x in table.entries]
        lats = e[-1]["latencies_us"]
        e[-1] = dict(e[-1], best_split=int(max(lats, key=lats.get)))
        with pytest.raises(ValueError, match="argmin"):
            cls(e, table.fingerprint).validate()
        with pytest.raises(ValueError, match="duplicate"):
            cls(table.entries + table.entries[:1],
                table.fingerprint).validate()
        with pytest.warns(UserWarning, match="mixed"):
            cls(table.entries, dict(table.fingerprint,
                                    sources="mixed")).validate()


def test_merge_as_the_reference(small_pair):
    port, ref = small_pair
    sub = dict(lk_buckets=(512, 640), batches=(1,),
               head_shapes=((64, 1, 128),), candidates=(1,),
               dtypes=("bfloat16",))
    recal = Calibrator(TuneSpec(num_cores=8, **sub), mode="modeled",
                       seed=1, hw=TPU_V5E).calibrate()
    jrecal = JCalibrator(JTuneSpec(**sub), mode="modeled",
                         seed=1).calibrate()
    merged, jmerged = port.merge(recal), ref.merge(jrecal)
    merged.validate()
    assert merged.entries == jmerged.entries
    assert merged.version == jmerged.version
    assert len(merged) == len(port) + 1
    w = DecodeWorkload(1, 1, 512, 64, 1, 128)
    assert merged.choose(w, impl="xla") == (1, True)
    assert port.choose(w, impl="xla")[0] != 1
    assert "merged_from" in merged.fingerprint
    other = SplitTable(recal.entries, recal.fingerprint)
    other.schema = SCHEMA_VERSION + 1
    with pytest.raises(ValueError, match="merge"):
        port.merge(other)


def test_choose_nearest_bucket_and_counted_fallbacks(small_pair):
    """On random workloads, the port's ``choose(impl="xla")`` gives the
    reference's ``choose`` (nearest L_K bucket, ties to the smaller,
    clamped; uncovered families fall back to ``paper`` at the table's 8
    cores), and both count the same lookups, fallbacks and trace; the
    port's own family label finds none of the reference's cells."""
    port, ref = (SplitTable(t.entries, t.fingerprint) for t in small_pair)
    ref = JSplitTable(ref.entries, ref.fingerprint)
    for w, jw in _workloads(np.random.default_rng(0), 300):
        got, want = port.choose(w, impl="xla"), ref.choose(jw)
        assert got == want, (w, got, want)
        assert got[1] == port.covers(w, impl="xla")
        if not got[1]:
            assert got[0] == choose_num_splits(w, policy="paper",
                                               num_cores=8)
    assert (port.lookups, port.fallbacks) == (ref.lookups, ref.fallbacks)
    assert port.fallbacks > 0 and port.fallbacks < port.lookups
    assert port.fallback_trace == ref.fallback_trace
    # ties go to the smaller bucket: 384 is 128 from 256 and 512
    w = DecodeWorkload(1, 1, 384, 64, 1, 128)
    fam = {e["lk_bucket"]: e["best_split"] for e in port.entries
           if (e["batch"], e["num_heads_q"], e["kv_dtype"]) ==
           (1, 64, "bfloat16")}
    assert port.choose(w, impl="xla") == (min(fam[256], 3), True)
    before = port.fallbacks
    s, tuned = port.choose(w)                 # impl None: the port's own
    assert not tuned and port.fallbacks == before + 1
    assert port.fallback_trace[-1][4] == PORT_IMPL


def test_select_table_registry_matches_the_live_device(tmp_path,
                                                       small_pair):
    port, _ = small_pair
    gpu = SplitTable(port.entries[:3], dict(port.fingerprint,
                                            backend="cuda",
                                            device="NVIDIA H100"))
    gpu.save(tmp_path / "a_gpu.json")
    port.save(tmp_path / "b_cpu.json")
    table, matched = select_table(tmp_path, device="cpu")
    assert matched and table.version == port.version
    (tmp_path / "b_cpu.json").unlink()
    with pytest.warns(RuntimeWarning, match="matches the live device"):
        table, matched = select_table(tmp_path, device="cpu")
    assert not matched and table.version == gpu.version
    assert select_table(tmp_path / "a_gpu.json", "cpu")[1]


# ---------------------------------------------------------------------------
# measured plans
# ---------------------------------------------------------------------------


def test_measured_plan_provenance_and_eviction(reference_table):
    planner = Planner(policy="measured", table=reference_table, impl="xla")
    ops.reset_policy_eval_count()
    covered = planner.plan(AttentionSpec.decode(1, 512, 64, 1, 128),
                           bucket=512)
    assert covered.tuned and covered.policy == "measured"
    assert covered.table_version == REFERENCE_VERSION
    assert covered.describe()["tuned"] is True
    uncovered = planner.plan(AttentionSpec.decode(3, 512, 8, 8, 128))
    assert not uncovered.tuned
    assert uncovered.table_version == REFERENCE_VERSION
    forced = Planner(policy="measured", table=reference_table,
                     num_splits_override=2).plan(
        AttentionSpec.decode(1, 512, 64, 1, 128))
    assert forced.num_splits == 2 and not forced.tuned
    # int8 cells are committed, fp8 (same width) is another family
    assert planner.plan(AttentionSpec.decode(1, 512, 64, 1, 128,
                                             kv_dtype="int8")).tuned
    assert not planner.plan(AttentionSpec.decode(1, 512, 64, 1, 128,
                                                 kv_dtype="fp8")).tuned
    # every committed cell replays through the planner
    for e in reference_table.entries:
        plan = planner.plan(AttentionSpec.decode(
            e["batch"], e["lk_bucket"], e["num_heads_q"], e["num_heads_kv"],
            e["head_dim"], kv_dtype=e["kv_dtype"]))
        assert plan.num_splits == e["best_split"] and plan.tuned
    assert ops.policy_eval_count() == 0
    cache = PlanCache(capacity=1)

    def build(bucket):
        spec = AttentionSpec.decode(1, bucket, 64, 1, 128)
        return lambda: planner.plan(spec, bucket=bucket)

    first = cache.get_or_build(512, build(512))
    cache.get_or_build(1024, build(1024))        # evicts 512
    assert 512 not in cache
    assert cache.get_or_build(512, build(512)) == first
    assert cache.stats.misses == 3


# ---------------------------------------------------------------------------
# the serving engine on the measured policy
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair_f32():
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=1,
                            d_model=32).replace(**F32)
    cfg = reduced_config("qwen2.5-3b", num_layers=1, d_model=32).replace(**F32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jmodel.init_params(jax.random.PRNGKey(0)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


# three requests whose decode crosses the 128 -> 256 bucket boundary
PROMPTS = [[1 + i, 2, 3] + [(5 * i + j) % 90 + 4 for j in range(120)]
           for i in range(3)]


def test_engine_measured_end_to_end_as_the_reference(pair_f32,
                                                     reference_table,
                                                     tmp_path):
    """Both packages' engines, f32 weights over a bf16 cache (the
    table's family), 2 slots, split_policy="measured" on the committed
    table (the port asks for its ``xla`` family): the same
    frozen splits per bucket, greedy streams, lookups and fallbacks; no
    policy evaluation in a launch; stats dumps with the reference's
    keys."""
    jcfg, jmodel, jparams, cfg, model, params = pair_f32
    jpath, path = tmp_path / "j.json", tmp_path / "t.json"
    jeng = JServingEngine(
        jmodel, JServeConfig(model=jcfg, split_policy="measured",
                             stats_path=str(jpath)),
        max_len=256, batch_slots=2, sampler=JGreedySampler(),
        tune_table=JSplitTable.load(REFERENCE_TABLE_PATH))
    jeng.load(jparams)
    for i, p in enumerate(PROMPTS):
        jeng.submit(JRequest(i, p, max_new_tokens=12))
    jdone = jeng.drain()
    ops.reset_policy_eval_count()
    eng = ServingEngine(
        model, ServeConfig(model=cfg, split_policy="measured",
                           stats_path=str(path)),
        max_len=256, batch_slots=2, sampler=GreedySampler(),
        tune_table=SplitTable.load(REFERENCE_TABLE_PATH), tune_impl="xla",
        device="cpu")
    eng.load(params)
    for i, p in enumerate(PROMPTS):
        eng.submit(Request(i, p, max_new_tokens=12))
    done = eng.drain()
    assert ops.policy_eval_count() == 0
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert eng.planned_splits() == jeng.planned_splits()
    assert sorted(eng.planned_splits()) == [128, 256]
    st, jst = eng.stats, jeng.stats
    assert (st.measured_lookups, st.measured_fallbacks) == \
        (jst.measured_lookups, jst.measured_fallbacks)
    assert st.measured_lookups >= 2 and st.measured_fallbacks == 0
    for bucket, entry in eng.sched.plans.items():
        if isinstance(bucket, int):
            assert entry.plan.tuned
            assert entry.plan.table_version == REFERENCE_VERSION
            assert entry.plan.num_splits == reference_table.choose(
                DecodeWorkload(2, 1, bucket, 4, 1, 8), impl="xla")[0]
    plan, jplan = eng.sched.decode_plan(200), jeng.sched.decode_plan(200)
    assert (plan.num_splits, plan.bucket, plan.tuned) == \
        (jplan.num_splits, jplan.bucket, jplan.tuned)
    snap, jsnap = (json.loads(x.read_text()) for x in (path, jpath))
    assert set(snap) == set(jsnap)
    assert snap["policy"] == "measured"
    assert snap["table_version"] == jsnap["table_version"]
    for key in ("hits", "misses", "measured_lookups", "measured_fallbacks",
                "launches", "seen_buckets"):
        assert snap[key] == jsnap[key], key
    assert eng.planner is eng.sched.planner
    assert eng.planner.table.version == REFERENCE_VERSION


def test_engine_measured_refusals_and_config_path(pair_f32, tmp_path):
    """Measured without the metadata path raises, as the reference's;
    the table loads from ``tune_table_path`` (a file, or a registry
    directory); the port's own family misses the reference's cells and
    every lookup is a counted fallback."""
    jcfg, jmodel, jparams, cfg, model, params = pair_f32
    table = SplitTable.load(REFERENCE_TABLE_PATH)
    for E, c, kw in ((JServingEngine, jcfg, {}),
                     (ServingEngine, cfg, dict(device="cpu"))):
        S = JServeConfig if E is JServingEngine else ServeConfig
        with pytest.raises(ValueError, match="metadata"):
            E(jmodel if E is JServingEngine else model,
              S(model=c, split_policy="measured",
                use_scheduler_metadata=False), tune_table=table, **kw)
    with pytest.raises(ValueError, match="SplitTable"):
        ServingEngine(model, ServeConfig(model=cfg, split_policy="measured"),
                      device="cpu")
    reg = tmp_path / "reg"
    table.save(reg / "reference.json")
    for where in (REFERENCE_TABLE_PATH, reg):
        eng = DecodeEngine(model, ServeConfig(
            model=cfg, split_policy="measured",
            tune_table_path=str(where)), batch_slots=4, device="cpu")
        assert eng.engine.tune_table.version == REFERENCE_VERSION
        assert eng.stats.table_registry_fallbacks == 0
        eng.load(params)
        eng.generate([Request(0, [1, 2], max_new_tokens=2)])
        st = eng.stats
        assert st.measured_lookups >= 1
        assert st.measured_fallbacks == st.measured_lookups
        assert st.measured_fallback_trace[0][:5] == (4, 4, 1, 8, PORT_IMPL)


# ---------------------------------------------------------------------------
# the calibrator's modes on a CPU device
# ---------------------------------------------------------------------------


def test_calibrator_wallclock_times_the_plain_path_on_the_cpu():
    spec = TuneSpec(lk_buckets=(256,), batches=(1,),
                    head_shapes=((4, 1, 64),), impls=(PORT_IMPL,),
                    repeats=2, warmup=1)
    table = Calibrator(spec, mode="wallclock", device="cpu",
                       launches=2).calibrate()
    bf16, int8 = table.entries
    assert bf16["kv_dtype"] == "bfloat16" and int8["kv_dtype"] == "int8"
    for e in table.entries:
        assert e["source"] == "wallclock"
        assert set(e["latencies_us"]) == {"1", "2"}
        assert all(t > 0 for t in e["latencies_us"].values())
        lats = e["latencies_us"]
        assert e["best_split"] == int(min(sorted(lats, key=int),
                                          key=lats.get))
    fp = table.fingerprint
    assert fp["sources"] == "measured" and fp["backend"] == "cpu"
    assert fp["mode"] == "wallclock" and fp["launches"] == 2
    with pytest.raises(ValueError, match=r"head_dim \[8\]"):
        Calibrator(spec.replace(head_shapes=((4, 1, 8),)),
                   mode="wallclock", device="cpu")
    assert Calibrator(spec, device="cpu").mode == "modeled"
    with pytest.warns(UserWarning, match="mixed sources"):
        degraded = Calibrator(spec.replace(lk_buckets=(128, 256),
                                           budget_s=0.0),
                              mode="wallclock", device="cpu").calibrate()
    assert all(e["source"] == "modeled" for e in degraded.entries)
    assert degraded.fingerprint["sources"] == "mixed"

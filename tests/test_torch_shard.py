"""The port's mesh-native serving against the reference's, on the CPU.

``ShardSpec`` (validation, ``parse``, ``fingerprint``, ``describe``),
``pick_shard`` and the resolver (divisibility before devices) against
``repro.shard``'s; ``choose_mesh_splits`` and ``Planner.mesh_plan`` field
for field over a grid of shapes that reaches both of ``mesh_plan``'s
branches; ``spec_for`` under every rule set over every registered arch's
param and cache axes; then the port's topologies, run in this process
over ``[cpu] * n``, against the JAX single-device engine in float32:
dp 4 x 2 slots; sp 2 and 4, dense and paged; sp 2 over an int8 cache; an
MLA model at sp 2; the ssm family at dp 2; per-shard page budgets;
conservation, the aggregate stats and the stats dump; and (marked
``multidevice``) the reference's ``ShardedServingEngine`` at (2, 2) and
(1, 4) in a subprocess with forced host devices, whose routes, streams
and plan fields the port's in-process run gives.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.core.split_policy import DecodeWorkload as JWorkload
from repro.core.split_policy import choose_mesh_splits as j_choose_mesh
from repro.models import build_model as j_build_model
from repro.plan import AttentionSpec as JAttentionSpec
from repro.plan import Planner as JPlanner
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.shard import ShardSpec as JShardSpec
from repro.shard import pick_shard as j_pick_shard
from repro.sharding import rules as jrules
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.core.split_policy import DecodeWorkload, choose_mesh_splits
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.mesh import EngineMesh, make_engine_mesh, \
    mesh_name, planner_for_mesh
from repro_torch.models import build_model
from repro_torch.plan import AttentionSpec, Planner, merge_stats_snapshots
from repro_torch.serving import GreedySampler, Request, ServingEngine
from repro_torch.shard import (
    ShardResolver,
    ShardSpec,
    ShardedServingEngine,
    clear_shard_plan_caches,
    pick_shard,
    shard_plan_cache,
)
from repro_torch.sharding import activation_mesh, current_mesh, rules, \
    shard_activation

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
F32 = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True)
def _fresh_registry():
    clear_shard_plan_caches()
    yield
    clear_shard_plan_caches()


# ---------------------------------------------------------------------------
# ShardSpec, pick_shard, the resolver
# ---------------------------------------------------------------------------


SPECS = [dict(), dict(dp=4, sp=2, slots_per_shard=3),
         dict(dp=2, sp=2, page_budget_per_shard=4),
         dict(dp=1, sp=4, params="tp")]


@pytest.mark.parametrize("kw", SPECS)
def test_shard_spec_equals_the_reference(kw):
    """Derived fields, ``fingerprint`` and ``describe`` equal to the
    reference's; ``with_`` and ``parse`` (positional, named, overrides)
    give the same specs."""
    s, j = ShardSpec(**kw), JShardSpec(**kw)
    assert s.describe() == j.describe()
    assert s.fingerprint == j.fingerprint
    assert (s.num_devices, s.total_slots) == (j.num_devices, j.total_slots)
    assert s.with_(sp=8).describe() == j.with_(sp=8).describe()
    for text, over in (("4,2", {}), ("4", {}), (" dp=2, sp=4 ", {}),
                       ("sp=2,slots_per_shard=8", {}),
                       ("2,2", dict(slots_per_shard=6))):
        assert ShardSpec.parse(text, **over).describe() == \
            JShardSpec.parse(text, **over).describe()


@pytest.mark.parametrize("kw,text,msg", [
    (dict(dp=0), None, "axes must be >= 1"),
    (dict(sp=0), None, "axes must be >= 1"),
    (dict(slots_per_shard=0), None, "slots_per_shard"),
    (dict(page_budget_per_shard=0), None, "page_budget_per_shard"),
    (dict(params="sharded"), None, "params policy"),
    (None, " , ", "empty"),
    (None, "4,sp=2", "mixed"),
    (None, "dp=2,chips=4", "unknown shard topology field"),
    (None, "2,2,2", "positional"),
])
def test_shard_spec_refusals_equal_the_references(kw, text, msg):
    for cls in (ShardSpec, JShardSpec):
        with pytest.raises(ValueError, match=msg) as e:
            cls(**kw) if text is None else cls.parse(text)
        if cls is ShardSpec:
            got = str(e.value)
        else:
            assert got == str(e.value)


def test_pick_shard_equals_the_references():
    rng = np.random.default_rng(0)
    for _ in range(200):
        loads = rng.integers(0, 4, int(rng.integers(1, 6))).tolist()
        assert pick_shard(loads) == j_pick_shard(loads)
    assert pick_shard([2, 1, 1]) == 1 and pick_shard([5]) == 0


def test_resolver_checks_divisibility_before_devices():
    """Layout divisibility fails first, with the reference's message,
    even where the device list is too short; a short list raises the
    reference's message with the port's hint; a resolved plan names the
    devices' type and shares PlanCaches by (topology, shard, ident)."""
    short = [CPU]
    with pytest.raises(ValueError, match=r"max_len \(63\) must divide"):
        ShardResolver(ShardSpec(sp=2)).resolve(max_len=63, devices=short)
    with pytest.raises(ValueError, match=r"page_size \(15\) must divide"):
        ShardResolver(ShardSpec(sp=2)).resolve(
            max_len=64, cache_layout="paged", page_size=15, devices=short)
    with pytest.raises(ValueError, match="needs 2 devices, 1 visible .* "
                                         "repeats a device"):
        ShardResolver(ShardSpec(dp=2)).resolve(max_len=64, devices=short)
    plan = ShardResolver(ShardSpec(dp=2, sp=2)).resolve(
        max_len=64, devices=[CPU] * 4)
    assert plan.mesh.shape == {"data": 2, "model": 2}
    assert mesh_name(plan.mesh) == "2x2"
    assert [m.shape for m in plan.submeshes] == [{"data": 1, "model": 2}] * 2
    assert plan.shard_devices(1) == (CPU, CPU)
    assert plan.fingerprint == plan.spec.fingerprint + ".cpu.cpu.4"
    c0 = plan.plan_cache(0, ident=("a",))
    assert plan.plan_cache(0, ident=("a",)) is c0
    assert plan.plan_cache(1, ident=("a",)) is not c0
    assert plan.plan_cache(0, ident=("b",)) is not c0
    clear_shard_plan_caches()
    assert plan.plan_cache(0, ident=("a",)) is not c0
    assert shard_plan_cache(("x",), 4).capacity == 4
    assert plan.describe()["devices"] == ["cpu"] * 4
    p = planner_for_mesh(plan.mesh, policy="fa3_baseline")
    assert (p.policy, p.num_cores) == ("fa3_baseline", 2)


# ---------------------------------------------------------------------------
# mesh-level planning
# ---------------------------------------------------------------------------


GRID = [(b, lk, hkv, axis) for b in (1, 2, 8) for lk in (512, 4096)
        for hkv in (1, 2, 8) for axis in (2, 4, 8)]


@pytest.mark.parametrize("policy", ["paper", "fa3_baseline"])
def test_choose_mesh_splits_and_mesh_plan_equal_the_references(policy):
    """Over B x L_K x H_KV x axis size (the storage branch wherever H_KV
    does not divide the axis), ``choose_mesh_splits`` and
    ``Planner.mesh_plan``'s ``mesh_splits``, ``num_splits``, ``num_cores``,
    ``seq_shard_axis`` and ``bucket`` equal the reference's.  (Under
    ``tpu_adaptive`` the two differ by design: its cost model reads the
    H100 in the port and the TPU in the reference.)"""
    storage = occupancy = 0
    for b, lk, hkv, axis in GRID:
        hq = 8 * hkv
        w = DecodeWorkload(b, 1, lk, hq, hkv, 128)
        jw = JWorkload(b, 1, lk, hq, hkv, 128)
        assert choose_mesh_splits(w, axis, policy=policy) == \
            j_choose_mesh(jw, axis, policy=policy)
        got = Planner(policy=policy).mesh_plan(
            AttentionSpec.decode(b, lk, hq, hkv, 128), axis_size=axis,
            bucket=lk)
        want = JPlanner(policy=policy).mesh_plan(
            JAttentionSpec.decode(b, lk, hq, hkv, 128), axis_size=axis,
            bucket=lk)
        for f in ("mesh_splits", "num_splits", "num_cores",
                  "seq_shard_axis", "bucket", "pack_gqa"):
            assert getattr(got, f) == getattr(want, f), (f, b, lk, hkv,
                                                         axis)
        assert got.describe() == want.describe()
        assert (got.spec.mesh_axis, got.spec.mesh_axis_size) == \
            ("model", axis)
        if hkv % axis:
            storage += 1
            assert got.mesh_splits == axis
        else:
            occupancy += 1
    assert storage and occupancy
    # a plan made without a mesh names no axis
    assert Planner(policy=policy).plan(
        AttentionSpec.decode(1, 512, 8, 1, 128)).seq_shard_axis is None


def test_mesh_plans_stamp_their_provenance():
    """A launch span's provenance: a plan made for a mesh stamps its
    ``mesh_splits``, and its ``seq_shard_axis`` once realized over a grid
    (``Scheduler._realize``), as the reference's ``plan_provenance``
    does for the same plans; a plan made without a mesh stamps null."""
    from repro.obs.observer import plan_provenance as j_provenance
    from repro_torch.obs.observer import plan_provenance
    from repro_torch.serving.scheduler import Scheduler
    cfg = reduced_config("qwen2.5-3b")
    _, (sub,) = make_engine_mesh(1, 2, [CPU] * 2)
    sched = Scheduler(cfg, batch_slots=2, max_len=64, policy="paper",
                      mesh=sub, seq_shards=2)
    plan = sched.decode_plan(40)
    want = JPlanner(policy="paper").mesh_plan(
        JAttentionSpec.decode(2, 128, cfg.num_heads, cfg.num_kv_heads,
                              cfg.resolved_head_dim), axis_size=2,
        bucket=128)
    d = plan_provenance(128, plan)
    assert (d["mesh_splits"], d["seq_shard_axis"]) == (2, "model")
    bare = dataclasses.replace(plan, seq_shard_mesh=None)
    assert plan_provenance(128, bare) == j_provenance(128, want)
    assert sched._plan(sched.verify_spec(2, 128), 128).seq_shard_mesh \
        is None
    one = Planner(policy="paper").plan(
        AttentionSpec.decode(2, 128, 4, 1, 16), bucket=128)
    assert plan_provenance(128, one)["mesh_splits"] is None


class FakeMesh:
    """A duck-typed mesh (``axis_names`` and a ``shape`` dict), the form
    both packages' ``spec_for`` read."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [FakeMesh({"data": 1, "model": 1}), FakeMesh({"data": 2,
                                                        "model": 2}),
          FakeMesh({"data": 4, "model": 2}), FakeMesh({"data": 1,
                                                       "model": 4}),
          FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16})]
RULE_SETS = ["param_rules", "serve_param_rules", "activation_rules"]


def _leaves(tree):
    """(shape, logical axes) of every ParamSpec of a reference tree."""
    flat = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: hasattr(x, "axes") and hasattr(x, "shape"))
    return [(tuple(s.shape), tuple(s.axes)) for s in flat]


def test_spec_for_equals_the_references_over_every_arch():
    """``spec_for`` under ``param_rules``, ``serve_param_rules`` and
    ``activation_rules`` over every registered arch's param axes, and
    under ``cache_rules(True / False)`` over its cache axes (int8 too),
    on 1 x 1 up to pod-sized grids: the port's tuple is the reference's
    PartitionSpec entry for entry (divisibility fallback, first dim
    wins).  A real grid of CPU devices gives the same specs."""
    from repro.configs.base import _REGISTRY as JREG
    j_get_arch("qwen2.5-3b")
    names = sorted(JREG)
    assert len(names) == 10
    cases = 0
    for name in names:
        jm = j_build_model(j_get_arch(name))
        params = _leaves(jm.param_specs())
        caches = _leaves(jm.cache_specs(4, 4096)) + \
            _leaves(jm.cache_specs(4, 4096, "int8"))
        for mesh in MESHES:
            for rs in RULE_SETS:
                r, jr = getattr(rules, rs)(), getattr(jrules, rs)()
                for shape, axes in params:
                    assert rules.spec_for(shape, axes, r, mesh) == \
                        tuple(jrules.spec_for(shape, axes, jr, mesh)), \
                        (name, rs, shape, axes, mesh.shape)
                    cases += 1
            for split in (True, False):
                r, jr = rules.cache_rules(split), jrules.cache_rules(split)
                for shape, axes in caches:
                    assert rules.spec_for(shape, axes, r, mesh) == \
                        tuple(jrules.spec_for(shape, axes, jr, mesh))
                    cases += 1
    assert cases > 4000
    grid, _ = make_engine_mesh(2, 2, [CPU] * 4)
    shape, axes = (2, 4, 4096, 8, 128), ("layers", "batch", "seq",
                                         "kv_heads", "head_dim")
    assert rules.spec_for(shape, axes, rules.cache_rules(True), grid) == \
        (None, "data", "model")
    assert rules.spec_for(shape, axes, rules.cache_rules(False), grid) == \
        (None, "data", None, "model")
    assert rules.replicated(grid) == ()
    assert rules.batch_spec(grid) == (("data",),)
    # the activation context binds a grid; a constraint is the identity
    x = torch.zeros(2, 3)
    assert current_mesh() is None
    with activation_mesh(grid):
        assert current_mesh() is grid
        assert shard_activation(x, ("batch", None)) is x
        with activation_mesh(None):
            assert current_mesh() is grid
    assert current_mesh() is None


# ---------------------------------------------------------------------------
# topologies in this process over [cpu] * n, against the JAX engine
# ---------------------------------------------------------------------------


def _pair(arch, d_model=32):
    jcfg = j_reduced_config(arch, d_model=d_model).replace(**F32)
    cfg = reduced_config(arch, d_model=d_model).replace(**F32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype("float32"),
                           jax.jit(jmodel.init_params)(
                               jax.random.PRNGKey(0)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen2.5-3b")


def _reqs(n, seed=0, max_new=6, lo=2, hi=8):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, 250, size=int(rng.integers(lo, hi))
                             ).tolist(), max_new) for i in range(n)]


def _jax_streams(pair, reqs, *, slots, max_len, **scfg_kw):
    jcfg, jmodel, jparams = pair[:3]
    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, **scfg_kw),
                          max_len=max_len, batch_slots=slots,
                          sampler=JGreedySampler())
    jeng.load(jparams)
    for i, p, n in reqs:
        jeng.submit(JRequest(i, list(p), max_new_tokens=n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {c.request_id: (c.tokens, c.finish_reason)
                for c in jeng.drain()}


def _sharded(pair, spec, *, max_len, **scfg_kw):
    cfg, model, params = pair[3:]
    eng = ShardedServingEngine(model, ServeConfig(model=cfg, **scfg_kw),
                               spec=spec, max_len=max_len,
                               sampler=GreedySampler(),
                               devices=[CPU] * spec.num_devices)
    eng.load(params)
    return eng


def _drain(eng, reqs):
    handles = [eng.submit(Request(i, list(p), max_new_tokens=n))
               for i, p, n in reqs]
    assert len(set(handles)) == len(reqs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {c.request_id: (c.tokens, c.finish_reason)
                for c in eng.drain()}


class _Launches:
    """Counts the sharded decode's kernel calls through ``ops``' names:
    the partials launches by (chunk rows, splits), the combine launches."""

    def __init__(self, monkeypatch):
        self.partials, self.combines = {}, 0
        for name in ("flash_decode_partials", "flash_decode_quant_partials"):
            fn = getattr(ops, name)
            monkeypatch.setattr(ops, name, self._wrap(name, fn))
        combine = ops.flash_combine

        def counted(*a, **kw):
            self.combines += 1
            return combine(*a, **kw)
        monkeypatch.setattr(ops, "flash_combine", counted)

    def _wrap(self, name, fn):
        def counted(q, k, *a, num_splits, **kw):
            key = (name, k.shape[1], num_splits)
            self.partials[key] = self.partials.get(key, 0) + 1
            return fn(q, k, *a, num_splits=num_splits, **kw)
        return counted


def test_dp4_serves_the_jax_streams(qwen):
    """dp 4 x 2 slots: 8 requests route [2, 2, 2, 2], and the streams are
    the JAX single-device 2-slot engine's; the aggregate stats sum the
    shards'; no sequence-sharded launch."""
    reqs = _reqs(8)
    want = _jax_streams(qwen, reqs, slots=2, max_len=64)
    eng = _sharded(qwen, ShardSpec(dp=4, slots_per_shard=2), max_len=64)
    assert eng.B == 8 and all(c.seq_shards == 1 for c in eng.cores)
    assert _drain(eng, reqs) == want
    assert [len(eng.routed(d)) for d in range(4)] == [2, 2, 2, 2]
    per_shard = [c.stats.total_launches for c in eng.cores]
    agg = eng.aggregate_stats()
    assert all(n > 0 for n in per_shard)
    assert agg["shards"] == 4 and agg["total_launches"] == sum(per_shard)
    assert all(e.plan.mesh_splits == 1 and e.plan.seq_shard_mesh is None
               for c in eng.cores for e in c.sched.plans.values())


@pytest.mark.parametrize("sp,layout,kv_quant", [
    (2, "dense", None), (4, "dense", None), (2, "paged", None),
    (4, "paged", None), (2, "dense", "int8")])
def test_sequence_sharded_decode_serves_the_jax_streams(
        qwen, monkeypatch, sp, layout, kv_quant):
    """dp 1 x sp, dense (the cache held as sp chunks of max_len / sp rows)
    or paged (the gathered view cut per launch), over a float32 or an
    int8 cache: prompts up to 100 tokens cross the chunks, and the streams are
    the JAX single-device engine's.  Every decode plan carries
    ``mesh_splits == sp`` and the shard's grid; each layer of each step
    launches sp partials at one split over a chunk and one combine."""
    kw = dict(cache_layout=layout, cache_page_size=16, kv_quant=kv_quant)
    reqs = _reqs(4, seed=sp, lo=20, hi=100)
    want = _jax_streams(qwen, reqs, slots=2, max_len=128, **kw)
    launches = _Launches(monkeypatch)
    eng = _sharded(qwen, ShardSpec(sp=sp, slots_per_shard=2), max_len=128,
                   **kw)
    core = eng.cores[0]
    assert core.seq_shards == sp
    dense = layout == "dense"
    assert ops.seq_sharded(core._caches) == dense
    assert _drain(eng, reqs) == want
    plans = {k: e.plan for k, e in core.sched.plans.items()
             if isinstance(k, int)}
    assert plans
    for p in plans.values():
        assert p.mesh_splits == sp and p.seq_shard_axis == "model"
        assert p.seq_shard_mesh.devices == (CPU,) * sp
    steps = sum(core.stats.launches[k] for k in plans)
    name = ("flash_decode_quant_partials" if kv_quant
            else "flash_decode_partials")
    layers = eng.cfg.num_layers
    assert launches.combines == layers * steps
    assert sum(launches.partials.values()) == sp * layers * steps
    assert all(k[0] == name and k[2] == 1 for k in launches.partials)
    if dense:
        assert {k[1] for k in launches.partials} == {128 // sp}
    if not dense:
        eng.check_conservation()


@pytest.fixture(scope="module")
def mla():
    return _pair("minicpm3-4b")


def test_mla_at_sp2_serves_the_jax_streams(mla, monkeypatch):
    """minicpm3-4b reduced at sp 2: the latent cache chunked, V the first
    kv_lora_rank columns of each chunk; the JAX engine's streams."""
    reqs = _reqs(3, seed=5, lo=10, hi=60)
    want = _jax_streams(mla, reqs, slots=2, max_len=64)
    launches = _Launches(monkeypatch)
    eng = _sharded(mla, ShardSpec(sp=2, slots_per_shard=2), max_len=64)
    assert sorted(eng.cores[0]._caches) == ["latent"]
    assert _drain(eng, reqs) == want
    assert launches.combines > 0
    assert {k[1] for k in launches.partials} == {32}


def test_ssm_at_dp2_serves_the_jax_streams():
    """mamba2-780m reduced at dp 2 x 2 slots: loop admission in each
    shard, the JAX single-device engine's streams, no kernel call."""
    pair = _pair("mamba2-780m")
    reqs = _reqs(4, seed=3, lo=3, hi=40)
    want = _jax_streams(pair, reqs, slots=2, max_len=64)
    eng = _sharded(pair, ShardSpec(dp=2, slots_per_shard=2), max_len=64)
    assert eng.prefill_mode == "loop"
    assert _drain(eng, reqs) == want
    assert eng.routed(0) == [0, 2] and eng.routed(1) == [1, 3]


def test_dp2_paged_budget_exhaustion_stays_per_shard(qwen):
    """One shard exhausting its 3-page budget finishes only its request
    with ``cache_capacity``; the other shard's request runs to length;
    both pools are whole again after drain, and each manager is labelled
    with its shard."""
    eng = _sharded(qwen, ShardSpec(dp=2, slots_per_shard=1,
                                   page_budget_per_shard=3),
                   max_len=128, cache_layout="paged", cache_page_size=16)
    assert [c.cache.label for c in eng.cores] == ["shard0", "shard1"]
    got = _drain(eng, [(0, [1] * 20, 60), (1, [2] * 5, 3)])
    assert eng.routed(0) == [0] and eng.routed(1) == [1]
    assert got[0][1] == "cache_capacity" and got[1][1] == "length"
    eng.check_conservation()
    for row in eng.describe():
        assert row["free_pages"] == row["total_pages"] == 3


def test_conservation_stats_and_one_dump(qwen, tmp_path):
    """A paged dp 2 x sp 2 topology: conservation holds on every shard,
    ``aggregate_stats`` is ``merge_stats_snapshots`` of the shards', and
    ``stats_path`` gets one dump with the topology, every shard's
    section and the aggregate, ``trace_path`` one trace that validates,
    with a track per shard; a conservation failure names its shard."""
    from repro_torch.obs import validate_trace
    out, trace = tmp_path / "stats.json", tmp_path / "trace.json"
    eng = _sharded(qwen, ShardSpec(dp=2, sp=2, slots_per_shard=2),
                   max_len=64, cache_layout="paged", cache_page_size=16,
                   stats_path=str(out), trace_path=str(trace))
    _drain(eng, _reqs(5))
    eng.check_conservation()
    snaps = [c.stats.to_json() for c in eng.cores]
    assert eng.aggregate_stats() == merge_stats_snapshots(snaps)
    d = json.loads(out.read_text())
    assert d["topology"] == eng.spec.describe()
    assert d["fingerprint"] == eng.plan.fingerprint
    assert [s["shard"] for s in d["shards"]] == [0, 1]
    assert d["shards"][1]["devices"] == ["cpu", "cpu"]
    assert d["aggregate"]["total_launches"] == sum(
        s["total_launches"] for s in d["shards"]) > 0
    events = json.loads(trace.read_text())
    validate_trace(events)
    spans = [e for e in events["traceEvents"] if e.get("name") == "request"]
    assert len(spans) == 5 and {e["pid"] for e in spans} == {0, 1}
    eng.cores[1].cache.refcount[1] += 1
    with pytest.raises(AssertionError, match=r"\[shard1\] refcount drift"):
        eng.check_conservation()


def test_same_topology_engines_share_one_plan_cache(qwen):
    """Two engines of one (topology, identity) share a PlanCache: the
    second serves from the first's entries with no miss, on its own
    storage, with the same streams; another policy does not share."""
    spec = ShardSpec(sp=2, slots_per_shard=2)
    e1 = _sharded(qwen, spec, max_len=64)
    out1 = _drain(e1, _reqs(3))
    misses = e1.stats.misses
    e2 = _sharded(qwen, spec, max_len=64)
    assert e2.cores[0].sched.plans is e1.cores[0].sched.plans
    assert _drain(e2, _reqs(3)) == out1
    assert e2.stats.misses == misses
    cfg, model = qwen[3], qwen[4]
    e3 = ShardedServingEngine(model, ServeConfig(model=cfg), spec=spec,
                              max_len=64, policy="fa3_baseline",
                              devices=[CPU] * 2)
    assert e3.cores[0].sched.plans is not e1.cores[0].sched.plans


def test_engine_refusals(qwen):
    """The reference's refusals: no topology; sp without the metadata
    path; max_len or the page size not dividing over sp; an unknown
    ``param_policy``.  ``"tp"``, validated as the reference does, is
    served (``tests/test_torch_tp.py`` holds its streams)."""
    cfg, model = qwen[3], qwen[4]
    with pytest.raises(ValueError, match="no topology"):
        ShardedServingEngine(model, ServeConfig(model=cfg))
    eng = ShardedServingEngine(model, ServeConfig(model=cfg, shard="1,1"),
                               max_len=64, devices=[CPU])
    assert eng.spec == ShardSpec()
    _, (sub,) = make_engine_mesh(1, 2, [CPU] * 2)
    assert isinstance(sub, EngineMesh) and sub.lead == CPU
    with pytest.raises(ValueError, match="metadata-enabled"):
        ServingEngine(model, ServeConfig(model=cfg,
                                         use_scheduler_metadata=False),
                      max_len=64, mesh=sub)
    with pytest.raises(ValueError, match=r"max_len \(65\) must divide"):
        ServingEngine(model, ServeConfig(model=cfg), max_len=65, mesh=sub)
    with pytest.raises(ValueError, match=r"cache_page_size \(9\) must"):
        ServingEngine(model, ServeConfig(model=cfg, cache_layout="paged",
                                         cache_page_size=9,
                                         seqlen_bucket=126),
                      max_len=64, mesh=sub)
    with pytest.raises(ValueError, match="unknown param_policy"):
        ServingEngine(model, ServeConfig(model=cfg), mesh=sub,
                      param_policy="fsdp")
    tp = ShardedServingEngine(model, ServeConfig(model=cfg),
                              spec=ShardSpec(params="tp"), max_len=64,
                              devices=[CPU])
    assert tp.cores[0].param_policy == "tp"


def test_sharded_verify_and_sampling_keep_the_streams(qwen):
    """Speculation (``ngram``, k 3) at sp 2 over the chunked dense cache:
    the verify steps attend the joined chunks and write back, and the
    streams are the single-device port engine's; sampled requests too."""
    cfg, model, params = qwen[3:]
    reqs = [(i, [5, 6, 7] * (4 + i), 8) for i in range(3)]
    single = ServingEngine(model, ServeConfig(model=cfg, speculation="ngram",
                                              speculation_k=3),
                           max_len=64, batch_slots=2, device="cpu")
    single.load(params)
    want = _drain(single, reqs)
    eng = _sharded(qwen, ShardSpec(sp=2, slots_per_shard=2), max_len=64,
                   speculation="ngram", speculation_k=3)
    assert _drain(eng, reqs) == want
    assert eng.stats.spec_steps > 0


# ---------------------------------------------------------------------------
# the reference's ShardedServingEngine on forced host devices
# ---------------------------------------------------------------------------


_REFERENCE = """
    import json, warnings
    import jax, numpy as np
    from repro.configs.base import ServeConfig
    from repro.configs.reduced import reduced_config
    from repro.models import build_model
    from repro.serving import GreedySampler, Request
    from repro.shard import ShardSpec, ShardedServingEngine

    cfg = reduced_config("qwen2.5-3b", d_model=32).replace(
        dtype="float32", param_dtype="float32")
    model = build_model(cfg)
    params = jax.tree.map(lambda a: a.astype("float32"),
                          model.init_params(jax.random.PRNGKey(0)))
    out = {}
    for name, (dp, sp, max_len, reqs) in json.loads(CASES).items():
        eng = ShardedServingEngine(
            model, ServeConfig(model=cfg),
            spec=ShardSpec(dp=dp, sp=sp, slots_per_shard=2),
            max_len=max_len, sampler=GreedySampler())
        eng.load(params)
        for i, p, n in reqs:
            eng.submit(Request(i, p, max_new_tokens=n))
        done = eng.drain()
        out[name] = {
            "routes": [eng.routed(d) for d in range(dp)],
            "streams": {str(c.request_id): [c.tokens, c.finish_reason]
                        for c in done},
            "plans": [sorted([k, e.plan.mesh_splits, e.plan.num_splits,
                              e.plan.seq_shard_axis]
                             for k, e in core.sched.plans.items()
                             if isinstance(k, int))
                      for core in eng.cores]}
    print(json.dumps(out))
"""


@pytest.mark.multidevice
def test_reference_topologies_route_and_plan_as_the_port():
    """The reference's ShardedServingEngine at (2, 2) and (1, 4) on 8
    forced host devices (a subprocess, as ``tests/test_shard.py`` runs
    it): the port's in-process run over ``[cpu] * n`` gives its routes,
    its streams and, for every decode plan, its bucket, ``mesh_splits``,
    ``num_splits`` and ``seq_shard_axis``."""
    cases = {"2x2": [2, 2, 64, _reqs(5)],
             "1x4": [1, 4, 128, _reqs(2, seed=9, lo=60, hi=100)]}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = f"CASES = {json.dumps(json.dumps(cases))}\n" + \
        textwrap.dedent(_REFERENCE)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=90)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    pair = _pair("qwen2.5-3b")
    for name, (dp, sp, max_len, reqs) in cases.items():
        eng = _sharded(pair, ShardSpec(dp=dp, sp=sp, slots_per_shard=2),
                       max_len=max_len)
        got = _drain(eng, reqs)
        want = ref[name]
        assert [eng.routed(d) for d in range(dp)] == want["routes"]
        assert {str(k): [v[0], v[1]] for k, v in got.items()} == \
            want["streams"]
        plans = [sorted([k, e.plan.mesh_splits, e.plan.num_splits,
                         e.plan.seq_shard_axis]
                        for k, e in core.sched.plans.items()
                        if isinstance(k, int)) for core in eng.cores]
        assert plans == want["plans"], name
        assert all(p[1] == sp for core in plans for p in core)

"""The port's occupancy model and metadata entry point against the
reference's: ``repro_torch.core.occupancy`` against ``repro.core.occupancy``
and ``repro_torch.core.scheduler_metadata`` against
``repro.core.scheduler_metadata``, on the CPU.

The occupancy model is the same Python arithmetic in both packages, so its
numbers must be equal, not close; the port only defaults to ``H100_SXM``
where the reference defaults to ``TPU_V5E``, so every comparison passes
``hw`` explicitly.
"""
import csv
import itertools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import occupancy as jocc
from repro.core import scheduler_metadata as jmeta
from repro.core.split_policy import DecodeWorkload as JWorkload
from repro.kernels import ops as jops
from repro_torch import core
from repro_torch.core import occupancy as tocc
from repro_torch.core import scheduler_metadata as tmeta
from repro_torch.core.split_policy import DecodeWorkload as TWorkload
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]

# the paper's Table 1 cells (B=1, H_Q=64, D=128) and a wider grid
TABLE1_CELLS = [(lk, hkv) for lk in (128, 256, 384, 512, 2048, 4096)
                for hkv in (1, 2, 8)]
WORKLOADS = [(1, 1, lk, 64, hkv, 128, 2) for lk, hkv in TABLE1_CELLS] + [
    (b, 1, lk, hq, hkv, d, nbytes)
    for b, lk, (hq, hkv), d, nbytes in itertools.product(
        (1, 3, 16), (1, 130, 640, 8192), ((16, 2), (40, 1), (8, 8)),
        (64, 256), (1, 2, 4))]
SPLITS = (1, 2, 3, 5, 16, 32, 200)
CORE_COUNTS = (None, 8, 132)


@pytest.mark.parametrize("hw_name", ["H100_SXM", "TPU_V5E"])
def test_occupancy_model_equals_the_reference(hw_name):
    jhw, thw = getattr(jocc, hw_name), getattr(tocc, hw_name)
    assert vars(jhw) == vars(thw)
    for shape in WORKLOADS:
        jw, tw = JWorkload(*shape), TWorkload(*shape)
        for s, cores in itertools.product(SPLITS, CORE_COUNTS):
            for pack, margin in ((True, 0), (False, 0), (True, 4)):
                assert tocc.modeled_latency_us(
                    tw, s, num_cores=cores, hw=thw, pack_gqa=pack,
                    sm_margin=margin) == jocc.modeled_latency_us(
                    jw, s, num_cores=cores, hw=jhw, pack_gqa=pack,
                    sm_margin=margin), (shape, s, cores, pack, margin)
            assert tocc.occupancy_fraction(tw, s, num_cores=cores, hw=thw) \
                == jocc.occupancy_fraction(jw, s, num_cores=cores, hw=jhw)
            assert tocc.modeled_speedup(tw, 1, s, num_cores=cores, hw=thw) \
                == jocc.modeled_speedup(jw, 1, s, num_cores=cores, hw=jhw)
        assert tocc._per_tile_kv_bytes(tw, 3) == \
            jocc._per_tile_kv_bytes(jw, 3)


def test_occupancy_model_defaults_to_the_h100():
    w = TWorkload(1, 1, 512, 64, 1, 128)
    assert tocc.modeled_latency_us(w, 3) == tocc.modeled_latency_us(
        w, 3, num_cores=132, hw=tocc.H100_SXM)
    assert tocc.occupancy_fraction(w, 3) == 3 / 132
    assert core.H100_SXM is tocc.H100_SXM


def test_table1_model_columns_equal_the_committed_csv():
    """The port's split policies and H100 model, rounded as
    benchmarks/table1_ab.py rounds them, give every model column of
    experiments/bench/table1_ab.csv."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks.table1_ab import PAPER_TABLE1
    finally:
        sys.path.remove(str(ROOT))
    with open(ROOT / "experiments" / "bench" / "table1_ab.csv") as f:
        want = {(int(r["L_K"]), int(r["H_KV"])): r for r in csv.DictReader(f)}
    hw = tocc.H100_SXM
    assert set(want) == set(TABLE1_CELLS) == set(PAPER_TABLE1)
    for (lk, hkv), (p_std, p_pat) in PAPER_TABLE1.items():
        w = TWorkload(1, 1, lk, 64, hkv, 128)
        s_std = core.fa3_baseline(w, num_cores=hw.num_cores)
        s_pat = core.paper_policy(w, num_cores=hw.num_cores)
        t_std = tocc.modeled_latency_us(w, s_std, hw=hw,
                                        num_cores=hw.num_cores)
        t_pat = tocc.modeled_latency_us(w, s_pat, hw=hw,
                                        num_cores=hw.num_cores)
        row = want[lk, hkv]
        assert (s_std, s_pat) == (int(row["s_std"]), int(row["s_patched"]))
        assert round(t_std, 2) == float(row["model_std_us"])
        assert round(t_pat, 2) == float(row["model_patched_us"])
        assert round(t_std / t_pat, 3) == float(row["model_speedup"])
        assert round(p_std / p_pat, 3) == float(row["paper_speedup"])
        assert round(t_std / p_std - 1, 3) == float(row["model_cal_err"])


@pytest.mark.parametrize("policy", ["fa3_baseline", "paper"])
@pytest.mark.parametrize("num_cores", [8, 132])
def test_get_scheduler_metadata_splits_equal_the_reference(policy,
                                                           num_cores):
    shapes = [(1, 1, lk, 64, hkv, 128) for lk, hkv in TABLE1_CELLS] + [
        (b, 1, lk, hq, hkv, d)
        for b, lk, (hq, hkv), d in itertools.product(
            (1, 2, 8), (64, 512, 1000, 4096, 20000),
            ((16, 2), (40, 1), (32, 32)), (128, 160))]
    for shape in shapes:
        for override in (None, 1, 3, 64):
            kw = dict(policy=policy, num_cores=num_cores,
                      num_splits_override=override)
            got = tmeta.get_scheduler_metadata(*shape, **kw)
            want = jmeta.get_scheduler_metadata(*shape, **kw)
            assert got.frozen and got.num_splits == want.num_splits, \
                (shape, kw)
            assert (got.policy, got.num_cores) == (want.policy,
                                                   want.num_cores)


def test_get_scheduler_metadata_packs_gqa_or_raises():
    """``pack_gqa`` None / True / False gives the reference's plan, field
    for field on the fields both packages have (the port's kernels pack
    either way; only the cost model reads the flag), for GQA and MHA
    shapes; an unknown policy still raises."""
    for shape in ((1, 1, 512, 64, 1, 128), (2, 1, 1000, 8, 8, 128)):
        for pack in (None, True, False):
            kw = dict(num_cores=132, pack_gqa=pack)
            got = tmeta.get_scheduler_metadata(*shape, **kw)
            want = jmeta.get_scheduler_metadata(*shape, **kw)
            for name in ("kind", "num_splits", "pack_gqa", "policy",
                         "num_cores", "bucket", "tuned", "table_version",
                         "frozen", "uses_split"):
                assert getattr(got, name) == getattr(want, name), \
                    (shape, pack, name)
            assert got.workload == TWorkload(*shape)
            assert want.workload == JWorkload(*shape)
    a = tmeta.get_scheduler_metadata(1, 1, 512, 64, 1, 128, pack_gqa=True)
    b = tmeta.get_scheduler_metadata(1, 1, 512, 64, 1, 128)
    assert a.num_splits == b.num_splits == 3
    assert tmeta.get_scheduler_metadata(1, 1, 512, 64, 1, 128,
                                        pack_gqa=False).pack_gqa is False
    with pytest.raises(KeyError):
        tmeta.get_scheduler_metadata(1, 1, 512, 64, 1, 128, policy="nope")
    assert core.get_scheduler_metadata is tmeta.get_scheduler_metadata
    assert core.SchedulerMetadata is tmeta.SchedulerMetadata
    assert core.bucket_seqlen(300) == 384


def test_inline_decode_counts_in_the_metadata_cache_as_the_reference():
    """One script of inline decode calls (no frozen plan) through both
    packages' decode op: the same hits and misses in each package's
    metadata cache, and one policy evaluation per call.  The shapes are
    ones no other test plans, so the process-wide caches have not seen
    them."""
    rng = np.random.default_rng(0)
    script = [(1, 333, 12, 3), (1, 333, 12, 3), (2, 157, 10, 5),
              (1, 333, 12, 3), (2, 157, 10, 5), (1, 709, 6, 6)]
    d = 64
    counts = {}
    for pkg in ("jax", "torch"):
        info = (jmeta if pkg == "jax" else tmeta).metadata_cache_info
        before = info()
        evals = (jops if pkg == "jax" else ops).policy_eval_count()
        for b, lk, hq, hkv in script:
            q = rng.standard_normal((b, hq, d), np.float32)
            k = rng.standard_normal((b, lk, hkv, d), np.float32)
            lens = np.full((b,), lk, np.int32)
            if pkg == "jax":
                jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(k), jnp.asarray(lens))
            else:
                ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(k),
                                     torch.from_numpy(lens))
        after = info()
        counts[pkg] = (after.hits - before.hits, after.misses - before.misses,
                       (jops if pkg == "jax" else ops).policy_eval_count()
                       - evals)
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][2] == len(script)

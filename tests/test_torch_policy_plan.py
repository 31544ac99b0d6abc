"""The port's split policies, planner and scheduler plans against the
reference: the golden decision table bit for bit, random workloads, and
a scripted bucket sequence through both schedulers."""
import json
import re
from pathlib import Path

import numpy as np
import pytest

from repro.configs.reduced import reduced_config as j_reduced_config
from repro.core import split_policy as jsp
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs.reduced import reduced_config
from repro_torch.core import split_policy as tsp
from repro_torch.plan import AttentionSpec, PlanCache, Planner
from repro_torch.serving.scheduler import Scheduler

GOLDEN = Path(__file__).parent / "golden" / "split_policy_table.json"
PORTED = ("fa3_baseline", "paper")


KEY = re.compile(r"(\w+)\|B(\d+)\|L(\d+)\|Hq(\d+)\|Hkv(\d+)\|C(\d+)"
                 r"(?:\|(\w+))?")


def _parse(key: str):
    """'paper|B1|L512|Hq16|Hkv2|C132[|int8]' -> (policy, workload, cores)."""
    policy, b, lk, hq, hkv, cores, kv = KEY.fullmatch(key).groups()
    kv = kv or "bfloat16"
    w = tsp.DecodeWorkload(int(b), 1, int(lk), int(hq), int(hkv), 128,
                           dtype_bytes=tsp.KV_DTYPES[kv], kv_dtype=kv)
    return policy, w, int(cores)


def test_golden_table_bit_exact():
    table = json.loads(GOLDEN.read_text())
    rows = [k for k in table if k.split("|")[0] in PORTED]
    assert any("C132" in k for k in rows)
    assert any(k.endswith("|int8") for k in rows)
    assert any(k.endswith("|fp8") for k in rows)
    for key in rows:
        policy, w, cores = _parse(key)
        assert tsp.choose_num_splits(w, policy=policy,
                                     num_cores=cores) == table[key], key


@pytest.mark.parametrize("num_cores", [8, 16, 132])
def test_matches_reference_on_random_workloads(num_cores):
    rng = np.random.default_rng(num_cores)
    for _ in range(400):
        b = int(rng.choice([1, 2, 3, 4, 8, 16, 64]))
        lk = int(rng.integers(1, 40_000))
        hkv = int(rng.choice([1, 2, 4, 8]))
        hq = hkv * int(rng.choice([1, 2, 4, 8, 16]))
        for policy in PORTED:
            want = jsp.choose_num_splits(
                jsp.DecodeWorkload(b, 1, lk, hq, hkv, 128), policy=policy,
                num_cores=num_cores)
            got = tsp.choose_num_splits(
                tsp.DecodeWorkload(b, 1, lk, hq, hkv, 128), policy=policy,
                num_cores=num_cores)
            assert got == want, (policy, b, lk, hq, hkv)


def test_default_machine_is_the_h100():
    assert tsp.DEFAULT_NUM_CORES == 132
    spec = AttentionSpec.decode(1, 512, 16, 2, 128)
    assert Planner(policy="paper").plan(spec).num_splits == 3
    assert Planner(policy="fa3_baseline").plan(spec).num_splits == 1
    assert Planner(policy="paper").plan(
        AttentionSpec.prefill(1, 512, 16, 2, 128)).num_splits == 1


def test_unknown_policy_raises_naming_ported_ones():
    with pytest.raises(KeyError, match="fa3_baseline.*paper"):
        tsp.get_policy("tpu_adaptive")
    with pytest.raises(KeyError):
        Planner(policy="measured")


@pytest.mark.parametrize("policy", PORTED)
def test_scheduler_plans_match_reference(policy):
    """A scripted sequence of decode positions and prompt lengths through
    both schedulers (8 cores, as the reference defaults to): same keys,
    same frozen splits, same PlanCacheStats counters."""
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2, d_model=64)
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=64)
    kw = dict(batch_slots=1, max_len=4096, policy=policy, bucket_width=128,
              prefill_bucket=64, plan_capacity=3)
    js = JScheduler(jcfg, **kw)
    ts = Scheduler(cfg, num_cores=8, **kw)
    script = [("d", 5), ("d", 127), ("d", 128), ("p", 40), ("d", 511),
              ("d", 600), ("p", 65), ("d", 1500), ("d", 5), ("p", 40),
              ("d", 4000), ("d", 511)]
    for kind, n in script:
        if kind == "d":
            je = js.decode_entry(n, lambda plan: None)
            te = ts.decode_entry(n, lambda plan: None)
        else:
            je = js.prefill_entry(n, lambda plan: None)
            te = ts.prefill_entry(n, lambda plan: None)
        assert te.key == je.key
        assert te.plan.num_splits == je.plan.num_splits, (kind, n)
        assert te.plan.bucket == je.plan.bucket
    assert ts.planned_splits() == js.planned_splits()
    jst, tst = js.plans.stats, ts.plans.stats
    assert (tst.hits, tst.misses) == (jst.hits, jst.misses)
    assert tst.launches == jst.launches
    assert tst.seen_buckets == jst.seen_buckets
    assert tst.trace == jst.trace


def test_plan_cache_eviction_counts_fresh_misses():
    cache = PlanCache(capacity=2)
    for key in (1, 2, 1, 3, 2, 1):
        cache.get_or_build(key, lambda: object())
    assert (cache.stats.hits, cache.stats.misses) == (1, 5)
    assert cache.stats.distinct_buckets == 3
    assert len(cache) == 2

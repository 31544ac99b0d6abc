"""The port's split policies, planner and scheduler plans against the
reference: the golden decision table bit for bit (``tpu_adaptive`` at
the reference's ``TPU_V5E`` model), random workloads, a scripted bucket
sequence through both schedulers, and ``plan_scope``'s precedence rules
through both packages' decode op."""
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_config as j_reduced_config
from repro.core import split_policy as jsp
from repro.kernels import ops as jops
from repro.plan import AttentionSpec as JAttentionSpec
from repro.plan import LaunchPlan as JLaunchPlan
from repro.plan import Planner as JPlanner
from repro.plan import current_plan as j_current_plan
from repro.plan import plan_scope as j_plan_scope
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.configs.reduced import reduced_config
from repro_torch.core import split_policy as tsp
from repro_torch.core.occupancy import TPU_V5E
from repro_torch.kernels import ops
from repro_torch.plan import (
    AttentionSpec,
    LaunchPlan,
    PlanCache,
    Planner,
    current_plan,
    plan_scope,
)
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
    """Every backend of the reference is ported: an unknown name raises
    naming all four, and ``measured`` without a table raises naming the
    analytic ones."""
    with pytest.raises(KeyError,
                       match="fa3_baseline.*measured.*paper.*tpu_adaptive"):
        tsp.get_policy("nope")
    with pytest.raises(KeyError):
        Planner(policy="nope")
    assert tsp.available_policies() == jsp.available_policies()
    with pytest.raises(ValueError, match="SplitTable") as ei:
        Planner(policy="measured")
    for name in tsp.analytic_policies():
        assert name in str(ei.value)
    with pytest.raises(ValueError, match="SplitTable"):
        tsp.choose_num_splits(tsp.DecodeWorkload(1, 1, 512, 16, 2),
                              policy="measured")


def test_tpu_adaptive_equals_the_golden_table_at_tpu_v5e():
    """``tpu_adaptive`` read at the reference's machine model gives all
    744 pinned golden cells (3 of them are the cells where it models
    slower than ``fa3_baseline``: kept, as the reference has them), and
    the analytic backends are the reference's."""
    table = json.loads(GOLDEN.read_text())
    rows = [k for k in table if k.startswith("tpu_adaptive|")]
    assert len(rows) == 744
    for key in rows:
        _, w, cores = _parse(key)
        assert tsp.tpu_adaptive(w, num_cores=cores, hw=TPU_V5E) \
            == table[key], key
    assert tsp.analytic_policies() == jsp.analytic_policies()
    for key in ("tpu_adaptive|B1|L4096|Hq64|Hkv1|C16",
                "tpu_adaptive|B2|L1024|Hq64|Hkv1|C132"):
        assert table[key] in (11, 4)


# the port's own tpu_adaptive decisions (H100_SXM model) at the golden
# table's B=1 C132 shapes, (H_Q, H_KV) -> [(L_K, splits)]
H100_ADAPTIVE = {
    (64, 1): [(128, 1), (256, 2), (384, 3), (448, 4), (512, 4), (640, 5),
              (1024, 8), (4096, 32), (32768, 64)],
    (16, 2): [(128, 1), (256, 2), (384, 3), (448, 4), (512, 4), (640, 5),
              (1024, 8), (4096, 32), (32768, 32)],
    (32, 4): [(128, 1), (256, 2), (384, 3), (448, 4), (512, 4), (640, 5),
              (1024, 8), (4096, 16), (32768, 16)],
}


def test_tpu_adaptive_h100_decisions_at_the_paper_shapes():
    """The port reads the cost model at ``H100_SXM`` by default; through
    the planner at 132 SMs these are its decisions."""
    for (hq, hkv), row in H100_ADAPTIVE.items():
        for lk, want in row:
            spec = AttentionSpec.decode(1, lk, hq, hkv, 128)
            assert Planner(policy="tpu_adaptive").plan(spec).num_splits \
                == want, (hq, hkv, lk)
            w = spec.workload()
            assert tsp.tpu_adaptive(w, num_cores=132) == \
                tsp.tpu_adaptive(w, num_cores=132, hw=None)


def test_planner_fields_and_context_match_the_reference():
    """pack_gqa (None packs when H_Q > H_KV, prefill never packs, an
    explicit value wins), ``context(**overrides)``, ``context_only`` and
    ``describe`` on the fields both packages have."""
    for kind, shape in (("decode", (1, 1, 512, 64, 1, 128)),
                        ("decode", (2, 1, 900, 8, 8, 128)),
                        ("prefill", (1, 512, 512, 16, 2, 128)),
                        ("verify", (2, 5, 384, 16, 2, 128))):
        for pack in (None, True, False):
            kw = dict(policy="tpu_adaptive", num_cores=16, pack_gqa=pack)
            got = Planner(**kw).plan(AttentionSpec(kind, *shape),
                                     bucket=shape[2])
            want = JPlanner(**kw).plan(JAttentionSpec(kind, *shape),
                                       bucket=shape[2])
            assert got.pack_gqa == want.pack_gqa, (kind, shape, pack)
            assert got.describe() == want.describe()
            assert got.context_only().describe() == \
                want.context_only().describe()
    ctx, jctx = (P(policy="fa3_baseline", num_cores=8).context(
        "decode", bucket=256) for P in (Planner, JPlanner))
    assert (ctx.frozen, ctx.policy, ctx.num_cores, ctx.bucket) == \
        (jctx.frozen, jctx.policy, jctx.num_cores, jctx.bucket)


# ---------------------------------------------------------------------------
# plan_scope: one stack, kind filtering, precedence (tests/test_plan.py)
# ---------------------------------------------------------------------------


def _decode_inputs(pkg):
    """tests/test_plan.py's ones-inputs: B 1, H_Q 8 over one KV head,
    L 512, D 64."""
    if pkg == "jax":
        return (jnp.ones((1, 8, 64)), jnp.ones((1, 512, 1, 64)),
                jnp.ones((1, 512, 1, 64)), jnp.array([512], jnp.int32))
    return (torch.ones(1, 8, 64), torch.ones(1, 512, 1, 64),
            torch.ones(1, 512, 1, 64), torch.tensor([512], dtype=torch.int32))


def _scope_script(pkg):
    """tests/test_plan.py's precedence cases through one package: a
    scope's policy applies without num_cores; an explicit context-only
    plan overrides the scope; a frozen scope plan is consumed with no
    inline evaluation, unless use_ctx_metadata=False; a prefill scope is
    invisible to decode.  Returns the inline plans' (policy, num_cores,
    num_splits)."""
    o, LP, PS, PL, AS = ((jops, JLaunchPlan, j_plan_scope, JPlanner,
                          JAttentionSpec) if pkg == "jax" else
                         (ops, LaunchPlan, plan_scope, Planner,
                          AttentionSpec))
    q, k, v, kv_len = _decode_inputs(pkg)
    seen = []
    o.reset_policy_eval_count()
    with PS(LP(kind="decode", policy="tpu_adaptive")):
        o.decode_attention(q, k, v, kv_len)
    assert o.policy_eval_count() == 1
    inline = o.last_inline_plan()
    assert inline is not None and inline.policy == "tpu_adaptive"
    seen.append((inline.policy, inline.num_cores, inline.num_splits))
    o.reset_policy_eval_count()
    with PS(LP(kind="decode", policy="tpu_adaptive")):
        o.decode_attention(q, k, v, kv_len,
                           plan=LP(kind="decode", policy="fa3_baseline"))
    assert o.last_inline_plan().policy == "fa3_baseline"
    with PS(LP(kind="decode", policy="paper", num_cores=132)):
        o.decode_attention(q, k, v, kv_len)
    inline = o.last_inline_plan()
    seen.append((inline.policy, inline.num_cores, inline.num_splits))
    plan = PL(policy="paper").plan(AS.decode(1, 512, 8, 1, 64))
    o.reset_policy_eval_count()
    with PS(plan):
        o.decode_attention(q, k, v, kv_len)
    assert o.policy_eval_count() == 0 and o.last_inline_plan() is None
    with PS(plan):
        o.decode_attention(q, k, v, kv_len, use_ctx_metadata=False)
    assert o.policy_eval_count() == 1
    # a prefill scope is invisible to decode
    with PS(LP(kind="prefill")):
        o.decode_attention(q, k, v, kv_len, policy="fa3_baseline")
    assert o.last_inline_plan().policy == "fa3_baseline"
    return seen


def test_scope_precedence_as_the_reference():
    """The precedence cases pass in both packages, and where the scope
    pins num_cores both resolve the same inline plan (unpinned, each
    package plans for its own default machine: 8 cores, 132 SMs)."""
    jseen, seen = _scope_script("jax"), _scope_script("torch")
    assert seen[1] == jseen[1] == ("paper", 132, 3)
    assert seen[0][:2] == ("tpu_adaptive", 132)
    assert jseen[0][:2] == ("tpu_adaptive", 8)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_scope_kind_filtering_keeps_decode_and_prefill_apart(pkg):
    LP, PS, cur = ((JLaunchPlan, j_plan_scope, j_current_plan)
                   if pkg == "jax" else
                   (LaunchPlan, plan_scope, current_plan))
    dec = LP(kind="decode", policy="paper")
    pre = LP(kind="prefill")
    with PS(dec):
        assert cur("decode") is dec
        assert cur("cross") is dec        # decode family
        assert cur("verify") is dec
        assert cur("prefill") is None
        with PS(pre):                      # inner scope shadows
            assert cur("prefill") is pre
            assert cur("decode") is None
        with PS(None):
            assert cur() is None
    assert cur() is None
    if pkg == "torch":
        with ops.decode_context(dec):
            assert ops.current_decode_context() is dec
            assert ops.current_attention_context().kind == "prefill"
        with ops.attention_context(pre):
            assert ops.current_attention_context() is pre


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

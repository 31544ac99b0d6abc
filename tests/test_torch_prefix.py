"""The port's prefix sharing against the reference's, on the CPU.

- The prefix trie and the cache manager are copies of the reference's
  host code: the same scripts of reserve / ensure / admit_prompt /
  register_prefix / release / eviction through both managers must give
  identical page tables, free lists, refcounts, queued copies and
  return values after every step.  One script is the chip smoke run's
  prefix cell (a 1000-token system prompt, 6 requests, 4 slots, page
  64), which pins 23 pages allocated against 98 unshared.
- ``lm_prefill_suffix_view`` on the same view and weights gives the
  reference's logits and rows within the model tests' float32 tolerance
  (1e-4; a bf16 cache within the prefill tolerance 3e-2; quantized
  rows: codes within one step, scales within 1e-5 relative, as
  ``tests/test_torch_quant.py`` holds them).
- Engines with ``share_prefix`` serve the JAX engine's streams, launch
  keys and page counts (tests/test_torch_cache.py holds the rest of the
  paged engine matrix).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import PrefixTrie as JPrefixTrie
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.models import build_model as j_build_model
from repro.models import lm as jlm
from repro_torch.cache import TRASH_PAGE, PrefixTrie
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import cache_from_numpy, params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import lm
from test_torch_serving import _run_both, tiny  # noqa: F401


@pytest.fixture(scope="module")
def models():
    """The reduced qwen2.5-3b model object of each package (managers need
    only its cache shapes)."""
    jmodel = j_build_model(j_reduced_config("qwen2.5-3b", num_layers=2,
                                            d_model=32))
    model = build_model(reduced_config("qwen2.5-3b", num_layers=2,
                                       d_model=32), device="cpu")
    return jmodel, model


# ---------------------------------------------------------------------------
# Manager scripts, step for step against the reference
# ---------------------------------------------------------------------------


def _state(mgr):
    return (mgr._table.tolist(), list(mgr._free), mgr.refcount.tolist(),
            list(mgr._pending_copies), mgr._allocated.tolist(),
            mgr.kv_len.tolist(), mgr.pages_allocated_total,
            mgr.prefix_hits, mgr.prefix_shared_rows, mgr.prefix_copies,
            None if mgr.trie is None else sorted(mgr.trie.pages()))


def _apply(mgr, op):
    name, *args = op
    if name == "admit":
        return mgr.admit_prompt(*args)
    if name == "register":
        return mgr.register_prefix(*args)
    if name == "reserve":
        return mgr.reserve(*args)
    if name == "ensure":
        return mgr.ensure(*args)
    if name == "note":
        return mgr.note_write(*args)
    if name == "can_admit":
        return mgr.can_admit(*args)
    if name == "release":
        return mgr.release(*args)
    if name == "drain":
        return mgr.drain_copies()
    if name == "reset":
        return mgr.reset_prefix()
    if name == "truncate":
        return mgr.truncate(*args)
    raise ValueError(name)


def _serving_script(prompts, new_tokens, slots):
    """What the engine asks of its manager serving ``prompts`` (each
    generating ``new_tokens``) through ``slots`` lockstep slots: admit
    and register at admission, one ensure a decode step per live slot,
    a release at each finish."""
    pending, live, ops_ = list(prompts), {}, []
    while pending or live:
        for s in range(slots):
            if s not in live and pending:
                p = pending.pop(0)
                ops_ += [("admit", s, p), ("drain",),
                         ("note", s, len(p) - 1), ("register", s, p)]
                live[s] = [len(p), new_tokens - 1]
        for s in sorted(live):
            if live[s][1] == 0:
                ops_.append(("release", s))
                del live[s]
                continue
            ops_ += [("ensure", s, live[s][0]), ("drain",),
                     ("note", s, live[s][0])]
            live[s][0] += 1
            live[s][1] -= 1
    return ops_


def _chip_prompts():
    """chip_smoke.py's prefix cell (``prefix_prompts``): a 1000-token
    system prompt (15 full pages of 64 and 40 rows), six requests with
    unique tails of 4-11 tokens, drawn from qwen2.5-3b's vocabulary."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, 151936, 1000).tolist()
    rng.integers(0, 151936, 1000)             # the warm-up's system prompt
    return [system + rng.integers(0, 151936, int(n)).tolist()
            for n in rng.integers(4, 12, 6)]


P9 = [(3 * j) % 11 + 1 for j in range(9)]      # 2 full pages + 1 row
P12 = list(range(1, 13))                       # 3 full pages
A8 = list(range(1, 9))
SCRIPTS = {
    # adoption, refcounts, an idempotent release, reset
    "adoption": (dict(batch=2, max_len=32, page_size=4, budget=8),
                 [("admit", 0, P9), ("register", 0, P9), ("admit", 1, P9),
                  ("release", 0), ("release", 0), ("release", 1),
                  ("reset",)]),
    # a prompt ending mid-page adopts the donor's page by copy
    "boundary_copy": (dict(batch=2, max_len=32, page_size=4, budget=8),
                      [("admit", 0, P12), ("register", 0, P12),
                       ("admit", 1, P12[:6]), ("drain",), ("release", 0),
                       ("release", 1)]),
    # a write into an adopted page moves the writer to a private copy
    "copy_on_write": (dict(batch=2, max_len=32, page_size=4, budget=8),
                      [("admit", 0, P9), ("register", 0, P9),
                       ("admit", 1, P9), ("drain",), ("ensure", 1, 0),
                       ("drain",), ("ensure", 1, 9), ("release", 1)]),
    # anchored-only pages yield to a disjoint prompt when the pool is dry
    "eviction": (dict(batch=2, max_len=16, page_size=4, budget=4),
                 [("admit", 0, P9), ("register", 0, P9),
                  ("can_admit", P9), ("can_admit", list(range(90, 99))),
                  ("release", 0), ("can_admit", list(range(90, 99))),
                  ("admit", 1, list(range(90, 99))),
                  ("register", 1, list(range(90, 99)))]),
    # an admission the pool cannot cover leaves no trace
    "rollback": (dict(batch=2, max_len=16, page_size=4, budget=3),
                 [("admit", 0, A8), ("register", 0, A8),
                  ("admit", 1, A8 + list(range(50, 58))), ("drain",),
                  ("reserve", 1, 4), ("ensure", 1, 4), ("ensure", 1, 8)]),
}


@pytest.mark.parametrize("name", list(SCRIPTS) + ["chip_prefix_phase"])
def test_manager_script_matches_reference(models, name):
    jmodel, model = models
    if name == "chip_prefix_phase":
        prompts = _chip_prompts()
        kw = dict(batch=4, max_len=2048, page_size=64, budget=None)
        script = _serving_script(prompts, 16, 4)
    else:
        kw, script = SCRIPTS[name]
    arms = {}
    for share in ((True, False) if name == "chip_prefix_phase"
                  else (True,)):
        mgrs = [m.cache_manager(kw["batch"], kw["max_len"], layout="paged",
                                page_size=kw["page_size"],
                                page_budget=kw["budget"], share_prefix=share,
                                prefix_capacity=kw.get("capacity"))
                for m in (jmodel, model)]
        for op in script:
            got = _apply(mgrs[1], op)
            want = _apply(mgrs[0], op)
            assert got == want, (op, got, want)
            assert _state(mgrs[1]) == _state(mgrs[0]), op
            mgrs[1].check_conservation()
            assert mgrs[1].refcount[TRASH_PAGE] == 0
        assert mgrs[1].describe() == mgrs[0].describe()
        arms[share] = mgrs[1].pages_allocated_total
    if name == "chip_prefix_phase":
        # chip_smoke.py's PREFIX_PAGES: the leader's 16 or 17 pages and
        # one or two private pages for each follower, against 16 or 17
        # pages for every request
        assert arms == {True: 23, False: 98}


@pytest.mark.parametrize("seed,budget", [(0, 14), (1, 9)])
def test_seeded_script_matches_reference(models, seed, budget):
    """One seeded script drawn step by step from numpy over a family of
    prompts sharing prefixes: admissions (with their gate), decode-row
    ensures, rollbacks (``truncate``, then a write at the rolled-back row,
    which can land in an adopted page), releases and trie resets, through
    both managers.  After every operation the returns, page tables, free
    lists, refcounts, queued copies and counters are equal, and the
    port's pool is conserved.  The script holds at least one
    copy-on-write and one boundary adoption (a copy queued by an
    admission), at two page budgets.  The trie is unbounded: under
    ``prefix_capacity`` the port departs from the reference on purpose
    (the next test)."""
    jmodel, model = models
    kw = dict(layout="paged", page_size=4, page_budget=budget,
              share_prefix=True)
    jmgr = jmodel.cache_manager(3, 32, **kw)
    mgr = model.cache_manager(3, 32, **kw)
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 50, 24).tolist()
    pos, copies = {}, {"admit": 0, "ensure": 0}

    def both(*op):
        got, want = _apply(mgr, op), _apply(jmgr, op)
        assert got == want, (op, got, want)
        assert _state(mgr) == _state(jmgr), op
        mgr.check_conservation()
        return got

    for _ in range(120):
        s = int(rng.integers(3))
        r = rng.random()
        if s not in pos:
            n = int(rng.integers(2, 24))
            tail = rng.integers(50, 99, int(rng.integers(0, 4))).tolist()
            p = base[:n] + tail
            if not both("can_admit", p):
                continue
            if both("admit", s, p) is None:
                continue
            copies["admit"] += len(both("drain"))
            both("note", s, len(p) - 1)
            both("register", s, p)
            pos[s] = len(p)
        elif r < 0.6 and pos[s] < 32:
            if both("ensure", s, pos[s]):
                copies["ensure"] += len(both("drain"))
                both("note", s, pos[s])
                pos[s] += 1
        elif r < 0.75:
            pos[s] = int(rng.integers(0, pos[s]))
            both("truncate", s, pos[s])
        elif r < 0.97:
            both("release", s)
            del pos[s]
        else:
            both("reset")
    assert copies["admit"] > 0 and copies["ensure"] > 0, copies


def test_bounded_trie_keeps_the_pages_it_anchors(models):
    """A fault of the reference, repaired in the port: registering a
    prompt with more full pages than ``prefix_capacity`` made the
    reference's manager evict a node it had just anchored (its trie
    reference is counted only after the insert), freeing a page the slot
    still holds.  The port keeps the prompt's own pages: the trie anchors
    the first two, the rest stay private, and the pool is conserved
    through a second registration that evicts LRU anchors."""
    jmodel, model = models
    kw = dict(layout="paged", page_size=4, page_budget=10,
              share_prefix=True, prefix_capacity=2)
    jmgr = jmodel.cache_manager(2, 32, **kw)
    mgr = model.cache_manager(2, 32, **kw)
    for m in (jmgr, mgr):
        m.admit_prompt(0, P12)
        m.register_prefix(0, P12)
    with pytest.raises(AssertionError, match="refcount drift"):
        jmgr.check_conservation()
    mgr.check_conservation()
    assert sorted(mgr.trie.pages()) == [1, 2]
    assert mgr.refcount[1:4].tolist() == [2, 2, 1]
    mgr.release(0)
    other = list(range(40, 49))
    assert mgr.admit_prompt(1, other) == 0
    assert mgr.register_prefix(1, other) == 2
    mgr.check_conservation()
    assert sorted(mgr.trie.pages()) == \
        sorted(int(p) for p in mgr._table[1, :2])


def test_trie_matches_reference():
    """match / insert / pop_evictable over one prefix family."""
    tries = (JPrefixTrie(4, capacity=3), PrefixTrie(4, capacity=3))
    base = [(7 * j) % 5 + 1 for j in range(16)]
    for n in (9, 16, 6, 13, 3, 12):
        prompt = base[:n]
        res = []
        for t in tries:
            m = t.match(prompt)
            new = t.insert(prompt, list(range(100 + n, 120 + n)),
                           can_add=lambda t=t: len(t) < t.capacity)
            res.append((m.pages, m.boundary_page, m.boundary_rows, new,
                        sorted(t.pages()), len(t)))
        assert res[0] == res[1], n
    popped = [t.pop_evictable(lambda p: p % 2 == 0) for t in tries]
    assert popped[0] == popped[1]


# ---------------------------------------------------------------------------
# lm_prefill_suffix_view against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair_f32():
    f32 = dict(dtype="float32", param_dtype="float32")
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2,
                            d_model=32).replace(**f32)
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32).replace(**f32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jmodel.init_params(jax.random.PRNGKey(5)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jparams, cfg, params


def _codes(x) -> np.ndarray:
    a = x.view(torch.uint8).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).view(np.uint8)
    if str(x.dtype).endswith("int8"):
        return a.view(np.int8).astype(np.int32)
    mag = (a & 0x7F).astype(np.int32)
    return np.where(a & 0x80, -mag, mag)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("start,n,mb,view_len", [
    (16, 23, 16, 32),      # suffix inside the view
    (24, 30, 16, 32),      # the padded suffix runs past the view's end
])
def test_suffix_prefill_matches_reference(pair_f32, kv_dtype, start, n, mb,
                                          view_len):
    """A view whose rows [0, start) hold the prompt's prefix (from a full
    prefill of the prompt) is suffix-prefilled from ``start`` in both
    packages: the last row's logits and the suffix rows agree."""
    jcfg, jparams, cfg, params = pair_f32
    rng = np.random.default_rng(start + n)
    prompt = rng.integers(1, 256, n).astype(np.int32)
    full = np.zeros(view_len, np.int32)
    full[:n] = prompt
    _, jview = jlm.lm_prefill_view(jparams, jcfg, jnp.asarray(full),
                                   jnp.int32(n), view_len,
                                   kv_dtype=kv_dtype)
    view = cache_from_numpy(jax.tree.map(np.asarray, jview), cfg,
                            device="cpu")
    suffix = np.zeros(mb, np.int32)
    suffix[:n - start] = prompt[start:]
    jlogits, jview = jlm.lm_prefill_suffix_view(
        jparams, jcfg, jview, jnp.asarray(suffix), jnp.int32(start),
        jnp.int32(n), kv_dtype=kv_dtype)
    logits = lm.lm_prefill_suffix_view(params, cfg, view,
                                       torch.from_numpy(suffix).long(),
                                       start, n, kv_dtype=kv_dtype)
    # a bf16 cache rounds K/V to bf16 in both packages, at other places:
    # the prefill tolerance
    tol = dict(rtol=3e-2, atol=3e-2) if kv_dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    jv = jview[0][0]
    rows = slice(start, n)
    if kv_dtype in ("float32", "bfloat16"):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                view[name][:, 0, rows].float().numpy(),
                np.asarray(jv[name][:, 0, rows]).astype(np.float32), **tol)
        return
    for name in ("k", "v"):
        got = _codes(view[name][:, 0, rows].contiguous())
        want = _codes(np.asarray(jv[name][:, 0, rows]))
        assert np.abs(got - want).max() <= 1
        np.testing.assert_allclose(view[name + "_s"][:, 0, rows].numpy(),
                                   np.asarray(jv[name + "_s"][:, 0, rows]),
                                   rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# Engines with share_prefix against the JAX engine
# ---------------------------------------------------------------------------


def _shared_prompts(lens=(9, 4, 12, 6), system=40):
    base = [(3 * j) % 150 + 1 for j in range(system)]
    return [base + [(7 * i + j) % 150 + 1 for j in range(n)]
            for i, n in enumerate(lens)]


def _sfx(stats, kind):
    return sum(v for k, v in stats.launches.items()
               if isinstance(k, tuple) and k[0] == kind)


@pytest.mark.parametrize("scfg_kw", [
    dict(cache_page_size=16),
    dict(cache_page_size=16, kv_quant="int8"),
    dict(cache_page_size=16, cache_page_budget=9, prefix_capacity=3),
])
def test_shared_engine_matches_jax_engine(tiny, scfg_kw):
    """Four requests opening with one 40-token system prompt (2 full
    pages of 16) through 2 slots, sharing on: the JAX engine's streams,
    finish reasons, launch keys (1 full prefill, 3 suffix prefills), pages
    allocated and prefix counters; zero policy evaluations; conservation."""
    prompts = _shared_prompts()
    jeng, jdone, eng, done = _run_both(
        tiny, max_len=128, prompts=prompts, cache_layout="paged",
        share_prefix=True, prefill_bucket=32, **scfg_kw)
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert [c.finish_reason for c in done] == \
        [c.finish_reason for c in jdone]
    assert eng.stats.launches == jeng.stats.launches
    assert (_sfx(eng.stats, "prefill"), _sfx(eng.stats, "sprefill")) == (1, 3)
    assert eng.planned_suffix_buckets() == jeng.planned_suffix_buckets()
    assert eng.cache_stats() == jeng.cache_stats()
    assert ops.policy_eval_count() == 0
    eng.cache.check_conservation()


def test_prefix_ab_workload_matches_reference():
    """``benchmarks/prefix_ab.py``'s full workload (6 requests opening with
    one 100-token system prompt, page 32, 4 slots, the reduced qwen2.5-3b
    at d_model 64) through the JAX engine and the port's, shared and
    unshared, after the benchmark's warm-up on another system prompt.  In
    the timed phase: the same streams and launch keys in both packages;
    shared 1 full and 5 suffix prefills against 6 full, 9 pages allocated
    against 24 (the committed ``experiments/bench/prefix_ab.csv``), 5
    prefix hits serving 480 rows; no policy evaluation; conservation."""
    from benchmarks.prefix_ab import _workload
    from repro.configs.base import ServeConfig as JServeConfig
    from repro.kernels import ops as jops
    from repro.serving import Request as JRequest
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving import Request, ServingEngine
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2, d_model=64)
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=64)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    model = build_model(cfg, device="cpu")
    prompts, warm, knobs = _workload(smoke=False)
    got = {}
    for share in (True, False):
        runs = []
        for pkg, (eng_cls, scfg_cls, req_cls, m, c, p, kw) in (
                ("jax", (JServingEngine, JServeConfig, JRequest, jmodel,
                         jcfg, jparams, {})),
                ("torch", (ServingEngine, ServeConfig, Request, model, cfg,
                           params, dict(device="cpu")))):
            eng = eng_cls(m, scfg_cls(model=c, cache_layout="paged",
                                      cache_page_size=knobs["page"],
                                      prefill_bucket=knobs["page"],
                                      share_prefix=share),
                          max_len=knobs["max_len"],
                          batch_slots=knobs["slots"], **kw)
            eng.load(p)
            for i, q in enumerate(warm):
                eng.submit(req_cls(i, q, max_new_tokens=knobs["max_new"]))
            eng.drain()
            base = dict(eng.stats.launches)
            cache = eng.cache
            before = (cache.pages_allocated_total, cache.prefix_hits,
                      cache.prefix_shared_rows)
            jops.reset_policy_eval_count()
            ops.reset_policy_eval_count()
            for i, q in enumerate(prompts):
                eng.submit(req_cls(i, q, max_new_tokens=knobs["max_new"]))
            done = eng.drain()
            kinds = {}
            for key, n in eng.stats.launches.items():
                if isinstance(key, tuple) and n > base.get(key, 0):
                    kinds[key[0]] = kinds.get(key[0], 0) + n - base.get(
                        key, 0)
            evals = (jops if pkg == "jax" else ops).policy_eval_count()
            cache.check_conservation()
            runs.append(([c.tokens for c in done], dict(eng.stats.launches),
                         kinds, tuple(a - b for a, b in zip(
                             (cache.pages_allocated_total, cache.prefix_hits,
                              cache.prefix_shared_rows), before)), evals))
        assert runs[1] == runs[0], share
        got[share] = runs[1][2:]
    assert got[True] == ({"prefill": 1, "sprefill": 5}, (9, 5, 480), 0)
    assert got[False] == ({"prefill": 6}, (24, 0, 0), 0)


"""The port's paged KV cache against the reference's, on the CPU.

- ``CacheSpec`` is a copy: the same extents and the same refusals.
- The paged layout's device-side entry points (``ops.gather_pages`` /
  ``scatter_pages`` and the layout's ``gather_view``, ``scatter_view``,
  ``write_token``, ``slot_view``, ``write_slot``, ``copy_page``) move the
  reference's bits
  on the same numpy storage, bf16 and int8, every page but the trash
  page (whose content the reference leaves nondeterministic too).
- ``write_slot`` in both layouts lands only the view's rows from its
  ``first_page`` on, and pads a paged view that ends inside a page.
- ``ops.decode_attention`` takes ``PagedKV`` views, as the reference's.
- Admission waits at the queue's head for free pages.
- Paged engines (dense-equivalent page budget, a budget tight enough for
  a ``cache_capacity`` finish, loop and fused admission, bf16 and int8)
  serve the JAX engine's streams, finish reasons, launch keys and page
  counts, and the port's own dense engine's streams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import CacheSpec as JCacheSpec
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.kernels import ops as jops
from repro.models import build_model as j_build_model
from repro_torch.cache import CacheSpec
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import cache_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.quant import QuantizedKV
from repro_torch.serving import Request, SamplingParams, ServingEngine
from test_torch_serving import _reqs, _run_both, tiny  # noqa: F401


@pytest.mark.parametrize("kw", [
    dict(family="dense", batch=2, max_len=100, layout="paged", page_size=16),
    dict(family="dense", batch=3, max_len=64, layout="paged", page_size=64,
         page_budget=5, share_prefix=True, prefix_capacity=2),
    dict(family="dense", batch=2, max_len=64),
])
def test_cache_spec_matches_reference(kw):
    got, want = CacheSpec(**kw), JCacheSpec(**kw)
    assert (got.slot_pages, got.total_pages, got.pool_pages) == \
        (want.slot_pages, want.total_pages, want.pool_pages)
    for n in (0, 1, 15, 16, 17, 64, 100, 1000):
        assert got.pages_for(n) == want.pages_for(n)
        if n:
            assert got.view_pages(n) == want.view_pages(n)


@pytest.mark.parametrize("kw,match", [
    (dict(layout="ring"), "unknown cache layout"),
    (dict(share_prefix=True), "share_prefix"),
    (dict(layout="paged", page_size=0), "page_size"),
    (dict(layout="paged", page_budget=0), "page_budget"),
])
def test_cache_spec_refuses_as_the_reference(kw, match):
    for cls in (CacheSpec, JCacheSpec):
        with pytest.raises(ValueError, match=match):
            cls("dense", 2, 64, **kw)


# ---------------------------------------------------------------------------
# Gather / scatter / write paths, bit for bit
# ---------------------------------------------------------------------------


def _numpy_like(rng, a):
    a = np.asarray(a)
    if a.dtype == np.int8:
        return rng.integers(-127, 128, a.shape).astype(np.int8)
    return rng.standard_normal(a.shape).astype(a.dtype)


def _bits(a) -> np.ndarray:
    """A tensor's or an array's bytes, as uint8 (last dim widened)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_paged_layout_moves_the_reference_bits(kv_dtype):
    """Random pool contents and views through both layouts: equal pools
    (pages 1..) and equal views after every entry point."""
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    B, L, ps = 3, 128, 16
    kw = dict(layout="paged", page_size=ps, page_budget=20)
    jmgr = j_build_model(jcfg).cache_manager(B, L, kv_dtype, **kw)
    mgr = build_model(cfg, device="cpu").cache_manager(B, L, kv_dtype, **kw)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: _numpy_like(rng, a), jmgr.init_storage())
    jstore = jax.tree.map(jnp.asarray, tree)
    store = cache_from_numpy(tree, cfg, device="cpu")
    for m in (jmgr, mgr):
        assert m.reserve(0, 50) and m.reserve(1, 17) and m.reserve(2, 64)
    for fn in ("storage_bytes", "dense_bytes", "row_bytes"):
        assert getattr(mgr.layout, fn)() == getattr(jmgr.layout, fn)(), fn
    assert mgr.layout.attended_bytes(64) == jmgr.layout.attended_bytes(64)
    jtable = jmgr.table_device()
    table = mgr.table_device()
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))

    def same(jtree, tdict, pool=False):
        for name, a in jtree[0][0].items():
            a, t = _bits(a), _bits(tdict[name])
            if pool:                   # the trash page is not compared
                a, t = a[:, 1:], t[:, 1:]
            np.testing.assert_array_equal(t, a, err_msg=name)

    n = 4                                   # a 64-row view per slot
    same(jmgr.layout.gather_view(jstore, jtable, n),
         mgr.layout.gather_view(store, table, n))
    # ops level: one pool tensor, no layer axis
    jk, k = jstore[0][0]["k"][0], store["k"][0]
    np.testing.assert_array_equal(
        _bits(ops.gather_pages(k, table, num_pages=n)),
        _bits(jops.gather_pages(jk, jtable, num_pages=n)))
    vtree = jax.tree.map(lambda a: _numpy_like(rng, a),
                         jmgr.layout.gather_view(jstore, jtable, n))
    view = cache_from_numpy(vtree, cfg, device="cpu")
    jv = jax.tree.map(jnp.asarray, vtree)
    np.testing.assert_array_equal(
        _bits(ops.scatter_pages(k.clone(), view["k"][0], table,
                                num_pages=n))[1:],
        _bits(jops.scatter_pages(jk, jv[0][0]["k"][0], jtable,
                                 num_pages=n))[1:])
    # a whole view back into every slot's pages
    jstore = jmgr.layout.scatter_view(jstore, jv, jtable, n)
    mgr.layout.scatter_view(store, view, table, n)
    same(jstore, store, pool=True)
    # decode: the page holding each slot's row goes back
    t = np.array([49, 16, 63])
    jstore = jmgr.layout.write_token(jstore, jv, jtable,
                                     jnp.asarray(t, jnp.int32), n)
    mgr.layout.write_token(store, view, table, torch.from_numpy(t), n)
    same(jstore, store, pool=True)
    # fused and suffix prefill: a slot's view out and back
    for slot in (0, 2):
        same(jmgr.layout.slot_view(jstore, jtable, jnp.int32(slot), n),
             mgr.layout.slot_view(store, table, slot, n))
        one = jax.tree.map(lambda a: _numpy_like(rng, a),
                           jmgr.layout.slot_view(jstore, jtable,
                                                 jnp.int32(slot), n))
        jstore = jmgr.layout.write_slot(
            jstore, jax.tree.map(jnp.asarray, one), jtable,
            jnp.int32(slot), n)
        mgr.layout.write_slot(store, cache_from_numpy(one, cfg,
                                                      device="cpu"),
                              table, slot, n)
        same(jstore, store, pool=True)
    # copy-on-write's page copy
    jstore = jmgr.layout.copy_page(jstore, jnp.int32(3), jnp.int32(9))
    mgr.layout.copy_page(store, 3, 9)
    same(jstore, store, pool=True)


@pytest.mark.parametrize("layout,rows,first_page", [
    ("dense", 40, 0), ("dense", 64, 2), ("paged", 64, 0), ("paged", 64, 2),
    ("paged", 40, 0), ("paged", 40, 1)])
def test_write_slot_lands_only_the_view_rows(layout, rows, first_page):
    """A batch-1 view of ``rows`` rows written into slot 1 from page
    ``first_page`` on: the slot reads back the view's rows [first_page *
    page, rows), its rows before them and every other slot are unchanged,
    and a paged view that ends inside its last page is zero-padded to
    it (suffix prefill writes from the page of its first row on, so
    adopted prefix pages are never written)."""
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    ps, n = 16, 4
    mgr = build_model(cfg, device="cpu").cache_manager(
        3, 128, "bfloat16", layout=layout, page_size=ps)
    assert mgr.reserve(0, 64) and mgr.reserve(1, 64)
    gen = torch.Generator().manual_seed(0)
    store = {name: torch.randn(t.shape, generator=gen).to(t.dtype)
             for name, t in mgr.init_storage().items()}
    table = mgr.table_device()
    before = mgr.layout.gather_view({name: t.clone()
                                     for name, t in store.items()},
                                    table, n)
    view = {name: torch.randn(t.shape[:1] + (1, rows) + t.shape[3:],
                              generator=gen).to(t.dtype)
            for name, t in store.items()}
    mgr.layout.write_slot(store, view, table, 1, n, first_page=first_page)
    after = mgr.layout.gather_view(store, table, n)
    lo = first_page * ps
    for name, got in after.items():
        old, new = before[name][:, :, :n * ps], got[:, :, :n * ps]
        assert torch.equal(new[:, 1, lo:rows], view[name][:, 0, lo:rows])
        assert torch.equal(new[:, 1, :lo], old[:, 1, :lo])
        tail = (torch.zeros_like(new[:, 1, rows:]) if layout == "paged"
                else old[:, 1, rows:])
        assert torch.equal(new[:, 1, rows:], tail)
        for other in (0, 2):
            assert torch.equal(new[:, other], old[:, other])


def test_decode_attention_accepts_paged_kv_views():
    """A ``PagedKV`` view per tensor attends as its gathered dense view,
    and as the reference's op on the same pool and table; over a quantized
    cache too."""
    rng = np.random.default_rng(0)
    B, hq, hkv, D, ps, n = 2, 4, 1, 8, 16, 3
    kp, vp = (rng.standard_normal((2 * n + 1, ps, hkv, D)).astype(np.float32)
              for _ in range(2))
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    kv_len = np.array([40, 17], np.int32)
    q = rng.standard_normal((B, hq, D)).astype(np.float32)
    tk, tv, tt, tq = (torch.from_numpy(a) for a in (kp, vp, table, q))
    pk, pv = ops.PagedKV(tk, tt, n), ops.PagedKV(tv, tt, n)
    assert pk.view_len == 48
    got = ops.decode_attention(tq, pk, pv, torch.from_numpy(kv_len))
    dense = ops.decode_attention(
        tq, ops.gather_pages(tk, tt, num_pages=n),
        ops.gather_pages(tv, tt, num_pages=n), torch.from_numpy(kv_len))
    assert torch.equal(got, dense)
    jt = jnp.asarray(table)
    want = jops.decode_attention(
        jnp.asarray(q), jops.PagedKV(jnp.asarray(kp), jt, n),
        jops.PagedKV(jnp.asarray(vp), jt, n), jnp.asarray(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # a quantized cache: codes and scales paged alike, through
    # decode_attention_quant
    codes = [torch.from_numpy(rng.integers(-127, 128, kp.shape)
                              .astype(np.int8)) for _ in range(2)]
    scales = [torch.from_numpy(rng.random(kp.shape[:3]).astype(np.float32))
              for _ in range(2)]
    paged = QuantizedKV(*(ops.PagedKV(x, tt, n) for x in codes + scales))
    dense = QuantizedKV(*(ops.gather_pages(x, tt, num_pages=n)
                          for x in codes + scales))
    assert torch.equal(
        ops.decode_attention_quant(tq, paged, torch.from_numpy(kv_len)),
        ops.decode_attention_quant(tq, dense, torch.from_numpy(kv_len)))


# ---------------------------------------------------------------------------
# Paged engines against the JAX engine and the port's dense engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run_kw", [
    dict(cache_page_size=16),
    dict(cache_page_size=32, kv_quant="int8"),
    dict(cache_page_size=16, prefill_mode="loop"),
    # 5 pages of 16 over two long requests: each finishes on its own
    # page exhaustion
    dict(cache_page_size=16, cache_page_budget=5, max_len=128,
         reqs_kw=dict(max_new=(60, 60, 3, 3)),
         prompts=[list(range(1, 40)), list(range(1, 30)), [5, 6], [7]]),
])
def test_paged_engine_matches_jax_engine(tiny, run_kw):
    """Refills through 2 slots: the JAX engine's streams, finish reasons,
    launch keys and page counts; the port's dense engine's streams;
    conservation after the drain; zero policy evaluations."""
    run_kw = dict(run_kw)
    tight = "cache_page_budget" in run_kw
    max_len = run_kw.pop("max_len", 64)
    reqs_kw = run_kw.pop("reqs_kw", None)
    prompts = run_kw.pop("prompts", None)
    jeng, jdone, eng, done = _run_both(tiny, max_len=max_len,
                                       reqs_kw=reqs_kw, prompts=prompts,
                                       cache_layout="paged", **run_kw)
    assert ops.policy_eval_count() == 0
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    reasons = [c.finish_reason for c in done]
    assert reasons == [c.finish_reason for c in jdone]
    if tight:
        assert reasons[:2] == ["cache_capacity"] * 2
    assert eng.stats.launches == jeng.stats.launches
    assert eng.cache_stats() == jeng.cache_stats()
    assert eng.cache.pages_allocated_total == \
        jeng.cache.pages_allocated_total
    eng.cache.check_conservation()
    if not tight:
        run_kw.pop("cache_page_size")
        *_, ddone = _run_both(tiny, max_len=max_len, reqs_kw=reqs_kw,
                              prompts=prompts, **run_kw)
        assert [c.tokens for c in ddone] == [c.tokens for c in done]


def test_admission_waits_for_free_pages(tiny):
    """Three slots over 6 pages of 16: two 40-token prompts hold every
    page, so the third request waits at the queue's head with a slot free
    until the first finish frees pages.  The JAX engine takes the same
    launches and finishes; the streams are held against the port's dense
    engine, because the JAX engine's part from the port's at a bf16
    near-tie (request 1's last token, top-2 logit margin 0.0098 in both
    of the port's layouts), which ROADMAP lists as expected across
    frameworks."""
    prompts = [list(range(1, 41)), list(range(2, 42)), [5, 6, 7]]
    kw = dict(cache_layout="paged", cache_page_size=16, cache_page_budget=6)
    reqs_kw = dict(max_new=(4, 6, 3))
    jeng, jdone, eng, done = _run_both(tiny, slots=3, max_len=128,
                                       prompts=prompts, reqs_kw=reqs_kw,
                                       **kw)
    assert eng.stats.launches == jeng.stats.launches
    assert [(len(c.tokens), c.finish_reason) for c in done] == \
        [(len(c.tokens), c.finish_reason) for c in jdone]
    *_, ddone = _run_both(tiny, slots=3, max_len=128, prompts=prompts,
                          reqs_kw=reqs_kw)
    assert [c.tokens for c in done] == [c.tokens for c in ddone]
    _, _, _, cfg, model, params = tiny
    eng = ServingEngine(model, ServeConfig(model=cfg, **kw), max_len=128,
                        batch_slots=3, device="cpu")
    eng.load(params)
    for r in _reqs(Request, SamplingParams, prompts=prompts, **reqs_kw):
        eng.submit(r)
    eng.step()
    assert [st.request.request_id for _, st in eng.sched.live()] == [0, 1]
    assert len(eng.sched.pending) == 1 and eng.cache.free_pages == 0
    while eng.sched.pending:
        eng.step()
    assert [(i, st.request.request_id) for i, st in eng.sched.live()] == \
        [(0, 2), (1, 1)]
    eng.drain()
    eng.cache.check_conservation()


def test_paged_needs_the_metadata_path_and_page_aligned_buckets(tiny):
    _, _, _, cfg, model, _ = tiny
    with pytest.raises(ValueError, match="metadata-enabled"):
        ServingEngine(model, ServeConfig(model=cfg, cache_layout="paged",
                                         use_scheduler_metadata=False),
                      max_len=64, batch_slots=2, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(model, ServeConfig(model=cfg, cache_layout="paged",
                                         cache_page_size=48),
                      max_len=96, batch_slots=2, device="cpu")
    with pytest.raises(ValueError, match="cache_layout='paged'"):
        ServingEngine(model, ServeConfig(model=cfg, share_prefix=True),
                      max_len=64, batch_slots=2, device="cpu")
    with pytest.raises(ValueError, match="prefill_mode='loop'"):
        ServingEngine(model, ServeConfig(model=cfg, share_prefix=True,
                                         cache_layout="paged",
                                         prefill_mode="loop"),
                      max_len=64, batch_slots=2, device="cpu")


def test_paged_engine_refuses_a_pool_filling_prompt(tiny):
    """A prompt whose pages fill the pool could never write its first
    decode row: refused at submit.  One row of headroom serves."""
    _, _, _, cfg, model, params = tiny
    eng = ServingEngine(model, ServeConfig(model=cfg, cache_layout="paged",
                                           cache_page_size=16,
                                           cache_page_budget=3),
                        max_len=128, batch_slots=2, device="cpu")
    eng.load(params)
    with pytest.raises(ValueError, match="page budget"):
        eng.submit(Request(0, list(range(1, 49)), max_new_tokens=4))
    eng.submit(Request(1, list(range(1, 48)), max_new_tokens=1))
    outs = eng.drain()
    assert [c.finish_reason for c in outs] == ["length"]
    assert eng.cache_stats()["free_pages"] == 3

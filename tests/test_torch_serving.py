"""The port's ServingEngine against the JAX one, on the CPU.

Same weights (JAX-initialised, passed through ``repro_torch.interop``),
same requests, both engines with a greedy sampler: the token streams,
finish reasons and launch counters must be identical.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.models import build_model as j_build_model
from repro.serving import GreedySampler as JGreedySampler
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving import (
    FINISHED,
    GreedySampler,
    Request,
    SamplingParams,
    ServingEngine,
)


@pytest.fixture(scope="module")
def tiny():
    """The tiny_model config of tests/test_serving_api.py, in both
    packages, with one set of JAX-initialised weights."""
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = build_model(cfg, device="cpu")
    return jcfg, jmodel, jparams, cfg, model, params_from_numpy(
        tree, cfg, device="cpu")


def _reqs(cls, sp_cls, lens=(3, 9, 2, 5), max_new=(6, 4, 8, 5), **kw):
    return [cls(i, [(7 * i + j) % 200 + 1 for j in range(n)],
                max_new_tokens=m, sampling=sp_cls(), **kw)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _run_both(tiny, *, slots=2, max_len=64, reqs_kw=None, **scfg_kw):
    jcfg, jmodel, jparams, cfg, model, params = tiny
    reqs_kw = reqs_kw or {}
    jeng = JServingEngine(jmodel, JServeConfig(model=jcfg, **scfg_kw),
                          max_len=max_len, batch_slots=slots,
                          sampler=JGreedySampler())
    jeng.load(jparams)
    for r in _reqs(JRequest, JSamplingParams, **reqs_kw):
        jeng.submit(r)
    jdone = jeng.drain()

    ops.reset_policy_eval_count()
    eng = ServingEngine(model, ServeConfig(model=cfg, **scfg_kw),
                        max_len=max_len, batch_slots=slots,
                        sampler=GreedySampler(), device="cpu")
    eng.load(params)
    for r in _reqs(Request, SamplingParams, **reqs_kw):
        eng.submit(r)
    done = eng.drain()
    return jeng, jdone, eng, done


def _launches(stats, prefill: bool) -> int:
    return sum(v for k, v in stats.launches.items()
               if isinstance(k, tuple) == prefill)


def test_configs_match_reference(tiny):
    jcfg, _, _, cfg, _, _ = tiny
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "resolved_head_dim", "qkv_bias", "rope_theta",
              "norm_eps", "dtype", "mlp_kind", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_streams_and_counters_match_jax_engine(tiny):
    """Refills with batch_slots=2: identical tokens, finish reasons,
    prefill and decode launches, plan misses; zero policy evaluations."""
    jeng, jdone, eng, done = _run_both(tiny)
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert [c.finish_reason for c in done] == \
        [c.finish_reason for c in jdone]
    assert _launches(eng.stats, True) == _launches(jeng.stats, True) == 4
    assert _launches(eng.stats, False) == _launches(jeng.stats, False)
    assert eng.stats.misses == jeng.stats.misses
    assert eng.stats.seen_buckets == jeng.stats.seen_buckets
    assert ops.policy_eval_count() == 0


def test_eos_finish_matches_jax_engine(tiny):
    """eos_id set to a token the model emits: both engines stop there."""
    _, first, _, _ = _run_both(tiny)
    eos = first[0].tokens[2]
    jeng, jdone, eng, done = _run_both(tiny, reqs_kw={"eos_id": eos})
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert [c.finish_reason for c in done] == \
        [c.finish_reason for c in jdone]
    assert done[0].finish_reason == "eos"
    assert done[0].tokens[-1] == eos


def test_cache_capacity_finish_matches_jax_engine(tiny):
    """A cache of 16 rows ends long requests with cache_capacity."""
    jeng, jdone, eng, done = _run_both(
        tiny, max_len=16, reqs_kw={"max_new": (20, 20, 20, 20)})
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    reasons = [c.finish_reason for c in done]
    assert reasons == [c.finish_reason for c in jdone]
    assert set(reasons) == {"cache_capacity"}


def test_internal_heuristic_path_matches_jax_engine(tiny):
    """use_scheduler_metadata=False: loop admission, the policy runs in
    every launch, and the streams still match."""
    jeng, jdone, eng, done = _run_both(tiny, use_scheduler_metadata=False)
    assert [c.tokens for c in done] == [c.tokens for c in jdone]
    assert eng.stats.fallback_launches == jeng.stats.fallback_launches
    assert ops.policy_eval_count() > 0


def test_stream_events_end_with_finished(tiny):
    _, _, _, cfg, model, params = tiny
    eng = ServingEngine(model, ServeConfig(model=cfg), max_len=64,
                        batch_slots=2, device="cpu")
    eng.load(params)
    h = eng.submit(Request(0, [1, 2, 3], max_new_tokens=4))
    evs = list(eng.stream(h))
    assert [e.index for e in evs[:-1]] == [0, 1, 2, 3]
    assert evs[-1].kind == FINISHED and evs[-1].finish_reason == "length"
    assert eng.drain() == []


def test_rejects_bad_requests_and_sampled_requests(tiny):
    _, _, _, cfg, model, params = tiny
    eng = ServingEngine(model, ServeConfig(model=cfg), max_len=64,
                        batch_slots=1, device="cpu")
    eng.load(params)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(0, []))
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(Request(1, list(range(64)), max_new_tokens=1))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(2, [1, 2], max_new_tokens=0))
    with pytest.raises(ValueError, match="GreedySampler"):
        eng.submit(Request(3, [1, 2],
                           sampling=SamplingParams(temperature=0.7)))
    assert not eng.has_work()


def test_unknown_policy_names_the_ported_ones(tiny):
    _, _, _, cfg, model, _ = tiny
    with pytest.raises(KeyError, match="fa3_baseline"):
        ServingEngine(model, ServeConfig(model=cfg), policy="tpu_adaptive",
                      device="cpu")

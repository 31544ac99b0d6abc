"""The port's sampled path against the reference's, on the CPU.

Both packages' samplers run on the same seeded numpy logits: the top-k
and top-p masks equal the reference's bit for bit, tie cases included;
``GreedySampler.verify`` and the greedy rows of
``CategoricalSampler.verify`` equal the reference's tokens and accepted
counts.  The draws themselves come from another PRNG than JAX's, so they
are held to the distribution instead: ``CategoricalSampler.sample`` and
``verify`` frequencies over 4000 draws on a 16-token vocab against the
masked softmax, by chi-square at p = 1e-6 (a fixed seed, so the test is
deterministic); the bonus row draws what ``sample`` draws at its
position.  The default engine serves sampled requests, reproducibly and
independent of slot packing, with and without speculation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.serving import sampling as jsampling
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.models import build_model
from repro_torch.serving import (
    CategoricalSampler,
    GreedySampler,
    Request,
    SamplingParams,
    ServingEngine,
    get_sampler,
)
from repro_torch.serving import sampling
from repro_torch.spec import SpecConfig

V = 16
P_MIN = 1e-6


def _logits(kind: str, rows: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((rows, 32)).astype(np.float32) * 3
    # ties everywhere: few distinct values, and one constant row
    x = rng.integers(0, 4, (rows, 32)).astype(np.float32)
    x[0] = 1.0
    return x


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_mask_top_k_equals_the_reference_bits(kind):
    x = _logits(kind, 7)
    k = np.array([0, 1, 2, 3, 7, 32, 40], np.int32)
    want = jsampling._mask_top_k(jnp.asarray(x), jnp.asarray(k))
    got = sampling._mask_top_k(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("after_top_k", [False, True])
def test_mask_top_p_equals_the_reference_bits(kind, after_top_k):
    """Alone and after a top-k mask (so -inf entries are in the sort); in
    the tie rows the cut falls inside a run of equal values, which keeps
    the whole run."""
    x = _logits(kind, 7, seed=1)
    p = np.array([0.05, 0.3, 0.5, 0.77, 0.9, 0.999, 1.0], np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if after_top_k:
        k = np.array([3, 0, 5, 9, 1, 20, 12], np.int32)
        jx = jsampling._mask_top_k(jx, jnp.asarray(k))
        tx = sampling._mask_top_k(tx, torch.from_numpy(k))
    want = jsampling._mask_top_p(jx, jnp.asarray(p))
    got = sampling._mask_top_p(tx, torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _state(temps, top_k=0, top_p=1.0, seed=0):
    n = len(temps)
    return {"temperature": np.asarray(temps, np.float32),
            "top_k": np.full(n, top_k, np.int32),
            "top_p": np.full(n, top_p, np.float32),
            "seed": np.full(n, seed, np.int64)}


def _jstate(st):
    return {"temperature": jnp.asarray(st["temperature"]),
            "top_k": jnp.asarray(st["top_k"]),
            "top_p": jnp.asarray(st["top_p"]),
            "key": jnp.stack([jax.random.PRNGKey(int(s))
                              for s in st["seed"]])}


def test_greedy_verify_equals_the_reference():
    """Drafts agreeing with the teacher-forced argmax for 0..3 rows:
    GreedySampler.verify and the temperature-0 rows of
    CategoricalSampler.verify (beside a sampled row) give the reference's
    tokens and accepted counts."""
    rng = np.random.default_rng(0)
    B, M = 5, 4
    x = rng.standard_normal((B, M, V)).astype(np.float32)
    greedy = x.argmax(-1)
    draft = greedy[:, :-1].copy()
    for b, agree in enumerate([0, 1, 2, 3, 1]):
        draft[b, agree:] = (draft[b, agree:] + 1) % V
    pos = np.array([3, 9, 0, 17, 5])
    jt, ja = jsampling.GreedySampler().verify(
        jnp.asarray(x), jnp.asarray(draft, jnp.int32), {},
        jnp.asarray(pos, jnp.int32))
    tx, td = torch.from_numpy(x), torch.from_numpy(draft).long()
    gt, ga = GreedySampler().verify(tx, td, {}, pos)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ga.numpy(), [0, 1, 2, 3, 1])
    st = _state([0.0, 0.0, 0.0, 0.0, 0.9])
    jct, jca = jsampling.CategoricalSampler().verify(
        jnp.asarray(x), jnp.asarray(draft, jnp.int32), _jstate(st),
        jnp.asarray(pos, jnp.int32))
    ct, ca = CategoricalSampler().verify(tx, td, st, pos)
    np.testing.assert_array_equal(ct[:4].numpy(), np.asarray(jct)[:4])
    np.testing.assert_array_equal(ca[:4].numpy(), np.asarray(jca)[:4])
    np.testing.assert_array_equal(ct[:4].numpy(), gt[:4].numpy())
    np.testing.assert_array_equal(
        CategoricalSampler().sample(tx[:, 0], st, pos)[:4].numpy(),
        GreedySampler().sample(tx[:, 0], st, pos)[:4].numpy())


def _target(x: np.ndarray, temperature: float, top_k: int, top_p: float):
    """The reference's masked, temperature-scaled softmax of one row."""
    scaled = jnp.asarray(x[None] / np.float32(temperature))
    scaled = jsampling._mask_top_k(scaled, jnp.asarray([top_k]))
    scaled = jsampling._mask_top_p(scaled, jnp.asarray([top_p], jnp.float32))
    return np.asarray(jax.nn.softmax(scaled[0]), np.float64)


def _chi2(counts: np.ndarray, p: np.ndarray) -> float:
    """Chi-square p-value of ``counts`` against ``p``; tokens the mask
    removes must never be drawn."""
    assert counts[p == 0].sum() == 0
    keep = p > 0
    return stats.chisquare(counts[keep],
                           counts.sum() * p[keep] / p[keep].sum()).pvalue


KNOBS = dict(temperature=0.8, top_k=10, top_p=0.9)


def test_sample_frequencies_match_the_masked_softmax():
    rng = np.random.default_rng(2)
    row = rng.standard_normal(V).astype(np.float32)
    n = 4000
    st = _state([KNOBS["temperature"]] * n, KNOBS["top_k"], KNOBS["top_p"],
                seed=11)
    toks = CategoricalSampler().sample(
        torch.from_numpy(np.tile(row, (n, 1))), st, np.arange(n))
    counts = np.bincount(toks.numpy(), minlength=V)
    p = _target(row, **KNOBS)
    assert (p > 0).sum() < V          # the masks removed tokens
    assert _chi2(counts, p) > P_MIN


@pytest.mark.parametrize("draft_rank", [0, 3])
def test_verify_frequencies_match_the_masked_softmax(draft_rank):
    """One draft per slot, 4000 slots at distinct positions: the first
    emitted token (the draft where accepted, else the residual draw) is
    distributed as the target, the draft being the most likely token or
    the fourth, which the top-p mask removes (so it is never accepted)."""
    rng = np.random.default_rng(3)
    row = rng.standard_normal((2, V)).astype(np.float32)
    n = 4000
    p = _target(row[0], **KNOBS)
    d = int(np.argsort(-p)[draft_rank])
    st = _state([KNOBS["temperature"]] * n, KNOBS["top_k"], KNOBS["top_p"],
                seed=5)
    toks, acc = CategoricalSampler().verify(
        torch.from_numpy(np.tile(row, (n, 1, 1))),
        torch.full((n, 1), d), st, np.arange(n))
    first = np.where(acc.numpy() >= 1, d, toks[:, 0].numpy())
    assert _chi2(np.bincount(first, minlength=V), p) > P_MIN
    # the accept coin lands with probability p(draft)
    rate = acc.numpy().mean()
    assert abs(rate - p[d]) <= 5 * np.sqrt(p[d] * (1 - p[d]) / n)
    assert (rate == 0) == (p[d] == 0)


def test_bonus_row_draws_what_sample_draws_there():
    rng = np.random.default_rng(4)
    B, M = 3, 4
    x = torch.from_numpy(rng.standard_normal((B, M, V)).astype(np.float32))
    st = _state([0.7, 1.0, 1.3], top_k=8, top_p=0.95, seed=21)
    st["seed"][:] = [21, 22, 23]
    pos = np.array([0, 14, 100])
    draft = torch.from_numpy(rng.integers(0, V, (B, M - 1)))
    toks, _ = CategoricalSampler().verify(x, draft, st, pos)
    want = CategoricalSampler().sample(x[:, M - 1], st, pos + M - 1)
    torch.testing.assert_close(toks[:, M - 1], want)
    # the same call again: the same bits
    again, _ = CategoricalSampler().verify(x, draft, st, pos)
    torch.testing.assert_close(again, toks)


def test_streams_differ_by_tag_and_position():
    seeds = {sampling.stream_seed(7, p, tag)
             for p in range(4) for tag in (None, sampling.ACCEPT_TAG,
                                           sampling.RESIDUAL_TAG)}
    assert len(seeds) == 12
    assert sampling.stream_seed(7, 3) == sampling.stream_seed(7, 3)
    assert sampling.stream_seed(7, 3) != sampling.stream_seed(8, 3)


def test_params_and_registry_refuse_as_the_reference():
    for kw in (dict(temperature=-1.0), dict(top_p=0.0), dict(top_p=1.5),
               dict(top_k=-2)):
        with pytest.raises(ValueError) as want:
            jsampling.SamplingParams(**kw)
        with pytest.raises(ValueError) as got:
            SamplingParams(**kw)
        assert str(got.value) == str(want.value)
    for name, cls in (("greedy", GreedySampler),
                      ("categorical", CategoricalSampler),
                      ("top_p", CategoricalSampler)):
        assert type(get_sampler(name)) is cls
    with pytest.raises(ValueError, match="unknown sampler"):
        get_sampler("beam")
    with pytest.raises(ValueError, match="GreedySampler ignores"):
        GreedySampler().check(SamplingParams(top_k=5))


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init_params(0)


def _serve(tiny, sp_of, *, slots=4, spec=None, sampler=None):
    cfg, model, params = tiny
    eng = ServingEngine(model, ServeConfig(model=cfg, cache_layout="paged"),
                        max_len=96, batch_slots=slots, sampler=sampler,
                        device="cpu")
    eng.load(params)
    rng = np.random.default_rng(0)
    for i in range(5):
        prompt = ([3, 4, 5] * 4)[:6 + i] if i % 2 else \
            rng.integers(1, 256, 5 + i).tolist()
        eng.submit(Request(i, prompt, max_new_tokens=12,
                           sampling=sp_of(i, spec)))
    done = eng.drain()
    eng.cache.check_conservation()
    return [c.tokens for c in done]


def _mixed(i, spec):
    """Request 2 is greedy, the others sampled with seeds of their own."""
    spec = SpecConfig(spec, 3) if spec else None
    if i == 2:
        return SamplingParams(speculation=spec)
    return SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=100 + i,
                          speculation=spec)


@pytest.mark.parametrize("spec", [None, "ngram"])
def test_default_engine_serves_sampled_requests_reproducibly(tiny, spec):
    """The default engine (CategoricalSampler) serves sampled requests:
    the same tokens on a second run and with one slot instead of four;
    the greedy request gets a GreedySampler engine's stream."""
    first = _serve(tiny, _mixed, spec=spec)
    assert all(len(t) == 12 for t in first)
    assert _serve(tiny, _mixed, spec=spec) == first
    assert _serve(tiny, _mixed, spec=spec, slots=1) == first
    greedy = _serve(tiny, lambda i, s: SamplingParams(
        speculation=SpecConfig(s, 3) if s else None), spec=spec,
        sampler=GreedySampler())
    assert first[2] == greedy[2]
    assert first != greedy

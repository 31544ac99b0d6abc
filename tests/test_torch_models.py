"""The port's dense model against the JAX model on the CPU.

Reduced qwen2.5-3b (2 layers, d_model 32) in float32, with JAX-
initialised weights passed through ``repro_torch.interop``: prefill
logits and 16 decode steps of logits agree at rtol = atol = 1e-4 (the
same float32 math summed in another order), and the greedy tokens are
equal.  The JAX side runs its XLA attention path; the port runs the
plain versions of its kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_config as j_reduced_config
from repro.models import build_model as j_build_model
from repro.models import lm as jlm
from repro_torch.configs.reduced import reduced_config
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.models import build_model
from repro_torch.models import lm
from repro_torch.plan import AttentionSpec, Planner, bucket_seqlen

F32 = dict(dtype="float32", param_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN, LENS, STEPS = 64, (7, 13), 16


@pytest.fixture(scope="module")
def pair():
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2, d_model=32).replace(
        **F32)
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32).replace(
        **F32)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32),
                           jmodel.init_params(jax.random.PRNGKey(3)))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    return jcfg, jmodel, jparams, cfg, build_model(cfg, device="cpu"), params


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, n).astype(np.int32) for n in LENS]


def test_interop_unstacks_layers(pair):
    jcfg, _, jparams, cfg, _, params = pair
    layer = jparams["groups"][0][0]
    for li in range(cfg.num_layers):
        np.testing.assert_array_equal(
            params.layers[li].mix.wq.numpy(),
            np.asarray(layer["mix"]["wq"][li]))
        np.testing.assert_array_equal(
            params.layers[li].ffn.wo.numpy(),
            np.asarray(layer["ffn"]["wo"][li]))
    np.testing.assert_array_equal(params.embed.tok.numpy(),
                                  np.asarray(jparams["embed"]["tok"]))


def test_bf16_arrays_read_through_uint16_view():
    x = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    assert x.dtype.name == "bfloat16"
    t = tensor_from_numpy(x)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))


def test_prefill_and_decode_logits_match_jax(pair):
    jcfg, jmodel, jparams, cfg, model, params = pair
    prompts = _prompts()
    jcaches = jmodel.init_cache(len(LENS), MAX_LEN, kv_dtype="float32")
    caches = model.init_cache(len(LENS), MAX_LEN, kv_dtype="float32")
    next_tok = []
    for slot, p in enumerate(prompts):
        lb = bucket_seqlen(len(p), 16)
        padded = np.zeros(lb, np.int32)
        padded[:len(p)] = p
        jlogits, jcaches = jlm.lm_prefill_slot(
            jparams, jcfg, jcaches, jnp.asarray(padded), jnp.int32(slot),
            jnp.int32(len(p)), MAX_LEN)
        logits = model.prefill_slot(params, caches,
                                    torch.from_numpy(padded).long(), slot,
                                    len(p))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        assert int(logits.argmax()) == int(jnp.argmax(jlogits))
        next_tok.append(int(jnp.argmax(jlogits)))

    pos = np.asarray(LENS, np.int32)
    tok = np.asarray(next_tok, np.int32)
    planner = Planner(policy="paper")
    for _ in range(STEPS):
        jlogits, jcaches = jlm.lm_decode_step(
            jparams, jcfg, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        bucket = bucket_seqlen(int(pos.max()) + 1, 16)
        plan = planner.plan(AttentionSpec.decode(
            len(LENS), bucket, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim), bucket=bucket)
        logits = model.decode_step(params, caches,
                                   torch.from_numpy(tok).long(),
                                   torch.from_numpy(pos).long(), plan=plan)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        want = np.asarray(jnp.argmax(jlogits, axis=-1))
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), want)
        tok, pos = want.astype(np.int32), pos + 1
    # the in-place cache holds what the reference's functional cache holds
    # on every row a decode step has read
    for slot in range(len(LENS)):
        rows = slice(0, int(pos[slot]))
        np.testing.assert_allclose(
            caches["k"][:, slot, rows].numpy(),
            np.asarray(jcaches[0][0]["k"][:, slot, rows]), **TOL)


def test_init_params_follow_reference_scales():
    cfg = reduced_config("qwen2.5-3b", num_layers=1, d_model=256)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg, device="cpu").init_params(gen)
    blk = params.layers[0]
    assert torch.all(blk.ln1.scale == 1) and torch.all(blk.mix.bq == 0)
    # std 1/sqrt(fan_in): fan_in is shape[-2] unless declared
    for t, fan_in in ((blk.mix.wq, cfg.num_heads),
                      (blk.mix.wo, cfg.num_heads * cfg.resolved_head_dim),
                      (blk.ffn.wo, cfg.d_ff),
                      (params.embed.tok, cfg.d_model)):
        assert abs(t.float().std().item() * fan_in ** 0.5 - 1) < 0.1
    again = build_model(cfg, device="cpu").init_params(0)
    same = build_model(cfg, device="cpu").init_params(0)
    assert torch.equal(again.layers[0].mix.wk, same.layers[0].mix.wk)

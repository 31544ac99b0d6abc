"""The port's training path against the reference's, on the CPU.

``SyntheticLM`` batches bit for bit; ``lr_schedule`` (three schedules),
``global_norm``, ``clip_by_global_norm`` and one ``adamw_update`` on the
same numpy trees within 1e-6 relative in float32 (one rounding order
against another); ``lm_loss`` on the same logits and labels (masked
labels, the MoE aux weight) within 1e-6; ``Model.forward`` of every
family's reduced config in float32 within the family tolerances of
``tests/test_models.py`` (relative to the largest logit); the autograd
gradient of ``lm_loss`` against ``jax.grad`` of the reference's, leaf for
leaf through ``params_to_numpy``, in float32, each leaf within 1e-4 of
its norm (floored at 1e-6 of the whole gradient's, so an all-but-zero
leaf is held to the gradient's scale); the four remat policies giving
``none``'s gradients bit for bit; five ``build_train_step`` steps from the
same weights and batches at microbatches 1 and 2, each step's loss and
lr within 1e-5 relative, its grad_norm within 1e-4 (see the test) and
the final weights within 1e-4 normwise; ``params_to_numpy``
round-tripping every registered arch's reduced weights bit for bit; the repairs that training needed (trainable
weights only on the training path, the prefill kernel's autograd form);
and ``run_training`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.reduced import reduced_config as j_reduced_config
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.launch.mesh import make_host_mesh
from repro.models import build_model as j_build_model
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs.base import OptimizerConfig, ShapeConfig, \
    TrainConfig
from repro_torch.configs.reduced import reduced_config
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import flash_prefill as fp
from repro_torch.launch.train import run_training
from repro_torch.models import build_model
from repro_torch.models.registry import Model
from repro_torch.training import optimizer as opt
from repro_torch.training import remat
from repro_torch.training.train_step import build_train_step, lm_loss, \
    param_tree

# tests/test_models.py's cross-path tolerances, relative to the largest
# logit
FAMILY_TOL = {"dense": 5e-3, "vlm": 5e-3, "encdec": 5e-3,
              "mla": 4e-2, "moe": 5e-2, "ssm": 4e-2, "hybrid": 4e-2}
FAMILY_ARCHS = {"dense": "qwen2.5-3b", "moe": "granite-moe-3b-a800m",
                "mla": "minicpm3-4b", "vlm": "paligemma-3b",
                "hybrid": "recurrentgemma-9b", "ssm": "mamba2-780m",
                "encdec": "whisper-large-v3"}
# sequence lengths past the reduced hybrid's window (64) and the reduced
# ssm's chunk (32), so the windowed mask and the chunk padding both run
SEQ = {"hybrid": 80, "ssm": 40}
GRAD_TOL = 1e-4
# the training trajectory's per-step tolerances (relative; see the test)
TRAJECTORY_TOL = {"loss": 1e-5, "total_loss": 1e-5, "lr": 1e-5,
                  "tokens": 0.0, "grad_norm": 1e-4}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# data, configs, optimizer, loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,hosts", [(0, 0, 1), (3, 17, 1),
                                             (5, 2, 2), (11, 1000, 4)])
def test_synthetic_batches_match_reference(seed, step, hosts):
    for host in range(hosts):
        kw = dict(vocab_size=97, seq_len=24, global_batch=8, seed=seed,
                  num_hosts=hosts, host_id=host)
        got = SyntheticLM(DataConfig(**kw)).batch_at(step)
        want = JSyntheticLM(JDataConfig(**kw)).batch_at(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_train_configs_match_reference_field_for_field():
    ours = [f.name for f in dataclasses.fields(TrainConfig)]
    theirs = [f.name for f in dataclasses.fields(JTrainConfig)]
    assert ours == [n for n in theirs if n != "mesh"]
    assert dataclasses.asdict(OptimizerConfig()) == \
        dataclasses.asdict(JOptimizerConfig())


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_reference(schedule):
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = float(opt.lr_schedule(OptimizerConfig(**cfg), s))
        want = float(jopt.lr_schedule(JOptimizerConfig(**cfg), jnp.int32(s)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 5), "b": (5,), "emb": (11, 8)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
    return params, grads


def test_global_norm_and_clip_match_reference():
    _, grads = _trees()
    tg = {k: _t(v) for k, v in grads.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    assert float(opt.global_norm(tg)) == pytest.approx(
        float(jopt.global_norm(jg)), rel=1e-6)
    for max_norm in (1.0, 1e4):
        got, gn = opt.clip_by_global_norm(tg, max_norm)
        want, jn = jopt.clip_by_global_norm(jg, max_norm)
        assert float(gn) == pytest.approx(float(jn), rel=1e-6)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


def test_global_norm_does_not_overflow():
    """Squares past float32's range (a norm of 1e23, as full-width
    qwen2.5-3b's gradient at step 0): the port's norm is the float64
    one, where the reference's float32 sum overflows to inf and its clip
    zeroes the gradient."""
    big = np.full((100,), 1e22, np.float32)
    norm = float(opt.global_norm({"g": _t(big)}))
    assert norm == pytest.approx(1e23, rel=1e-6)
    assert np.isinf(float(jopt.global_norm({"g": jnp.asarray(big)})))
    clipped, _ = opt.clip_by_global_norm({"g": _t(big)}, 1.0)
    assert float(clipped["g"].norm()) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(clip):
    """Two in-place updates against the reference's two pure ones: the
    weights, both moments, the count and the metrics."""
    params, grads = _trees(1)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip_norm=clip)
    tp = {k: _t(v).clone() for k, v in params.items()}
    state = opt.adamw_init(tp)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.adamw_init(jp)
    for i in range(2):
        g = {k: v * (i + 1) for k, v in grads.items()}
        m = opt.adamw_update({k: _t(v) for k, v in g.items()}, state, tp,
                             OptimizerConfig(**cfg))
        jp, jstate, jm = jopt.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp,
            JOptimizerConfig(**cfg))
        for k in ("grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 2
    for k in params:
        for got, want in ((tp[k], jp[k]), (state["m"][k], jstate["m"][k]),
                          (state["v"][k], jstate["v"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-8)


class _Fixed:
    """A model stand-in whose forward returns fixed logits and aux."""

    def __init__(self, cfg, logits, aux):
        self.cfg, self._out = cfg, (logits, aux)

    def forward(self, params, batch, block_wrapper=None):
        return self._out


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-3b-a800m",
                                  "paligemma-3b"])
def test_lm_loss_matches_reference(arch):
    """Masked labels (< 0), a label tail shorter than the logits (vlm's
    patch prefix) and the MoE aux weight."""
    rng = np.random.default_rng(2)
    cfg, jcfg = reduced_config(arch), j_reduced_config(arch)
    L, Lt, V = 12, 12 if arch != "paligemma-3b" else 9, cfg.vocab_size
    logits = (rng.standard_normal((2, L, V)) * 4).astype(np.float32)
    labels = rng.integers(0, V, (2, Lt)).astype(np.int32)
    labels[0, 3] = labels[1, 7] = -1
    aux = np.float32(0.37)
    total, m = lm_loss(_Fixed(cfg, _t(logits), torch.tensor(aux)), None,
                       {"labels": _t(labels)})
    jtotal, jm = jts.lm_loss(_Fixed(jcfg, jnp.asarray(logits),
                                    jnp.asarray(aux)), None,
                             {"labels": jnp.asarray(labels)})
    assert float(total) == pytest.approx(float(jtotal), rel=1e-6)
    for k in ("loss", "aux_loss", "tokens"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert float(m["tokens"]) == 2 * (Lt - 1) - 2


# ---------------------------------------------------------------------------
# forward and gradients, every family
# ---------------------------------------------------------------------------


def _family_pair(family, seed=0):
    """Reduced config of the family in float32: (cfg, the port's model and
    weights, the reference's model and weights, a batch for each)."""
    arch = FAMILY_ARCHS[family]
    kw = dict(dtype="float32", param_dtype="float32")
    jcfg = j_reduced_config(arch).replace(**kw)
    cfg = reduced_config(arch).replace(**kw)
    jmodel = j_build_model(jcfg)
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jax.jit(
        jmodel.init_params)(jax.random.PRNGKey(seed)))
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")
    rng = np.random.default_rng(seed + 7)
    L = SEQ.get(family, 32)
    Lt = model.text_len(L)
    tokens = rng.integers(0, cfg.vocab_size, (2, Lt)).astype(np.int32)
    labels = tokens.copy()
    labels[1, 5] = -1
    nb = {"tokens": tokens, "labels": labels}
    for k, (shape, _) in model.frontend_inputs(2, L).items():
        nb[k] = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    batch = {k: _t(v).long() if k in ("tokens", "labels") else _t(v)
             for k, v in nb.items()}
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    return cfg, model, params, jmodel, jparams, batch, jbatch


@pytest.fixture(scope="module", params=sorted(FAMILY_ARCHS))
def family(request):
    return request.param, _family_pair(request.param)


def test_forward_matches_reference(family):
    name, (cfg, model, params, jmodel, jparams, batch, jbatch) = family
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
    jlogits, jaux = jax.jit(jmodel.forward)(jparams, jbatch)
    assert logits.shape == jlogits.shape and logits.dtype == torch.float32
    scale = float(jnp.max(jnp.abs(jlogits)))
    rel = float(np.abs(logits.numpy() - np.asarray(jlogits)).max()) / scale
    assert rel < FAMILY_TOL[name], rel
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-7)


def _grads(model, params, batch, wrapper=None):
    Model.trainable(params)
    tree = param_tree(params)
    total, _ = lm_loss(model, params, batch, block_wrapper=wrapper)
    names = list(tree)
    gs = torch.autograd.grad(total, [tree[n] for n in names])
    return total.detach(), dict(zip(names, gs))


def test_gradients_match_reference(family):
    """The encdec case is the repair of its gradient: its forward ran
    under ``no_grad`` and gave none."""
    name, (cfg, model, params, jmodel, jparams, batch, jbatch) = family
    total, grads = _grads(model, params, batch)
    jtotal, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jts.lm_loss(jmodel, p, jbatch)[0]))(jparams)
    assert float(total) == pytest.approx(float(jtotal), rel=1e-5)
    got = params_to_numpy(grads, cfg)
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten(
        jax.tree.map(np.asarray, jgrads))
    assert g_def == w_def
    whole = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2))
                        for w in w_leaves))
    assert whole > 0
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            w_leaves):
        assert g.shape == w.shape, path
        err = np.linalg.norm((g - w).astype(np.float64))
        ref = max(np.linalg.norm(w.astype(np.float64)), 1e-6 * whole)
        assert err <= GRAD_TOL * ref, (jax.tree_util.keystr(path), err, ref)


@pytest.mark.parametrize("family_name", ["dense", "hybrid"])
@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable",
                                    "dots_with_no_batch_dims"])
def test_remat_policies_give_the_same_gradients(family_name, policy):
    """Recomputation runs the same ops on the same inputs: every policy
    gives ``none``'s loss and gradients bit for bit on the CPU."""
    cfg, model, params, *_, batch, _ = _family_pair(family_name)
    assert remat.block_wrapper("none") is None
    t0, g0 = _grads(model, params, batch)
    t1, g1 = _grads(model, params, batch, remat.block_wrapper(policy))
    assert torch.equal(t0, t1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_unknown_remat_policy_raises_the_references_error():
    with pytest.raises(KeyError, match="unknown remat policy"):
        remat.block_wrapper("everything")
    from repro.training import remat as jremat
    assert sorted(remat.POLICIES) == sorted(jremat.POLICIES)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("micro", [1, 2])
def test_training_trajectory_matches_reference(micro):
    """Five steps of reduced qwen2.5-3b in float32 from the same weights
    and SyntheticLM batches as the reference's ``build_train_step``
    (remat nothing_saveable, cosine lr with warmup 2): every step's loss
    and lr within 1e-5 relative, its grad_norm within 1e-4 (qwen's K bias
    has a gradient that is zero up to rounding, AdamW moves it by about
    lr times the sign of that noise, and the two frameworks' noise
    differs: by step 4 the norm moves by up to 5e-5), and the final
    weights within 1e-4 of their norm, all leaves together."""
    kw = dict(dtype="float32", param_dtype="float32")
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32).replace(**kw)
    jcfg = j_reduced_config("qwen2.5-3b", num_layers=2,
                            d_model=32).replace(**kw)
    okw = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    jbundle = jts.build_train_step(
        j_build_model(jcfg), JTrainConfig(
            model=jcfg, shape=JShapeConfig("t", 16, 4, "train"),
            microbatches=micro, optimizer=JOptimizerConfig(**okw)),
        make_host_mesh())
    bundle = build_train_step(build_model(cfg, device="cpu"), TrainConfig(
        model=cfg, shape=ShapeConfig("t", 16, 4, "train"),
        microbatches=micro, optimizer=OptimizerConfig(**okw)))
    jparams, jstate = jbundle.init(jax.random.PRNGKey(0))
    # the reference's init draws bfloat16 whatever param_dtype says
    jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    params = Model.trainable(params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    state = opt.adamw_init(param_tree(params))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=3))
    for step in range(5):
        nb = data.batch_at(step)
        jparams, jstate, jm = jbundle.step(
            jparams, jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        params, state, m = bundle.step(params, state, bundle.to_device(nb))
        for k, tol in TRAJECTORY_TOL.items():
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=tol), \
                (step, k)
    got = jax.tree_util.tree_leaves(params_to_numpy(params, cfg))
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jparams))
    diff = sum(float(np.sum((g - w).astype(np.float64) ** 2))
               for g, w in zip(got, want))
    norm = sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want)
    assert diff ** 0.5 <= 1e-4 * norm ** 0.5


def test_microbatches_match_the_full_batch():
    """Two microbatches against one batch in the port itself (the
    reference's test_microbatching_matches_full_batch): f32 loss within
    1e-6 relative, the weights after the step within 1e-5 of their norm,
    all leaves together (a leaf whose gradient is rounding noise, as the
    K bias's is, moves by lr times a noise sign in AdamW's first step)."""
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32).replace(
        dtype="float32", param_dtype="float32")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=1))
    out = []
    for micro in (1, 2):
        bundle = build_train_step(build_model(cfg, device="cpu"),
                                  TrainConfig(model=cfg, shape=ShapeConfig(
                                      "t", 16, 4, "train"),
                                      microbatches=micro))
        params, state = bundle.init(0)
        _, _, m = bundle.step(params, state,
                              bundle.to_device(data.batch_at(0)))
        out.append((float(m["loss"]), param_tree(params)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    with torch.no_grad():
        diff = sum(float((a - out[1][1][n]).square().sum())
                   for n, a in out[0][1].items())
        norm = sum(float(a.square().sum()) for a in out[0][1].values())
    assert diff ** 0.5 <= 1e-5 * norm ** 0.5


def test_build_train_step_refuses_a_model_axis():
    cfg = reduced_config("qwen2.5-3b")
    with pytest.raises(NotImplementedError, match="mesh training"):
        build_train_step(build_model(cfg, device="cpu"),
                         TrainConfig(model=cfg), model_axis=2)


# ---------------------------------------------------------------------------
# interop, repairs, entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_params_to_numpy_round_trips(arch):
    """Every registered arch's reduced weights: the reference's tree
    structure and shapes, and back to the same bits (bfloat16 through
    exact float32)."""
    cfg = reduced_config(arch)
    params = build_model(cfg, device="cpu").init_params(3)
    tree = params_to_numpy(params, cfg)
    jshapes = jax.eval_shape(j_build_model(j_reduced_config(arch))
                             .init_params, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(jshapes)
    for a, s in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(jshapes)):
        assert a.shape == s.shape
    back = params_from_numpy(tree, cfg, device="cpu").state_dict()
    for n, t in params.state_dict().items():
        assert back[n].dtype == t.dtype and torch.equal(back[n], t), n


def test_weights_are_trainable_only_on_the_training_path():
    """Serving's weights stay frozen; the train bundle's are trainable and
    every one of them gets a gradient."""
    cfg = reduced_config("qwen2.5-3b", num_layers=2, d_model=32)
    model = build_model(cfg, device="cpu")
    served = model.init_params(0)
    assert not any(p.requires_grad for p in served.parameters())
    bundle = build_train_step(model, TrainConfig(
        model=cfg, shape=ShapeConfig("t", 16, 2, "train")))
    params, state = bundle.init(0)
    assert all(p.requires_grad for p in params.parameters())
    assert set(state["m"]) == set(param_tree(params))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 2, seed=0))
    total, _ = lm_loss(model, params, bundle.to_device(data.batch_at(0)))
    total.backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in params.parameters())


@pytest.mark.parametrize("causal,window,q_offset,lk", [
    (True, None, 0, 24), (True, 5, 0, 24), (False, None, 0, 40),
    (True, None, 16, 40)])
def test_prefill_autograd_function_matches_plain_autograd(causal, window,
                                                          q_offset, lk):
    """The prefill kernel's autograd form, whose forward and backward are
    the kernels on the card, run here on their plain versions: autograd's
    gradient of the plain forward, in float64, GQA 6 / 2 at (D 16, Dv 8)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 24, 6, 16, generator=g, dtype=torch.float64)
    k = torch.randn(2, lk, 2, 16, generator=g, dtype=torch.float64)
    v = torch.randn(2, lk, 2, 8, generator=g, dtype=torch.float64)
    do = torch.randn(2, 24, 6, 8, generator=g, dtype=torch.float64)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = torch.autograd.grad(fp.prefill_plain(*leaves, **kw), leaves, do)
    out = fp.FlashPrefillFn.apply(*leaves, causal, window, q_offset)
    assert torch.equal(out, fp.prefill_plain(q, k, v, **kw))
    got = torch.autograd.grad(out, leaves, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    o, lse = fp.flash_prefill_lse(q, k, v, **kw)
    assert lse.shape == (2, 6, 24) and lse.dtype == torch.float64


def test_run_training_on_the_cpu(tmp_path):
    lines = []
    m = run_training("qwen2.5-3b", steps=4, d_model=64, num_layers=2,
                     seq_len=32, global_batch=2, ckpt_dir=str(tmp_path),
                     ckpt_every=2, remat_policy="nothing_saveable",
                     device="cpu", log_fn=lines.append)
    assert set(m) == {"loss", "aux_loss", "tokens", "total_loss",
                      "grad_norm", "lr"} and np.isfinite(m["loss"])
    assert lines[0].startswith("step     0 loss ")
    with pytest.raises(NotImplementedError, match="text-only"):
        run_training("paligemma-3b", steps=1, device="cpu",
                     ckpt_dir=str(tmp_path / "v"))

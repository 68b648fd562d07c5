"""The port's dual-view train step against the JAX step, on the CPU in f32.

The JAX step runs as ``make_train_step(..., jit=False)`` on the tiny config,
and its noise is recorded as it is drawn (the guided uniforms and EPRL eps
through ``jax.random``, the dropout masks through a flax method
interceptor that draws them as ``nn.Dropout`` does); the port's step gets
the same draws.  A recording optimizer captures JAX's gradients.  The
optimizer is compared with optax separately, on identical gradients: Adam's
first updates are about lr * sign(g), so parameters after a step would
hide or magnify tiny gradient differences.

Tolerances: loss, MMD and every parameter's gradient atol 2e-4 / rtol 1e-3
(``tests/test_window_attention.py``'s gradient bar); BN running statistics
1e-5; the optimizer 1e-6.  With the fused flags on, JAX runs its Pallas
kernels in interpret mode and the port their plain versions.
"""

import contextlib
import dataclasses

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.models import dilr as jdilr
from edrl_tpu.models import eprl as jeprl
from edrl_tpu.models import medfusion as jmedfusion
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.convert import flax_key_map, load_flax_variables
from edrl_tpu_torch.models import dilr, eprl, medfusion
from edrl_tpu_torch.train import trainer

ATOL, RTOL = 2e-4, 1e-3
BATCH = 3


@contextlib.contextmanager
def record_jax_draws(rec, convert=np.asarray):
    """Record, in call order, what ``jax.random.uniform`` / ``normal`` return
    and the dropout keep masks (drawn here as flax's ``nn.Dropout`` draws
    them), each through ``convert``; under ``jax.jit`` pass ``convert=lambda
    x: x`` and return the record from the traced function."""
    real_uniform, real_normal = jax.random.uniform, jax.random.normal

    def uniform(*args, **kwargs):
        out = real_uniform(*args, **kwargs)
        rec["uniform"].append(convert(out))
        return out

    def normal(*args, **kwargs):
        out = real_normal(*args, **kwargs)
        rec["normal"].append(convert(out))
        return out

    def interceptor(next_fun, args, kwargs, context):
        module = context.module
        if isinstance(module, fnn.Dropout) and context.method_name == "__call__":
            x = args[0]
            det = kwargs.get("deterministic", args[1] if len(args) > 1 else module.deterministic)
            if module.rate > 0.0 and not det:
                keep = 1.0 - module.rate
                mask = jax.random.bernoulli(module.make_rng("dropout"), keep, x.shape)
                rec["dropout"].append(convert(mask))
                return jax.lax.select(mask, x / keep, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    jax.random.uniform, jax.random.normal = uniform, normal
    try:
        with fnn.intercept_methods(interceptor):
            yield
    finally:
        jax.random.uniform, jax.random.normal = real_uniform, real_normal


def port_draws(rec, forwards: int):
    """JAX's recorded draws as ``MedFusion.forward`` keyword arguments, one
    mapping per forward (per forward JAX draws: fundus EPRL masks 1, 2, eps,
    mask 3; the same for OCT; then the two guided uniforms).  Mask 3 is on the
    pseudo-label branch, which the port's train mode skips: nothing the step
    returns depends on it."""
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    assert len(rec["uniform"]) == 2 * forwards and len(rec["normal"]) == 2 * forwards
    assert len(rec["dropout"]) == 6 * forwards
    out = []
    for i in range(forwards):
        masks = [t(m) for m in rec["dropout"][6 * i: 6 * i + 6]]
        out.append({
            "guided_uniform": (t(rec["uniform"][2 * i]), t(rec["uniform"][2 * i + 1])),
            "eprl_eps": (t(rec["normal"][2 * i]), t(rec["normal"][2 * i + 1])),
            "dropout_masks": (masks[:2], masks[3:5]),
        })
    return out


def _configs(fused: bool, **train):
    """The same tiny config for both stacks."""
    jcfg, tcfg = jax_tiny_config(batch_size=BATCH), tconfig.tiny_test_config(batch_size=BATCH)
    out = []
    for cfg in (jcfg, tcfg):
        model = dataclasses.replace(cfg.model, use_fused_attention=fused, vit_fused_attention=fused)
        out.append(cfg.replace(model=model, train=dataclasses.replace(cfg.train, **train)))
    return out


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d = cfg.data
    batch = {k: rng.uniform(size=(BATCH, d.fundus_size, d.fundus_size, 3)).astype(np.float32)
             for k in ("fundus_low", "fundus_high")}
    batch.update({k: rng.uniform(size=(BATCH, *d.oct_size, 1)).astype(np.float32)
                  for k in ("oct_low", "oct_high")})
    batch["label"] = np.array([0, 1, 1], np.int32)
    return batch


def test_random_views_match_bench_make_batch():
    """The port's synthetic train batch holds what the JAX package's
    ``bench.make_batch`` draws from the same numpy seed."""
    import bench

    jcfg, tcfg = _configs(False)
    want = bench.make_batch(BATCH, jcfg.data, np.random.default_rng(4))
    got = trainer.random_views(tcfg, seed=4, batch_size=BATCH, device="cpu")
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value))


@pytest.fixture(scope="module")
def jax_variables():
    """Perturbed flax MedFusion variables of the tiny config (the fused flags
    do not change the tree), with non-trivial BN statistics."""
    jcfg, _ = _configs(False)
    _, state = jtrainer.init_state(jcfg, 0)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.05, size=np.shape(a))).astype(np.float32),
        flax.core.unfreeze(state.params))
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
        flax.core.unfreeze(state.batch_stats))
    return {"params": params, "batch_stats": stats}


def _run_jax_step(jcfg, variables, batch):
    """One JAX step: ``(out, grads, new batch_stats, draws record)``."""
    model = jtrainer.make_model(jcfg)
    captured = {}

    def update(grads, opt_state, params=None):
        captured["grads"] = grads
        return jax.tree_util.tree_map(jnp.zeros_like, grads), opt_state

    tx = optax.GradientTransformation(lambda params: optax.EmptyState(), update)
    state = jtrainer.TrainState(
        step=jnp.asarray(0, jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]))
    step = jtrainer.make_train_step(model, tx, jcfg, jit=False)
    rec = {"uniform": [], "normal": [], "dropout": []}
    with record_jax_draws(rec):
        new_state, out = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(7))
    grads = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(captured["grads"]))
    stats = jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(new_state.batch_stats))
    return out, grads, stats, rec


def _leaf(tree, path):
    for key in path.split("/")[1:]:
        tree = tree[key]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# The modules in train mode, one forward each, against flax.
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


def test_eprl_train(jax_variables):
    rng = np.random.default_rng(2)
    kw = dict(x_dim=24, num_tokens=16, z_dim=8, num_classes=3, sample_num=12, topk=5)
    x = rng.normal(size=(4, 16, 24)).astype(np.float32)
    y = np.array([0, 2, 1, 2], np.int32)
    eps = rng.normal(size=(3, 12, 8)).astype(np.float32)
    jm = jeprl.EPRL(**kw)
    variables = _np(jm.init(jax.random.key(0), x, y, train=False, eps=eps))
    rec = {"uniform": [], "normal": [], "dropout": []}
    with record_jax_draws(rec):
        want = jm.apply(variables, x, y, train=True, eps=eps, rngs={"dropout": jax.random.key(3)})
    assert [m.shape for m in rec["dropout"]] == [(4, 16, 16), (4, 16, 16), (4, 3)]
    tm = load_flax_variables(eprl.EPRL(24, 16, z_dim=8, num_classes=3, sample_num=12, topk=5),
                             variables["params"])
    got = tm(_t(x), _t(y), train=True, eps=_t(eps), dropout_masks=[_t(m) for m in rec["dropout"][:2]])
    for g, w in zip(got, want):  # mu, sigma, proxy loss, z, entropy (0 in train mode)
        _close(g, w)
    assert float(got[4]) == 0.0
    with pytest.raises(ValueError, match="labels"):
        tm(_t(x), train=True)


def test_dilr_train_updates_biased_running_stats():
    """Batch statistics normalise; the running variance moves toward the
    biased batch variance (flax), not the unbiased one (torch's BatchNorm)."""
    rng = np.random.default_rng(3)
    kw = dict(fundus_dim=32, oct_dim=24, feature_dim=64, guided_in_dim=16, num_heads=4)
    args = [rng.normal(size=(3, 9, 32)), rng.normal(size=(3, 8, 24)), rng.normal(size=(3, 32)),
            rng.normal(size=(3, 16)), rng.normal(size=(3, 16))]
    args = [a.astype(np.float32) for a in args]
    jm = jdilr.DILR(**kw)
    variables = _np(jm.init(jax.random.key(0), *args, train=False))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32), variables["batch_stats"])
    (combined, loss), updated = jm.apply(variables, *args, train=True, mutable=["batch_stats"])
    tm = load_flax_variables(dilr.DILR(**kw), variables["params"], variables["batch_stats"])
    tcombined, tloss = tm(*map(_t, args), train=True)
    _close(tcombined, combined)
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-4)
    for bn in ("bn1", "bn2"):
        stats = updated["batch_stats"][bn]
        _close(getattr(tm, bn).running_mean, stats["mean"], atol=1e-5, rtol=1e-5)
        _close(getattr(tm, bn).running_var, stats["var"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_medfusion_train_forward(jax_variables, fused):
    jcfg, tcfg = _configs(fused)
    batch = _batch(tcfg)
    d = jcfg.data
    jm = jmedfusion.MedFusion(cfg=jcfg.model, fundus_size=d.fundus_size, oct_size=d.oct_size)
    rec = {"uniform": [], "normal": [], "dropout": []}
    with record_jax_draws(rec):
        out, updated = jm.apply(
            jax_variables, batch["fundus_low"], batch["oct_low"], batch["label"], train=True,
            rngs={"sample": jax.random.key(4), "dropout": jax.random.key(5)}, mutable=["batch_stats"])
    tm = load_flax_variables(
        medfusion.MedFusion(tcfg.model, d.fundus_size, d.oct_size, device="cpu"),
        jax_variables["params"], jax_variables["batch_stats"])
    got = tm(_t(batch["fundus_low"]), _t(batch["oct_low"]), _t(batch["label"]), train=True,
             **port_draws(rec, 1)[0])
    # The step's bar: BN on batch statistics of 3 samples amplifies the two
    # stacks' rounding differences beyond the eval forward's 1e-4.  The
    # BN'd blocks of the features get 1e-2: flax's variance E[x^2] - E[x]^2
    # cancels where a column barely varies over the 3 samples (one column
    # here has a variance of ~4e-5 at E[x^2] ~ 1, so f32 rounding moves its
    # normalised values by ~3e-3); the raw middle block gets the step's bar.
    logits, loss, combined, aux = out
    _close(got[0], logits, ATOL, RTOL)
    half = jcfg.model.fundus_embed_dim
    _close(got[2][:, half:2 * half], np.asarray(combined)[:, half:2 * half], ATOL, RTOL)
    _close(got[2], combined, 1e-2, 1e-2)
    np.testing.assert_allclose(float(got[1].detach()), float(loss), atol=ATOL, rtol=RTOL)
    assert set(got[3]) == set(aux)
    for key in aux:
        np.testing.assert_allclose(float(got[3][key].detach()), float(aux[key]), atol=ATOL, rtol=RTOL,
                                   err_msg=key)
    for bn in ("bn1", "bn2"):
        stats = updated["batch_stats"]["dilr"][bn]
        _close(getattr(tm.dilr, bn).running_mean, stats["mean"], atol=1e-5, rtol=1e-5)
        _close(getattr(tm.dilr, bn).running_var, stats["var"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The whole step.
# ---------------------------------------------------------------------------


CASES = {
    # name: (fused flags, train config overrides, forwards)
    "fused_mmd": (True, {}, 2),
    "pallas_mmd": (False, {"use_pallas_mmd": True}, 2),
    "no_mmd_js": (False, {"mmd_weight": 0.0, "js_distillation_weight": 0.5}, 2),
    "no_mmd_no_js": (False, {"mmd_weight": 0.0}, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(jax_variables, case):
    fused, overrides, forwards = CASES[case]
    jcfg, tcfg = _configs(fused, **overrides)
    batch = _batch(tcfg)
    jout, jgrads, jstats, rec = _run_jax_step(jcfg, jax_variables, batch)

    state = trainer.init_state(tcfg, device="cpu", variables=jax_variables)
    out = trainer.make_train_step(tcfg)(state, batch, torch.Generator(), draws=port_draws(rec, forwards))

    for key in ("loss", "mmd"):
        np.testing.assert_allclose(float(out[key]), float(jout[key]), atol=ATOL, rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(out["probs"].numpy(), np.asarray(jout["probs"]), atol=ATOL, rtol=RTOL)
    assert set(out) == set(jout)
    key_map = flax_key_map(state.model, jax_variables["params"], jax_variables["batch_stats"])
    n_grads = 0
    for name, p in state.model.named_parameters():
        want = _leaf(jgrads, key_map[name])
        if key_map[name].endswith("/kernel"):
            want = want.T
        np.testing.assert_allclose(p.grad.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)
        n_grads += 1
    assert n_grads == len(jax.tree_util.tree_leaves(jgrads))
    n_stats = 0
    for name, buf in state.model.named_buffers():
        if name in key_map:
            np.testing.assert_allclose(buf.numpy(), _leaf(jstats, key_map[name]), atol=1e-5,
                                       rtol=1e-5, err_msg=name)
            n_stats += 1
    assert n_stats == 4
    assert state.step == 1


def _optax_params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("clip,warmup", [(0.0, 100), (0.5, 100), (0.0, 0)])
def test_optimizer_matches_optax_on_identical_grads(clip, warmup):
    jcfg = jax_tiny_config().replace(train=dataclasses.replace(
        jax_tiny_config().train, lr=1e-2, weight_decay=1e-2, grad_clip_norm=clip, warmup_steps=warmup))
    tcfg = tconfig.tiny_test_config().replace(train=dataclasses.replace(
        tconfig.tiny_test_config().train, lr=1e-2, weight_decay=1e-2, grad_clip_norm=clip,
        warmup_steps=warmup))
    params = _optax_params(0)
    tx = jtrainer.make_optimizer(jcfg)
    opt_state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    optimizer, scheduler = trainer.make_optimizer(list(tparams.values()), tcfg)
    jparams = params
    for step in range(4):
        grads = _optax_params(10 + step)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        if clip > 0:
            torch.nn.utils.clip_grad_norm_(list(tparams.values()), clip)
        optimizer.step()
        scheduler.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6, rtol=1e-6)


def test_warmup_factor():
    assert trainer.warmup_factor(0, 100) == pytest.approx(0.01)
    assert trainer.warmup_factor(99, 100) == 1.0
    assert trainer.warmup_factor(500, 100) == 1.0
    assert trainer.warmup_factor(3, 0) == 1.0


def test_eval_step_matches_jax(jax_variables):
    jcfg, tcfg = _configs(True)
    batch = _batch(tcfg)
    model = jtrainer.make_model(jcfg)
    state = jtrainer.TrainState(step=jnp.asarray(0), params=jax_variables["params"],
                                batch_stats=jax_variables["batch_stats"], opt_state=())
    want = jtrainer.make_eval_step(model, jcfg)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    m = jcfg.model
    ku1, ku2 = jax.random.split(jax.random.key(1))
    shape = (BATCH, m.num_classes, m.z_dim)
    draws = {
        "guided_uniform": tuple(torch.tensor(np.asarray(jax.random.uniform(k, shape))) for k in (ku1, ku2)),
        "eprl_eps": torch.tensor(np.asarray(
            jax.random.normal(jax.random.key(1), (m.num_classes, m.sample_num, m.z_dim)))),
    }
    tstate = trainer.init_state(tcfg, device="cpu", variables=jax_variables)
    got = trainer.make_eval_step(tcfg)(tstate, batch, draws=draws)
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)


def test_step_trains_and_updates_running_stats():
    """Without injected draws the step draws from its generator (the same
    seed gives the same step), updates every parameter the loss reaches and
    the BN statistics, and counts the step."""
    _, tcfg = _configs(False)
    state = trainer.init_state(tcfg, seed=3, device="cpu")
    twin = trainer.init_state(tcfg, seed=3, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = trainer.make_train_step(tcfg)
    out = step(state, _batch(tcfg), torch.Generator().manual_seed(4))
    assert torch.equal(step(twin, _batch(tcfg), torch.Generator().manual_seed(4))["loss"], out["loss"])
    assert torch.isfinite(out["loss"]) and float(out["mmd"]) > 0.0
    after = state.model.state_dict()
    for name, p in state.model.named_parameters():
        if p.grad.abs().max() > 0:
            assert not torch.equal(before[name], after[name]), name
    assert not torch.equal(before["eprl_fundus.token_mlp.weight"], after["eprl_fundus.token_mlp.weight"])
    assert not torch.equal(before["dilr.bn1.running_var"], after["dilr.bn1.running_var"])
    assert state.step == 1 and state.scheduler.get_last_lr() == [tcfg.train.lr]

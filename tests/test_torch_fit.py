"""The port's fit loop and what it stands on, against the JAX package, on the CPU.

- The train step from a clean batch (uint8 and f32): the dequantize, the
  on-device augmentation and noise, then the step, against JAX's
  ``make_train_step(..., jit=False)`` (traced under ``jax.jit`` with its
  draws as outputs) fed the same draws, at the bars of
  ``test_torch_train.test_train_step_matches_jax``.
- The bf16 step (ROADMAP queue C1): JAX's bf16-vs-f32 gradient gap beside
  the port's on the same batch and draws.
- Metrics (1e-12), the CSV rows (bytes), ``PlateauTracker``,
  ``set_learning_rate`` under the warmup (against optax's chain),
  ``run_eval`` (against JAX's on carried weights, 1e-5), checkpoints (bit
  for bit) and resume (a run resumed after 2 of 4 epochs ends equal to an
  uninterrupted one).
"""

import csv
import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edrl_tpu.config import tiny_test_config as jax_tiny_config
from edrl_tpu.data import BatchLoader as JaxBatchLoader
from edrl_tpu.data import SyntheticGammaDataset as JaxSyntheticGammaDataset
from edrl_tpu.train import logging as jlogging
from edrl_tpu.train import metrics as jmetrics
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.convert import flax_key_map
from edrl_tpu_torch.data import BatchLoader, SyntheticGammaDataset
from edrl_tpu_torch.data import device_augment as aug
from edrl_tpu_torch.train import logging as tlogging
from edrl_tpu_torch.train import metrics
from edrl_tpu_torch.train import trainer
from edrl_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_data import fundus_draws, view_draws
from test_torch_train import ATOL, BATCH, RTOL, _configs, _leaf, jax_variables, port_draws, record_jax_draws  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU work here: the tiny config's ops
    are small, and the test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The train step from a clean batch.
# ---------------------------------------------------------------------------


def _clean_batch(cfg, dtype, seed=0):
    rng = np.random.default_rng(seed)
    d = cfg.data
    shapes = {"fundus": (BATCH, d.fundus_size, d.fundus_size, 3), "oct": (BATCH, *d.oct_size, 1)}
    if dtype == "uint8":
        batch = {k: rng.integers(0, 256, s, dtype=np.uint8) for k, s in shapes.items()}
    else:
        batch = {k: rng.uniform(size=s).astype(np.float32) for k, s in shapes.items()}
    batch["label"] = np.array([0, 1, 1], np.int32)
    return batch


def split_input_draws(rec, cfg, batch):
    """JAX's recorded draws of a clean-batch step -> (the port's input draws,
    the record of the model's draws).  JAX draws, in order: the fundus
    augmentation's 7 uniforms, the OCT's 1, the views' noise, then the two
    forwards."""
    d = cfg.data
    fundus_shape, oct_shape = batch["fundus"].shape, batch["oct"].shape
    sizes = {"low": (d.noise.gaussian_low, d.noise.salt_pepper_low),
             "high": (d.noise.gaussian_high, d.noise.salt_pepper_high)}
    from edrl_tpu_torch.data import device_noise

    n_normal = n_uniform = 0
    for view in ("low", "high"):
        for key in device_noise.draw_corruption(fundus_shape, oct_shape, d.noise, *sizes[view], torch.Generator(),
                                                "cpu"):
            n_normal += key.endswith("gaussian")
            n_uniform += key.endswith("salt_pepper")
    noise_rec = {"normal": rec["normal"][:n_normal], "uniform": rec["uniform"][8:8 + n_uniform]}
    draws = {
        "fundus_augment": fundus_draws(rec["uniform"][:7]),
        "oct_augment": {"flip": torch.tensor(np.asarray(rec["uniform"][7]))},
        "views": view_draws(noise_rec, d.noise, fundus_shape, oct_shape),
    }
    model_rec = {"normal": rec["normal"][n_normal:], "uniform": rec["uniform"][8 + n_uniform:],
                 "dropout": rec["dropout"]}
    return draws, model_rec


def _run_jax_step(jcfg, variables, batch):
    """One JAX step under ``jax.jit`` (a fraction of the eager step's time on
    the CPU), its draws returned from the traced function:
    ``(out, grads, new batch_stats, draws record)``.  A stand-in optimizer
    passes the gradients out as its state."""
    model = jtrainer.make_model(jcfg)
    tx = optax.GradientTransformation(lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
                                      lambda grads, opt_state, params=None: (
                                          jax.tree_util.tree_map(jnp.zeros_like, grads), grads))
    state = jtrainer.TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]))
    step = jtrainer.make_train_step(model, tx, jcfg, jit=False)

    def run(state, batch, key):
        rec = {"uniform": [], "normal": [], "dropout": []}
        with record_jax_draws(rec, convert=lambda x: x):
            new_state, out = step(state, batch, key)
        return new_state, out, rec

    new_state, out, rec = jax.jit(run)(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(7))
    numpy = lambda tree: jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))  # noqa: E731
    return out, numpy(new_state.opt_state), numpy(new_state.batch_stats), numpy(rec)


@pytest.fixture(scope="module")
def clean_steps(jax_variables):  # noqa: F811
    """``run(dtype, bf16)``: JAX's step and the port's on the same clean
    batch and draws, each computed once: ``(JAX's out, grads, batch stats),
    (the port's out, state)``."""
    memo = {}

    def run(dtype, bf16=False):
        if (dtype, bf16) not in memo:
            jcfg, tcfg = (c.replace(model=dataclasses.replace(c.model, use_bfloat16=bf16)) for c in _configs(False))
            batch = _clean_batch(tcfg, dtype)
            jout, jgrads, jstats, rec = _run_jax_step(jcfg, jax_variables, batch)
            input_draws, model_rec = split_input_draws(rec, tcfg, batch)
            state = trainer.init_state(tcfg, device="cpu", variables=jax_variables)
            out = trainer.make_train_step(tcfg)(state, batch, torch.Generator(),
                                                draws=port_draws(model_rec, 2), input_draws=input_draws)
            memo[(dtype, bf16)] = (jout, jgrads, jstats), (out, state)
        return memo[(dtype, bf16)]

    return run


def _port_grads(state):
    return {name: p.grad.float().clone() for name, p in state.model.named_parameters()}


def _jax_grads(state, jgrads, variables):
    """JAX's gradients by the port's parameter names, in the port's layout."""
    key_map = flax_key_map(state.model, variables["params"], variables["batch_stats"])
    out = {}
    for name, _ in state.model.named_parameters():
        g = _leaf(jgrads, key_map[name]).astype(np.float32)
        out[name] = torch.tensor(g.T if key_map[name].endswith("/kernel") else g)
    return out


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_clean_batch_step_matches_jax(jax_variables, clean_steps, dtype):  # noqa: F811
    """A clean batch through the whole step: the four views come from the
    port's own augmentation and noise on JAX's draws, then the step is held
    at the bars of ``test_train_step_matches_jax``."""
    (jout, jgrads, jstats), (out, state) = clean_steps(dtype)
    for key in ("loss", "mmd"):
        np.testing.assert_allclose(float(out[key]), float(jout[key]), atol=ATOL, rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(out["probs"].numpy(), np.asarray(jout["probs"]), atol=ATOL, rtol=RTOL)
    want = _jax_grads(state, jgrads, jax_variables)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=ATOL, rtol=RTOL, err_msg=name)
    key_map = flax_key_map(state.model, jax_variables["params"], jax_variables["batch_stats"])
    for name, buf in state.model.named_buffers():
        if name in key_map:
            np.testing.assert_allclose(buf.numpy(), _leaf(jstats, key_map[name]), atol=1e-5, rtol=1e-5)
    assert state.step == 1


def test_bf16_step_gap_matches_jax(jax_variables, clean_steps):  # noqa: F811
    """ROADMAP queue C1: at the tiny config in bf16, on the clean uint8 batch
    with JAX's draws, the port's bf16 step against its f32 step reads a gap
    of the same order as JAX's bf16 step against JAX's f32 step.

    Gap: per tensor, the largest |bf16 - f32| gradient over the largest
    |f32| one, median over the tensors (the key biases aside: their
    gradient is 0 up to rounding, as softmax ignores a shift of the keys).
    Read when the bars were set: JAX (its step under jit, as its trainer
    runs it) 0.217, the port 0.188, the bf16 losses 5.3e-4 apart; JAX's
    eager step read 0.156, and on another batch the two read 0.45 and 0.22,
    3.6e-3 apart.  Each module's bf16 eval output lay within one bf16
    rounding of JAX's.  Bars: each median within 3x of the other; the bf16
    losses at 2e-2."""
    (jf, jgf, _), (tf, sf) = clean_steps("uint8")
    (jb, jgb, _), (tb, sb) = clean_steps("uint8", bf16=True)

    def median_gap(bf16, f32):
        errs = sorted(float((bf16[n] - f32[n]).abs().max() / f32[n].abs().max())
                      for n in f32 if not n.endswith(".k.bias") and f32[n].abs().max() > 0)
        return errs[len(errs) // 2]

    j_gap = median_gap(_jax_grads(sb, jgb, jax_variables), _jax_grads(sf, jgf, jax_variables))
    t_gap = median_gap(_port_grads(sb), _port_grads(sf))
    print(f"bf16 vs f32 gradient gap (median): JAX {j_gap:.3e}, port {t_gap:.3e}; bf16 loss JAX "
          f"{float(jb['loss']):.7g}, port {float(tb['loss']):.7g}; f32 loss JAX {float(jf['loss']):.7g}, "
          f"port {float(tf['loss']):.7g}")
    np.testing.assert_allclose(float(tb["loss"]), float(jb["loss"]), rtol=2e-2)
    assert j_gap / 3 <= t_gap <= 3 * j_gap


def test_ablation_step_reads_and_builds_the_low_view_only(monkeypatch):
    """Without a second forward (MMD and JS weights 0) the step reads no
    high view of a ready-made batch and builds none from a clean one."""
    from edrl_tpu_torch.data import device_noise

    _, tcfg = _configs(False)
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, mmd_weight=0.0, js_distillation_weight=0.0))
    step = trainer.make_train_step(tcfg)
    state = trainer.init_state(tcfg, device="cpu")

    class LowOnly(dict):
        def __getitem__(self, key):
            assert not key.endswith("_high"), f"the step read {key}"
            return super().__getitem__(key)

    step(state, LowOnly(trainer.random_views(tcfg, batch_size=BATCH, device="cpu")), torch.Generator())
    built, real = [], device_noise.apply_corruption

    def spy(fundus, oct_vol, cfg, sigma, amount, draws):
        built.append((sigma, amount))
        return real(fundus, oct_vol, cfg, sigma, amount, draws)

    monkeypatch.setattr(device_noise, "apply_corruption", spy)
    step(state, _clean_batch(tcfg, "uint8"), torch.Generator().manual_seed(1))
    n = tcfg.data.noise
    assert built == [(n.gaussian_low, n.salt_pepper_low)]
    views = trainer.train_views(_clean_batch(tcfg, "float32"), tcfg, "cpu", torch.Generator(), two_views=False)
    assert set(views) == {"fundus_low", "oct_low", "label"} and state.step == 2


def test_clean_batch_views_follow_the_generator():
    """Without injected draws the views come from the generator: one seed,
    one set of views; the augmentation is per sample; the views lie in [0, 1]."""
    _, tcfg = _configs(False)
    batch = _clean_batch(tcfg, "uint8", seed=2)
    a = trainer.train_views(batch, tcfg, "cpu", torch.Generator().manual_seed(5))
    b = trainer.train_views(batch, tcfg, "cpu", torch.Generator().manual_seed(5))
    c = trainer.train_views(batch, tcfg, "cpu", torch.Generator().manual_seed(6))
    assert set(a) == {*trainer.VIEW_KEYS, "label"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fundus_high"], c["fundus_high"])
    for k in trainer.VIEW_KEYS:
        assert a[k].dtype == torch.float32 and 0.0 <= a[k].min() and a[k].max() <= 1.0
    # Gaussian, low sigma 0: the low view is the augmented clean batch.
    fa = aug.draw_fundus_augment(BATCH, torch.Generator().manual_seed(5), "cpu", tcfg.data.color_jitter_strength)
    clean = aug.apply_fundus_augment(torch.from_numpy(batch["fundus"]).float() / 255.0, fa,
                                     tcfg.data.color_jitter_prob, tcfg.data.grayscale_prob, tcfg.data.hflip_prob)
    assert torch.equal(a["fundus_low"], clean)


# ---------------------------------------------------------------------------
# Metrics, CSV, the plateau schedule and the learning rate.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_classes", [2, 4])
def test_metrics_match(num_classes):
    rng = np.random.default_rng(num_classes)
    targets = rng.integers(0, num_classes, 57)
    logits = rng.normal(size=(57, num_classes))
    logits[:5] = logits[5:10]  # tied scores
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    got = metrics.compute_epoch_metrics(targets, probs, 0.7).as_dict()
    want = jmetrics.compute_epoch_metrics(targets, probs, 0.7).as_dict()
    assert got.keys() == want.keys()
    np.testing.assert_allclose(list(got.values()), list(want.values()), atol=1e-12, rtol=0)
    got, want = metrics.compute_uncertainty_metrics(targets, probs), jmetrics.compute_uncertainty_metrics(targets, probs)
    assert list(got) == list(want) and len(got) == 10
    np.testing.assert_allclose(list(got.values()), list(want.values()), atol=1e-12, rtol=0)


def test_csv_rows_match_byte_for_byte(tmp_path):
    rows = [metrics.EpochMetrics(1.2345678, 0.5, 0.25, 0.5, 1 / 3, 0.61, 1.0),
            metrics.EpochMetrics(0.9, 0.75, 0.7, 0.75, 0.72, float("nan"), 0.5),
            metrics.EpochMetrics(0.8, 0.8, 0.8, 0.8, 0.8, 0.8, 0.8)]
    paths = {}
    for name, module, cls in (("port", tlogging, metrics.EpochMetrics), ("jax", jlogging, jmetrics.EpochMetrics)):
        paths[name] = str(tmp_path / name / "run.csv")
        writer = module.CsvMetricWriter(paths[name])
        for epoch, m in enumerate(rows, start=1):
            writer.write(epoch, cls(**m.as_dict()))
        assert writer.drop_rows_from(3) == 1
    with open(paths["port"], "rb") as f, open(paths["jax"], "rb") as g:
        assert f.read() == g.read()
    with open(paths["port"], newline="") as f:
        assert [r[0] for r in csv.reader(f)] == ["Epoch", "1", "2"]


def test_plateau_tracker_matches():
    signals = [1.0, 0.9, 0.95, 0.92, 0.91, 0.91, 0.8, 0.85, 0.85, 0.85, 0.85, 0.79, 0.9, 0.9, 0.9]
    mine, theirs = trainer.PlateauTracker(1e-3, 0.5, 2), jtrainer.PlateauTracker(1e-3, 0.5, 2)
    got = [mine.step(s) for s in signals]
    assert got == [theirs.step(s) for s in signals]
    assert sum(x is not None for x in got) >= 2


def test_set_learning_rate_during_warmup_matches_optax():
    """Four warmup steps, a plateau cut at step 2, two more steps: the port's
    base lr under the LambdaLR moves as optax's injected lr under its
    scale_by_schedule; the parameters agree at 1e-6 after every step."""
    kw = dict(lr=1e-2, weight_decay=1e-2, warmup_steps=4)
    jcfg = jax_tiny_config().replace(train=dataclasses.replace(jax_tiny_config().train, **kw))
    tcfg = tconfig.tiny_test_config().replace(train=dataclasses.replace(tconfig.tiny_test_config().train, **kw))
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jtrainer.make_optimizer(jcfg)
    jstate = jtrainer.TrainState(step=jnp.asarray(0), params=params, batch_stats={}, opt_state=tx.init(params))
    tparams = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    optimizer, scheduler = trainer.make_optimizer(list(tparams.values()), tcfg)
    tstate = trainer.TrainState(model=None, optimizer=optimizer, scheduler=scheduler)
    for step in range(6):
        if step == 2:
            jstate = jtrainer.set_learning_rate(jstate, 4e-3)
            trainer.set_learning_rate(tstate, 4e-3)
            assert trainer.get_learning_rate(tstate) == pytest.approx(jtrainer.get_learning_rate(jstate), rel=1e-7)
            assert scheduler.get_last_lr()[0] == pytest.approx(4e-3 * trainer.warmup_factor(2, 4))
        grads = {k: np.random.default_rng(10 + step).normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update(grads, jstate.opt_state, jstate.params)
        jstate = jstate.replace(params=optax.apply_updates(jstate.params, updates), opt_state=opt_state)
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        optimizer.step()
        scheduler.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# run_eval, checkpoints, resume.
# ---------------------------------------------------------------------------


def _jax_eval_draws(cfg, n):
    """The draws JAX's eval forward makes for a batch of ``n`` (fixed keys)."""
    m = cfg.model
    ku1, ku2 = jax.random.split(jax.random.key(1))
    shape = (n, m.num_classes, m.z_dim)
    return {"guided_uniform": tuple(torch.tensor(np.asarray(jax.random.uniform(k, shape))) for k in (ku1, ku2)),
            "eprl_eps": torch.tensor(np.asarray(
                jax.random.normal(jax.random.key(1), (m.num_classes, m.sample_num, m.z_dim))))}


@pytest.mark.parametrize("mask", [None, (True, False), (False, True)], ids=["both", "fundus_only", "oct_only"])
def test_run_eval_matches_jax(jax_variables, mask):  # noqa: F811
    """Clean uint8 batches of 3 and a remainder of 2 (the low view draws
    nothing: sigma 0): JAX's ``run_eval`` on its eval step against the
    port's on the same weights, JAX's eval draws injected."""
    jcfg, tcfg = _configs(False)
    jd = dataclasses.replace(jcfg.data, device_noise=True, num_synthetic_samples=5)
    td = dataclasses.replace(tcfg.data, device_noise=True, num_synthetic_samples=5)
    jloader = JaxBatchLoader(JaxSyntheticGammaDataset(jd, mode="val"), BATCH, shuffle=False, drop_last=False,
                             num_workers=2, uint8_transport=True)
    tloader = BatchLoader(SyntheticGammaDataset(td, mode="val"), BATCH, shuffle=False, drop_last=False,
                          num_workers=2, uint8_transport=True)
    modality_mask = None if mask is None else np.array(mask)
    jstate = jtrainer.TrainState(step=jnp.asarray(0), params=jax_variables["params"],
                                 batch_stats=jax_variables["batch_stats"], opt_state=())
    want, wt, wp = jtrainer.run_eval(jstate, jtrainer.make_eval_step(jtrainer.make_model(jcfg), jcfg), jloader,
                                     modality_mask=modality_mask)
    state = trainer.init_state(tcfg, device="cpu", variables=jax_variables)
    port_eval = trainer.make_eval_step(tcfg)
    sizes = []

    def eval_step(st, batch, mm=None):
        sizes.append(int(batch["label"].shape[0]))
        return port_eval(st, batch, mm, draws=_jax_eval_draws(tcfg, sizes[-1]))

    got, gt, gp = trainer.run_eval(state, eval_step, tloader, modality_mask=modality_mask)
    assert sizes == [3, 2]
    assert np.array_equal(gt, wt)
    np.testing.assert_allclose(gp, np.asarray(wp), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(list(got.as_dict().values()), list(want.as_dict().values()), atol=1e-5, rtol=1e-5)


def test_run_eval_empty_loader_gives_nan_metrics():
    _, tcfg = _configs(False)
    td = dataclasses.replace(tcfg.data, num_synthetic_samples=2)
    state = trainer.init_state(tcfg, device="cpu")
    loader = BatchLoader(SyntheticGammaDataset(td, mode="val"), BATCH, shuffle=False, drop_last=True)
    m, targets, probs = trainer.run_eval(state, trainer.make_eval_step(tcfg), loader)
    assert np.isnan(m.loss) and np.isnan(m.accuracy) and targets.shape == (0,) and probs.shape == (0, 2)


def test_eval_low_view_of_clean_batches():
    """Sigma 0 draws nothing: the low view is the dequantized batch, as JAX's.
    Otherwise the view comes from a fixed seed: two calls give one view."""
    _, tcfg = _configs(False)
    batch = trainer.to_device(_clean_batch(tcfg, "uint8"), "cpu")
    f, o = trainer.eval_low_view(batch, tcfg, "cpu")
    assert torch.equal(f, batch["fundus"].float() / 255.0) and torch.equal(o, batch["oct"].float() / 255.0)
    noisy = tcfg.replace(data=dataclasses.replace(
        tcfg.data, noise=dataclasses.replace(tcfg.data.noise, gaussian_low=0.2)))
    f1, _ = trainer.eval_low_view(batch, noisy, "cpu")
    f2, _ = trainer.eval_low_view(batch, noisy, "cpu")
    assert torch.equal(f1, f2) and not torch.equal(f1, f)


def test_eval_step_on_a_noisy_low_view_matches_jax(jax_variables):  # noqa: F811
    """A clean batch with a low sigma of 0.2: JAX draws the low view from
    ``jax.random.key(123)``, which the port cannot replay; its draws, made
    here as ``make_low_view_device`` makes them, go in under ``low_view``."""
    jcfg, tcfg = _configs(False)
    jcfg, tcfg = (c.replace(data=dataclasses.replace(c.data, noise=dataclasses.replace(
        c.data.noise, gaussian_low=0.2))) for c in (jcfg, tcfg))
    batch = _clean_batch(tcfg, "uint8", seed=4)
    jstate = jtrainer.TrainState(step=jnp.asarray(0), params=jax_variables["params"],
                                 batch_stats=jax_variables["batch_stats"], opt_state=())
    want = jtrainer.make_eval_step(jtrainer.make_model(jcfg), jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    kf, ko, _, _ = jax.random.split(jax.random.key(123), 4)
    low_view = {"fundus_gaussian": torch.tensor(np.asarray(jax.random.normal(kf, batch["fundus"].shape))),
                "oct_gaussian": torch.tensor(np.asarray(jax.random.normal(ko, batch["oct"].shape)))}
    state = trainer.init_state(tcfg, device="cpu", variables=jax_variables)
    got = trainer.make_eval_step(tcfg)(state, batch, draws={**_jax_eval_draws(tcfg, BATCH), "low_view": low_view})
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)


def _train_batch(tcfg, seed):
    return _clean_batch(tcfg, "uint8", seed)


def _assert_states_equal(a, b):
    for (na, ta), (nb, tb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert na == nb and torch.equal(ta, tb), na
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for k in sa["state"]:
        for field in sa["state"][k]:
            assert torch.equal(sa["state"][k][field], sb["state"][k][field]), (k, field)
    assert a.scheduler.state_dict() == b.scheduler.state_dict() and a.step == b.step


def _entries(directory):
    """The names in ``directory``, and where each link among them points."""
    names = sorted(os.listdir(directory))
    links = {n: os.readlink(os.path.join(directory, n)) for n in names if os.path.islink(os.path.join(directory, n))}
    return names, links


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    _, tcfg = _configs(False)
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train, warmup_steps=10))
    state = trainer.init_state(tcfg, seed=1, device="cpu")
    step = trainer.make_train_step(tcfg)
    for i in range(2):
        step(state, _train_batch(tcfg, i), torch.Generator().manual_seed(i))
    trainer.set_learning_rate(state, 3e-4)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_best(state, epoch=2, accuracy=0.75)
    mgr.save_latest(state, epoch=2)
    mgr.save(state, "latest")  # over an existing checkpoint
    mgr.wait()
    assert mgr.best_info() == {"epoch": 2, "accuracy": 0.75} and mgr.latest_info() == {"epoch": 2}
    names, links = _entries(mgr.directory)
    # Each name links to its one live directory; the replaced one is gone.
    assert [n for n in names if not n.startswith(".")] == ["best", "best.json", "latest", "latest.json"]
    assert sorted(links) == ["best", "latest"] and sorted(n for n in names if n.startswith(".")) == sorted(
        links.values())

    restored = mgr.restore(trainer.init_state(tcfg, seed=9, device="cpu"), "best")
    _assert_states_equal(restored, state)
    assert trainer.get_learning_rate(restored) == 3e-4
    for st in (state, restored):
        step(st, _train_batch(tcfg, 5), torch.Generator().manual_seed(5))
    _assert_states_equal(restored, state)


def test_checkpoint_write_failure_leaves_no_partial_directory(tmp_path, monkeypatch):
    _, tcfg = _configs(False)
    state = trainer.init_state(tcfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, "best")
    mgr.wait()
    before = _entries(tmp_path)

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", fail)
    mgr.save(state, "best")
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert _entries(tmp_path) == before
    monkeypatch.undo()
    mgr.restore(trainer.init_state(tcfg, seed=4, device="cpu"), "best")


@pytest.mark.parametrize("crash", ["before_the_swap", "after_the_swap"])
def test_checkpoint_survives_a_crash_in_a_save(tmp_path, monkeypatch, crash):
    """A process that dies in the middle of replacing ``latest`` leaves a
    whole ``latest``, the old one or the new one, that resume finds; the
    next save removes what it left."""
    import edrl_tpu_torch.train.checkpoint as ckpt

    _, tcfg = _configs(False)
    old = trainer.init_state(tcfg, seed=1, device="cpu")
    new = trainer.init_state(tcfg, seed=2, device="cpu")
    new.step = 7
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_latest(old, epoch=1)
    mgr.wait()

    class Died(BaseException):
        """The process ends here: nothing after this line runs."""

    def die(*args):
        raise Died()

    if crash == "before_the_swap":
        monkeypatch.setattr(ckpt.os, "replace", die)
        monkeypatch.setattr(ckpt.shutil, "rmtree", lambda *a, **k: None)
        monkeypatch.setattr(ckpt.os, "unlink", lambda *a: None)
    else:
        monkeypatch.setattr(ckpt, "_remove_stale", die)
    mgr.save(new, "latest")
    with pytest.raises(Died):
        mgr.wait()
    monkeypatch.undo()
    # What a new process finds: a whole latest, and a crash's leftovers.
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_info() == {"epoch": 1}
    names, links = _entries(tmp_path)
    assert len([n for n in names if n.startswith(".latest.v-")]) > 1
    got = mgr.restore(trainer.init_state(tcfg, seed=9, device="cpu"), "latest")
    _assert_states_equal(got, old if crash == "before_the_swap" else new)
    mgr.save(got, "latest")
    mgr.wait()
    names, links = _entries(tmp_path)
    assert [n for n in names if n.startswith(".")] == [links["latest"]]


def _fit_config(tmp_path, **train):
    _, tcfg = _configs(False)
    data = dataclasses.replace(tcfg.data, batch_size=4, eval_batch_size=4, num_synthetic_samples=8,
                               device_noise=True)
    train = {"end_epochs": 4, "save_latest_every": 1, "log_dir": str(tmp_path / "log"), "name": "r", **train}
    return tcfg.replace(data=data, train=dataclasses.replace(tcfg.train, **train))


def _loaders(cfg):
    return (BatchLoader(SyntheticGammaDataset(cfg.data, "train"), 4, seed=cfg.train.seed, num_workers=2,
                        uint8_transport=True),
            BatchLoader(SyntheticGammaDataset(cfg.data, "val"), 4, shuffle=False, drop_last=False, num_workers=2,
                        uint8_transport=True))


def test_resume_is_step_identical_to_an_uninterrupted_run(tmp_path):
    """Epoch-indexed shuffles and step-seeded noise: 2 epochs, a "crash",
    ``resume_from_latest`` and 2 more end where 4 uninterrupted epochs end,
    and the CSV holds the same rows."""
    base = _fit_config(tmp_path / "a")
    whole, _ = trainer.fit(base, *_loaders(base), verbose=False, device="cpu",
                           checkpoint_manager=CheckpointManager(str(tmp_path / "a" / "ckpt")))

    cut = _fit_config(tmp_path / "b")
    mgr = CheckpointManager(str(tmp_path / "b" / "ckpt"))
    half = cut.replace(train=dataclasses.replace(cut.train, end_epochs=2))
    trainer.fit(half, *_loaders(half), checkpoint_manager=mgr, verbose=False, device="cpu")
    resume = cut.replace(train=dataclasses.replace(cut.train, resume=True))
    resumed = trainer.resume_from_latest(resume, mgr, _loaders(resume)[0], device="cpu")
    assert resumed is not None
    state, rcfg, initial_best, done = resumed
    assert done == 2 and rcfg.train.start_epoch == 3 and initial_best == mgr.best_info()["accuracy"]
    # A row of an epoch the crash lost, which the resumed run re-writes.
    tlogging.CsvMetricWriter(os.path.join(rcfg.train.log_dir, "synthetic_0.5_r.csv")).write(
        3, metrics.EpochMetrics(*[0.0] * 7))
    final, result = trainer.fit(rcfg, *_loaders(rcfg), state=state, checkpoint_manager=mgr, verbose=False,
                                initial_best=initial_best, device="cpu")
    assert final.step == whole.step == 8 and len(result.train_history) == 2
    _assert_states_equal(final, whole)
    with open(tmp_path / "a" / "log" / "synthetic_0.5_r.csv", "rb") as f, \
            open(tmp_path / "b" / "log" / "synthetic_0.5_r.csv", "rb") as g:
        assert f.read() == g.read()


def test_resume_without_latest_returns_none(tmp_path):
    cfg = _fit_config(tmp_path)
    assert trainer.resume_from_latest(cfg, CheckpointManager(str(tmp_path / "c")), _loaders(cfg)[0],
                                      device="cpu") is None


def test_fit_writes_checkpoints_logs_and_plots(tmp_path):
    cfg = _fit_config(tmp_path, end_epochs=2, save_every=2, plot_dir=str(tmp_path / "plots"), student_t_every=1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state, result = trainer.fit(cfg, *_loaders(cfg), checkpoint_manager=mgr, verbose=False, device="cpu")
    assert state.step == 4 and len(result.val_history) == 2 and np.isfinite(result.train_history[-1].loss)
    assert mgr.best_info()["epoch"] == result.best_epoch >= 1
    assert {"best", "epoch_2", "latest"} <= set(os.listdir(mgr.directory))
    plots = sorted(os.listdir(tmp_path / "plots"))
    assert plots == ["MedFusion_4_synthetic_2_acc.jpg", "MedFusion_4_synthetic_2_loss.jpg",
                     "students_t_distributions_epoch_1.pdf", "students_t_distributions_epoch_2.pdf"]


def test_proxy_distribution_dump_matches_jax(jax_variables, monkeypatch, tmp_path):  # noqa: F811
    """The Student-t summaries of EPRL's proxies that the epoch dump plots:
    the port's, read from the module, against JAX's, read from the params."""
    from edrl_tpu.train import visualize as jvisualize
    from edrl_tpu_torch.train import visualize

    captured = {}
    for name, module in (("port", visualize), ("jax", jvisualize)):
        monkeypatch.setattr(module, "visualize_student_t_distributions",
                            lambda *args, _n=name: captured.setdefault(_n, args[:6]))
    _, tcfg = _configs(False)
    state = trainer.init_state(tcfg, device="cpu", variables=jax_variables)
    visualize.dump_proxy_distributions(state.model, tcfg.model, 1, str(tmp_path))
    jvisualize.dump_proxy_distributions(jax_variables["params"], _configs(False)[0].model, 1, str(tmp_path))
    assert len(captured["port"][0]) == 2 * tcfg.model.num_classes
    np.testing.assert_allclose(np.array(captured["port"]), np.array(captured["jax"]), rtol=1e-5, atol=1e-7)


def test_refusals_name_their_roadmap_items(tmp_path):
    """What runs and what refuses: ``check_ported`` takes every registry
    name at model axes 2 and 4 and ``scan_batches`` 2 and 64; over a model
    axis only B5 and B6 refuse, by flag (``ValueError``), in ``fit`` as in
    ``check_ported``; a mesh that is not a DeviceMesh is a TypeError; ZeRO-1
    with no mesh is one rank's plain step (a one-epoch fit equal to the run
    without it)."""
    from edrl_tpu_torch.baselines import MODEL_REGISTRY

    _, tcfg = _configs(False)
    for name in MODEL_REGISTRY:
        for shards in (2, 4):
            for scan in (2, 64):
                trainer.check_ported(tcfg.replace(
                    model=dataclasses.replace(tcfg.model, model_name=name),
                    train=dataclasses.replace(tcfg.train, num_model_shards=shards, scan_batches=scan)))
    for flag in ("use_fused_mlp", "use_fused_block_attention"):
        cfg = tcfg.replace(train=dataclasses.replace(tcfg.train, num_model_shards=2, scan_batches=2),
                           model=dataclasses.replace(tcfg.model, model_name="Trans_cross", **{flag: True}))
        with pytest.raises(ValueError, match=flag):
            trainer.fit(cfg, None, None, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        trainer.fit(tcfg, None, None, mesh=object(), device="cpu")
    data = dataclasses.replace(tcfg.data, num_synthetic_samples=6, device_noise=True)
    states = []
    for zero1 in (False, True):
        cfg = tcfg.replace(data=data, train=dataclasses.replace(tcfg.train, zero1=zero1, end_epochs=1, log_dir="",
                                                                plot_dir=""))
        loader = BatchLoader(SyntheticGammaDataset(data, "train"), BATCH, num_workers=1, uint8_transport=True)
        states.append(trainer.fit(cfg, loader, loader, verbose=False, device="cpu")[0])
    assert isinstance(states[1].optimizer, torch.optim.Adam)
    _assert_states_equal(*states)
    trainer.check_ported(tcfg.replace(model=dataclasses.replace(tcfg.model, model_name="Multi_ResNet")))
    with pytest.raises(NameError, match="NoSuchModel"):
        trainer.check_ported(tcfg.replace(model=dataclasses.replace(tcfg.model, model_name="NoSuchModel")))


# ---------------------------------------------------------------------------
# scan_batches: accepted at any K, the run the per-batch one.
# ---------------------------------------------------------------------------


def _scan_fit(tmp_path, scan):
    """Two epochs of 3 batches of 4 with ``scan_batches`` ``scan``: the final
    state and the CSV's bytes."""
    cfg = _fit_config(tmp_path, end_epochs=2, scan_batches=scan, save_latest_every=0)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_synthetic_samples=12))
    state, _ = trainer.fit(cfg, *_loaders(cfg), verbose=False, device="cpu")
    with open(tmp_path / "log" / "synthetic_0.5_r.csv", "rb") as f:
        return state, f.read()


@pytest.fixture(scope="module")
def per_batch_fit(tmp_path_factory):
    return _scan_fit(tmp_path_factory.mktemp("per_batch"), 0)


@pytest.mark.parametrize("scan", [2, 3, 64], ids=["chunk_and_remainder", "whole_epoch_chunks", "longer_than_the_epoch"])
def test_scan_batches_fit_is_bit_equal_to_per_batch_fit(per_batch_fit, tmp_path, scan):
    """``scan_batches`` K over 3 batches an epoch, 2 epochs (in the JAX
    package K = 2 scans one chunk an epoch and dispatches the third batch on
    its own, K = 3 scans the whole epoch, K = 64 dispatches every batch on
    its own): each run ends bit-equal to the per-batch run: parameters,
    moments, the schedule, the step and the CSV's bytes."""
    state, csv_bytes = _scan_fit(tmp_path, scan)
    want_state, want_csv = per_batch_fit
    assert state.step == want_state.step == 6
    _assert_states_equal(state, want_state)
    assert csv_bytes == want_csv

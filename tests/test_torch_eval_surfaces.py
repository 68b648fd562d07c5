"""The evaluation surfaces over the baseline zoo against the JAX package, on the
CPU at the baseline tests' sizes (fundus 32^2, OCT 16^3): MC-dropout, the
robustness sweep, deep ensembles (``ensemble_predict``, ``Metric.txt``), the
ensemble ``Predictor``, and the CLIs that drive them (``cli.train
--model_name``, ``cli.test --mc_samples --sweep``, ``cli.ensemble``).

Bars: f32 1e-5 (probabilities, stds, metrics).  The eval view is JAX's
wherever it draws nothing (sigma and amount 0, the CLI's default); the JAX
MC-dropout masks are recorded as flax draws them and injected.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edrl_tpu.train import ensemble as jensemble
from edrl_tpu.train import mc_dropout as jmc
from edrl_tpu.train import metrics as jmetrics
from edrl_tpu.train import robustness as jrobustness
from edrl_tpu.train import trainer as jtrainer
from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.cli import ensemble as ensemble_cli
from edrl_tpu_torch.cli import test as test_cli
from edrl_tpu_torch.cli import train as train_cli
from edrl_tpu_torch.data import SYNTHETIC_DATASETS, BatchLoader
from edrl_tpu_torch.serve.predictor import Predictor
from edrl_tpu_torch.train import ensemble, mc_dropout, robustness, trainer
from edrl_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_baselines import build_pair, inputs
from test_torch_train import record_jax_draws

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_state(variables):
    return jtrainer.TrainState(step=jnp.asarray(0, jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"], opt_state=None)


def _val_loader(cfg):
    ds = SYNTHETIC_DATASETS[cfg.data.dataset](cfg.data, mode="val")
    return BatchLoader(ds, cfg.data.eval_batch_size, shuffle=False, drop_last=False, num_workers=1)


# ---------------------------------------------------------------------------
# MC-dropout.
# ---------------------------------------------------------------------------


def test_mc_predict_matches_jax_on_its_masks():
    """K = 3 passes of the dropout feature extractor with JAX's masks: the
    mean and std of the softmax equal ``make_mc_predict``'s."""
    jcfg, tcfg, jm, tm, variables = build_pair("Medical_base_dropout_3DNet")
    f, o, y = inputs(tcfg, seed=4)
    rec = {"uniform": [], "normal": [], "dropout": []}
    with jax.disable_jit(), record_jax_draws(rec):
        mean_j, std_j = jmc.make_mc_predict(jm, 3)(_jax_state(variables), f, o, y, jax.random.key(5))
    assert len(rec["dropout"]) == 3
    predict = mc_dropout.make_mc_predict(tm.eval(), 3)
    masks = [[torch.tensor(np.asarray(m))] for m in rec["dropout"]]
    mean_t, std_t = predict(torch.tensor(f), torch.tensor(o), torch.tensor(y), masks=masks)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=ATOL)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), atol=ATOL)
    assert float(std_t.max()) > 0.0


def test_mc_without_mc_gives_equal_passes():
    _, tcfg, jm, tm, _ = build_pair("Multi_ResNet")
    assert not mc_dropout.model_supports_mc(tm) and not jmc.model_supports_mc(jm)
    f, o, y = inputs(tcfg, seed=4)
    gens = [torch.Generator().manual_seed(k) for k in range(3)]
    _, std = mc_dropout.make_mc_predict(tm.eval(), 3)(torch.tensor(f), torch.tensor(o), torch.tensor(y), gens)
    assert float(std.abs().max()) == 0.0


def test_mc_dropout_predict_over_a_loader():
    _, tcfg, _, tm, variables = build_pair("Multi_dropout_ResNet")
    assert mc_dropout.model_supports_mc(tm)
    state = trainer.init_state(tcfg, device="cpu", variables=variables)
    loader = _val_loader(tcfg)
    a = mc_dropout.mc_dropout_predict(tcfg, state, loader, num_samples=3, seed=1, device="cpu")
    b = mc_dropout.mc_dropout_predict(tcfg, state, loader, num_samples=3, seed=1, device="cpu")
    n = len(loader.dataset)
    assert a["probs"].shape == (n, 2) and a["predictive_std"].shape == (n, 2) and a["targets"].shape == (n,)
    np.testing.assert_allclose(a["probs"].sum(-1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(a["probs"], b["probs"])  # seeded from (seed, batch, k)
    assert a["predictive_std"].mean() > 0.0


# ---------------------------------------------------------------------------
# The robustness sweep.
# ---------------------------------------------------------------------------


def test_noise_sweep_at_sigma_0_matches_jax_and_run_eval():
    jcfg, tcfg, jm, tm, variables = build_pair("Medical_3DNet")
    state = trainer.init_state(tcfg, device="cpu", variables=variables)
    got = robustness.noise_sweep(tcfg, state, sigmas=(0.0,), device="cpu")
    want = jrobustness.noise_sweep(jcfg, _jax_state(variables), sigmas=(0.0,))
    assert list(got) == list(want) == list(robustness.MODALITY_GRID)
    for modality in got:
        g, w = got[modality][0.0], want[modality][0.0]
        assert set(g) == set(w) and g["num_samples"] == w["num_samples"]
        for key in g:
            np.testing.assert_allclose(g[key], w[key], atol=ATOL, err_msg=f"{modality} {key}")
    m, _, _ = trainer.run_eval(state, trainer.make_eval_step(tcfg), _val_loader(tcfg))
    for key, value in m.as_dict().items():
        np.testing.assert_allclose(got["both"][0.0][key], value, atol=1e-7)
    assert robustness.format_sweep(got) == jrobustness.format_sweep(want)


def test_sweep_grids_and_format_match_jax():
    assert robustness.DEFAULT_SIGMAS == jrobustness.DEFAULT_SIGMAS
    assert robustness.DEFAULT_SP_LEVELS == jrobustness.DEFAULT_SP_LEVELS
    assert {k: None if v is None else v.tolist() for k, v in robustness.MODALITY_GRID.items()} == {
        k: None if v is None else v.tolist() for k, v in jrobustness.MODALITY_GRID.items()}
    from edrl_tpu.config import tiny_test_config as jax_tiny_config

    tcfg, jcfg = tconfig.tiny_test_config(), jax_tiny_config()
    for kind in ("gaussian", "salt_pepper"):
        assert dataclasses.asdict(robustness._cfg_for(tcfg, 0.3, kind).data.noise) == dataclasses.asdict(
            jrobustness._cfg_for(jcfg, 0.3, kind).data.noise)
    results = {"both": {0.005: {"accuracy": 0.5, "auc": 0.25, "f1": 1 / 3}, 0.001: {"accuracy": 1.0, "auc": 1.0,
                                                                                  "f1": 1.0}}}
    assert robustness.format_sweep(results) == jrobustness.format_sweep(results)
    with pytest.raises(ValueError):
        robustness._cfg_for(tcfg, 0.1, "blur")


@pytest.mark.parametrize("sweep,kind,levels,sp,want", [
    ("gaussian", "gaussian", [0.2], None, (0.2,)),
    ("all", "salt_pepper", [0.2], None, (0.0, 0.001, 0.005, 0.01, 0.05)),
    ("all", "salt_pepper", [0.2], [0.01], (0.01,)),
    ("salt_pepper", "salt_pepper", [0.02], None, (0.02,)),
])
def test_resolve_sweep_levels_matches_jax(sweep, kind, levels, sp, want):
    from edrl_tpu.cli.test import resolve_sweep_levels as jresolve

    args = (sweep, kind, levels, sp, robustness.DEFAULT_SIGMAS, robustness.DEFAULT_SP_LEVELS)
    assert test_cli.resolve_sweep_levels(*args) == jresolve(*args) == want


# ---------------------------------------------------------------------------
# Deep ensembles.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def members():
    """Two converted Multi_DE members (the same architecture, other weights)."""
    out = [build_pair("Multi_DE1_ResNet", seed=s) for s in (0, 10)]
    return out[0][0], out[0][1], out[0][2], [v for *_, v in out]


def test_ensemble_predict_matches_jax(members):
    jcfg, tcfg, jm, variables = members
    models = [trainer.init_state(tcfg, device="cpu", variables=v).model for v in variables]
    got = ensemble.ensemble_predict(tcfg, models, _val_loader(tcfg), device="cpu")
    want = jensemble.ensemble_predict(jcfg, [_jax_state(v) for v in variables], _val_loader(tcfg), model=jm)
    np.testing.assert_array_equal(got["targets"], np.asarray(want["targets"]))
    np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]), atol=ATOL)
    assert got["latency_per_sample"] > 0


def test_evaluate_ensemble_writes_jax_s_keys(members, tmp_path):
    _, tcfg, _, variables = members
    dirs = []
    for i, v in enumerate(variables):
        mgr = CheckpointManager(str(tmp_path / f"m{i}"))
        mgr.save(trainer.init_state(tcfg, device="cpu", variables=v), "latest")
        mgr.wait()
        dirs.append(mgr.directory)
    restored = ensemble.restore_members(tcfg, dirs, device="cpu")
    for model, v in zip(restored, variables):
        assert not model.training
        want = trainer.init_state(tcfg, device="cpu", variables=v).model.state_dict()
        for k, t in model.state_dict().items():
            torch.testing.assert_close(t, want[k], rtol=0, atol=0)
    suite = ensemble.evaluate_ensemble(tcfg, dirs, _val_loader(tcfg), str(tmp_path / "Metric.txt"), device="cpu")
    t = np.array([0, 1, 1, 0])
    keys = list(jmetrics.compute_uncertainty_metrics(t, np.eye(2)[t] * 0.8 + 0.1)) + ["latency_per_sample_s"]
    with open(tmp_path / "Metric.txt") as f:
        lines = f.read().splitlines()
    assert [line.split(":")[0] for line in lines] == keys == list(suite)
    assert all(np.isfinite(float(line.split(": ")[1])) for line in lines)


def test_ensemble_predictor_averages_member_logits(members, tmp_path):
    _, tcfg, _, variables = members
    rng = np.random.default_rng(6)
    n = 3
    f = rng.uniform(size=(n, 32, 32, 3)).astype(np.float32)
    o = rng.uniform(size=(n, 16, 16, 16, 1)).astype(np.float32)
    pred = Predictor(tcfg, variables, device="cpu", transport="f32")
    assert pred.num_members == 2
    got = pred.predict_probs(f, o)
    logits = []
    for v in variables:
        m = trainer.init_state(tcfg, device="cpu", variables=v).model.eval()
        with torch.no_grad():
            logits.append(m(torch.tensor(f), torch.tensor(o))[0])
    np.testing.assert_allclose(got, torch.softmax((logits[0] + logits[1]) / 2, -1).numpy(), atol=ATOL)
    # From the members' checkpoints (best, else latest), and one member alone.
    dirs = []
    for i, v in enumerate(variables):
        mgr = CheckpointManager(str(tmp_path / f"m{i}"))
        mgr.save(trainer.init_state(tcfg, device="cpu", variables=v), "latest")
        mgr.wait()
        dirs.append(mgr.directory)
    np.testing.assert_allclose(Predictor.from_checkpoints(tcfg, dirs, device="cpu", transport="f32")
                               .predict_probs(f, o), got, atol=0)
    one = Predictor.from_checkpoint(tcfg, dirs[0], device="cpu", transport="f32").predict_probs(f, o)
    np.testing.assert_allclose(one, torch.softmax(logits[0], -1).numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# The CLIs at the tiny config.
# ---------------------------------------------------------------------------


@pytest.fixture
def baseline_cli(monkeypatch, tmp_path):
    """The CLIs at fundus 32^2 / OCT 16^3 with the tiny config's transformer
    widths (the CNN baselines' widths are fixed), on the CPU, with
    checkpoints and logs under ``tmp_path``; returns ``run(module, *args)``."""
    real = train_cli.config_from_args

    def tiny(args):
        cfg = real(args)
        t = tconfig.tiny_test_config(batch_size=cfg.data.batch_size)
        data = dataclasses.replace(cfg.data, fundus_size=32, oct_size=(16, 16, 16), eval_batch_size=4)
        model = dataclasses.replace(t.model, model_name=cfg.model.model_name)
        return cfg.replace(data=data, model=model)

    monkeypatch.setattr(train_cli, "config_from_args", tiny)
    monkeypatch.setattr(ensemble_cli, "config_from_args", tiny)
    base = ["--dataset", "synthetic", "--batch_size", "4", "--synthetic_samples", "12", "--plot_dir", "",
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "log"), "--name", "t",
            "--device", "cpu", "--warmup_steps", "0"]

    def run(module, *args):
        return module.main(base + list(args))

    run.tmp_path = tmp_path
    return run


def test_cli_train_takes_a_baseline_and_test_samples_and_sweeps(baseline_cli, capsys):
    baseline_cli(train_cli, "--model_name", "Multi_dropout_ResNet", "--end_epochs", "1")
    out = capsys.readouterr().out
    assert out.count("Train Epoch: 1") == 1 and out.count("Val   Epoch: 1") == 1
    ckpt = baseline_cli.tmp_path / "ckpt" / "synthetic_0.5_t"
    assert (ckpt / "best").is_dir() or (ckpt / "latest").is_dir() or not os.listdir(ckpt)
    best = ckpt / "best"
    args = ["--model_name", "Multi_dropout_ResNet", "--mc_samples", "2", "--sweep", "gaussian",
            "--sweep_levels", "0.0", "0.3"] + (["--checkpoint", str(best)] if best.is_dir() else [])
    baseline_cli(test_cli, *args)
    out = capsys.readouterr().out
    mc = [line for line in out.splitlines() if line.startswith("MC-dropout (K=2): ")]
    assert len(mc) == 1 and float(mc[0].rsplit(" ", 1)[1]) > 0.0
    assert any(line.startswith("MC-dropout suite: ") for line in out.splitlines())
    with open(baseline_cli.tmp_path / "log" / "synthetic_t_test.log") as f:
        log = f.read()
    assert "Robustness sweep [gaussian]:" in log and "modality\tsigma\taccuracy\tauc\tf1" in log
    for modality in robustness.MODALITY_GRID:
        for sigma in ("0", "0.3"):
            assert f"{modality}\t{sigma}\t" in log


def test_cli_ensemble_trains_and_evaluates_members(baseline_cli, capsys):
    metric = baseline_cli.tmp_path / "Metric.txt"
    suite = baseline_cli(ensemble_cli, "--members", "2", "--end_epochs", "1", "--metric_path", str(metric))
    out = capsys.readouterr().out
    assert "[Multi_DE1_ResNet] best val acc" in out and "[Multi_DE2_ResNet] best val acc" in out
    assert "Ensemble (2 members) -> " in out
    with open(metric) as f:
        assert len(f.read().splitlines()) == len(suite) == 11
    again = baseline_cli(ensemble_cli, "--members", "2", "--skip_train", "--metric_path", str(metric))
    for key in suite:
        if key != "latency_per_sample_s":
            assert again[key] == suite[key]


def test_ensemble_member_dirs_match_jax():
    from edrl_tpu.cli.ensemble import member_checkpoint_dir as jdir
    from edrl_tpu.config import EDRLConfig as JConfig

    assert ensemble_cli.member_checkpoint_dir(tconfig.EDRLConfig(), "Multi_DE2_ResNet") == jdir(
        JConfig(), "Multi_DE2_ResNet")

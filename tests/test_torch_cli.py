"""The port's train and test CLIs on the CPU, at the tiny config.

The parser is held to the JAX package's (the same dests and defaults, plus
``--device``).  ``cli.train.main`` and ``cli.test.main`` run end to end with
the model and input sizes of ``tiny_test_config`` (``config_from_args`` is
patched; every other setting is the CLI's), and ``cli.test`` on the saved
``best`` must print the train&test run's test block, on the synthetic data
and on written GAMMA-layout trees (``dr2``, ``glu2``).  What the port has
not got refuses by ROADMAP item before any work is done; a dataset path
that is not there raises what the JAX CLI raises.
"""

import builtins
import dataclasses
import inspect
import os

import pytest
import torch

from edrl_tpu.cli import train as jcli
from edrl_tpu_torch import config as tconfig
from edrl_tpu_torch.cli import predict as predict_cli
from edrl_tpu_torch.cli import test as test_cli
from edrl_tpu_torch.cli import train as train_cli

TEST_BLOCK = ("Test: Acc", "Uncertainty suite: ", "Missing-modality [fundus-only]", "Missing-modality [oct-only]")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's CPU work here: the tiny config's ops
    are small, and the test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_parser_matches_the_jax_cli():
    ours = {a.dest: a.default for a in train_cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in jcli.build_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs


@pytest.mark.parametrize("argv", [[], ["--dataset", "synthetic_fusion", "--condition_name", "All",
                                       "--Condition_SP_Variance_low", "0.01", "--host_noise", "--no_bfloat16",
                                       "--warmup_steps", "0", "--folder", "folder3", "--num_classes", "4"]])
def test_config_from_args_matches_the_jax_cli(argv):
    ours = train_cli.config_from_args(train_cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    theirs = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.fixture
def tiny_cli(monkeypatch, tmp_path):
    """The CLIs at the tiny config's model and input sizes, on the CPU, with
    checkpoints and logs under ``tmp_path``; returns ``run(module, *args)``."""
    real = train_cli.config_from_args

    def tiny(args):
        cfg = real(args)
        t = tconfig.tiny_test_config(batch_size=cfg.data.batch_size)
        data = dataclasses.replace(cfg.data, fundus_size=t.data.fundus_size, oct_size=t.data.oct_size)
        model = dataclasses.replace(t.model, use_bfloat16=cfg.model.use_bfloat16)
        return cfg.replace(data=data, model=model)

    monkeypatch.setattr(train_cli, "config_from_args", tiny)
    base = ["--dataset", "synthetic", "--batch_size", "4", "--synthetic_samples", "12", "--plot_dir", "",
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--log_dir", str(tmp_path / "log"), "--name", "t",
            "--device", "cpu"]

    def run(module, *args):
        module.main(base + list(args))
        phase = "train" if module is train_cli else "test"
        with open(tmp_path / "log" / f"synthetic_t_{phase}.log") as f:
            return f.read()

    run.tmp_path = tmp_path
    run.base = base
    return run


def _test_block(log):
    lines = [line.split("===> ", 1)[1] for line in log.splitlines() if any(k in line for k in TEST_BLOCK)]
    assert len(lines) == 4, lines
    return lines


def test_train_then_test_cli_agree(tiny_cli, capsys):
    train_log = tiny_cli(train_cli, "--end_epochs", "2")
    out = capsys.readouterr().out
    assert out.count("Train Epoch:") == 2 and out.count("Val   Epoch:") == 2
    ckpt = tiny_cli.tmp_path / "ckpt" / "synthetic_0.5_t"
    assert (ckpt / "best").is_dir() and (ckpt / "best.json").is_file()
    with open(tiny_cli.tmp_path / "log" / "synthetic_0.5_t.csv") as f:
        assert len(f.read().splitlines()) == 3
    test_log = tiny_cli(test_cli, "--checkpoint", str(ckpt / "best"))
    assert _test_block(test_log) == _test_block(train_log)
    suite = _test_block(train_log)[1]
    assert suite.count(":") == 11  # the label's and the ten metrics'


def test_resume_and_host_noise_through_the_cli(tiny_cli, capsys):
    tiny_cli(train_cli, "--end_epochs", "1", "--save_latest_every", "1", "--host_noise", "--mode", "train")
    log = tiny_cli(train_cli, "--end_epochs", "2", "--save_latest_every", "1", "--host_noise", "--resume",
                   "--mode", "train")
    assert "Resuming from latest (completed epoch 1" in log
    out = capsys.readouterr().out
    assert out.count("Train Epoch: 1") == 1 and out.count("Train Epoch: 2") == 1
    with open(tiny_cli.tmp_path / "log" / "synthetic_0.5_t.csv") as f:
        assert [line.split(",")[0] for line in f.read().splitlines()] == ["Epoch", "1", "2"]


def test_test_epoch_and_missing_checkpoint(tiny_cli):
    log = tiny_cli(train_cli, "--end_epochs", "2", "--save_every", "2", "--test_epoch", "2")
    assert "Evaluating checkpoint epoch_2" in log
    log = tiny_cli(test_cli)
    assert len(_test_block(log)) == 4
    log = tiny_cli(train_cli, "--mode", "test", "--checkpoint_dir", str(tiny_cli.tmp_path / "none"))
    assert "no checkpoint found" in log


@pytest.mark.parametrize("argv,error,match", [
    (["--dataset", "dr2", "--data_path", "/nonexistent"], FileNotFoundError,
     "No such file or directory: '/nonexistent'"),
    (["--dataset", "glu2"], FileNotFoundError, "No such file or directory: ''"),
    (["--scan_batches", "4"], NotImplementedError, "A14"),
    (["--num_model_shards", "2", "--model_name", "Multi_ResNet"], NotImplementedError, "A11"),
    (["--model_name", "NoSuchModel"], NameError, "There is no model named 'NoSuchModel'"),
])
def test_train_cli_refusals_name_their_items(tmp_path, argv, error, match):
    args = ["--plot_dir", "", "--device", "cpu", "--checkpoint_dir", str(tmp_path / "c"), "--log_dir",
            str(tmp_path / "l")]
    with pytest.raises(error, match=match):
        train_cli.main(argv + args)
    if "--dataset" in argv:
        # The JAX CLI raises the same where it builds its loaders.
        with pytest.raises(error, match=match):
            jcli.make_loaders(jcli.config_from_args(jcli.build_parser().parse_args(argv)))


def test_zero1_on_one_rank_is_the_plain_step(tiny_cli):
    """``--zero1`` with no launcher: one rank, so JAX's unsharded step (its
    ``train_state_shardings`` runs only on a mesh of more than one device):
    the same test block as the run without it."""
    plain = tiny_cli(train_cli, "--end_epochs", "1")
    both = tiny_cli(train_cli, "--end_epochs", "1", "--zero1", "--checkpoint_dir", str(tiny_cli.tmp_path / "z"))
    assert _test_block(both[len(plain):]) == _test_block(plain)


def _gamma_tree(root, n=10):
    """A GAMMA-layout tree at the tiny config's sizes (fundus 70 x 90 resized
    to 64, OCT stored (36, 34, 40) zoomed to 32^3): ids 1..n, the even ones
    zero-padded on disk; xlsx and csv labels in id order."""
    import numpy as np

    from edrl_tpu_torch.data.nifti import write_nifti
    from edrl_tpu_torch.data.png import write_png
    from edrl_tpu_torch.data.xlsx import write_xlsx

    rng = np.random.default_rng(3)
    rows = []
    for i in range(1, n + 1):
        sid = str(i).zfill(5) if i % 2 == 0 else str(i)
        (root / sid).mkdir(parents=True)
        write_png(str(root / sid / f"data_{sid}_fundus.png"), rng.integers(0, 256, (70, 90, 3), dtype=np.uint8))
        write_nifti(str(root / sid / f"data_{sid}.nii"), rng.integers(0, 256, (36, 34, 40)).astype(np.float32))
        rows.append([str(i).zfill(5), i % 2, 1 - i % 2])
    write_xlsx(str(root.parent / "labels.xlsx"), ["data", "class_0", "class_1"], rows)
    (root.parent / "labels.csv").write_text("data,class_0,class_1\n" + "".join(f"{a},{b},{c}\n" for a, b, c in rows))


@pytest.mark.parametrize("dataset,labels", [("dr2", "labels.xlsx"), ("glu2", "labels.csv")])
def test_real_data_through_the_clis(tiny_cli, monkeypatch, capsys, dataset, labels):
    """``--dataset dr2`` (shuffled 5-fold) and ``glu2`` (80/20 in label-file
    order) through ``cli.train`` and ``cli.test --sweep``: the train and val
    ids are the JAX CLI's, ``cli.test`` prints the train run's test block and
    the sweep reads ``GammaDataset``."""
    from edrl_tpu_torch.data import GammaDataset
    from edrl_tpu_torch.train import robustness

    tmp = tiny_cli.tmp_path
    _gamma_tree(tmp / "data")
    argv = [*tiny_cli.base, "--dataset", dataset, "--data_path", str(tmp / "data"), "--label_file",
            str(tmp / labels)]
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(argv))
    jargv = argv[: argv.index("--device")] + argv[argv.index("--device") + 2:]
    jcfg = jcli.config_from_args(jcli.build_parser().parse_args(jargv))
    for ours, theirs in zip(train_cli.make_loaders(cfg), jcli.make_loaders(jcfg)):
        assert [s[0] for s in ours.dataset.samples] == [s[0] for s in theirs.dataset.samples]
    assert [len(loader.dataset) for loader in train_cli.make_loaders(cfg)] == [8, 2]

    seen = []
    real = robustness._dataset_for

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(robustness, "_dataset_for", spy)
    train_cli.main(argv + ["--end_epochs", "2"])
    ckpt = tmp / "ckpt" / f"{dataset}_0.5_t" / "best"
    test_cli.main(argv + ["--checkpoint", str(ckpt), "--sweep", "gaussian", "--sweep_levels", "0.0", "0.2"])
    logs = {phase: (tmp / "log" / f"{dataset}_t_{phase}.log").read_text() for phase in ("train", "test")}
    assert _test_block(logs["test"]) == _test_block(logs["train"])
    # A fresh tree: the train run names the uncached samples and the tool
    # that fills their caches ahead; the caches then serve cli.test.
    assert logs["train"].count("10 of 10 samples have no decoded cache yet") == 1
    assert "tools.build_cache" in logs["train"] and "no decoded cache" not in logs["test"]
    assert capsys.readouterr().out.count("Train Epoch:") == 2
    assert "Robustness sweep [gaussian]:" in logs["test"]
    assert len(seen) == 2 and all(type(ds) is GammaDataset and len(ds) == 10 for ds in seen)


def test_conv_precision_is_settled_where_the_entry_points_start(monkeypatch, tmp_path):
    """The CLIs and ``Predictor`` settle f32 convolutions to full f32 as they
    start; resolving a device, building a state or a batch leaves the setting
    alone, so a caller's ``set_conv_precision(True)`` holds."""
    from edrl_tpu_torch.config import tiny_test_config
    from edrl_tpu_torch.serve.predictor import Predictor
    from edrl_tpu_torch.train import trainer

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = tiny_test_config(batch_size=2)
    trainer.resolve_device("cpu")
    trainer.init_state(cfg, device="cpu")
    trainer.random_views(cfg, device="cpu")
    assert torch.backends.cudnn.allow_tf32
    with pytest.raises(NameError):
        train_cli.main(["--model_name", "NoSuchModel", "--plot_dir", "", "--device", "cpu",
                        "--checkpoint_dir", str(tmp_path / "c"), "--log_dir", str(tmp_path / "l")])
    assert not torch.backends.cudnn.allow_tf32
    trainer.set_conv_precision(True)
    assert torch.backends.cudnn.allow_tf32
    Predictor(cfg, device="cpu")
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("argv", [["--sweep", "gaussian", "--sweep_levels", "0.0", "0.2"], ["--mc_samples", "2"]])
def test_test_cli_runs_the_sweep_and_mc_dropout(tiny_cli, capsys, argv):
    """MedFusion takes no ``mc``: its passes are equal (std 0); the sweep logs
    its grid."""
    log = tiny_cli(test_cli, *argv)
    assert len(_test_block(log)) == 4
    out = capsys.readouterr().out
    if "--mc_samples" in argv:
        mc = [line for line in out.splitlines() if line.startswith("MC-dropout (K=2): ")]
        assert len(mc) == 1 and mc[0].endswith("mean predictive std 0.0000")
    else:
        assert "Robustness sweep [gaussian]:" in log
        assert sum(f"\t{s}\t" in log for s in ("0", "0.2")) == 2


def test_plots_need_matplotlib_before_training(monkeypatch, tmp_path):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        train_cli.main(["--device", "cpu", "--plot_dir", str(tmp_path / "plots"), "--log_dir", str(tmp_path / "l"),
                        "--checkpoint_dir", str(tmp_path / "c")])
    assert not os.path.exists(tmp_path / "l") and not os.path.exists(tmp_path / "c")


def test_cli_runs_on_the_card_by_default(tmp_path):
    from edrl_tpu_torch.train import trainer

    assert train_cli.build_parser().parse_args([]).device == "cuda"
    for fn in (trainer.fit, trainer.resume_from_latest):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--plot_dir", "", "--log_dir", str(tmp_path / "l"), "--checkpoint_dir", str(tmp_path / "c")])
    assert not os.path.exists(tmp_path / "l")


@pytest.mark.parametrize("source", ["synthetic", "npz"])
def test_predict_cli_agrees_with_the_predictor(tiny_cli, capsys, source):
    """``cli.predict`` at the tiny config, int8 calibrated on the first 4 pairs,
    in chunks of 2 batches: one CSV row per pair, the probabilities of the
    ``Predictor`` built as the CLI builds it (the CSV's 6 decimals)."""
    import numpy as np

    from edrl_tpu_torch.serve.predictor import Predictor

    tmp = tiny_cli.tmp_path
    args = [*tiny_cli.base, "--int8", "--int8_calibrate", "4", "--chunk_batches", "2", "--output", str(tmp / "p.csv")]
    cfg = train_cli.config_from_args(predict_cli.build_parser().parse_args(args))
    d = cfg.data
    if source == "npz":
        rng = np.random.default_rng(7)
        fundus = rng.random((5, d.fundus_size, d.fundus_size, 3), dtype=np.float32)
        oct_vol = rng.random((5, *d.oct_size, 1), dtype=np.float32)
        np.savez(tmp / "pairs.npz", fundus=fundus, oct=oct_vol)
        args += ["--input", str(tmp / "pairs.npz"), "--transport", "f32"]
    else:
        rng = np.random.default_rng(cfg.train.seed)
        fundus = (rng.uniform(size=(6, d.fundus_size, d.fundus_size, 3)) * 255).astype(np.uint8)
        oct_vol = (rng.uniform(size=(6, *d.oct_size, 1)) * 255).astype(np.uint8)
        args += ["--num", "6"]
    predict_cli.main(args)
    out = capsys.readouterr().out
    assert "no --checkpoint: serving randomly initialized weights" in out and "static activation scales" in out
    got = np.loadtxt(tmp / "p.csv", delimiter=",")
    want = Predictor(cfg, seed=cfg.train.seed, device="cpu", quantize_int8=True,
                     int8_calibration=(fundus[:4], oct_vol[:4]), chunk_batches=2,
                     transport="f32" if source == "npz" else "uint8").predict_probs(fundus, oct_vol)
    assert got.shape == (len(fundus), cfg.model.num_classes)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_predict_cli_calibrate_without_int8_errors(tiny_cli, capsys):
    with pytest.raises(SystemExit):
        predict_cli.main([*tiny_cli.base, "--num", "4", "--int8_calibrate", "2"])
    assert "--int8_calibrate requires --int8" in capsys.readouterr().err

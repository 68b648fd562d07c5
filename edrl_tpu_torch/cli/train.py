"""The training CLI (``edrl_tpu/cli/train.py``): the reference's
``fusion_train.py`` flags, the same defaults, plus ``--device`` (the card
unless the caller asks for the CPU).

    python -m edrl_tpu_torch.cli.train --dataset synthetic --batch_size 16 \\
        --end_epochs 2 --synthetic_samples 48 --checkpoint_dir ckpt --log_dir log

``--model_name`` takes every name of the baseline zoo's registry
(``baselines.MODEL_REGISTRY``; MedFusion by default); an unknown one raises
``NameError``.  ``--dataset`` takes the synthetic datasets and the
GAMMA-layout trees (``dr2``, ``glu2``: ``--data_path``, ``--label_file``;
preflight them with ``python -m edrl_tpu_torch.tools.verify_dataset``).
``--scan_batches K`` is accepted and changes nothing: ``trainer.fit`` steps
batch by batch, the run of ``--scan_batches 0`` bit for bit; it captures
nothing.  With ``--plot_dir`` set (its default), matplotlib must
import: the run checks that before it trains.

Data parallelism: started by ``torchrun`` with more than one process
(``WORLD_SIZE`` > 1, the JAX CLI's "more than one device"), the CLI joins
the process group (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``), builds the data mesh and trains and evaluates across the ranks;
``--batch_size`` is the global batch.  Rank 0 alone prints and writes.
``--zero1`` shards Adam's moments over the ranks (on one rank it is the
plain step, as in the JAX package).  ``--num_model_shards M`` splits the
world into ``(WORLD_SIZE // M, M)``: M ranks a data row shard the model's
kernels that the TP rules name over the model axis (``parallel.tensor``;
any ``--model_name``: a CNN model has none and stays whole on every rank),
and ``--zero1`` then shards each model rank's moments over its data group;
``WORLD_SIZE`` must be a multiple of M.

    python -m torch.distributed.run --nproc_per_node 4 -m edrl_tpu_torch.cli.train \
        --dataset synthetic --batch_size 32 --end_epochs 2 --plot_dir "" --num_model_shards 2
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from edrl_tpu_torch.config import DataConfig, EDRLConfig, ModelConfig, NoiseConfig, TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # Reference flags (``fusion_train.py:510-542``).
    p.add_argument("--modal_number", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--start_epoch", type=int, default=1)
    p.add_argument("--end_epochs", type=int, default=200)
    # 0 = off: only an explicit flag diverts the test phase to an epoch's checkpoint.
    p.add_argument("--test_epoch", type=int, default=0)
    p.add_argument("--lambda_epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument(
        "--warmup_steps", type=int, default=100,
        help="linear LR warmup over N optimizer steps (0 = constant lr)",
    )
    p.add_argument(
        "--grad_clip_norm", type=float, default=0.0,
        help="global-norm gradient clipping (0 = off)",
    )
    p.add_argument("--model_name", default="MedFusion")
    p.add_argument("--dataset", default="synthetic", help="synthetic/dr2/glu2")
    p.add_argument("--folder", default="folder0")
    p.add_argument("--mode", default="train&test", help="train/test/train&test")
    p.add_argument("--model_base", default="transformer")
    p.add_argument("--condition", default="noise", help="noise/normal")
    p.add_argument("--condition_name", default="Gaussian")
    p.add_argument("--Condition_SP_Variance", type=float, default=0.005)
    p.add_argument("--Condition_G_Variance", type=float, default=0.5)
    p.add_argument("--name", default="checkpoint_0.3")
    p.add_argument("--Condition_G_Variance_low", type=float, default=0.0)
    p.add_argument("--Condition_SP_Variance_low", type=float, default=0.0)
    p.add_argument("--data_path", default="")
    p.add_argument("--label_file", default="")
    p.add_argument("--checkpoint_dir", default="checkpoint")
    p.add_argument("--log_dir", default="log")
    # End-of-run loss/acc curves (``fusion_train.py:771-772``); "" disables.
    p.add_argument("--plot_dir", default="results/plot")
    p.add_argument(
        "--student_t_every", type=int, default=0,
        help="dump EPRL proxy Student-t PDF grids to --plot_dir every N epochs (0 = off)",
    )
    p.add_argument(
        "--save_every", type=int, default=0,
        help="keep an epoch_{N} checkpoint every N epochs so --test_epoch can "
        "evaluate that epoch (0 = best-only)",
    )
    p.add_argument(
        "--save_latest_every", type=int, default=0,
        help="rolling 'latest' checkpoint every N epochs for preemption resume "
        "(written in the background; 0 = off)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="restore the 'latest' checkpoint (if present) and continue from "
        "the epoch derived from its step counter",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_model_shards", type=int, default=1)
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: Adam's moments sharded over the data ranks (under torchrun)")
    p.add_argument("--scan_batches", type=int, default=0)
    p.add_argument("--no_bfloat16", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument(
        "--host_noise", action="store_true",
        help="build noise views on the host (reference parity) instead of on the device",
    )
    p.add_argument("--synthetic_samples", type=int, default=128)
    p.add_argument(
        "--num_classes", type=int, default=2,
        help="grading classes; the label schema carries 4 one-hot columns",
    )
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda, or cpu)")
    return p


def config_from_args(args) -> EDRLConfig:
    noise = NoiseConfig(
        condition=args.condition,
        condition_name=args.condition_name,
        gaussian_low=args.Condition_G_Variance_low,
        gaussian_high=args.Condition_G_Variance,
        salt_pepper_low=args.Condition_SP_Variance_low,
        salt_pepper_high=args.Condition_SP_Variance,
    )
    data = DataConfig(
        dataset=args.dataset,
        data_path=args.data_path,
        label_file=args.label_file,
        batch_size=args.batch_size,
        fold=int(args.folder[-1]) if args.folder[-1].isdigit() else 0,
        noise=noise,
        num_classes=args.num_classes,
        num_synthetic_samples=args.synthetic_samples,
        device_noise=not args.host_noise,
    )
    model = ModelConfig(
        model_name=args.model_name,
        num_classes=args.num_classes,
        use_bfloat16=not args.no_bfloat16,
        remat=args.remat,
    )
    train = TrainConfig(
        mode=args.mode,
        lr=args.lr,
        warmup_steps=args.warmup_steps,
        grad_clip_norm=args.grad_clip_norm,
        start_epoch=args.start_epoch,
        end_epochs=args.end_epochs,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        log_dir=args.log_dir,
        plot_dir=args.plot_dir,
        student_t_every=args.student_t_every,
        save_every=args.save_every,
        save_latest_every=args.save_latest_every,
        resume=args.resume,
        name=args.name,
        num_model_shards=args.num_model_shards,
        zero1=args.zero1,
        scan_batches=args.scan_batches,
    )
    return EDRLConfig(data=data, model=model, train=train)


def make_loaders(cfg: EDRLConfig, mesh=None):
    """The train loader (shuffled, drop_last) and the val loader (in order,
    the remainder kept) of the configured dataset: a synthetic one, or a
    GAMMA-layout tree (``glu2``: the sequential 80/20 split in label-file
    order, ``fusion_train.py:619-631``; ``dr2`` and the others: the shuffled
    5-fold split of the sorted directory, ``fusion_train.py:564``).  With
    ``mesh``, this rank's rows of every batch."""
    from edrl_tpu_torch.data import SYNTHETIC_DATASETS, BatchLoader, GammaDataset, kfold_split
    from edrl_tpu_torch.data.gamma import csv_ids
    from edrl_tpu_torch.data.xlsx import read_xlsx_dict

    if cfg.data.dataset in SYNTHETIC_DATASETS:
        ds_cls = SYNTHETIC_DATASETS[cfg.data.dataset]
        train_ds = ds_cls(cfg.data, mode="train")
        val_ds = ds_cls(cfg.data, mode="val")
    elif cfg.data.dataset == "glu2":
        if cfg.data.label_file.endswith(".csv"):
            raw_ids = csv_ids(cfg.data.label_file)
        else:
            raw_ids = [str(x) for x in read_xlsx_dict(cfg.data.label_file)["data"]]
        ids = [str(x).split(".")[0].zfill(5) for x in raw_ids]
        n_train = int(len(ids) * 0.8)
        train_ds = GammaDataset(cfg.data, mode="train", filelists=ids[:n_train])
        val_ds = GammaDataset(cfg.data, mode="val", filelists=ids[n_train:])
    else:
        filelists = sorted(os.listdir(cfg.data.data_path))
        folds = kfold_split(filelists, cfg.data.folds, cfg.data.split_seed)
        train_files, val_files = folds[cfg.data.fold]
        train_ds = GammaDataset(cfg.data, mode="train", filelists=list(train_files))
        val_ds = GammaDataset(cfg.data, mode="val", filelists=list(val_files))
    u8 = cfg.data.device_noise and cfg.data.uint8_transport
    ranks = {} if mesh is None else {"rank": mesh.get_local_rank("data"), "world": mesh.size(0)}
    train_loader = BatchLoader(
        train_ds, cfg.data.batch_size, shuffle=True, drop_last=True, seed=cfg.train.seed, uint8_transport=u8,
        **ranks)
    # Eval keeps the remainder batch: every sample is scored.  Its batch is
    # cut to the set's size (a multiple of the ranks: a padded remainder).
    eval_batch = min(cfg.data.eval_batch_size, max(len(val_ds), 1))
    world = ranks.get("world", 1)
    val_loader = BatchLoader(
        val_ds, -(-eval_batch // world) * world, shuffle=False, drop_last=False, uint8_transport=u8, **ranks)
    return train_loader, val_loader


def uncached_hint(cfg: EDRLConfig, *loaders) -> Optional[str]:
    """A line for a run whose GAMMA samples are not all decoded to their
    caches yet: the loader's threads decode a miss about one at a time (the
    decode holds the interpreter's lock), so a fresh tree's first epoch is
    slow, and ``tools.build_cache`` fills the caches ahead in processes."""
    from edrl_tpu_torch.data import GammaDataset

    sets = [loader.dataset for loader in loaders if isinstance(loader.dataset, GammaDataset) and loader.dataset.cache]
    missing = sum(not os.path.exists(ds.cache_path(sid)) for ds in sets for sid, _ in ds.samples)
    if not missing:
        return None
    return (f"{missing} of {sum(len(ds) for ds in sets)} samples have no decoded cache yet; the first epoch "
            "decodes them in the loader's threads, about one at a time. To fill the caches ahead in N processes: "
            f"python -m edrl_tpu_torch.tools.build_cache --data_path {cfg.data.data_path} --label_file "
            f"{cfg.data.label_file} --fundus_size {cfg.data.fundus_size} --oct_size {cfg.data.oct_size[0]} "
            "--workers N")


def check_plotting(cfg: EDRLConfig) -> None:
    """With ``plot_dir`` set, the plots' libraries must import: fail now,
    not after training."""
    if not cfg.train.plot_dir:
        return
    needed = ["matplotlib"] + (["scipy"] if cfg.train.student_t_every > 0 else [])
    for name in needed:
        try:
            __import__(name)
        except ImportError as exc:
            raise RuntimeError(
                f"--plot_dir {cfg.train.plot_dir!r} needs {name}, which does not import here "
                f"({exc}); install it or pass --plot_dir ''"
            ) from exc


def setup_cli_logging(cfg, args, phase: str):
    """File and console logging of the run (the reference's ``log_args``,
    ``fusion_train.py:44-63``): returns ``emit``, ``logger.info`` when
    ``--log_dir`` is set, else ``print``."""
    if not cfg.train.log_dir:
        return print
    from edrl_tpu_torch.train.logging import setup_logging

    logger = setup_logging(os.path.join(cfg.train.log_dir, f"{cfg.data.dataset}_{cfg.train.name}_{phase}.log"))
    logger.info("args: %s", vars(args))
    return logger.info


def report_eval(emit, cfg, state, eval_step, val_loader, mesh=None):
    """The test-phase report of both CLIs: the overall metrics, the 10-metric
    uncertainty suite and the missing-modality sweep."""
    from edrl_tpu_torch.train.metrics import compute_uncertainty_metrics
    from edrl_tpu_torch.train.trainer import run_eval

    m, targets, probs = run_eval(state, eval_step, val_loader, mesh=mesh)
    emit(
        f"Test: Acc {m.accuracy:.4f} AUC {m.auc:.4f} F1 {m.f1:.4f} "
        f"Precision {m.precision:.4f} Recall {m.recall:.4f} "
        f"Specificity {m.specificity:.4f}"
    )
    suite = compute_uncertainty_metrics(targets, probs)
    emit(f"Uncertainty suite: {({k: round(v, 4) for k, v in suite.items()})}")
    for mask, label in ((np.array([True, False]), "fundus-only"), (np.array([False, True]), "oct-only")):
        mm, _, _ = run_eval(state, eval_step, val_loader, modality_mask=mask, mesh=mesh)
        emit(f"Missing-modality [{label}]: Acc {mm.accuracy:.4f} AUC {mm.auc:.4f}")


def data_parallel(cfg: EDRLConfig, args):
    """``(device, mesh, emit, leave)``: under a launcher with ``WORLD_SIZE`` >
    1, this rank's device, the ``(data, model)`` mesh over the ranks (a model
    axis of ``cfg.train.num_model_shards``), off rank (0, 0) an ``emit``
    that says nothing, and ``leave``, which leaves the process group if this
    call joined it (a caller that joined it first keeps it); else the
    device, no mesh, ``None`` and a ``leave`` that does nothing.  A model
    axis above 1 needs a launcher: with none it raises ``ValueError``."""
    import torch.distributed as dist

    shards = cfg.train.num_model_shards
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        from edrl_tpu_torch.train.trainer import resolve_device

        if shards > 1:
            raise ValueError(f"--num_model_shards {shards} needs a multiple of {shards} ranks: start them with "
                             "torchrun")
        return resolve_device(args.device), None, None, lambda: None
    from edrl_tpu_torch.parallel import init_distributed, is_writer, make_mesh

    joined = not dist.is_initialized()
    device = init_distributed(args.device)
    mesh = make_mesh(shards, device=device.type)
    return (device, mesh, None if is_writer(mesh) else (lambda *a, **k: None),
            dist.destroy_process_group if joined else (lambda: None))


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    from edrl_tpu_torch.train.checkpoint import CheckpointManager
    from edrl_tpu_torch.train.trainer import (
        check_ported,
        fit,
        init_state,
        make_eval_step,
        resume_from_latest,
        set_conv_precision,
    )

    set_conv_precision()
    check_ported(cfg)
    device, mesh, quiet, leave = data_parallel(cfg, args)
    check_plotting(cfg)
    emit = quiet or setup_cli_logging(cfg, args, "train")
    train_loader, val_loader = make_loaders(cfg, mesh)
    hint = uncached_hint(cfg, train_loader, val_loader)
    if hint and cfg.train.mode in ("train", "train&test"):
        emit(hint)
    ckpt_dir = os.path.join(cfg.train.checkpoint_dir,
                            f"{cfg.data.dataset}_{cfg.data.noise.gaussian_high}_{cfg.train.name}")
    mgr = CheckpointManager(ckpt_dir, mesh=mesh)

    if cfg.train.mode in ("train", "train&test"):
        state, initial_best, initial_best_epoch = None, 0.0, -1
        if cfg.train.resume:
            resumed = resume_from_latest(cfg, mgr, train_loader, device=device, mesh=mesh)
            if resumed is not None:
                state, cfg, initial_best, done = resumed
                binfo = mgr.best_info()
                if binfo is not None:
                    initial_best_epoch = int(binfo["epoch"])
                emit(f"Resuming from latest (completed epoch {done}, best {initial_best:.4f})")
        state, result = fit(cfg, train_loader, val_loader, state=state, mesh=mesh, checkpoint_manager=mgr,
                            initial_best=initial_best, initial_best_epoch=initial_best_epoch, device=device)
        emit(f"Best val accuracy {result.best_acc:.4f} at epoch {result.best_epoch}")
        del state
    if cfg.train.mode in ("test", "train&test"):
        state = init_state(cfg, cfg.train.seed, device=device, mesh=mesh)
        # ``--test_epoch`` (``fusion_train.py:517``): that epoch's checkpoint
        # when one was kept (--save_every), else best, else the rolling latest;
        # and say so loudly when nothing can be restored.
        epoch_name = f"epoch_{args.test_epoch}"
        if args.test_epoch and os.path.isdir(os.path.join(ckpt_dir, epoch_name)):
            state = mgr.restore(state, epoch_name)
            emit(f"Evaluating checkpoint {epoch_name}")
        elif mgr.best_info() is not None:
            if args.test_epoch:
                emit(f"--test_epoch {args.test_epoch}: no {epoch_name} checkpoint kept (see --save_every); "
                     "evaluating best")
            state = mgr.restore(state, "best")
        elif mgr.latest_info() is not None:
            emit("No 'best' checkpoint; evaluating the rolling 'latest'")
            state = mgr.restore(state, "latest")
        else:
            emit(f"WARNING: no checkpoint found under {ckpt_dir}; evaluating RANDOMLY INITIALIZED weights — "
                 "metrics below are not a trained model's")
        report_eval(emit, cfg, state, make_eval_step(cfg), val_loader, mesh)
    leave()


if __name__ == "__main__":
    main()

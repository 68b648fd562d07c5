"""The deep-ensemble CLI (``edrl_tpu/cli/ensemble.py``; the reference's
``test_ensemble`` path, ``fusion_train.py:392-502``): train the
``Multi_DE{1..5}_ResNet`` members (one late-fusion architecture, each at its
learning rate from the registry), checkpoint each, then evaluate the
logit-averaged ensemble with the 10-metric uncertainty suite and write
``Metric.txt``.

    python -m edrl_tpu_torch.cli.ensemble --dataset synthetic --batch_size 8 \\
        --end_epochs 2 --synthetic_samples 32 --plot_dir ""

``--members`` takes the first N members; ``--skip_train`` evaluates existing
member checkpoints only.  A member's checkpoint (f32 parameters and Adam's
two moments of ~60 M parameters) is ~0.7 GB, and each member keeps ``best``
and ``latest``.
"""

from __future__ import annotations

import dataclasses
import os

from edrl_tpu_torch.cli.train import build_parser, check_plotting, config_from_args, make_loaders


def member_checkpoint_dir(cfg, member: str) -> str:
    return os.path.join(cfg.train.checkpoint_dir,
                        f"{cfg.data.dataset}_{cfg.data.noise.gaussian_high}_{cfg.train.name}_{member}")


def run_ensemble(cfg, members, skip_train: bool = False, metric_path: str = "Metric.txt", *, device="cuda"):
    """Train each member (unless ``skip_train``), then evaluate the ensemble.
    Returns the metric suite."""
    from edrl_tpu_torch.train.checkpoint import CheckpointManager
    from edrl_tpu_torch.train.ensemble import evaluate_ensemble
    from edrl_tpu_torch.train.trainer import fit, resolve_device

    device = resolve_device(device)
    train_loader, val_loader = make_loaders(cfg)
    dirs = []
    for member in members:
        mcfg = cfg.replace(model=dataclasses.replace(cfg.model, model_name=member))
        ckpt_dir = member_checkpoint_dir(mcfg, member)
        dirs.append(ckpt_dir)
        if skip_train:
            continue
        mgr = CheckpointManager(ckpt_dir)
        state, result = fit(mcfg, train_loader, val_loader, checkpoint_manager=mgr, verbose=True, device=device)
        # A restorable checkpoint even if no epoch beat accuracy 0.
        mgr.save(state, name="latest")
        mgr.wait()
        del state
        print(f"[{member}] best val acc {result.best_acc:.4f} at epoch {result.best_epoch}")

    # The members share one architecture: any member's config restores them all.
    ecfg = cfg.replace(model=dataclasses.replace(cfg.model, model_name=members[0]))
    suite = evaluate_ensemble(ecfg, dirs, val_loader, output_path=metric_path, device=device)
    print(f"Ensemble ({len(members)} members) -> {metric_path}")
    for k, v in suite.items():
        print(f"  {k}: {v:.6f}")
    return suite


def main(argv=None):
    parser = build_parser()
    parser.add_argument("--members", type=int, default=5, help="number of Multi_DE members to train/evaluate (1-5)")
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--metric_path", default="Metric.txt")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    from edrl_tpu_torch.baselines.registry import ENSEMBLE_LRS
    from edrl_tpu_torch.train.trainer import resolve_device, set_conv_precision

    set_conv_precision()
    device = resolve_device(args.device)
    if not args.skip_train:
        check_plotting(cfg)
    members = list(ENSEMBLE_LRS)[: max(1, min(args.members, len(ENSEMBLE_LRS)))]
    return run_ensemble(cfg, members, skip_train=args.skip_train, metric_path=args.metric_path, device=device)


if __name__ == "__main__":
    main()

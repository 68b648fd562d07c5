"""The evaluation CLI (``edrl_tpu/cli/test.py``, the reference's
``fusion_test.py``): the training CLI's flags plus ``--checkpoint``; it
evaluates only.

    python -m edrl_tpu_torch.cli.test --dataset synthetic --checkpoint ckpt_dir/best

``--mc_samples N`` first runs MC-dropout over N forwards (the models that
take ``mc``: ``Multi_dropout_ResNet`` and the dropout feature extractors;
any other gives a predictive std of 0).  ``--sweep`` then runs the noise x
modality robustness grid (``train.robustness``).  Under ``torchrun`` with
more than one process the evaluation and the sweep run across the ranks,
as ``cli.train``'s do (rank 0 prints; MC-dropout runs on rank 0 over the
whole set, and over a model axis above 1 on every rank, whose sharded
forwards it takes part in, each rank's dropout draws seeded alike).  Any
registry model's checkpoint loads on any mesh: checkpoints hold full
shapes.
"""

from __future__ import annotations

import os

from edrl_tpu_torch.cli import train as train_cli


def resolve_sweep_levels(sweep, kind, sweep_levels, sp_sweep_levels, default_sigmas, default_sp):
    """The corruption grid of one kind for ``--sweep``.

    ``--sweep_levels`` sets the gaussian grid; under ``--sweep all`` it does
    not reach the salt-pepper kind (sigmas read as corrupted-pixel fractions
    would be ten times the protocol's grid), which ``--sp_sweep_levels``
    sets.  A bare ``--sweep salt_pepper --sweep_levels ...`` takes
    ``--sweep_levels``.
    """
    if kind == "gaussian":
        return tuple(sweep_levels or default_sigmas)
    explicit = sp_sweep_levels if sweep == "all" else (sp_sweep_levels or sweep_levels)
    return tuple(explicit or default_sp)


def build_parser():
    parser = train_cli.build_parser()
    parser.add_argument("--checkpoint", default="")
    parser.add_argument(
        "--sweep", choices=["gaussian", "salt_pepper", "all"], default="",
        help="run the noise x modality robustness grid after eval (the reference's "
        "Condition_G/SP_Variance axes)",
    )
    parser.add_argument("--sweep_levels", type=float, nargs="+", default=None,
                        help="corruption levels for --sweep (the gaussian grid with --sweep all)")
    parser.add_argument("--sp_sweep_levels", type=float, nargs="+", default=None,
                        help="salt-pepper corrupted-pixel fractions for --sweep salt_pepper/all")
    parser.add_argument("--mc_samples", type=int, default=0,
                        help="N > 0: MC-dropout, N stochastic forwards averaged, with the predictive std")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = train_cli.config_from_args(args)

    from edrl_tpu_torch.train.checkpoint import CheckpointManager
    from edrl_tpu_torch.train.metrics import compute_epoch_metrics, compute_uncertainty_metrics
    from edrl_tpu_torch.train.trainer import init_state, make_eval_step, set_conv_precision

    set_conv_precision()
    device, mesh, quiet, leave = train_cli.data_parallel(cfg, args)
    emit = quiet or train_cli.setup_cli_logging(cfg, args, "test")
    _, val_loader = train_cli.make_loaders(cfg, mesh)
    state = init_state(cfg, cfg.train.seed, device=device, mesh=mesh)
    if args.checkpoint:
        directory, name = os.path.split(args.checkpoint.rstrip("/"))
        state = CheckpointManager(directory or ".", mesh=mesh).restore(state, name)

    # MC-dropout over the whole set on rank (0, 0); under a model axis above
    # 1 on every rank, whose sharded forwards it takes part in.
    sharded = mesh is not None and mesh.size(1) > 1
    if args.mc_samples > 0 and (quiet is None or sharded):
        from edrl_tpu_torch.train.mc_dropout import mc_dropout_predict

        mc_loader = val_loader if mesh is None else train_cli.make_loaders(cfg)[1]
        pred = mc_dropout_predict(cfg, state, mc_loader, num_samples=args.mc_samples, seed=cfg.train.seed,
                                  device=device)
        if quiet is None:
            em = compute_epoch_metrics(pred["targets"], pred["probs"], 0.0)
            print(f"MC-dropout (K={args.mc_samples}): Acc {em.accuracy:.4f} AUC {em.auc:.4f} F1 {em.f1:.4f} "
                  f"mean predictive std {pred['predictive_std'].mean():.4f}")
            mc_suite = compute_uncertainty_metrics(pred["targets"], pred["probs"])
            print("MC-dropout suite:", {k: round(v, 4) for k, v in mc_suite.items()})

    train_cli.report_eval(emit, cfg, state, make_eval_step(cfg), val_loader, mesh)

    if args.sweep:
        from edrl_tpu_torch.train.robustness import DEFAULT_SIGMAS, DEFAULT_SP_LEVELS, format_sweep, noise_sweep

        kinds = ("gaussian", "salt_pepper") if args.sweep == "all" else (args.sweep,)
        for kind in kinds:
            levels = resolve_sweep_levels(args.sweep, kind, args.sweep_levels, args.sp_sweep_levels,
                                          DEFAULT_SIGMAS, DEFAULT_SP_LEVELS)
            res = noise_sweep(cfg, state, sigmas=levels, kind=kind, device=device, mesh=mesh)
            emit(f"Robustness sweep [{kind}]:")
            emit(format_sweep(res))
    leave()


if __name__ == "__main__":
    main()

"""The evaluation CLI (``edrl_tpu/cli/test.py``, the reference's
``fusion_test.py``): the training CLI's flags plus ``--checkpoint``; it
evaluates only.

    python -m edrl_tpu_torch.cli.test --dataset synthetic --checkpoint ckpt_dir/best

The robustness sweep (``--sweep``) and MC-dropout (``--mc_samples``) are
ROADMAP item A10 and refuse by name.
"""

from __future__ import annotations

import os

from edrl_tpu_torch.cli import train as train_cli


def build_parser():
    parser = train_cli.build_parser()
    parser.add_argument("--checkpoint", default="")
    parser.add_argument(
        "--sweep", choices=["gaussian", "salt_pepper", "all"], default="",
        help="the noise x modality robustness grid after eval (ROADMAP item A10; refused)",
    )
    parser.add_argument("--sweep_levels", type=float, nargs="+", default=None,
                        help="corruption levels for --sweep (the gaussian grid with --sweep all)")
    parser.add_argument("--sp_sweep_levels", type=float, nargs="+", default=None,
                        help="salt-pepper corrupted-pixel fractions for --sweep salt_pepper/all")
    parser.add_argument("--mc_samples", type=int, default=0,
                        help="N > 0: MC-dropout over N forwards (ROADMAP item A10; refused)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.sweep or args.mc_samples > 0:
        raise NotImplementedError(
            "the robustness sweep (--sweep) and MC-dropout (--mc_samples) are ROADMAP item A10"
        )
    cfg = train_cli.config_from_args(args)

    from edrl_tpu_torch.train.checkpoint import CheckpointManager
    from edrl_tpu_torch.train.trainer import init_state, make_eval_step, resolve_device

    device = resolve_device(args.device)
    emit = train_cli.setup_cli_logging(cfg, args, "test")
    _, val_loader = train_cli.make_loaders(cfg)
    state = init_state(cfg, cfg.train.seed, device=device)
    if args.checkpoint:
        directory, name = os.path.split(args.checkpoint.rstrip("/"))
        state = CheckpointManager(directory or ".").restore(state, name)
    train_cli.report_eval(emit, cfg, state, make_eval_step(cfg), val_loader)


if __name__ == "__main__":
    main()

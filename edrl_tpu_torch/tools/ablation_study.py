"""The ablation study on the port (``scripts/ablation_study.py``): what does
each EDRL mechanism buy, and does the port learn what the JAX package learns?

Trains each variant with ``fit`` on a synthetic protocol and evaluates its
final state on the sigma x modality grid (``noise_sweep``):

- MedFusion (full EDRL)
- MedFusion without MK-MMD self-distillation (``mmd_weight=0``)
- MedFusion without EPRL proxy losses (``proxy_weight_*=0``)
- MedFusion without DILR loss (``dilr_weight=0``)
- Multi_ResNet (plain late fusion)

One record per (variant, seed) goes to ``<output>.jsonl`` as the run
finishes, with the JAX script's keys (so the two files read alike) and the
port's own beside them: the card, the step's ms, the per-epoch train loss
and val accuracy, and the attention kernels' launches by route.  A second
call skips the recorded runs; a record whose protocol differs from this
call's moves to ``<output>.jsonl.stale`` and is run again.  The markdown
table is rendered anew after every run.  ``--parity_jsonl`` holds the rows
against another study's records under the same protocol (the JAX package's
``ABLATION_FUSION_DEFAULT.md.jsonl``), read as plain JSON.

On the card (one run a call is fine: rows resume by key):

    python -m edrl_tpu_torch.tools.ablation_study --protocol fusion --epochs 75 \\
      --warmup_steps 100 --train_samples 256 --val_samples 128 --batch_size 16 \\
      --lr 3e-5 --fundus_size 384 --oct_size 96 --sigmas 0 0.25 0.5 \\
      --variants "MedFusion (full EDRL)" --seeds 0 \\
      --output ABLATION_FUSION_DEFAULT_TORCH.md \\
      --parity_jsonl ABLATION_FUSION_DEFAULT.md.jsonl

``--device cpu`` runs it on the host (the tests do, at a tiny config).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from edrl_tpu_torch.config import DataConfig, EDRLConfig, ModelConfig, TrainConfig
from edrl_tpu_torch.data import SYNTHETIC_DATASETS, BatchLoader
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.train.robustness import noise_sweep
from edrl_tpu_torch.train.trainer import fit, resolve_device, set_conv_precision

# --protocol hard: weak modality-split noise-buried signal (the robustness
#   axes).  --protocol fusion: label = sign(u+v), u in the fundus, v in the
#   OCT: the multimodal advantage shows in clean accuracy (unimodal Bayes
#   ceiling ~0.75, fused ~1.0).
PROTOCOL_DATASETS = {"hard": "synthetic_hard", "fusion": "synthetic_fusion"}

FULL = "MedFusion (full EDRL)"
LATE = "Multi_ResNet (late fusion)"
VARIANTS = (
    FULL,
    "MedFusion -MMD",
    "MedFusion -EPRL",
    "MedFusion -DILR",
    LATE,
)
# The variants the parity bar decides; the others are reported without one.
HEADLINE = (FULL, LATE)
MODALITIES = ("both", "fundus-only", "oct-only")

PARITY_BAR = (
    "For full EDRL and for late fusion: (1) best val accuracy: the port's "
    "mean differs from the reference's by at most 2·√(s_port²/n_port + "
    "s_ref²/n_ref), std with ddof=1; (2) fusion advantage (\"both\" at σ=0 "
    "minus the better of the two unimodal cells at σ=0, paired per seed): "
    "full EDRL's mean advantage is > 0 and above late fusion's.  The ablated "
    "variants are reported with no bar."
)


def base_config(args) -> EDRLConfig:
    return EDRLConfig(
        data=DataConfig(
            dataset=PROTOCOL_DATASETS[args.protocol],
            batch_size=args.batch_size,
            eval_batch_size=args.batch_size,
            num_synthetic_samples=args.train_samples,
            device_noise=True,
            fundus_size=args.fundus_size,
            oct_size=(args.oct_size,) * 3,
        ),
        model=ModelConfig(use_bfloat16=True),
        train=TrainConfig(
            lr=args.lr,
            warmup_steps=args.warmup_steps,
            end_epochs=args.epochs,
            log_dir="",
            checkpoint_dir="",
            # Accepted and bit-equal to 0: fit steps batch by batch.
            scan_batches=args.scan_batches,
        ),
    )


def variant(cfg: EDRLConfig, name: str) -> EDRLConfig:
    m, t = cfg.model, cfg.train
    if name == FULL:
        return cfg
    if name == "MedFusion -MMD":
        return cfg.replace(train=dataclasses.replace(t, mmd_weight=0.0))
    if name == "MedFusion -EPRL":
        return cfg.replace(model=dataclasses.replace(m, proxy_weight_train=0.0, proxy_weight_eval=0.0))
    if name == "MedFusion -DILR":
        return cfg.replace(model=dataclasses.replace(m, dilr_weight=0.0))
    if name == LATE:
        return cfg.replace(model=dataclasses.replace(m, model_name="Multi_ResNet"))
    raise ValueError(name)


def protocol_of(args) -> dict:
    """The training and sweep grid a recorded row must match to be reused
    (compared as a dict: the JAX script's key, so that rows of either
    package with equal keys ran the same protocol)."""
    out = {
        "protocol": args.protocol,
        "heldout_val": True,
        "sigmas": list(args.sigmas),
        "epochs": args.epochs,
        "train_samples": args.train_samples,
        "val_samples": args.val_samples,
        "batch_size": args.batch_size,
        "lr": args.lr,
        "fundus_size": args.fundus_size,
        "oct_size": args.oct_size,
    }
    # Only when active, so that the default studies' keys stay as they were.
    if args.warmup_steps:
        out["warmup_steps"] = args.warmup_steps
    return out


def card_of(device: torch.device) -> str:
    """The card as ``nvidia-smi`` names it with its power limit, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[device.index or 0]


class _CardWatch:
    """Counts the processes on the card (``nvidia-smi``'s compute apps) every
    ``period`` seconds from a thread while a run trains: runs that share the
    card share its time, and their seconds say so beside them."""

    def __init__(self, device: torch.device, period: float = 15.0):
        self.counts, self._stop, self._thread = [], threading.Event(), None
        if device.type == "cuda":
            self._thread = threading.Thread(target=self._poll, args=(period,), daemon=True)
            self._thread.start()

    def _poll(self, period: float) -> None:
        # The first count after one period: by then the run's own process
        # holds its context on the card.
        while not self._stop.wait(period):
            try:
                out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                                     capture_output=True, text=True, timeout=30)
                self.counts.append(sum(1 for line in out.stdout.splitlines() if line.strip()))
            except (OSError, subprocess.SubprocessError):
                pass

    def close(self) -> list:
        """The counts seen, each once, in order (empty off the card)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        return sorted(set(self.counts))


class _EpochClock:
    """A loader whose epochs note when their first batch is asked for."""

    def __init__(self, loader, marks: list):
        self.loader, self.marks = loader, marks
        self.dataset, self.batch_size, self.world = loader.dataset, loader.batch_size, loader.world

    def __len__(self) -> int:
        return len(self.loader)

    def rows(self, b: int) -> int:
        return self.loader.rows(b)

    def epoch(self, epoch: int = 0):
        self.marks.append(time.perf_counter())
        yield from self.loader.epoch(epoch)


def _attention_launches() -> dict:
    return {"kernels": dict(wa.LAUNCHES), "forward": dict(wa.FWD_ROUTES), "backward": dict(wa.BWD_ROUTES)}


def _launches_since(before: dict) -> dict:
    """The attention kernels' launches, by kernel and by route, since
    ``before`` (the counts are read, never reset, so a caller's stay whole)."""
    return {part: {k: v - before[part][k] for k, v in now.items()} for part, now in _attention_launches().items()}


def run_variant(name: str, seed: int, cfg: EDRLConfig, args, card: str) -> dict:
    device = torch.device(args.device)
    vcfg = variant(cfg, name)
    # The seed reaches everything stochastic in training: init and step
    # draws (train.seed), per-sample draws (data.seed), the shuffle order.
    # The dataset is a fixed instantiation per index, so every variant and
    # seed trains on the same data.
    vcfg = vcfg.replace(
        data=dataclasses.replace(vcfg.data, seed=11 + 101 * seed),
        train=dataclasses.replace(vcfg.train, seed=seed),
    )
    val_cfg = dataclasses.replace(vcfg.data, num_synthetic_samples=args.val_samples)
    ds_cls = SYNTHETIC_DATASETS[vcfg.data.dataset]
    train_marks, val_marks = [], []
    train_loader = _EpochClock(BatchLoader(ds_cls(vcfg.data, mode="train"), vcfg.data.batch_size, shuffle=True,
                                           drop_last=True, seed=seed, uint8_transport=True), train_marks)
    val_loader = _EpochClock(BatchLoader(ds_cls(val_cfg, mode="val"), vcfg.data.eval_batch_size, shuffle=False,
                                         drop_last=False, uint8_transport=True), val_marks)
    start = _attention_launches()
    watch = _CardWatch(device)
    t0 = time.time()
    try:
        state, result = fit(vcfg, train_loader, val_loader, verbose=args.verbose, device=device)
    finally:
        card_processes = watch.close()
    train_time = time.time() - t0
    fit_launches = _launches_since(start)
    if args.state_dir:
        # The swept state, so that a sweep can be run again without training.
        from edrl_tpu_torch.train.checkpoint import CheckpointManager

        slug = name.replace(" ", "_").replace("(", "").replace(")", "")
        mgr = CheckpointManager(os.path.join(args.state_dir, f"{slug}_s{seed}"))
        mgr.save(state, name="final")
        mgr.wait()
    start = _attention_launches()
    sweep = noise_sweep(vcfg.replace(data=val_cfg), state, sigmas=args.sigmas, device=device)
    sweep_launches = _launches_since(start)
    del state
    # An epoch's train span runs from its first batch to its val pass (fit
    # reads the epoch's losses back first, so the card has finished); the
    # first epoch's holds the kernels' build and warm-up.
    spans = [v - t for t, v in zip(train_marks, val_marks)]
    steady = spans[1:] or spans
    return {
        "name": name,
        "seed": seed,
        "protocol": protocol_of(args),
        "best_val_acc": result.best_acc,
        "final_train_loss": result.train_history[-1].loss,
        "train_time_s": round(train_time, 1),
        "sweep": sweep,
        "card": card,
        "card_processes": card_processes,
        "step_ms": 1000.0 * float(np.median(steady)) / len(train_loader),
        "first_epoch_s": spans[0],
        "train_loss_history": [m.loss for m in result.train_history],
        "val_acc_history": [m.accuracy for m in result.val_history],
        "launches": {"fit": fit_launches, "sweep": sweep_launches},
    }


def _stats(values):
    """(mean, std with ddof=1 (0 for one value), n)."""
    v = np.asarray(values, dtype=float)
    return float(v.mean()), (float(v.std(ddof=1)) if v.size > 1 else 0.0), int(v.size)


def _agg(values) -> str:
    """mean±std over seeds (std left out for a single seed)."""
    mean, std, n = _stats(values)
    return f"{mean:.2f}" if n <= 1 else f"{mean:.2f}±{std:.2f}"


def _fmt(values, digits: int = 3) -> str:
    mean, std, n = _stats(values)
    return f"{mean:.{digits}f}±{std:.{digits}f} (n={n})" if n > 1 else f"{mean:.{digits}f} (n=1)"


def best_unimodal(row, sigma0: float = 0.0) -> float:
    cells = row["sweep"]
    return max(cells["fundus-only"][sigma0]["accuracy"], cells["oct-only"][sigma0]["accuracy"])


def advantage(row, sigma0: float = 0.0) -> float:
    """Clean-accuracy fusion advantage of one run: "both" minus the better
    unimodal cell, at ``sigma0``."""
    return row["sweep"]["both"][sigma0]["accuracy"] - best_unimodal(row, sigma0)


PROTOCOL_BLURB = {
    "hard": (
        "Protocol: `HardSyntheticGammaDataset` (weak modality-split signal, signal-dropout 0.3, distractors; "
        "dual-view training with gaussian_high=0.5)."
    ),
    "fusion": (
        "Protocol: `ComplementarySyntheticGammaDataset` — label = sign(u+v) with u rendered only in the fundus "
        "and v only in the OCT, so a unimodal Bayes-optimal classifier caps at ~0.75 accuracy while fusing both "
        "modalities decodes u+v exactly (ceiling ~1.0).  The multimodal advantage is therefore expressible in "
        "CLEAN accuracy: advantage = both(σ=0) − max(unimodal σ=0)."
    ),
}


def _by_name(rows) -> dict:
    by = {}
    for r in rows:
        by.setdefault(r["name"], []).append(r)
    return by


def _order(by: dict, variants=VARIANTS) -> tuple:
    order = [n for n in VARIANTS if n in by]
    order += [n for n in variants if n in by and n not in order]
    return tuple(order + [n for n in by if n not in order])


def parity(rows, ref_rows, sigma0: float = 0.0) -> dict:
    """Each variant's statistics against the reference's and the bar's
    outcome: ``{name: {metric: {"ref", "port", "diff", "limit", "ok"}}}``
    with ``(mean, std, n)`` for "ref" and "port"; ``limit`` and ``ok`` are
    set where a bar applies and both sides have n >= 2 (accuracy), or where
    full EDRL and late fusion both have rows (advantage)."""
    ours, theirs = _by_name(rows), _by_name(ref_rows)
    fields = {
        "best_val_acc": lambda r: r["best_val_acc"],
        "final_train_loss": lambda r: r["final_train_loss"],
        "advantage": lambda r: advantage(r, sigma0),
    }
    out = {}
    for name in _order({**theirs, **ours}):
        if name not in ours or name not in theirs:
            continue
        entry = {}
        for key, f in fields.items():
            port, ref = _stats([f(r) for r in ours[name]]), _stats([f(r) for r in theirs[name]])
            entry[key] = {"ref": ref, "port": port, "diff": port[0] - ref[0], "limit": None, "ok": None}
        acc = entry["best_val_acc"]
        if name in HEADLINE and acc["port"][2] > 1 and acc["ref"][2] > 1:
            acc["limit"] = 2.0 * math.sqrt(acc["port"][1] ** 2 / acc["port"][2] + acc["ref"][1] ** 2 / acc["ref"][2])
            acc["ok"] = abs(acc["diff"]) <= acc["limit"]
        out[name] = entry
    if FULL in ours and LATE in ours:
        full, late = (_stats([advantage(r, sigma0) for r in ours[n]])[0] for n in (FULL, LATE))
        ok = full > 0.0 and full > late
        for name in HEADLINE:
            if name in out:
                out[name]["advantage"]["ok"] = ok
    return out


def parity_markdown(rows, ref_rows, ref_path: str, sigma0: float = 0.0) -> str:
    """The parity section: each variant's reference and port statistics, the
    difference, the bar and its outcome."""
    table = parity(rows, ref_rows, sigma0)

    def ms(t):
        return f"{t[0]:.4f}±{t[1]:.4f} (n={t[2]})"

    lines = [
        f"## Parity with the reference rows (`{ref_path}`)",
        "",
        f"Bar, decided before the runs: {PARITY_BAR}",
        "",
        "| model | metric | reference | port | port − reference | bar | outcome |",
        "|---|---|---|---|---|---|---|",
    ]
    verdicts = []
    for name, entry in table.items():
        for key, label in (("best_val_acc", "best val acc"), ("final_train_loss", "final train loss"),
                           ("advantage", "fusion advantage")):
            e = entry[key]
            bar, outcome = "—", "—"
            if key == "best_val_acc" and name in HEADLINE:
                if e["limit"] is None:
                    bar, outcome = "needs n ≥ 2 on both sides", "not decided"
                else:
                    bar, outcome = f"\\|Δ\\| ≤ {e['limit']:.4f}", "pass" if e["ok"] else "**FAIL**"
            elif key == "advantage" and name in HEADLINE:
                bar = "> 0 and > late fusion's" if name == FULL else "< full EDRL's"
                outcome = "not decided" if e["ok"] is None else ("pass" if e["ok"] else "**FAIL**")
            if outcome != "—":
                verdicts.append(f"{name} {label}: {outcome}")
            lines.append(f"| {name} | {label} | {ms(e['ref'])} | {ms(e['port'])} | {e['diff']:+.4f} | {bar} | "
                         f"{outcome} |")
    lines += ["", "Outcome: " + ("; ".join(verdicts) if verdicts else "no headline variant on both sides") + ".",
              ""]
    return "\n".join(lines)


def to_markdown(rows, sigmas, variants=VARIANTS, protocol: str = "hard", ref_rows=None,
                ref_path: str = "") -> str:
    by = _by_name(rows)
    variants = _order(by, variants)
    seeds_seen = sorted({r["seed"] for r in rows})
    title = {
        "hard": "# Hard-synthetic ablation study (PyTorch port)",
        "fusion": "# Complementary-evidence (fusion) ablation study (PyTorch port)",
    }[protocol]
    lines = [
        title,
        "",
        PROTOCOL_BLURB[protocol] + "  Cells are `accuracy/AUC` of the final-epoch state on the sigma-corrupted "
        "low view of a HELD-OUT val split (disjoint per-index draws from the same protocol), mean±std over seeds "
        f"{seeds_seen}.  Seeds vary the init, the shuffle order and the device noise and augmentation draws "
        "(torch's generators: a seed's draws are not the JAX package's); the dataset is a fixed instantiation of "
        "the protocol, so every variant and seed sees the same data.",
        "",
    ]
    for metric in ("accuracy", "auc"):
        lines += [f"## {metric.upper()} per cell", ""]
        header, sep = "| model | val acc |", "|---|---|"
        for m in MODALITIES:
            for s in sigmas:
                header += f" {m} σ={s} |"
                sep += "---|"
        lines += [header, sep]
        for name in variants:
            group = by[name]
            row = f"| {name} | {_agg([g['best_val_acc'] for g in group])} |"
            for m in MODALITIES:
                for s in sigmas:
                    row += f" {_agg([g['sweep'][m][s][metric] for g in group])} |"
            lines.append(row)
        lines.append("")
    lines += ["## Per-seed best val accuracy", "", "| model |" + "".join(f" s{s} |" for s in seeds_seen),
              "|---|" + "---|" * len(seeds_seen)]
    for name in variants:
        acc_by_seed = {g["seed"]: g["best_val_acc"] for g in by[name]}
        lines.append(f"| {name} |" + "".join(
            f" {acc_by_seed[s]:.3f} |" if s in acc_by_seed else " — |" for s in seeds_seen))
    lines.append("")
    s0 = min(sigmas)
    if protocol == "fusion":
        lines += [
            "## Fusion advantage (clean accuracy, σ=0 cells)",
            "",
            "| model | both | fundus-only | oct-only | advantage |",
            "|---|---|---|---|---|",
        ]
        for name in variants:
            group = by[name]
            cells = [[g["sweep"][m][s0]["accuracy"] for g in group] for m in MODALITIES]
            lines.append(f"| {name} | {' | '.join(_agg(c) for c in cells)} | "
                         f"{_agg([advantage(g, s0) for g in group])} |")
        lines.append("")
    # The paired per-seed aggregates (each a mean±std over the variant's
    # seeds, every run's advantage computed within the run).
    lines += [
        "## Paired per seed",
        "",
        "| model | best val acc | final train loss | advantage | best unimodal σ=0 | both σ=0.5 − σ=0 "
        "| advantage per seed |",
        "|---|---|---|---|---|---|---|",
    ]
    for name in variants:
        group = sorted(by[name], key=lambda g: g["seed"])
        sig_hi = max(sigmas)
        delta = [g["sweep"]["both"][sig_hi]["accuracy"] - g["sweep"]["both"][s0]["accuracy"] for g in group]
        lines.append(
            f"| {name} | {_fmt([g['best_val_acc'] for g in group])} | {_fmt([g['final_train_loss'] for g in group])}"
            f" | {_fmt([advantage(g, s0) for g in group])} | {_fmt([best_unimodal(g, s0) for g in group])} | "
            f"{np.mean(delta):+.3f} | " + " ".join(f"s{g['seed']}:{advantage(g, s0):+.3f}" for g in group) + " |")
    lines.append("")
    lines += [
        "## Runs",
        "",
        "Wall seconds of `fit` (train and the per-epoch val) on the card's host; step ms is the median over "
        "epochs 2 onwards of an epoch's train span (its first batch to its val pass) over its steps.  Processes "
        "on the card: the counts `nvidia-smi` showed while the run trained, 0 left out (above 1, runs shared the "
        "card's time, and their seconds are not one run's alone).  B1/B2: the attention kernels' launches in `fit` by "
        "route, forward / backward.",
        "",
        "| model | seed | train_time_s | step ms | first epoch s | processes on the card | B1/B2 launches by route "
        "| card |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for name in variants:
        for g in sorted(by[name], key=lambda g: g["seed"]):
            fit_l = g.get("launches", {}).get("fit")
            routes = "—" if fit_l is None else " / ".join(
                ", ".join(f"{k} {v}" for k, v in fit_l[d].items()) for d in ("forward", "backward"))
            step, first = g.get("step_ms"), g.get("first_epoch_s")
            procs = ", ".join(str(c) for c in g.get("card_processes", []) if c) or "—"
            lines.append(f"| {name} | {g['seed']} | {g['train_time_s']} | "
                         f"{'—' if step is None else f'{step:.1f}'} | {'—' if first is None else f'{first:.1f}'} | "
                         f"{procs} | {routes} | {g.get('card', '—')} |")
    lines.append("")
    if ref_rows is not None:
        lines.append(parity_markdown(rows, ref_rows, ref_path, s0))
    lines += ["Generated by `python -m edrl_tpu_torch.tools.ablation_study`.", ""]
    return "\n".join(lines)


def _float_sweep(r: dict) -> dict:
    # JSON writes the float sigma keys as strings.
    r["sweep"] = {m: {float(s): v for s, v in cells.items()} for m, cells in r["sweep"].items()}
    return r


def read_rows(path: str, proto: dict) -> list:
    """The rows of a ``.jsonl`` recorded under ``proto`` (plain JSON; any
    study's records, the JAX package's included)."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [_float_sweep(r) for r in rows if r.get("protocol") == proto]


def load_recorded(jsonl: str, proto: dict) -> list:
    """The rows of ``jsonl`` under ``proto``; the others move to
    ``<jsonl>.stale`` and leave the live file."""
    if not os.path.exists(jsonl):
        return []
    keep, stale, rows = [], [], []
    with open(jsonl) as f:
        for line in f:
            if not line.strip():
                continue
            r = json.loads(line)
            if r.get("protocol") != proto:
                print(f"(stale row archived: {r['name']} seed={r.get('seed')} — protocol mismatch)", flush=True)
                stale.append(line)
                continue
            keep.append(line)
            rows.append(_float_sweep(r))
    if stale:
        with open(jsonl + ".stale", "a") as f:
            f.writelines(stale)
        with open(jsonl, "w") as f:
            f.writelines(keep)
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--train_samples", type=int, default=256)
    p.add_argument("--val_samples", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps (0 = constant lr; nonzero enters the protocol key)")
    p.add_argument("--fundus_size", type=int, default=384)
    p.add_argument("--oct_size", type=int, default=96)
    p.add_argument("--sigmas", type=float, nargs="+", default=[0.0, 0.25, 0.5])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--scan_batches", type=int, default=16, help="accepted; fit steps batch by batch")
    p.add_argument("--state_dir", default="", help="save each run's final state under this directory")
    p.add_argument("--variants", nargs="+", default=None)
    p.add_argument("--protocol", choices=sorted(PROTOCOL_DATASETS), default="hard")
    p.add_argument("--output", default=None)
    p.add_argument("--parity_jsonl", default=None,
                   help="another study's records (the JAX package's .jsonl) to hold the rows against")
    p.add_argument("--device", default="cuda", help="where to train (cuda unless asked for cpu)")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.output is None:
        args.output = "ABLATION.md" if args.protocol == "hard" else "ABLATION_FUSION.md"
    args.sigmas = tuple(args.sigmas)
    device = resolve_device(args.device)
    set_conv_precision()
    card = card_of(device)
    proto = protocol_of(args)
    variants = tuple(args.variants or VARIANTS)
    ref_rows = read_rows(args.parity_jsonl, proto) if args.parity_jsonl else None
    if ref_rows == []:
        print(f"(no row of {args.parity_jsonl} has this protocol)", flush=True)

    def render(rows):
        return to_markdown(rows, args.sigmas, variants, args.protocol, ref_rows, args.parity_jsonl or "")

    cfg = base_config(args)
    jsonl = args.output + ".jsonl"
    rows = load_recorded(jsonl, proto)
    done = {(r["name"], r["seed"]) for r in rows}
    # Seed-major: the first pass gives every variant one seed.
    for seed in args.seeds:
        for name in variants:
            if (name, seed) in done:
                print(f"=== {name} s{seed} === (cached)", flush=True)
                continue
            print(f"=== {name} s{seed} === [{card}]", flush=True)
            r = run_variant(name, seed, cfg, args, card)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            rows.append(r)
            with open(jsonl, "a") as f:
                f.write(json.dumps(r, default=float) + "\n")
            print(json.dumps({k: r[k] for k in ("name", "seed", "best_val_acc", "final_train_loss",
                                                "train_time_s", "step_ms", "card")}, default=float), flush=True)
            # After every run, so that a cut study leaves its freshest table.
            with open(args.output, "w") as f:
                f.write(render(rows))
    if rows:
        md = render(rows)
        with open(args.output, "w") as f:
            f.write(md)
        print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())

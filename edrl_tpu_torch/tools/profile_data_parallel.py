"""Data parallelism across the cards of one host: checked, then timed.

Run under the launcher, one process per card, from the root of a checkout:

    python -m torch.distributed.run --nproc_per_node 4 -m edrl_tpu_torch.tools.profile_data_parallel

On N ranks over NCCL (N = 1 runs too, as a rehearsal), in the shipped
``EDRLConfig()`` at full width, with seeded random weights and
``trainer.random_views`` batches:

1. Checks, in f32 (the port's bars for a step's results, atol 2e-4 / rtol
   1e-3): two world-N steps at global batch 32 against rank 0's one-card
   steps on the same global batches and draws (loss, MMD, probabilities,
   every gradient); again with ZeRO-1 (whose second step shows the sharded
   update equal to the replicated one), and again with ``use_pallas_mmd``
   (B3 on the gathered 2 x 32 rows).
2. Times, in the shipped bf16: steps at global batch 32 and 32 x N (32 / N
   and 32 per card) against one card at batch 32 (rank 0 alone, the others
   waiting): ms a step on the host clock to a ``synchronize()``, pairs/s,
   and the scaling, the world's pairs/s over one card's; the host's
   enqueue of a step; the gradient all-reduce alone; the peak device
   memory of each card (``max_memory_allocated``) with and without ZeRO-1.
3. The CLIs under the launcher, timed (batch 32, 64 synthetic samples):
   ``cli.train`` for 1 epoch; ``cli.train --zero1`` for 1 epoch, then
   ``--resume`` from its consolidated ``latest`` for a second (every rank
   loads it and keeps its shard); ``cli.test`` on its best with MC-dropout
   (2 passes, on rank 0) and a 2-level sweep.  Each must log its report on
   rank 0.

Rank 0 prints the card's name and power limit (``nvidia-smi``) and, as its
last line, one JSON object of the readings.  A failed check raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from edrl_tpu_torch import parallel
from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.kernels import build
from edrl_tpu_torch.train import trainer

BATCH = 32
STEPS = 5
ATOL, RTOL = 2e-4, 1e-3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def worst(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| / (atol + rtol |b|): at most 1 is within the bars."""
    a, b = a.detach().double(), b.detach().double()
    return float(((a - b).abs() / (ATOL + RTOL * b.abs())).max())


def with_train(cfg: EDRLConfig, **train) -> EDRLConfig:
    return cfg.replace(train=dataclasses.replace(cfg.train, **train))


def check_against_one_card(cfg: EDRLConfig, mesh, device, steps: int = 2) -> dict:
    """Two world-N steps against rank 0's one-card steps: the worst readings
    (see ``worst``) of the outputs and the gradients, on rank 0."""
    ranks = trainer.init_state(cfg, seed=0, device=device, mesh=mesh)
    step = trainer.make_train_step(cfg, mesh)
    one = trainer.init_state(cfg, seed=0, device=device) if mesh.get_local_rank("data") == 0 else None
    one_step = trainer.make_train_step(cfg)
    errs = {"loss": 0.0, "mmd": 0.0, "probs": 0.0, "grads": 0.0}
    for i in range(steps):
        batch = trainer.random_views(cfg, seed=50 + i, device=device)
        out = step(ranks, parallel.shard_batch(batch, mesh), torch.Generator(device=device).manual_seed(60 + i))
        if one is not None:
            want = one_step(one, batch, torch.Generator(device=device).manual_seed(60 + i))
            for key in ("loss", "mmd", "probs"):
                errs[key] = max(errs[key], worst(out[key], want[key]))
            errs["grads"] = max(errs["grads"], max(worst(a.grad, b.grad) for a, b in
                                                   zip(ranks.model.parameters(), one.model.parameters())))
        dist.barrier()
    del ranks, one
    torch.cuda.empty_cache()
    return errs


def timed_steps(cfg: EDRLConfig, device, mesh=None, steps: int = STEPS) -> dict:
    """ms a step at ``cfg``'s global batch (one warm-up step first), this
    card's peak device memory (GiB), the host's ms to enqueue a step (the
    step called, not waited for, then a ``synchronize()``), and under a
    mesh the gradient all-reduce alone (``all_reduce_mean_`` of the step's
    gradients, ms a call, between ``synchronize()``s)."""
    state = trainer.init_state(cfg, seed=0, device=device, mesh=mesh)
    step = trainer.make_train_step(cfg, mesh)
    batch = trainer.random_views(cfg, seed=70, device=device)
    if mesh is not None:
        # This rank's rows in storage of their own: the global batch is freed.
        batch = {k: v.clone() for k, v in parallel.shard_batch(batch, mesh).items()}
    gen = torch.Generator(device=device).manual_seed(71)
    step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    outs = [step(state, batch, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t) / steps
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    enqueue = []
    for _ in range(3):
        t = time.perf_counter()
        outs.append(step(state, batch, gen))
        enqueue.append(1000.0 * (time.perf_counter() - t))
        torch.cuda.synchronize()
    result = {"ms": ms, "pairs_per_s": 1000.0 * cfg.data.batch_size / ms, "peak_gib": peak,
              "enqueue_ms": sorted(enqueue)[1]}
    if mesh is not None:
        grads = [p.grad for p in state.model.parameters()]
        t = time.perf_counter()
        for _ in range(steps):
            parallel.all_reduce_mean_(grads, mesh)
        torch.cuda.synchronize()
        result["grad_all_reduce_ms"] = 1000.0 * (time.perf_counter() - t) / steps
    losses = [float(o["loss"]) for o in outs]
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise RuntimeError(f"non-finite losses {losses}")
    del state, batch, outs
    torch.cuda.empty_cache()
    return result


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer.set_conv_precision()
    device = parallel.init_distributed("cuda")
    mesh = parallel.make_mesh(device="cuda")
    world, rank = mesh.size(0), mesh.get_local_rank("data")
    writer = rank == 0
    if writer:
        build.build_library()
    dist.barrier()
    build.load_library()
    card = card_line() if writer else ""
    if writer:
        print(card, flush=True)

    shipped = with_train(EDRLConfig(), seed=0)
    f32 = shipped.replace(model=dataclasses.replace(shipped.model, use_bfloat16=False))
    readings = {"card": card, "world": world, "checks": {}, "steps": {}}

    # 1. The world-N step against one card's, in f32.
    for label, train in (("replicated", {}), ("zero1", {"zero1": True}), ("pallas_mmd", {"use_pallas_mmd": True})):
        t = time.perf_counter()
        shared = [check_against_one_card(with_train(f32, **train), mesh, device)]
        dist.broadcast_object_list(shared, src=0)  # rank 0's readings, so that every rank stops on a failure
        errs = readings["checks"][label] = shared[0]
        if writer:
            print(f"check {label}: world {world} against one card, 2 f32 steps at global batch {BATCH}: worst "
                  f"|err| / (atol + rtol |want|) {errs} ({time.perf_counter() - t:.1f} s) [{card}]", flush=True)
        if max(errs.values()) > 1.0:
            raise RuntimeError(f"world {world} {label} step differs from one card's: {errs}")

    # 2. Step times and peak memory, in the shipped bf16.
    if writer:
        readings["steps"]["one card, batch 32"] = timed_steps(with_train(shipped), device)
    dist.barrier()
    for per_card in sorted({BATCH // world, BATCH}):
        for zero1 in (False, True):
            c = shipped.replace(data=dataclasses.replace(shipped.data, batch_size=per_card * world))
            got = timed_steps(with_train(c, zero1=zero1), device, mesh)
            peaks = [None] * world
            dist.all_gather_object(peaks, got["peak_gib"])
            if writer:
                one = readings["steps"]["one card, batch 32"]["pairs_per_s"]
                got.update(peak_gib_per_card=peaks, scaling=got["pairs_per_s"] / one)
                label = f"world {world}, global batch {per_card * world} ({per_card} a card){', zero1' if zero1 else ''}"
                readings["steps"][label] = got
                print(f"{label}: {got} [{card}]", flush=True)
    if writer:
        print(f"one card, batch 32: {readings['steps']['one card, batch 32']} [{card}]", flush=True)

    # 3. The CLIs under the launcher, on this group (which each keeps).
    from edrl_tpu_torch.cli import test as test_cli
    from edrl_tpu_torch.cli import train as train_cli

    work = Path(tempfile.mkdtemp(prefix="edrl_dp_tool_", dir="build")) if writer else None
    objs = [str(work)]
    dist.broadcast_object_list(objs, src=0)
    common = ["--dataset", "synthetic", "--batch_size", str(BATCH), "--synthetic_samples", str(2 * BATCH),
              "--plot_dir", "", "--checkpoint_dir", os.path.join(objs[0], "ckpt"), "--log_dir",
              os.path.join(objs[0], "log")]
    zero1 = ["--name", "z1", "--mode", "train", "--zero1", "--save_latest_every", "1"]
    runs = (("cli_train_1_epoch_s", train_cli, ["--end_epochs", "1", "--name", "dp", "--mode", "train"],
             "dp_train", "Best val accuracy"),
            ("cli_train_zero1_1_epoch_s", train_cli, ["--end_epochs", "1", *zero1], "z1_train", "Best val accuracy"),
            ("cli_train_zero1_resumed_epoch_s", train_cli, ["--end_epochs", "2", "--resume", *zero1], "z1_train",
             "Resuming from latest (completed epoch 1"),
            ("cli_test_s", test_cli, ["--name", "z1", "--mc_samples", "2", "--sweep", "gaussian", "--sweep_levels",
                                      "0.0", "0.3", "--checkpoint",
                                      os.path.join(objs[0], "ckpt", "synthetic_0.5_z1", "best")],
             "z1_test", "Robustness sweep [gaussian]:"))
    for key, cli, argv, log, expect in runs:
        t = time.perf_counter()
        cli.main(common + argv)
        if writer:
            readings[key] = time.perf_counter() - t
            if expect not in Path(objs[0], "log", f"synthetic_{log}.log").read_text():
                raise RuntimeError(f"{key}: {expect!r} not in its log")
    dist.destroy_process_group()
    if writer:
        shutil.rmtree(work, ignore_errors=True)
        print(json.dumps(readings), flush=True)


if __name__ == "__main__":
    main()

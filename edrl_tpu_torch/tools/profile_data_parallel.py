"""Data and tensor parallelism across the cards of one host: checked, then timed.

Run under the launcher, one process per card, from the root of a checkout:

    python -m torch.distributed.run --nproc_per_node 4 -m edrl_tpu_torch.tools.profile_data_parallel \\
        [--model_name MedFusion ...] [--num_model_shards 1 2 4] [--parts 1 2 3 4]

On N ranks over NCCL (N = 1 runs too, as a rehearsal), for each registry
model of ``--model_name`` (default MedFusion) and each model axis M of
``--num_model_shards`` (default 1, 2 and 4: the data mesh ``(N, 1)`` and
the tensor-parallel meshes ``(N / 2, 2)`` and ``(N / 4, 4)``), in the
shipped ``EDRLConfig()`` with that model at full width, with seeded random
weights and ``trainer.random_views`` batches:

1. Checks, in f32 (the port's bars for a step's results, atol 2e-4 / rtol
   1e-3): two steps on the mesh at global batch 32 against rank 0's
   one-card steps on the same global batches and draws (loss, MMD,
   probabilities, every gradient gathered to full shape); the replicated
   parameters' gradients, as the ranks of a model group computed them
   before the step's broadcast, within the bars' atol of each other
   (``replica_drift``).  Beside each, rank 0's witness: the one-card steps against
   themselves with every input view moved by one f32 ulp (``nudged``),
   read the same way, which says how far the step's rounding alone carries
   a difference that small.  A reading passes within the bars, or within
   ``WITNESS`` times its witness where that exceeds them: B5 rounds its f32
   activation to bf16, so its one-card step leaves the bars under a
   one-ulp move of its inputs.  The configurations (``CHECKS``): the plain
   step; ZeRO-1 where the data axis is above 1 (its second step shows the
   sharded update equal to the replicated one); ``use_pallas_mmd`` (B3 on
   the gathered rows); and each of the fused flags ``use_fused_ln`` (B4),
   ``use_fused_mlp`` (B5) and ``use_fused_block_attention`` (B6), B5 and B6
   on the data mesh only (they refuse a model axis above 1), and the three
   only for a model with a Swin or a ViT (a CNN model has none of their
   layers).  A CNN model's f32 train-mode BatchNorm carries rounding far:
   its witness says how far.
2. Times, in the shipped bf16 (a CNN model computes in f32), at global
   batch ``--global_batches`` (default 32 and 32 x N), with ZeRO-1
   too where the data axis is above 1, against one card at batch 32 (rank
   0 alone, timed first): ms a step on the host clock to a
   ``synchronize()``, pairs/s and the scaling, the world's pairs/s over one
   card's; the host's enqueue of a step; the gradient all-reduce alone;
   under a model axis the replicated gradients' broadcast alone, its
   collectives a step (their count and bytes, the broadcast's among them), the
   device ms of every NCCL kernel in one profiled step and B1's and B2's
   launches a step by route; the peak device memory of each card and the
   bytes of a card's parameters.
3. ``sharded_byte_fraction`` of the shipped model.
4. The CLIs under the launcher, timed (batch 32, 64 synthetic samples, the
   mesh's model axis as ``--num_model_shards``): ``cli.train`` for 1 epoch;
   ``cli.train --zero1`` for 1 epoch, then ``--resume`` from its
   consolidated ``latest`` for a second (every rank loads it and keeps its
   shard and its slices); ``cli.test`` on that run's best with MC-dropout
   (2 passes) and a 2-level sweep.  Each must log its report on rank 0.

``--parts`` runs some of the four (default all of them) and ``--checks``
some of step 1's configurations (by label); a failed check of step 1
raises after the others.  Rank 0 prints the card's name and power
limit (``nvidia-smi``) and, as its last line, one JSON object of the
readings by model name.
"""

from __future__ import annotations

import argparse
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
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.parallel import mesh as pmesh
from edrl_tpu_torch.parallel import tensor
from edrl_tpu_torch.train import trainer

BATCH = 32
STEPS = 5
ATOL, RTOL = 2e-4, 1e-3
# Step 1's configurations: (label, train settings, model settings).
CHECKS = (("replicated", {}, {}), ("zero1", {"zero1": True}, {}), ("pallas_mmd", {"use_pallas_mmd": True}, {}),
          ("fused_ln", {}, {"use_fused_ln": True}), ("fused_mlp", {}, {"use_fused_mlp": True}),
          ("fused_block_attention", {}, {"use_fused_block_attention": True}))
# The flags whose kernels read whole weights, refused over a model axis above 1.
WHOLE_WEIGHTS = ("use_fused_mlp", "use_fused_block_attention")
# A check's reading passes at most max(1, WITNESS x its one-ulp witness), the
# factor of tests/test_torch_baselines.py's CNN rule.
WITNESS = 3.0
READINGS = ("loss", "mmd", "probs", "grads")


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


def applies(train: dict, model: dict, mesh, backbones: bool = True) -> bool:
    """Whether a configuration of ``CHECKS`` runs on ``mesh``: ZeRO-1 wants a
    data axis above 1 (on one it is the plain Adam), B5 and B6 a model axis
    of 1, and the fused flags a model with ``backbones`` (a Swin or a ViT)."""
    if train.get("zero1") and mesh.size(0) == 1:
        return False
    if model and not backbones:
        return False
    return mesh.size(1) == 1 or not any(model.get(flag) for flag in WHOLE_WEIGHTS)


def has_backbones(cfg: EDRLConfig) -> bool:
    """Whether ``cfg``'s model holds a Swin or a ViT, whose layers the fused
    flags reach."""
    from edrl_tpu_torch.models.swin2d import SwinTransformer2D
    from edrl_tpu_torch.models.vit3d import ViT3D

    return any(isinstance(m, (SwinTransformer2D, ViT3D)) for m in trainer.make_model(cfg, "meta").modules())


def nudged(batch: dict) -> dict:
    """``batch`` with every floating-point tensor moved by one f32 ulp up."""
    return {k: torch.nextafter(v, torch.full_like(v, float("inf"))) if v.is_floating_point() else v
            for k, v in batch.items()}


def replica_drift(mesh) -> float:
    """The largest |difference| between a rank's replicated gradients and
    model rank 0's that the steps' broadcast overwrote since the last
    ``tensor.reset_collective_counts()`` (``tensor.replica_drift``), over
    every rank: 0 where the ranks of a model group computed them bit for
    bit alike."""
    drift = torch.tensor([tensor.replica_drift()], device=mesh.device_type)
    dist.all_reduce(drift, op=dist.ReduceOp.MAX)
    return float(drift)


def passes(errs: dict) -> bool:
    """Whether a check's readings pass: each within the bars or within
    ``WITNESS`` times its one-ulp witness, and the replicated gradients'
    drift over the model ranks within the gradient bars' atol."""
    return errs["replica_drift"] <= ATOL and all(
        errs[key] <= max(1.0, WITNESS * errs.get(f"ulp_{key}", 0.0)) for key in READINGS)


def _readings(out: dict, grads: dict, want: dict, want_grads: dict) -> dict:
    errs = {key: worst(out[key], want[key]) for key in READINGS[:3]}
    errs["grads"] = max(worst(grads[n], g) for n, g in want_grads.items())
    return errs


def _merge(errs: dict, new: dict) -> None:
    for key, value in new.items():
        errs[key] = max(errs.get(key, 0.0), value)


def check_against_one_card(cfg: EDRLConfig, mesh, device, steps: int = 2) -> dict:
    """Two steps on ``mesh`` against rank 0's one-card steps: the worst
    readings (``worst``) of the outputs and of every gradient at full shape,
    the replicated gradients' drift over the model ranks before the step's
    broadcast (``replica_drift``; the collective counts are reset first),
    and (``ulp_*``) rank 0's one-card steps on the ``nudged`` batches
    against its own."""
    writer = parallel.is_writer(mesh)
    ranks = trainer.init_state(cfg, seed=0, device=device, mesh=mesh)
    one = trainer.init_state(cfg, seed=0, device=device) if writer else None
    step, one_step = trainer.make_train_step(cfg, mesh), trainer.make_train_step(cfg)
    errs, wants = {}, []
    tensor.reset_collective_counts()
    for i in range(steps):
        batch = trainer.random_views(cfg, seed=50 + i, device=device)
        out = step(ranks, parallel.shard_batch(batch, mesh), torch.Generator(device=device).manual_seed(60 + i))
        full = tensor.gather_full(ranks.model, {n: p.grad for n, p in ranks.model.named_parameters()})
        if writer:
            want = one_step(one, batch, torch.Generator(device=device).manual_seed(60 + i))
            want_grads = {n: p.grad.clone() for n, p in one.model.named_parameters()}
            _merge(errs, _readings(out, full, want, want_grads))
            wants.append((want, want_grads))
        del full
        dist.barrier()
    errs["replica_drift"] = replica_drift(mesh)
    del ranks, one
    if writer:
        ulp = trainer.init_state(cfg, seed=0, device=device)
        for i, (want, want_grads) in enumerate(wants):
            batch = nudged(trainer.random_views(cfg, seed=50 + i, device=device))
            out = one_step(ulp, batch, torch.Generator(device=device).manual_seed(60 + i))
            grads = {n: p.grad for n, p in ulp.model.named_parameters()}
            _merge(errs, {f"ulp_{k}": v for k, v in _readings(out, grads, want, want_grads).items()})
        del ulp
    del wants
    torch.cuda.empty_cache()
    dist.barrier()
    return errs


def nccl_device_ms(fn) -> float | None:
    """The device ms of the NCCL kernels while ``fn`` runs (one
    ``torch.profiler`` window), or None where the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(getattr(e, "device_time_total", 0.0) for e in events)
    if not total:
        return None
    return sum(getattr(e, "self_device_time_total", 0.0) for e in events if "nccl" in e.key.lower()) / 1000.0


def start_together() -> None:
    """Every rank's queued work done, then a barrier: a collective timed
    next counts itself, not the wait for a rank that is still stepping."""
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.synchronize()


def timed_steps(cfg: EDRLConfig, device, mesh=None, steps: int = STEPS) -> dict:
    """ms a step at ``cfg``'s global batch (one warm-up step first), this
    card's peak device memory (GiB) and parameter bytes, the host's ms to
    enqueue a step (the step called, not waited for, then a
    ``synchronize()``); under a mesh the model axis's collectives a step
    (count, MB put in), the NCCL kernels' device ms in one profiled step,
    the gradient all-reduce alone (``all_reduce_mean_`` of the step's
    gradients, ms a call, from ``start_together()`` to a ``synchronize()``)
    and, over a model axis, the replicated gradients' broadcast alone (the
    same way), and
    B1's and B2's launches a step by route."""
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
    tensor.reset_collective_counts()
    wa.reset_launch_counts()
    t = time.perf_counter()
    outs = [step(state, batch, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    ms = 1000.0 * (time.perf_counter() - t) / steps
    result = {"ms": ms, "pairs_per_s": 1000.0 * cfg.data.batch_size / ms,
              "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
              "param_gib": sum(p.numel() * p.element_size() for p in state.model.parameters()) / 2**30,
              "collectives_a_step": {k: v / steps for k, v in tensor.COLLECTIVES.items()},
              "tp_launches_a_step": {k: v / steps for k, v in wa.TP_ROUTES.items() if v}}
    if "bytes" in result["collectives_a_step"]:
        result["collectives_a_step"]["bytes"] /= 2**20
    enqueue = []
    for _ in range(3):
        t = time.perf_counter()
        outs.append(step(state, batch, gen))
        enqueue.append(1000.0 * (time.perf_counter() - t))
        torch.cuda.synchronize()
    result["enqueue_ms"] = sorted(enqueue)[1]
    if mesh is not None:
        result["nccl_device_ms_a_step"] = nccl_device_ms(lambda: outs.append(step(state, batch, gen)))
        grads = [p.grad for p in state.model.parameters()]
        start_together()
        t = time.perf_counter()
        for _ in range(steps):
            parallel.all_reduce_mean_(grads, mesh)
        torch.cuda.synchronize()
        result["grad_all_reduce_ms"] = 1000.0 * (time.perf_counter() - t) / steps
        if mesh.size(1) > 1:
            params = list(state.model.parameters())
            start_together()
            t = time.perf_counter()
            for _ in range(steps):
                tensor.broadcast_replicated_grads_(state.model, params, mesh)
            torch.cuda.synchronize()
            result["replicated_broadcast_ms"] = 1000.0 * (time.perf_counter() - t) / steps
    losses = [float(o["loss"]) for o in outs]
    if not all(x == x and abs(x) < float("inf") for x in losses):
        raise RuntimeError(f"non-finite losses {losses}")
    del state, batch, outs
    torch.cuda.empty_cache()
    return result


def run_clis(shards: int, writer: bool, model_name: str = "MedFusion") -> dict:
    """``cli.train`` (1 epoch), ``cli.train --zero1`` (1 epoch) and its
    ``--resume`` for a second, and ``cli.test`` on the resumed run's best,
    each with ``--num_model_shards shards`` and ``--model_name``, timed;
    each must log its report on rank 0."""
    from edrl_tpu_torch.cli import test as test_cli
    from edrl_tpu_torch.cli import train as train_cli

    work = [str(Path(tempfile.mkdtemp(prefix="edrl_parallel_tool_", dir="build"))) if writer else ""]
    dist.broadcast_object_list(work, src=0)
    common = ["--dataset", "synthetic", "--batch_size", str(BATCH), "--synthetic_samples", str(2 * BATCH),
              "--plot_dir", "", "--checkpoint_dir", os.path.join(work[0], "ckpt"), "--log_dir",
              os.path.join(work[0], "log"), "--num_model_shards", str(shards), "--model_name", model_name]
    zero1 = ["--name", "z1", "--mode", "train", "--zero1", "--save_latest_every", "1"]
    runs = (("cli_train_1_epoch_s", train_cli, ["--end_epochs", "1", "--name", "plain", "--mode", "train"],
             "plain_train", "Best val accuracy"),
            ("cli_train_zero1_1_epoch_s", train_cli, ["--end_epochs", "1", *zero1], "z1_train", "Best val accuracy"),
            ("cli_train_zero1_resumed_epoch_s", train_cli, ["--end_epochs", "2", "--resume", *zero1], "z1_train",
             "Resuming from latest (completed epoch 1"),
            ("cli_test_s", test_cli, ["--name", "z1", "--mc_samples", "2", "--sweep", "gaussian", "--sweep_levels",
                                      "0.0", "0.3", "--checkpoint",
                                      os.path.join(work[0], "ckpt", "synthetic_0.5_z1", "best")],
             "z1_test", "Robustness sweep [gaussian]:"))
    out = {}
    for key, cli, argv, log, expect in runs:
        t = time.perf_counter()
        cli.main(common + argv)
        if writer:
            out[key] = time.perf_counter() - t
            if expect not in Path(work[0], "log", f"synthetic_{log}.log").read_text():
                raise RuntimeError(f"{key}: {expect!r} not in its log")
    if writer:
        shutil.rmtree(work[0], ignore_errors=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model_name", nargs="+", default=["MedFusion"])
    parser.add_argument("--num_model_shards", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--global_batches", type=int, nargs="+", default=None)
    parser.add_argument("--parts", type=int, nargs="+", choices=(1, 2, 3, 4), default=[1, 2, 3, 4])
    parser.add_argument("--checks", nargs="+", choices=[c[0] for c in CHECKS], default=[c[0] for c in CHECKS])
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer.set_conv_precision()
    device = parallel.init_distributed("cuda")
    world = dist.get_world_size()
    writer = dist.get_rank() == 0
    if writer:
        build.build_library()
    dist.barrier()
    build.load_library()
    card = card_line() if writer else ""
    if writer:
        print(card, flush=True)

    readings = {"card": card, "world": world}
    failed = []
    for name in args.model_name:
        readings[name] = profile_model(name, args, device, world, writer, card, failed)
    dist.destroy_process_group()
    if writer:
        print(json.dumps(readings), flush=True)
    if failed:
        raise RuntimeError(f"steps differ from one card's in {failed}")


def profile_model(name: str, args, device, world: int, writer: bool, card: str, failed: list) -> dict:
    """Steps 1-4 for registry model ``name``: its readings; the labels of
    its failed checks are added to ``failed``."""
    parts = set(args.parts)
    shipped = with_train(EDRLConfig(), seed=0)
    shipped = shipped.replace(model=dataclasses.replace(shipped.model, model_name=name))
    f32 = shipped.replace(model=dataclasses.replace(shipped.model, use_bfloat16=False))
    backbones = has_backbones(shipped)
    tag = f"{name} "
    readings = {"checks": {}, "steps": {}, "clis": {}}
    if 3 in parts:
        meta = trainer.make_model(shipped, "meta")
        readings["sharded_byte_fraction"] = {m: pmesh.sharded_byte_fraction(meta, pmesh.param_shardings(meta, m))
                                             for m in args.num_model_shards}
        if writer:
            print(f"sharded_byte_fraction of the shipped {name}: {readings['sharded_byte_fraction']}", flush=True)
    if writer and 2 in parts:
        readings["steps"]["one card, batch 32"] = timed_steps(shipped, device)
        print(f"{tag}one card, batch 32: {readings['steps']['one card, batch 32']} [{card}]", flush=True)
    dist.barrier()
    for m in args.num_model_shards:
        mesh = parallel.make_mesh(m, device="cuda")
        shape = tuple(mesh.shape)
        # 1. The step on the mesh against one card's, in f32; a failed check
        # raises once the other parts have run.
        for label, train, model in CHECKS if 1 in parts else ():
            if label not in args.checks or not applies(train, model, mesh, backbones):
                continue
            t = time.perf_counter()
            c = with_train(f32, **train)
            shared = [check_against_one_card(c.replace(model=dataclasses.replace(c.model, **model)), mesh, device)]
            dist.broadcast_object_list(shared, src=0)  # rank 0's readings, so that every rank stops on a failure
            errs = readings["checks"][f"{shape} {label}"] = shared[0]
            if writer:
                print(f"{tag}check {shape} {label}: 2 f32 steps at global batch {BATCH} against one card: worst "
                      f"|err| / (atol + rtol |want|) {errs} ({time.perf_counter() - t:.1f} s) [{card}]", flush=True)
            if not passes(errs):
                failed.append(f"{tag}{shape} {label}")
        # 2. Step times, collectives and peak memory, in bf16.
        batches = args.global_batches or sorted({BATCH, BATCH * world})
        for global_batch in batches if 2 in parts else ():
            for zero1 in (False, True) if mesh.size(0) > 1 else (False,):
                c = shipped.replace(data=dataclasses.replace(shipped.data, batch_size=global_batch))
                got = timed_steps(with_train(c, zero1=zero1), device, mesh)
                peaks = [None] * world
                dist.all_gather_object(peaks, got["peak_gib"])
                if writer:
                    got.update(peak_gib_per_card=peaks,
                               scaling=got["pairs_per_s"] / readings["steps"]["one card, batch 32"]["pairs_per_s"])
                    label = f"{shape}, global batch {global_batch}{', zero1' if zero1 else ''}"
                    readings["steps"][label] = got
                    print(f"{tag}{label}: {got} [{card}]", flush=True)
        # 4. The CLIs on this mesh's model axis.
        if 4 in parts:
            readings["clis"][str(shape)] = run_clis(m, writer, name)
            if writer:
                print(f"{tag}{shape} CLIs: {readings['clis'][str(shape)]} [{card}]", flush=True)
    return readings


if __name__ == "__main__":
    main()

"""Where a full-width train step's time goes on the card, by ``torch.profiler``.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m edrl_tpu_torch.tools.profile_train_step [--plain] [--fused-ln] [--fused-mlp]
        [--fused-block-attention] [--model_name NAME] [--tf32] [--top N]

Builds the shipped ``EDRLConfig()`` (bf16, batch 32) with the flags given:
``--plain`` turns both fused-attention flags off, ``--fused-ln`` and
``--fused-mlp`` turn on B4 and B5, ``--fused-block-attention`` turns on B6
(which takes precedence over the fused-attention flags), ``--model_name``
picks a registry model (MedFusion by default; the CNN baselines compute in
f32), ``--tf32`` computes f32 convolutions in cuDNN's TF32
(``trainer.set_conv_precision``; the port's entry points keep them in f32), and ``--top`` prints the N kernels
that take the most device time.  With seeded
random weights it feeds the step ``trainer.random_views`` from seed 0, takes
two warm-up steps, then runs three steps without the profiler and three
under it, and prints:

- unprofiled: the step time on the host clock (to a ``synchronize()``), the
  host's enqueue time per step (the step returns before the device
  finishes) and the peak device memory of those steps;
- profiled (the profiler slows the host, not the kernels): the kernels per
  step, the device busy time per step (the union of the kernels'
  intervals) and its share of the span from the first kernel's start to
  the last kernel's end, and device time per step by category.  B5's and
  B6's products share one category (a configuration runs one or the other):
  the wgmma mainloop's ``wgmma_gemm_kernel`` (B5's single products, B6's
  forward products and its backward's Dense layers), B5's other kernels, B6's
  f32 products (``sublayer_gemm``) and the bias gradients' column partials,
  ahead of the cuBLAS row that "gemm" would otherwise match.  B4's category
  holds its row kernels and the backward's sums of dgamma/dbeta partials;
  B6's LayerNorm, forward and backward, counts there too, and its attention
  under B1/B2's.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import statistics
import subprocess
import time

import torch

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.train import trainer

STEPS = 3
# (category, substrings of a kernel name), first match wins.
CATEGORIES = (
    ("attention kernels (B1/B2 fwd)", ("attention_fwd",)),
    ("attention kernels (B1/B2 bwd)", ("attention_bwd",)),
    ("MK-MMD kernel (B3)", ("mmd_",)),
    ("LayerNorm kernels (B4 fwd/bwd)", ("layer_norm_fwd_kernel", "layer_norm_bwd_kernel",
                                        "layer_norm_bwd_sums_kernel")),
    ("B5 or B6 products (wgmma, mma.sync, f32), weight preps", (
        "fused_mlp_fwd_kernel", "mlp_fwd_fused_wgmma", "wgmma_gemm_kernel", "mlp_bwd_", "mlp_wgrad_kernel",
        "row_tile_sums_kernel", "col_partials_kernel", "transpose_bf16_kernel", "round_bf16_kernel",
        "sublayer_gemm")),
    ("partial sums (dbias, B5, B6)", ("column_sum_kernel", "column_sum4_kernel")),
    ("convolutions (cuDNN), layout changes", ("fprop", "dgrad", "wgrad", "conv", "implicit", "nchwToNhwc",
                                              "nhwcToNchw", "Nhwc", "precomputed")),
    ("pooling", ("pool",)),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sm90_", "sm80_", "cublas", "Kernel2")),
    ("Adam (multi-tensor)", ("multi_tensor", "adam", "Adam")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("softmax", ("softmax", "Softmax")),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "Copy", "cat_", "CatArray")),
    ("index/gather/scatter", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized")),
)


def _category(name: str) -> str:
    for label, keys in CATEGORIES:
        if any(k in name for k in keys):
            return label
    return "other"


def _union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def config_from_args(args) -> EDRLConfig:
    """``EDRLConfig()`` with the command line's flags."""
    flags = dict(use_fused_ln=args.fused_ln, use_fused_mlp=args.fused_mlp,
                 use_fused_block_attention=args.fused_block_attention)
    if args.plain:
        flags.update(use_fused_attention=False, vit_fused_attention=False)
    cfg = EDRLConfig()
    return cfg.replace(model=dataclasses.replace(cfg.model, model_name=args.model_name, **flags))


def _label(cfg: EDRLConfig) -> str:
    m = cfg.model
    on = [name for name, flag in (("use_fused_attention", m.use_fused_attention),
                                  ("vit_fused_attention", m.vit_fused_attention), ("use_fused_ln", m.use_fused_ln),
                                  ("use_fused_mlp", m.use_fused_mlp),
                                  ("use_fused_block_attention", m.use_fused_block_attention)) if flag]
    return f"{m.model_name}, flags on: " + (", ".join(on) or "none")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--plain", action="store_true", help="both fused-attention flags off")
    parser.add_argument("--fused-ln", action="store_true", help="use_fused_ln on (B4)")
    parser.add_argument("--fused-mlp", action="store_true", help="use_fused_mlp on (B5)")
    parser.add_argument("--fused-block-attention", action="store_true", help="use_fused_block_attention on (B6)")
    parser.add_argument("--model_name", default="MedFusion", help="a registry model (baselines.MODEL_REGISTRY)")
    parser.add_argument("--tf32", action="store_true", help="cuDNN's TF32 on for f32 convolutions")
    parser.add_argument("--top", type=int, default=0, help="print the N kernels with the most device time")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = config_from_args(args)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer.set_conv_precision(args.tf32)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    batch = trainer.random_views(cfg, seed=0)
    state = trainer.init_state(cfg, seed=0)
    train_step = trainer.make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(2):
        train_step(state, batch, gen)
    torch.cuda.synchronize()

    enqueue_ms = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        t = time.perf_counter()
        train_step(state, batch, gen)
        enqueue_ms.append(1000.0 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    wall_ms = 1000.0 * (time.perf_counter() - t0) / STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(STEPS):
            train_step(state, batch, gen)
        torch.cuda.synchronize()

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        raise SystemExit("profile_train_step: the profiler recorded no device time")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window_us = max(e for _, e in spans) - min(s for s, _ in spans)
    busy_us = _union_us(spans)
    by_cat = collections.defaultdict(float)
    for e in kernels:
        by_cat[_category(e.name)] += e.time_range.elapsed_us()
    per_step = 1000.0 * STEPS  # us over the run -> ms per step
    dtype = "bf16" if cfg.model.use_bfloat16 else "f32"
    print(f"train step, {_label(cfg)}, batch {cfg.data.batch_size} {dtype}"
          f"{', cuDNN TF32 on' if args.tf32 else ''} [{card}]")
    print(f"  unprofiled: host clock to sync {wall_ms:.3f} ms/step, host enqueue "
          f"{statistics.median(enqueue_ms):.3f} ms/step (median of {STEPS}), peak device memory {peak_gib:.2f} GiB")
    print(f"  profiled: {len(kernels) // STEPS} kernels/step; device busy {busy_us / per_step:.3f} ms/step, "
          f"{100.0 * busy_us / window_us:.1f}% of the {window_us / per_step:.3f} ms/step kernel span")
    print("  device ms/step by category:")
    for label, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"    {us / per_step:9.3f}  {label}")
    if args.top:
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in kernels:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
        print(f"  the {args.top} kernels with the most device time, ms/step (launches/step):")
        for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
            print(f"    {us / per_step:9.3f}  ({n // STEPS})  {name[:160]}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and train step on one NVIDIA GPU, and check them.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is nonzero):

1. Require CUDA; print the card's name and power limit; turn TF32 off.
2. Build the CUDA kernels from ``edrl_tpu_torch/kernels/csrc`` (one nvcc per
   source, in parallel) and print the build time and the compiler's
   register/shared-memory report; for the attention's tensor-core kernels,
   forward and backward, registers, spills, shared memory and resident
   blocks per SM at the main-path shapes (N = 144 and 216, head_dim 128);
   the same for B5's and B6's wgmma kernels, which must not spill; for B4's
   row kernels (forward, backward, residual form) at every width of the
   train step, registers, local memory, shared memory and CTAs per SM, which
   must cover the plan's waves, and no B4 kernel may spill; v1's kernels
   (the attention's, through B2's entry points with v1's strides) at N =
   144; B3's cluster kernel (registers, shared and local memory, the
   cluster's size) and its backward kernel.
3. Check each forward kernel against its plain PyTorch version at every
   serving shape (batch 16) and at the edges of its two routes (those of
   phase 7, biases with -1e9 entries), in bf16 (atol 3e-2) and f32 (atol
   1e-4), each call counted under the route the Python mirror predicts,
   which must be the C entry points' choice.
4. Serve three uint8 requests (16, 5 and 40 pairs) with a full-width
   ``Predictor`` (``EDRLConfig()`` defaults, seeded random weights) and
   check the probabilities and that each forward kernel ran 12 times per
   batch.
5. Compare the serving kernel path with the plain path (both fused flags
   off) on the same weights, in bf16 (2e-2) and f32 (1e-4), and a small f32
   model on the card against the same model on the CPU (1e-4).
6. Time each forward kernel against its plain version at the serving
   shapes, and the full-width forward at batch 16 on both paths.
7. Check the forward kernels (the bars of phase 3), the backward kernels
   (B1, B2) and the MK-MMD kernels (B3, forward and backward) against
   their plain versions at every train-step shape of batch 32 (B2 also at
   N = 216, W = 1, as the fused attention sublayer calls it) and at the
   edges of the backward's two routes (bf16 takes the tensor cores at
   head_dim % 16 == 0 and N <= 224): N = 224 and 225, N = 1, 17 and 145,
   head_dim 16, 8 and 24, N = 240, biases with -1e9 entries; in bf16 and
   f32, each call counted under the route the Python mirror predicts, which
   must be the C entry points' choice.  Bars, relative to the largest
   magnitude of the plain result: 1e-2 for bf16 results, 1e-4 for f32
   results and dbias; MK-MMD rtol 1e-4.  dqkv and dbias the same bit for bit
   over two launches at a Swin train shape.  B3 forward and backward against
   ``mk_mmd`` and ``mk_mmd_bwd_reference`` at the main shape, n_s != n_t, n = 2
   and odd n, d % 128 != 0, two rows equal and an n above the cluster route's
   limit (the split route): value rtol 1e-4, gradients 1e-4 of their largest
   magnitude, both the same bit for bit over two runs, each call counted
   under the route the Python mirror predicts, which must be the C entry
   point's choice.
8. Train three full-width steps (``EDRLConfig()``: bf16, both fused flags,
   batch 32, seeded weights) on ready-made f32 views from numpy seed 0, and
   check finite losses, changed parameters and BN statistics, and 24
   launches per step of each attention kernel, forward and backward, every
   forward and backward launch on the tensor-core route.  Then
   one step with ``use_pallas_mmd`` against the same step with the plain
   MMD, in bf16 and in f32: B3's forward and backward launched once each,
   the MMD and the loss agree (rtol 1e-4), and in f32 every gradient at
   phase 9's f32 bars.
9. One step on the kernel path against one on the plain path, same weights,
   batch and draws: in f32 loss (1e-5) and per-tensor gradients (median
   1e-3, worst 1e-2 relative to the tensor's largest gradient, key biases
   aside); in bf16 the loss (1e-2), and each of the step's 48 attention
   calls (24 of B1, 24 of B2), forward and backward, against the plain
   versions on that call's own tensors (the bars of phase 7).  The bf16
   paths' gradient errors against the f32 plain path, with DILR's loss on
   and off, are printed.  Then a small f32 model's step on the card against
   the same step on the CPU (loss 1e-4, gradients 1e-3).
10. Time the train step on both paths (interleaved), its peak device
    memory (the plain path's Swin attention rematerialised, as
    ``remat_attention`` asks), one step with ``remat`` on the kernel path
    (its loss equal to the step's without, two forward launches per
    attention call, its peak memory), and each kernel at batch 32 against
    its plain version (B1 and B2 forward also one call between two events,
    the dispatch included, with SDPA's time taken the same way), one
    PyTorch call computing the same function (``library_ms``; timed only,
    never called by the port) and its bound; B3's forward and backward
    device-only (CUDA graphs) beside runs of 10, the host enqueue and one
    empty kernel's launch.

Then the fused-LayerNorm + fused-MLP configuration (``EDRLConfig()`` with
``use_fused_ln`` and ``use_fused_mlp``), whose every backbone LayerNorm and
MLP runs through B4 and B5:

11. B4 and B5, forward and backward, against their plain versions at every
    shape of the configuration's serving (batch 16) and train step (batch
    32), and at odd shapes, in bf16 and f32 (the bars of phase 7; B5's f32
    results 2^-8, see ``MLP_F32_BAR``); B4's residual form (B6's LayerNorm
    backward) at every shape of the B6 configuration's train step and at odd
    ones; dgamma, dbeta and the weight and bias gradients the same bit for
    bit over two runs; every B5 launch counted
    under the route the Python mirror predicts (bf16 "wgmma", f32 "mma"),
    which must be the C entry point's choice; a width the kernels refuse
    raises.
12. Serve the three requests with a full-width ``Predictor`` of the
    configuration: finite probabilities; per batch 54 B4, 24 B5 (all on the
    wgmma route), 12 B1 and 12 B2 launches.
13. Train three full-width bf16 steps at batch 32: finite losses, changed
    parameters; per step 108 + 108 B4, 48 + 48 B5 (all on the wgmma route)
    and 24 of each attention kernel, forward and backward, both on the
    tensor cores.
14. One more bf16 step with every B4 and B5 call, forward and backward, held
    against the plain versions on that call's own tensors.
15. A small f32 model of the configuration (widths that route), one step on
    the card against the same step on the CPU, which replays the card's B5
    results call by call (``tools/mlp_replay.py``; the fused MLP rounds its
    activation to bf16 in f32 mode too, and the two devices round a few
    values the other way).  Each B5 result is held at ``MLP_F32_BAR``
    against the plain version on the kernel's own inputs, and against the
    witness: the plain version on the CPU step's inputs whose bf16 roundings
    that land one bf16 ulp from the card inputs' take the card inputs'
    value; each f32 B4 call of the step against its plain version (1e-4).
    Loss 1e-4, per-tensor gradient error median 1e-4 and worst 1e-2
    (phase 9's bar; a gradient that is a cancelling sum over the batch reads
    ~1e-3); every B5 launch on the mma route.  Printed: the distance to the
    plain version on the CPU's inputs without the witness, the flips, and
    the comparison without the replay.
16. Time the configuration's train step against the shipped config's
    (interleaved), both peak memories, both serving forwards, and each B4
    and B5 shape of the batch-32 step against its plain version, one
    PyTorch call (B4: ``F.layer_norm``, and the library's LayerNorm backward
    on the statistics its forward saved) and its bound; B5
    also beside the shipped ``Mlp`` (two cuBLAS Dense and the GELU, forward
    and backward through autograd), as no single call computes it, and with
    its wrappers' host enqueue time per call.  B4, and its residual form at
    the B6 configuration's shapes, with ``tools/timing.py``'s timers: the
    device-only time (a CUDA graph of 10 calls; the ``kernels`` line takes it
    for B4's kernel, plain version and library call alike) beside the
    runs-of-10 time of each, the host enqueue per call, the
    backward's row kernel and column sums (``torch.profiler``), the plan and
    the partials' bytes, which must stay within a tenth of the call's.

Then the fused attention-sublayer configuration (``EDRLConfig()`` with
``use_fused_block_attention``), whose every backbone block runs its attention
sublayer (LayerNorm, qkv, attention, proj, residual) through B6, and its
backward through B2's kernels, B6's two Dense layers' backwards and B4's
residual LayerNorm backward:

17. B6's forward and backward against their plain versions at every Swin
    and ViT shape of the configuration's serving (batch 16) and train step
    (batch 32), with a one-window bias (Wb = 1) and a per-window one (Wb =
    W), and at odd shapes (ragged M), in bf16 and f32 (the bars of phase 7,
    but a bf16 call's dbias at ``tools/sublayer_dbias.py``'s DBIAS_BAR,
    since its do rounds in another summation order, and at 1e-4 against B2's
    plain backward on the do its own product made; a control of bf16
    precision, dbias on a do truncated to bf16, must read above
    DBIAS_BAR); the products' route ("wgmma"
    for bf16, "fma" for f32) counted as the Python mirror and the C entry
    point predict; the bf16 weight and bias gradients the same bit for bit over
    two runs; the bf16 kernel against the TPU kernel's rounding order
    (scores from the f32 qkv) is printed; shapes the kernel refuses raise.
    v1 (``window_attention_fused``) against its plain versions, forward and
    backward, at the Swin train shapes and an odd one; one v1 forward and
    backward launches only v1's kernels and dbias's column sum
    (``torch.profiler``: no copy, permute or cat), and its gradients are the
    same bit for bit over two runs.
18. Serve the three requests with a full-width ``Predictor`` of the
    configuration: finite probabilities; 24 B6 launches per batch (12 Swin,
    12 ViT), all on the wgmma route, and none of B1 or B2.
19. Train three full-width bf16 steps at batch 32: finite losses, changed
    parameters; per step 48 B6 forward launches and 96 of its backward's
    Dense layers (all 144 on the wgmma route), 48 of B2's forward (the
    backward's recompute), 48 of B2's backward and 48 of B4's backward,
    none of B1; all 96 forward attention launches (B6's attention phase,
    B2) and the 48 backward ones on the tensor cores.
20. One more bf16 step with every B6 call, forward and backward, held
    against the plain versions on that call's own tensors (dbias as in 17).
21. A small f32 model of the configuration (widths that route, shifted
    blocks included), one step on the card against the same step on the
    CPU: loss 1e-4, per-tensor gradient error median 1e-4 and worst 1e-2;
    every B6 launch on the fma route.
22. Time the configuration's train step against the shipped config's
    (interleaved), both peak memories, both serving forwards; each B6 shape
    of the batch-32 step, forward and backward, against its plain version,
    its bound and the shipped sublayer at that shape (LayerNorm, Dense, B2,
    Dense; its backward through autograd), with B6's device time by phase
    (``tools/profile_sublayer.py``: LayerNorm, the qkv product, the
    attention, the proj product; the backward's); and v1's own path: one
    forward and backward at each Swin stage of a batch-32 step (its forwards
    on the tensor cores), device-only (CUDA graphs) beside runs of 10 and the
    host enqueue, against its plain version, SDPA and its bound.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script imports no JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores
BF16_ATOL, F32_ATOL = 3e-2, 1e-4
BWD_BAR = {"bf16": 1e-2, "f32": 1e-4}
MMD_RTOL = 1e-4
TRAIN_STEPS = 3
# torch.profiler now and then records no device time for a profile, at times
# three in a row in one process: each profile is taken up to this many times.
PROFILE_ATTEMPTS = 8

# B5's f32 results: the kernel and the plain version sum in other orders, so
# a value next to a bf16 rounding boundary (the activation, or dh in the
# backward) can round the other way.  That moves one term of each sum it
# enters by one bf16 ulp, 2^-8 of itself; over few terms (M = 40 rows for
# dW2) it shows as ~2e-3 of the result's largest magnitude.
MLP_F32_BAR = 2.0 ** -8
SA, V2, SA_BWD, V2_BWD, MMD, MMD_BWD = (
    "self_attention_fused", "window_attention_fused_v2", "self_attention_fused_bwd",
    "window_attention_fused_v2_bwd", "mk_mmd_fused", "mk_mmd_fused_bwd",
)
LN, LN_BWD, MLP, MLP_BWD = "fused_layer_norm", "fused_layer_norm_bwd", "fused_mlp", "fused_mlp_bwd"
# B4's backward in its residual form (B6's LayerNorm backward): its own row
# in the kernels line, its launches counted under LN_BWD by the wrapper.
LN_RES = "fused_layer_norm_bwd_residual"
B6, B6_BWD = "attention_sublayer_fused", "attention_sublayer_fused_bwd"
V1, V1_BWD = "window_attention_fused", "window_attention_fused_bwd"
# B5's bf16 (wgmma) route: the mainloop's product kernel, the fused forward
# (C = 128) and the backward's hidden kernel.
B5_WGMMA_KERNELS = ("wgmma_gemm_kernel", "mlp_fwd_fused_wgmma_kernel", "mlp_bwd_hidden_wgmma_kernel")
# B6's bf16 (wgmma) route: the mainloop's product kernel with the epilogues of
# its forward (qkv, proj) and of its backward's Dense layers (do, dxln, dW).
B6_EPILOGUES = ("BiasEpilogue", "ResidualEpilogue", "StoreEpilogue", "StoreF32Epilogue", "WgradEpilogue")
KERNEL_SOURCE = {
    SA: "edrl_tpu_torch/kernels/csrc/self_attention_fwd.cu",
    V2: "edrl_tpu_torch/kernels/csrc/window_attention_v2_fwd.cu",
    SA_BWD: "edrl_tpu_torch/kernels/csrc/self_attention_bwd.cu",
    V2_BWD: "edrl_tpu_torch/kernels/csrc/window_attention_v2_bwd.cu",
    MMD: "edrl_tpu_torch/kernels/csrc/mmd_fwd.cu",
    MMD_BWD: "edrl_tpu_torch/kernels/csrc/mmd_bwd.cu",
    LN: "edrl_tpu_torch/kernels/csrc/layer_norm_fwd.cu",
    LN_BWD: "edrl_tpu_torch/kernels/csrc/layer_norm_bwd.cu",
    LN_RES: "edrl_tpu_torch/kernels/csrc/layer_norm_bwd.cu",
    MLP: "edrl_tpu_torch/kernels/csrc/fused_mlp_fwd.cu",
    MLP_BWD: "edrl_tpu_torch/kernels/csrc/fused_mlp_bwd.cu",
    B6: "edrl_tpu_torch/kernels/csrc/attention_sublayer_fwd.cu",
    B6_BWD: "edrl_tpu_torch/kernels/csrc/attention_sublayer_bwd.cu",
    # Its forward and backward in one row, through B2's entry points
    # (window_attention_v2_bwd.cu too) with v1's strides.
    V1: "edrl_tpu_torch/kernels/csrc/window_attention_v2_fwd.cu",
}
KERNEL_REPLACES = {
    SA: "edrl_tpu/kernels/window_attention.py:571",
    V2: "edrl_tpu/kernels/window_attention.py:363",
    SA_BWD: "edrl_tpu/kernels/window_attention.py:592",
    V2_BWD: "edrl_tpu/kernels/window_attention.py:390",
    MMD: "edrl_tpu/kernels/mmd_pallas.py:68",
    # mk_mmd_pallas's custom VJP: the XLA path's VJP, one fused XLA program.
    MMD_BWD: "edrl_tpu/kernels/mmd_pallas.py:98",
    LN: "edrl_tpu/kernels/layer_norm.py:91",
    LN_BWD: "edrl_tpu/kernels/layer_norm.py:109",
    # The same Pallas backward, in the role of _v4_bwd's LayerNorm lines.
    LN_RES: "edrl_tpu/kernels/layer_norm.py:109",
    MLP: "edrl_tpu/kernels/fused_mlp.py:123",
    MLP_BWD: "edrl_tpu/kernels/fused_mlp.py:217",
    B6: "edrl_tpu/kernels/block_attention.py:141",
    # The JAX VJP (_v4_bwd): B2's Pallas kernels and products XLA runs.
    B6_BWD: "edrl_tpu/kernels/block_attention.py:208",
    V1: "edrl_tpu/kernels/window_attention.py:152,164",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flops_per_s: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and ops over peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return 1000.0 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    if not (REPO / "edrl_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py: no edrl_tpu_torch/ beside this script; run it from a checkout")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; this needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from edrl_tpu_torch.config import EDRLConfig, tiny_test_config
    from edrl_tpu_torch.kernels import block_attention as ba
    from edrl_tpu_torch.kernels import build
    from edrl_tpu_torch.kernels import fused_mlp as fm
    from edrl_tpu_torch.kernels import layer_norm as ln
    from edrl_tpu_torch.kernels import mmd as kmmd
    from edrl_tpu_torch.kernels import window_attention as wa
    from edrl_tpu_torch.models.layers import Mlp
    from edrl_tpu_torch.models.swin2d import rel_bias_from_table, relative_position_index, shift_attn_mask
    from edrl_tpu_torch.ops.mmd import mk_mmd, mk_mmd_bwd_reference, mk_mmd_grad_d2
    from edrl_tpu_torch.serve.predictor import Predictor
    from edrl_tpu_torch.tools import mlp_replay as mr
    from edrl_tpu_torch.tools import profile_layer_norm as pln
    from edrl_tpu_torch.tools import profile_sublayer as psl
    from edrl_tpu_torch.tools import profile_v1_mmd as pv
    from edrl_tpu_torch.tools import sublayer_dbias as sd
    from edrl_tpu_torch.tools.timing import enqueue_ms, graph_ms, runs_ms
    from edrl_tpu_torch.train import trainer

    def reset_counts():
        for module in (wa, kmmd, ln, fm, ba):
            module.reset_launch_counts()

    def counts():
        return {**wa.LAUNCHES, **kmmd.LAUNCHES, **ln.LAUNCHES, **fm.LAUNCHES, **ba.LAUNCHES}

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.relative_to(REPO)}", flush=True)
    log = lib_path.with_suffix(".log")
    if log.exists():
        # ptxas: registers per entry, and every entry that spills.
        entry, regs, spills = None, {}, []
        for line in log.read_text().splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "registers" in line and entry:
                regs[entry] = int(line.split("Used ")[1].split(" registers")[0])
            elif "spill stores" in line and entry and int(line.split(" bytes spill stores")[0].split()[-1]):
                spills.append(f"{entry}: {line.strip()}")
        print(f"  ptxas: {len(regs)} entries, registers {min(regs.values())}..{max(regs.values())}; "
              f"{len(spills)} spill", flush=True)
        for line in spills:
            print(f"  ptxas spill: {line}")
        for kernel in ("attention_fwd_tc_kernel", "attention_bwd_dq_mma_kernel", "attention_bwd_dkv_mma_kernel",
                       *B5_WGMMA_KERNELS):
            found = [r for e, r in regs.items() if kernel in e]
            print(f"  ptxas {kernel}: registers {found}, "
                  f"spilling: {[line for line in spills if kernel in line] or 'none'}", flush=True)
        check(not [line for line in spills for k in B5_WGMMA_KERNELS if k in line], "B5's wgmma kernels spill")
        for epilogue in B6_EPILOGUES:
            found = [r for e, r in regs.items() if "wgmma_gemm_kernel" in e and epilogue in e]
            print(f"  ptxas B6 wgmma_gemm_kernel<{epilogue}>: registers {found}, spilling: "
                  f"{[line for line in spills if 'wgmma_gemm_kernel' in line and epilogue in line] or 'none'}",
                  flush=True)
            check(bool(found), f"ptxas reported no wgmma_gemm_kernel<{epilogue}>")
    # The attention's tensor-core kernels at the main-path shapes: resident
    # blocks per SM (occupancy calculator) and shared memory.
    import ctypes

    bwd_lib = build.load_library()
    for label, n_fwd, with_bias in (("B1, N=216", 216, 0), ("B2, N=144", 144, 1),
                                    ("B2 and B6's attention phase, N=216", 216, 1)):
        occ = (ctypes.c_int * 3)()
        check(bwd_lib.edrl_attention_fwd_occupancy(1, n_fwd, 128, with_bias, occ) == 0, "occupancy query")
        print(f"  attention fwd tensor cores, {label}, head_dim 128: {occ[0]} blocks of {occ[2]} warps per SM "
              f"({occ[0] * occ[2]} warps), {occ[1]} bytes of shared memory per block", flush=True)
    for label, n_bwd, with_dbias in (("B1, N=216", 216, 0), ("B2, N=144", 144, 1), ("B2 under B6, N=216", 216, 1)):
        occ = (ctypes.c_int * 4)()
        check(bwd_lib.edrl_attention_bwd_occupancy(1, n_bwd, 128, with_dbias, occ) == 0, "occupancy query")
        print(f"  attention bwd tensor cores, {label}, head_dim 128: dq kernel {occ[0]} blocks per SM "
              f"({4 * occ[0]} warps), {occ[2]} bytes of shared memory; dk/dv kernel {occ[1]} blocks per SM "
              f"({4 * occ[1]} warps), {occ[3]} bytes", flush=True)
    # v1 runs the same device code through B2's entry points with its own
    # strides: its kernels at the Swin stages' shape.
    occ = (ctypes.c_int * 4)()
    check(bwd_lib.edrl_attention_fwd_occupancy(1, 144, 128, 1, occ) == 0, "occupancy query")
    print(f"  v1 fwd tensor cores, N=144, head_dim 128: {occ[0]} blocks of {occ[2]} warps per SM, {occ[1]} bytes of "
          f"shared memory per block", flush=True)
    check(bwd_lib.edrl_attention_bwd_occupancy(1, 144, 128, 1, occ) == 0, "occupancy query")
    print(f"  v1 bwd tensor cores, N=144, head_dim 128: dq kernel {occ[0]} blocks per SM, {occ[2]} bytes; dk/dv "
          f"kernel {occ[1]} blocks per SM, {occ[3]} bytes", flush=True)
    if log.exists():
        for kernel in ("attention_fwd_tc_kernel", "attention_bwd_dq_mma_kernel", "attention_bwd_dkv_mma_kernel",
                       "mmd_cluster_kernel", "mmd_bwd_kernel", "mmd_gram_partial_kernel"):
            found = sorted({r for e, r in regs.items() if kernel in e})
            check(bool(found), f"ptxas reported no {kernel}")
            print(f"  ptxas {kernel} (every source that instantiates it): registers {found}, spilling: "
                  f"{[line for line in spills if kernel in line] or 'none'}", flush=True)
    # B3: the cluster kernel's and the backward's registers, shared and local
    # memory, CTAs per SM; the cluster's size.
    occ = (ctypes.c_int * 8)()
    check(bwd_lib.edrl_mk_mmd_fwd_attributes(occ) == 0, "B3 forward attributes query")
    print(f"  B3 fwd cluster kernel: {occ[0]} registers, {occ[1]} bytes of static shared memory, {occ[2]} bytes of "
          f"local memory, {occ[3]} threads per CTA, one CTA per SM; a cluster of {occ[7]} CTAs; the split "
          f"route's Gram-partial kernel {occ[4]} registers, {occ[5]} bytes of shared memory, {occ[6]} of local "
          f"memory", flush=True)
    occ = (ctypes.c_int * 4)()
    check(bwd_lib.edrl_mk_mmd_bwd_attributes(64, occ) == 0, "B3 backward attributes query")
    print(f"  B3 bwd kernel at n = 64: {occ[0]} registers, {occ[1]} bytes of local memory, {occ[2]} bytes of dynamic "
          f"shared memory, {occ[3]} CTAs per SM", flush=True)
    # B5's wgmma route: CTAs per SM (occupancy calculator) and shared memory.
    occ = (ctypes.c_int * 7)()
    check(bwd_lib.edrl_fused_mlp_fwd_occupancy(occ) == 0, "B5 forward occupancy query")
    print(f"  B5 fwd wgmma, CTAs of {occ[6]} threads: first and second product (C >= 256) {occ[0]} and {occ[2]} "
          f"per SM, {occ[1]} bytes of dynamic shared memory each; fused kernel (C = 128) {occ[4]} per SM, "
          f"{occ[5]} bytes", flush=True)
    occ = (ctypes.c_int * 5)()
    check(bwd_lib.edrl_fused_mlp_bwd_occupancy(occ) == 0, "B5 backward occupancy query")
    print(f"  B5 bwd wgmma: hidden kernel {occ[0]} CTA per SM, {occ[1]} bytes; du and weight-gradient products "
          f"{occ[2]} and {occ[3]} CTAs per SM, {occ[4]} bytes each", flush=True)
    occ = (ctypes.c_int * 4)()
    check(bwd_lib.edrl_attention_sublayer_fwd_occupancy(occ) == 0, "B6 forward occupancy query")
    print(f"  B6 fwd wgmma, CTAs of {occ[3]} threads: qkv and proj products {occ[0]} and {occ[1]} per SM, {occ[2]} "
          f"bytes of dynamic shared memory each", flush=True)
    check(bwd_lib.edrl_attention_sublayer_bwd_occupancy(occ) == 0, "B6 backward occupancy query")
    print(f"  B6 bwd wgmma: do and dxln products (bf16, f32 out) {occ[0]} and {occ[1]} CTAs per SM, weight "
          f"gradients {occ[2]}, {occ[3]} bytes each", flush=True)
    # B4's row kernels at the train step's widths: the occupancy calculator's
    # CTAs per SM must cover the plan's waves (a plan for one SM and many
    # rows is one SM's share of a wave), and local memory must be 0.
    if log.exists():
        ln_regs = sorted(r for e, r in regs.items() if "layer_norm" in e)
        check(bool(ln_regs), "ptxas reported no B4 kernel")
        print(f"  ptxas B4: {len(ln_regs)} entries, registers {ln_regs[0]}..{ln_regs[-1]}, "
              f"spilling: {[line for line in spills if 'layer_norm' in line] or 'none'}", flush=True)
        check(not [line for line in spills if "layer_norm" in line], "B4's kernels spill")
    occ = (ctypes.c_int * 5)()
    ln_widths = {c_ for _, c_ in pln.ln_shapes(EDRLConfig())} | {c_ for _, c_ in pln.residual_shapes(EDRLConfig())}
    for c_ in sorted(ln_widths):
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = int(dtype == torch.bfloat16)
            for kind, query in (("forward", lambda: bwd_lib.edrl_layer_norm_fwd_occupancy(c_, bf16, occ)),
                                ("backward", lambda: bwd_lib.edrl_layer_norm_bwd_occupancy(c_, bf16, 0, occ)),
                                ("residual", lambda: bwd_lib.edrl_layer_norm_bwd_occupancy(c_, bf16, 1, occ))):
                check(query() == 0, f"B4 {kind} occupancy query")
                waves = ln.layer_norm_plan(10 ** 7, c_, dtype, 1, kind).ctas
                if bf16:
                    print(f"  B4 {kind} bf16 C={c_}: {occ[0]} CTAs of {occ[1]} threads per SM (plan: {waves}), "
                          f"{occ[3]} registers, {occ[2]} bytes of shared memory, {occ[4]} bytes of local memory",
                          flush=True)
                check(occ[4] == 0 and occ[0] >= waves, f"B4 {kind} {dtype} C={c_}: {list(occ)}, plan's waves {waves}")

    # -- 3. forward kernels against their plain versions --------------------
    cfg = EDRLConfig()
    mc = cfg.model
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def swin_bias(grid, window, heads, shifted):
        table = torch.randn(((2 * window - 1) ** 2, heads), generator=gen, device=dev) * 0.02
        index = torch.as_tensor(relative_position_index(window), device=dev)
        bias = rel_bias_from_table(table, index, heads, torch.bfloat16)
        w = (grid // window) ** 2
        full = bias[None].expand(w, heads, window * window, window * window)
        if shifted:
            full = full + torch.as_tensor(shift_attn_mask(grid, window, window // 2), device=dev)[:, None]
        return full.contiguous()

    def attention_shapes(b):
        """(ViT shape, Swin shapes) of one forward at batch b, with calls per forward."""
        vit = dict(b=b, n=mc.oct_tokens, c=mc.oct_embed_dim, heads=mc.vit3d_heads, calls=mc.vit3d_depth)
        swin = []
        grid, dim = cfg.data.fundus_size // 4, mc.swin_embed_dim
        for depth, heads in zip(mc.swin_depths, mc.swin_heads):
            window = min(mc.swin_window, grid)
            swin.append(dict(b=b, grid=grid, window=window, c=dim, heads=heads,
                             shifted=window < grid, calls=depth))
            grid, dim = grid // 2, dim * 2
        return vit, swin

    b = cfg.data.eval_batch_size
    vit_shape, swin_shapes = attention_shapes(b)
    c_vit, h_vit = mc.oct_embed_dim, mc.vit3d_heads
    max_err = {name: 0.0 for name in KERNEL_SOURCE}

    def compare(name, label, dtype, got, want):
        err = (got.float() - want.float()).abs().max().item()
        atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
        print(f"check {name} {label} {str(dtype)[6:]}: max_abs_err {err:.3e} (atol {atol:g})", flush=True)
        check(err <= atol and got.dtype == dtype, f"{name} {label} {dtype}: err {err}")
        if dtype == torch.bfloat16:
            max_err[name] = max(max_err[name], err)

    def vit_inputs(s, dtype):
        shape = (s["b"], s["n"], s["c"])
        return normal(shape, dtype), normal(shape, dtype), normal(shape, dtype)

    def swin_inputs(s, dtype):
        n = s["window"] ** 2
        w = (s["grid"] // s["window"]) ** 2
        qkv = normal((s["b"], w, n, 3 * s["c"]), dtype)
        return qkv, swin_bias(s["grid"], s["window"], s["heads"], s["shifted"])

    def routed(name, label, dtype, n_, d_, launch, kind="bwd"):
        """Run ``launch`` (one forward or backward call) and check that it
        counted under the route attention_fwd_route / attention_bwd_route
        predicts, which must be the route the C entry points pick
        (edrl_attention_fwd_route / edrl_attention_bwd_route)."""
        py_route, c_route, routes = {
            "fwd": (wa.attention_fwd_route, bwd_lib.edrl_attention_fwd_route, wa.FWD_ROUTES),
            "bwd": (wa.attention_bwd_route, bwd_lib.edrl_attention_bwd_route, wa.BWD_ROUTES),
        }[kind]
        route = py_route(dtype, n_, d_)
        c_route = {1: "mma", 0: "fma"}[c_route(int(dtype == torch.bfloat16), n_, d_)]
        check(route == c_route, f"{name} {label}: Python route {route}, C route {c_route}")
        wa.reset_launch_counts()
        out = launch()
        check(routes == {r: int(r == route) for r in routes},
              f"{name} {label}: {kind} routes {routes}, expected one launch on {route}")
        return out, route

    def sa_fwd_case(q, k, v, heads, dtype, label):
        scale = (q.shape[2] // heads) ** -0.5
        got, route = routed(SA, label, dtype, q.shape[1], q.shape[2] // heads,
                            lambda: wa.self_attention_fused(q, k, v, heads, scale), kind="fwd")
        compare(SA, f"{label} {route}", dtype, got, wa.self_attention_reference(q, k, v, heads, scale))

    def v2_fwd_case(qkv, bias, heads, dtype, label):
        c_ = qkv.shape[3] // 3
        scale = (c_ // heads) ** -0.5
        got, route = routed(V2, label, dtype, qkv.shape[2], c_ // heads,
                            lambda: wa.window_attention_fused_v2(qkv, bias, heads, scale), kind="fwd")
        compare(V2, f"{label} {route}", dtype, got, wa.window_attention_v2_reference(qkv, bias, heads, scale))

    # The routes' edges, (shape, heads), forward and backward: N = 224 (tensor
    # cores) and 225 (CUDA cores in bf16 too), N = 1, 17 and 145 (ragged
    # tails), head_dim 16 (tensor cores), 8 and 24 (CUDA cores), N = 240.
    sa_edges = (((2, 224, 128), 1), ((2, 225, 128), 1), ((2, 1, 32), 2), ((3, 17, 32), 2), ((2, 145, 256), 2),
                ((3, 16, 32), 2), ((2, 40, 16), 2), ((2, 40, 48), 2), ((2, 240, 128), 1))
    v2_edges = (((2, 1, 224, 384), 1), ((2, 1, 225, 384), 1), ((2, 3, 1, 96), 2), ((3, 2, 17, 96), 2),
                ((2, 2, 145, 384), 1), ((3, 2, 16, 96), 2), ((2, 2, 16, 48), 2), ((2, 1, 40, 144), 2),
                ((2, 1, 240, 48), 2))

    def edge_bias(shape, heads):
        bias = torch.randn((shape[1], heads, shape[2], shape[2]), generator=gen, device=dev)
        bias[..., 1::3] = -1e9
        return bias

    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            sa_fwd_case(*vit_inputs(vit_shape, dtype), h_vit, dtype, f"[{b},{mc.oct_tokens},{c_vit}]x{h_vit}")
            for s in swin_shapes:
                qkv, bias = swin_inputs(s, dtype)
                v2_fwd_case(qkv, bias, s["heads"], dtype, f"{list(qkv.shape)} H={s['heads']} shifted={s['shifted']}")
            for shape, heads in sa_edges:
                sa_fwd_case(*(normal(shape, dtype) for _ in range(3)), heads, dtype, f"{list(shape)}x{heads} (edge)")
            for shape, heads in v2_edges:
                v2_fwd_case(normal(shape, dtype), edge_bias(shape, heads), heads, dtype,
                            f"{list(shape)} H={heads} -1e9 bias (edge)")
    torch.cuda.synchronize()

    # -- 4. the serving path at full width ---------------------------------
    check(mc.use_bfloat16 and mc.use_fused_attention and mc.vit_fused_attention,
          "shipped config has bf16 and both fused flags on")
    t0 = time.perf_counter()
    pred = Predictor(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"predictor: {n_params} parameters, built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    d = cfg.data
    requests = [
        (rng.integers(0, 256, (n, d.fundus_size, d.fundus_size, 3), dtype=np.uint8),
         rng.integers(0, 256, (n, *d.oct_size, 1), dtype=np.uint8))
        for n in (16, 5, 40)
    ]
    reset_counts()
    outputs = [pred.predict_probs(f, o) for f, o in requests]
    serve_launches = counts()
    batches = sum(-(-len(f) // cfg.data.eval_batch_size) for f, _ in requests)
    for (f, _), p in zip(requests, outputs):
        check(p.shape == (len(f), mc.num_classes), f"probs shape {p.shape}")
        check(bool(np.isfinite(p).all()), "probs finite")
        check(bool(np.allclose(p.sum(-1), 1.0, atol=1e-5)), "probs rows sum to 1")
        print(f"request {len(f)} pairs -> probs {p.shape}, first row {p[0].tolist()}", flush=True)
    expected = 12 * batches
    print(f"serving launches over {batches} batches: {serve_launches} (expected {expected} "
          f"for each forward kernel, 0 for the others)", flush=True)
    for name, count in serve_launches.items():
        check(count == (expected if name in (SA, V2) else 0),
              f"{name} launched {count} times while serving")

    # -- 5. serving kernel path against the plain path ----------------------
    def plain_cfg(c):
        return c.replace(model=dataclasses.replace(
            c.model, use_fused_attention=False, vit_fused_attention=False))

    f16, o16 = requests[0]
    for label, bf16 in (("bf16", True), ("f32", False)):
        kcfg = cfg.replace(model=dataclasses.replace(mc, use_bfloat16=bf16))
        kpred = pred if bf16 else Predictor(kcfg, device=dev, seed=0)
        ppred = Predictor(plain_cfg(kcfg), device=dev, seed=0)
        ppred.model.load_state_dict(kpred.model.state_dict())
        delta = float(np.abs(kpred.predict_probs(f16, o16) - ppred.predict_probs(f16, o16)).max())
        limit = 2e-2 if bf16 else 1e-4
        print(f"full width {label}: max |dprobs| kernel vs plain path {delta:.3e} (limit {limit:g})", flush=True)
        check(delta <= limit, f"{label} kernel path vs plain path: {delta}")
        if bf16:
            plain_pred = ppred
        else:
            del kpred, ppred

    # The port on the card against the same port on the CPU, small f32 model.
    # vit3d_heads 2: the kernels take head_dim % 8 == 0 (48 / 2 = 24).
    tcfg = tiny_test_config(batch_size=4)
    tcfg = tcfg.replace(model=dataclasses.replace(
        tcfg.model, use_fused_attention=True, vit_fused_attention=True, vit3d_heads=2))
    gpu_small = Predictor(tcfg, device=dev, seed=0)
    cpu_small = Predictor(tcfg, device="cpu", seed=0)
    cpu_small.model.load_state_dict({k: v.cpu() for k, v in gpu_small.model.state_dict().items()})
    td = tcfg.data
    sf = rng.integers(0, 256, (6, td.fundus_size, td.fundus_size, 3), dtype=np.uint8)
    so = rng.integers(0, 256, (6, *td.oct_size, 1), dtype=np.uint8)
    u = [rng.uniform(size=(4, tcfg.model.num_classes, tcfg.model.z_dim)) for _ in range(2)]
    gpu_small.guided_uniform = tuple(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in u)
    cpu_small.guided_uniform = tuple(torch.as_tensor(x, dtype=torch.float32) for x in u)
    # EPRL noise reaches only the losses, so the probabilities need no shared draw.
    delta = float(np.abs(gpu_small.predict_probs(sf, so) - cpu_small.predict_probs(sf, so)).max())
    print(f"small f32 model, card vs CPU: max |dprobs| {delta:.3e} (limit 1e-4)", flush=True)
    check(delta <= 1e-4, f"small model card vs CPU: {delta}")
    del gpu_small, cpu_small

    # -- 6. serving timings ---------------------------------------------------
    with torch.inference_mode():
        q, k, v = vit_inputs(vit_shape, torch.bfloat16)
        scale = (c_vit // h_vit) ** -0.5
        tk = runs_ms(lambda: wa.self_attention_fused(q, k, v, h_vit, scale))
        tp = runs_ms(lambda: wa.self_attention_reference(q, k, v, h_vit, scale))
        print(f"time {SA} [{b},{mc.oct_tokens},{c_vit}]x{h_vit} bf16: kernel {tk:.4f} ms, "
              f"plain {tp:.4f} ms per call, x{vit_shape['calls']} per forward [{card}]", flush=True)
        for s in swin_shapes:
            qkv, bias = swin_inputs(s, torch.bfloat16)
            scale = (s["c"] // s["heads"]) ** -0.5
            tk = runs_ms(lambda: wa.window_attention_fused_v2(qkv, bias, s["heads"], scale))
            tp = runs_ms(lambda: wa.window_attention_v2_reference(qkv, bias, s["heads"], scale))
            print(f"time {V2} {list(qkv.shape)} H={s['heads']} bf16: kernel {tk:.4f} ms, "
                  f"plain {tp:.4f} ms per call, x{s['calls']} per forward [{card}]", flush=True)

        f_dev = pred._to_device(f16)
        o_dev = pred._to_device(o16)
        fwd = {}
        for label, p in (("plain", plain_pred), ("kernel", pred), ("kernel", pred), ("plain", plain_pred)):
            fwd.setdefault(label, []).append(runs_ms(lambda: p._forward(f_dev, o_dev), launches=1))
        for label in ("kernel", "plain"):
            ms = statistics.median(fwd[label])
            print(f"time full-width forward, {label} path, batch {b} bf16: {ms:.3f} ms/batch, "
                  f"{1000.0 * b / ms:.1f} pairs/s (runs {fwd[label]}) [{card}]", flush=True)
    t_req = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred.predict_probs(f16, o16)
        t_req.append(1000.0 * (time.perf_counter() - t0))
    print(f"time predict_probs, 16-pair uint8 request, host clock: median {statistics.median(t_req):.3f} ms "
          f"[{card}]", flush=True)
    del pred, plain_pred
    torch.cuda.empty_cache()

    # -- 7. backward and MK-MMD kernels against their plain versions ----------
    bt = cfg.data.batch_size
    train_vit, train_swin = attention_shapes(bt)

    def rel_err(got, want):
        return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()

    def compare_grads(name, label, dtype, got, want, dbias=None, main_path=True):
        """got/want: tuples of gradients in dtype; dbias: optional (got, want) f32."""
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        pairs = [(g, w, BWD_BAR[kind]) for g, w in zip(got, want)]
        if dbias is not None:
            pairs.append((*dbias, BWD_BAR["f32"]))
        for g, w, bar in pairs:
            err, rel = (g.float() - w.float()).abs().max().item(), rel_err(g, w)
            check(rel <= bar, f"{name} {label} {kind}: relative error {rel} over {bar}")
            if dtype == torch.bfloat16 and main_path:
                max_err[name] = max(max_err[name], err)
        worst = max(rel_err(g, w) for g, w, _ in pairs)
        print(f"check {name} {label} {kind}: worst relative error {worst:.3e} "
              f"(bars {BWD_BAR[kind]:g} / dbias {BWD_BAR['f32']:g})", flush=True)

    def sa_bwd_case(shape, heads, dtype, main_path=False):
        q, k, v, do = (normal(shape, dtype) for _ in range(4))
        scale = (shape[2] // heads) ** -0.5
        label = f"{list(shape)}x{heads}" + ("" if main_path else " (edge)")
        if main_path:
            with torch.no_grad():
                sa_fwd_case(q, k, v, heads, dtype, label)
        got, route = routed(SA_BWD, label, dtype, shape[1], shape[2] // heads,
                            lambda: wa.self_attention_bwd_kernel(q, k, v, do, heads, scale))
        want = wa.self_attention_bwd_reference(q, k, v, do, heads, scale)
        compare_grads(SA_BWD, f"{label} {route}", dtype, got, want, main_path=main_path)

    def v2_bwd_case(qkv, bias, heads, dtype, label, main_path=False, twice=False):
        if main_path:
            with torch.no_grad():
                v2_fwd_case(qkv, bias, heads, dtype, label)
        do = normal((*qkv.shape[:3], qkv.shape[3] // 3), dtype)
        scale = (qkv.shape[3] // 3 // heads) ** -0.5
        (dqkv, dbias), route = routed(V2_BWD, label, dtype, qkv.shape[2], qkv.shape[3] // 3 // heads,
                                      lambda: wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, scale))
        want_dqkv, want_dbias = wa.window_attention_v2_bwd_reference(qkv, bias, do, heads, scale)
        compare_grads(V2_BWD, f"{label} {route}", dtype, (dqkv,), (want_dqkv,), (dbias, want_dbias),
                      main_path=main_path)
        if twice:
            again = wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, scale)
            same = torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)
            print(f"check {V2_BWD} {label} {route}: dqkv and dbias the same bit for bit over two launches: "
                  f"{same}", flush=True)
            check(same, f"{V2_BWD} {label}: two launches differ")

    for dtype in (torch.bfloat16, torch.float32):
        sa_bwd_case((bt, mc.oct_tokens, c_vit), h_vit, dtype, main_path=True)
        for i, s in enumerate(train_swin):
            qkv, bias = swin_inputs(s, dtype)
            v2_bwd_case(qkv, bias, s["heads"], dtype, f"{list(qkv.shape)} H={s['heads']} shifted={s['shifted']}",
                        main_path=True, twice=i == 1)
            del qkv, bias
        # B2 as the fused attention sublayer calls it for the ViT: N = 216, W = 1, zero bias.
        v2_bwd_case(normal((bt, 1, mc.oct_tokens, 3 * c_vit), dtype),
                    torch.zeros((1, h_vit, mc.oct_tokens, mc.oct_tokens), device=dev), h_vit, dtype,
                    f"[{bt},1,{mc.oct_tokens},{3 * c_vit}] H={h_vit} zero bias (B6's ViT)", main_path=True)
        torch.cuda.empty_cache()
        for shape, heads in sa_edges:
            sa_bwd_case(shape, heads, dtype)
        for shape, heads in v2_edges:
            v2_bwd_case(normal(shape, dtype), edge_bias(shape, heads), heads, dtype,
                        f"{list(shape)} H={heads} -1e9 bias (edge)")
    # B3, forward and backward, against mk_mmd and mk_mmd_bwd_reference: the
    # main shape; n_s != n_t; n = 2 and odd n; d % 128 != 0; two rows equal
    # (an exact-0 distance off the diagonal); n above the cluster route's
    # limit (the split route).  Value rtol 1e-4, gradients 1e-4 of their
    # largest magnitude; both the same bit for bit over two runs.
    feat_dim = mc.fundus_embed_dim * 3

    def mmd_case(n_s, n_t, dd, duplicate=False):
        src = normal((n_s, dd), torch.float32)
        tgt = normal((n_t, dd), torch.float32) * 1.1 + 0.05
        if duplicate:
            tgt[1] = src[0]
        grad = torch.tensor(0.7, device=dev)
        route = kmmd.mk_mmd_route(n_s + n_t)
        c_route = {1: "cluster", 0: "split"}[bwd_lib.edrl_mk_mmd_route(n_s + n_t)]
        check(route == c_route, f"{MMD} n={n_s + n_t}: Python route {route}, C route {c_route}")
        kmmd.reset_launch_counts()
        value, state = kmmd.mk_mmd_fwd_kernel(src, tgt)
        grads = kmmd.mk_mmd_bwd_kernel(src, tgt, state, grad)
        check(kmmd.LAUNCHES == {MMD: 1, MMD_BWD: 1} and kmmd.MMD_ROUTES[route] == 1,
              f"{MMD} n={n_s + n_t}: launches {kmmd.LAUNCHES}, routes {kmmd.MMD_ROUTES}")
        got, want = value.item(), mk_mmd(src, tgt).item()
        err = abs(got - want)
        plain = mk_mmd_bwd_reference(src, tgt, grad)
        scale = max(p_.abs().max().item() for p_ in plain)
        if n_s + n_t == 2:
            # One distance sets the bandwidth, so the MMD does not move with
            # the inputs and its gradient is 0 but for rounding (the direct
            # term and the bandwidth's cancel): held relative to the direct
            # term's gradient, 2 |g| rowsum|H_direct| max|x|.
            _, total, direct = mk_mmd_grad_d2(src, tgt)
            scale = (2 * abs(grad.item()) * (direct + direct.T).abs().sum(dim=1).max().item()
                     * total.abs().max().item())
        gerr = max((g - p_).abs().max().item() for g, p_ in zip(grads, plain))
        again = kmmd.mk_mmd_fwd_kernel(src, tgt)
        same = (torch.equal(again[0], value) and torch.equal(again[1], state)
                and all(torch.equal(a, g) for a, g in zip(kmmd.mk_mmd_bwd_kernel(src, tgt, state, grad), grads)))
        label = f"[{n_s},{dd}]+[{n_t},{dd}]" + (" two rows equal" if duplicate else "")
        print(f"check {MMD} {label} f32, {route} route: {got:.7g} vs plain {want:.7g}, abs err {err:.3e} (rtol "
              f"{MMD_RTOL:g}); {MMD_BWD}: worst gradient error {gerr / max(scale, 1e-30):.3e} of the largest magnitude "
              f"{scale:.3e} (bar {MMD_RTOL:g}); value, state and gradients the same bit for bit over two runs: "
              f"{same}", flush=True)
        check(err <= MMD_RTOL * abs(want) + 1e-7, f"{MMD} {label}: {got} vs {want}")
        check(gerr <= MMD_RTOL * scale, f"{MMD_BWD} {label}: gradient error {gerr} of {scale}")
        check(same, f"{MMD} {label}: two runs differ")
        if (n_s, n_t, dd, duplicate) == (bt, bt, feat_dim, False):
            max_err[MMD], max_err[MMD_BWD] = err, gerr

    for n_s, n_t, dd, duplicate in ((bt, bt, feat_dim, False), (bt, bt, feat_dim, True), (40, 24, feat_dim, False),
                                    (1, 1, 130, False), (3, 4, 7, False), (16, 16, 200, False),
                                    (70, 50, 129, False)):
        mmd_case(n_s, n_t, dd, duplicate)
    torch.cuda.synchronize()

    # -- 8. the train step at full width ------------------------------------
    check(cfg.data.batch_size == 32, "shipped train batch is 32")
    batch = trainer.random_views(cfg, seed=0, device=dev)

    t0 = time.perf_counter()
    state = trainer.init_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"train state: {sum(p.numel() for p in state.model.parameters())} parameters, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    train_step = trainer.make_train_step(cfg)

    def seeded(seed):
        """The step's noise generator; one seed gives both paths of a pair the same draws."""
        return torch.Generator(device=dev).manual_seed(seed)

    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    gen_train = seeded(1)
    reset_counts()
    outs = [train_step(state, batch, gen_train) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_launches = counts()
    train_routes = dict(wa.BWD_ROUTES)
    train_fwd_routes = dict(wa.FWD_ROUTES)
    for i, out in enumerate(outs):
        loss, mmd_v = out["loss"].item(), out["mmd"].item()
        print(f"train step {i}: loss {loss:.6f}, mmd {mmd_v:.6f}, ce {out['ce_loss'].item():.6f}, "
              f"dilr {out['dilr_loss'].item():.6f}", flush=True)
        check(np.isfinite(loss) and np.isfinite(mmd_v), f"step {i}: loss {loss}, mmd {mmd_v}")
        check(tuple(out["probs"].shape) == (bt, mc.num_classes), "train probs shape")
    after = state.model.state_dict()
    changed = sum(not torch.equal(before[n], after[n]) for n, _ in state.model.named_parameters())
    n_tensors = sum(1 for _ in state.model.parameters())
    print(f"parameters changed: {changed} of {n_tensors} tensors", flush=True)
    check(changed >= n_tensors - 4, f"only {changed} of {n_tensors} parameter tensors changed")
    for bn in ("dilr.bn1", "dilr.bn2"):
        for stat in ("running_mean", "running_var"):
            check(not torch.equal(before[f"{bn}.{stat}"], after[f"{bn}.{stat}"]), f"{bn}.{stat} unchanged")
    del before, after
    per_step = 2 * 12
    print(f"train launches over {TRAIN_STEPS} steps: {train_launches} (expected {per_step} per step "
          f"for each attention kernel, 0 for {MMD})", flush=True)
    for name in (SA, V2, SA_BWD, V2_BWD):
        check(train_launches[name] == per_step * TRAIN_STEPS,
              f"{name} launched {train_launches[name]} times in {TRAIN_STEPS} steps")
    check(train_launches[MMD] == train_launches[MMD_BWD] == 0, "B3 is off in the shipped config")

    def check_routes(label, routes, launches, kind="backward"):
        print(f"{label}: {kind} launches by route {routes} (expected {launches} on the tensor cores, "
              f"none on the CUDA cores)", flush=True)
        check(routes == {"mma": launches, "fma": 0}, f"{label}: {kind} routes {routes}")

    check_routes(f"train, {TRAIN_STEPS} steps", train_routes, 2 * per_step * TRAIN_STEPS)
    check_routes(f"train, {TRAIN_STEPS} steps", train_fwd_routes, 2 * per_step * TRAIN_STEPS, "forward")
    del state
    torch.cuda.empty_cache()

    # One step through B3 against the same step with the plain MMD (same
    # weights, batch and draws), in the shipped config (bf16) and in f32:
    # one forward and one backward launch of B3 a step; the MMD and the loss
    # at rtol 1e-4; in f32 every gradient at phase 9's f32 bars (the two steps
    # differ only in the MMD's f32 gradient; in bf16 its last bits flip bf16
    # roundings downstream, so the bf16 gradients are printed, not held).
    for label, bf16 in (("bf16", True), ("f32", False)):
        c = cfg.replace(model=dataclasses.replace(mc, use_bfloat16=bf16))
        b3_cfg = c.replace(train=dataclasses.replace(c.train, use_pallas_mmd=True))
        b3_state = trainer.init_state(b3_cfg, seed=1, device=dev)
        reset_counts()
        b3_out = trainer.make_train_step(b3_cfg)(b3_state, batch, seeded(2))
        torch.cuda.synchronize()
        b3_launches = counts()
        b3_grads = {name: p.grad.clone() for name, p in b3_state.model.named_parameters() if p.grad is not None}
        del b3_state
        ref_state = trainer.init_state(c, seed=1, device=dev)
        ref_out = trainer.make_train_step(c)(ref_state, batch, seeded(2))
        b3_errs = sorted((((b3_grads[name] - p.grad).abs().max() / p.grad.abs().max()).item(), name)
                         for name, p in ref_state.model.named_parameters()
                         if p.grad is not None and name in b3_grads and p.grad.abs().max() > 0)
        del ref_state, b3_grads
        torch.cuda.empty_cache()
        m_k, m_p = b3_out["mmd"].item(), ref_out["mmd"].item()
        l_k, l_p = b3_out["loss"].item(), ref_out["loss"].item()
        b3_scored = [(r, n) for r, n in b3_errs if not n.endswith(".k.bias")]
        print(f"train step with B3, {label}: {b3_launches[MMD]} forward and {b3_launches[MMD_BWD]} backward "
              f"launch(es); mmd {m_k:.7g} vs plain MMD {m_p:.7g}; loss {l_k:.7g} vs {l_p:.7g} (rtol {MMD_RTOL:g}); "
              f"per-tensor gradient error relative to the tensor's largest gradient over {len(b3_errs)} tensors: "
              f"median {b3_errs[len(b3_errs) // 2][0]:.3e}, worst outside the key biases {b3_scored[-1][0]:.3e} "
              f"({b3_scored[-1][1]})" + ("" if bf16 else " (bars 1e-3 and 1e-2)"), flush=True)
        check(b3_launches[MMD] == 1 and b3_launches[MMD_BWD] == 1, f"B3 launches in one {label} step: {b3_launches}")
        check(abs(m_k - m_p) <= MMD_RTOL * abs(m_p) + 1e-7, f"B3 {label} step mmd {m_k} vs {m_p}")
        check(abs(l_k - l_p) <= MMD_RTOL * abs(l_p) + 1e-7, f"B3 {label} step loss {l_k} vs {l_p}")
        if bf16:
            train_launches[MMD], train_launches[MMD_BWD] = b3_launches[MMD], b3_launches[MMD_BWD]
        else:
            check(b3_errs[len(b3_errs) // 2][0] <= 1e-3 and b3_scored[-1][0] <= 1e-2,
                  f"B3 f32 step gradients: median {b3_errs[len(b3_errs) // 2]}, worst {b3_scored[-1]}")

    # -- 9. train kernel path against the plain path ----------------------
    # In f32 the two paths must agree closely.  In bf16 (the shipped config)
    # the gradients of this randomly initialised model differ from f32 ones
    # by a third or more per tensor on either path (printed below: each bf16
    # path against the f32 plain path, with DILR's loss on and off), so the
    # bf16 step is held on its loss and, call by call, on its attention: each
    # forward and backward the kernels compute in that step is held against
    # the plain version on the same tensors (the inputs the forward saved
    # and the cotangent autograd passed in).  The key biases' exact gradient
    # is zero (softmax ignores a per-row constant), so their computed values
    # are rounding noise and are left out of the per-tensor bar.
    def grads_of(model):
        return {name: p.grad for name, p in model.named_parameters()}

    def grad_errors(grads_a, grads_b):
        return sorted((rel_err(grads_a[name], g), name) for name, g in grads_b.items() if g.abs().max() > 0)

    def median_err(errs):
        return errs[len(errs) // 2][0]

    @contextlib.contextmanager
    def held_attention(errs):
        """Hold every attention call's kernels against the plain versions on
        its own tensors, at backward time; errors relative to the plain
        result's largest magnitude go to ``errs``."""
        sa_bwd, v2_bwd = wa._SelfAttention.backward, wa._WindowAttentionV2.backward

        def sa(ctx, dout):
            grads = sa_bwd(ctx, dout)
            q, k, v = ctx.saved_tensors
            h, sc = ctx.num_heads, ctx.scale
            want = wa.self_attention_bwd_reference(q, k, v, dout.to(q.dtype).contiguous(), h, sc)
            errs[SA_BWD].append(max(rel_err(g, w) for g, w in zip(grads, want)))
            errs[SA].append(rel_err(wa.self_attention_fused(q, k, v, h, sc),
                                    wa.self_attention_reference(q, k, v, h, sc)))
            return grads

        def v2(ctx, dout):
            grads = v2_bwd(ctx, dout)
            qkv, bias = ctx.saved_tensors
            h, sc = ctx.num_heads, ctx.scale
            dqkv, dbias = wa.window_attention_v2_bwd_reference(qkv, bias, dout.to(qkv.dtype).contiguous(), h, sc)
            errs[V2_BWD].append(rel_err(grads[0], dqkv))
            errs["dbias"].append(rel_err(grads[1], dbias))
            errs[V2].append(rel_err(wa.window_attention_fused_v2(qkv, bias, h, sc),
                                    wa.window_attention_v2_reference(qkv, bias, h, sc)))
            return grads

        wa._SelfAttention.backward, wa._WindowAttentionV2.backward = staticmethod(sa), staticmethod(v2)
        try:
            yield
        finally:
            wa._SelfAttention.backward = staticmethod(sa_bwd)
            wa._WindowAttentionV2.backward = staticmethod(v2_bwd)

    held = {name: [] for name in (SA, SA_BWD, V2, V2_BWD, "dbias")}
    f32_plain_grads = None
    for label, bf16 in (("f32", False), ("bf16", True)):
        c = cfg.replace(model=dataclasses.replace(mc, use_bfloat16=bf16))
        ks, ps = trainer.init_state(c, seed=2, device=dev), trainer.init_state(plain_cfg(c), seed=2, device=dev)
        with held_attention(held) if bf16 else contextlib.nullcontext():
            lk = trainer.make_train_step(c)(ks, batch, seeded(3))["loss"].item()
        lp = trainer.make_train_step(plain_cfg(c))(ps, batch, seeded(3))["loss"].item()
        errs = grad_errors(grads_of(ks.model), grads_of(ps.model))
        scored = [(r, n) for r, n in errs if not n.endswith(".k.bias")]
        print(f"train step {label}, kernel vs plain path: loss {lk:.7g} vs {lp:.7g} (relative "
              f"{abs(lk - lp) / abs(lp):.3e}); per-tensor gradient error relative to the tensor's largest "
              f"gradient over {len(errs)} tensors: median {median_err(errs):.3e}, worst outside the key "
              f"biases {scored[-1][0]:.3e} ({scored[-1][1]}), worst key bias "
              f"{max(r for r, n in errs if n.endswith('.k.bias')):.3e}", flush=True)
        if bf16:
            check(abs(lk - lp) <= 1e-2 * abs(lp), f"bf16 kernel vs plain loss {lk} vs {lp}")
            for name, bar in ((SA, BWD_BAR["bf16"]), (SA_BWD, BWD_BAR["bf16"]), (V2, BWD_BAR["bf16"]),
                              (V2_BWD, BWD_BAR["bf16"]), ("dbias", BWD_BAR["f32"])):
                e = held[name]
                print(f"bf16 step, {name} held against its plain version on the step's own tensors: "
                      f"{len(e)} calls, worst relative error {max(e):.3e}, median "
                      f"{statistics.median(e):.3e} (bar {bar:g})", flush=True)
                check(len(e) == per_step and max(e) <= bar, f"bf16 step {name}: {len(e)} calls, worst {max(e)}")
            print(f"bf16 gradients against the f32 plain path's, median per-tensor error: kernel path "
                  f"{median_err(grad_errors(grads_of(ks.model), f32_plain_grads)):.3e}, plain path "
                  f"{median_err(grad_errors(grads_of(ps.model), f32_plain_grads)):.3e}", flush=True)
            k_state, p_state, p_step = ks, ps, trainer.make_train_step(plain_cfg(cfg))
            del f32_plain_grads
        else:
            check(abs(lk - lp) <= 1e-5 * abs(lp), f"f32 kernel vs plain loss {lk} vs {lp}")
            check(median_err(errs) <= 1e-3 and scored[-1][0] <= 1e-2,
                  f"f32 kernel vs plain gradients: {median_err(errs)}, {scored[-1]}")
            f32_plain_grads = {n: g.clone() for n, g in grads_of(ps.model).items()}
            del ks, ps
            torch.cuda.empty_cache()

    # The same three steps with DILR's loss off (dilr_weight 0).
    no_dilr = dataclasses.replace(mc, dilr_weight=0.0)
    grads0 = {}
    f32_no_dilr = cfg.replace(model=dataclasses.replace(no_dilr, use_bfloat16=False))
    for label, c in (("f32 plain", plain_cfg(f32_no_dilr)), ("bf16 kernel", cfg.replace(model=no_dilr)),
                     ("bf16 plain", plain_cfg(cfg.replace(model=no_dilr)))):
        st = trainer.init_state(c, seed=2, device=dev)
        trainer.make_train_step(c)(st, batch, seeded(3))
        grads0[label] = {n: g.clone() for n, g in grads_of(st.model).items()}
        del st
        torch.cuda.empty_cache()
    print(f"dilr_weight 0, median per-tensor gradient error: bf16 kernel path vs f32 plain path "
          f"{median_err(grad_errors(grads0['bf16 kernel'], grads0['f32 plain'])):.3e}, bf16 plain path vs f32 "
          f"plain path {median_err(grad_errors(grads0['bf16 plain'], grads0['f32 plain'])):.3e}, bf16 kernel vs "
          f"bf16 plain path {median_err(grad_errors(grads0['bf16 kernel'], grads0['bf16 plain'])):.3e}", flush=True)
    del grads0

    # The small f32 model's step on the card against the same step on the CPU.
    scfg = tiny_test_config(batch_size=4)
    scfg = scfg.replace(model=dataclasses.replace(
        scfg.model, use_fused_attention=True, vit_fused_attention=True, vit3d_heads=2))
    s_cpu = trainer.init_state(scfg, seed=0, device="cpu")
    s_gpu = trainer.init_state(scfg, seed=0, device=dev)
    s_gpu.model.load_state_dict(s_cpu.model.state_dict())
    sm = scfg.model
    sbatch = trainer.random_views(scfg, seed=5, device="cpu")
    # Two of each class.  With seed 5's own labels (0, 1, 0, 0) the gradient
    # of poe.phi, a batch sum that cancels to about 4e-3, differs by 1.9e-3
    # of itself between card and CPU (PERF.md, open questions).
    sbatch["label"] = torch.tensor([0, 1, 1, 0], dtype=torch.int32)

    reset_counts()
    g_out = trainer.make_train_step(scfg)(s_gpu, sbatch, seeded(4), draws=mr.small_draws(sm, dev))
    small_launches = counts()
    c_out = trainer.make_train_step(scfg)(s_cpu, sbatch, torch.Generator(), draws=mr.small_draws(sm, "cpu"))
    srels = mr.grad_errors(s_gpu, s_cpu)
    dl = abs(g_out["loss"].item() - c_out["loss"].item())
    print(f"small f32 train step, card vs CPU: loss {g_out['loss'].item():.7g} vs {c_out['loss'].item():.7g} "
          f"(|d| {dl:.3e}, limit 1e-4 relative); per-tensor gradient error outside the key biases: median "
          f"{srels[len(srels) // 2][0]:.3e}, worst {srels[-1][0]:.3e} ({srels[-1][1]}; limit 1e-3); "
          f"card launches {small_launches}", flush=True)
    check(dl <= 1e-4 * abs(c_out["loss"].item()), f"small step loss card vs CPU {dl}")
    check(srels[-1][0] <= 1e-3, f"small step gradients card vs CPU {srels[-1]}")
    small_expected = {name: 0 for name in small_launches}
    small_expected.update({SA: 2 * sm.vit3d_depth, SA_BWD: 2 * sm.vit3d_depth, V2: 2 * sum(sm.swin_depths),
                           V2_BWD: 2 * sum(sm.swin_depths)})
    check(small_launches == small_expected, f"small model launches {small_launches}, expected {small_expected}")
    del s_cpu, s_gpu

    # -- 10. timings ----------------------------------------------------------
    gen_time = seeded(5)

    def step_ms(state_, step_fn, steps=3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            step_fn(state_, batch, gen_time)
        torch.cuda.synchronize()
        return 1000.0 * (time.perf_counter() - t) / steps

    runs = {}
    for label, st, fn in (("plain", p_state, p_step), ("kernel", k_state, train_step),
                          ("kernel", k_state, train_step), ("plain", p_state, p_step)):
        runs.setdefault(label, []).append(step_ms(st, fn))
    for label in ("kernel", "plain"):
        ms = statistics.median(runs[label])
        print(f"time train step, {label} path, batch {bt} bf16, host clock to sync: {ms:.3f} ms/step, "
              f"{1000.0 * bt / ms:.1f} pairs/s (runs of 3 steps: {[round(x, 3) for x in runs[label]]}) "
              f"[{card}]", flush=True)
    for label, st, fn in (("kernel", k_state, train_step), ("plain", p_state, p_step)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn(st, batch, gen_time)
        torch.cuda.synchronize()
        print(f"peak device memory, {label} path train step: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    del k_state, p_state
    torch.cuda.empty_cache()

    # The kernel path with remat (every backbone block recomputed in the
    # backward, as flax's nn.remat): the same loss as without, one forward
    # launch more per attention call, and its peak memory.
    remat_cfg = cfg.replace(model=dataclasses.replace(mc, remat=True))
    remat_loss, remat_peak = {}, {}
    for label, c in (("remat", remat_cfg), ("no remat", cfg)):
        st = trainer.init_state(c, seed=2, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        remat_loss[label] = trainer.make_train_step(c)(st, batch, seeded(3))["loss"].item()
        torch.cuda.synchronize()
        remat_peak[label] = torch.cuda.max_memory_allocated() / 2**30
        if label == "remat":
            remat_launches, remat_fwd_routes = counts(), dict(wa.FWD_ROUTES)
        del st
        torch.cuda.empty_cache()
    print(f"train step with remat, kernel path: loss {remat_loss['remat']:.7g} vs {remat_loss['no remat']:.7g} "
          f"without; peak device memory {remat_peak['remat']:.2f} GiB vs {remat_peak['no remat']:.2f} GiB; "
          f"launches {remat_launches} [{card}]", flush=True)
    check(abs(remat_loss["remat"] - remat_loss["no remat"]) <= 1e-6 * abs(remat_loss["no remat"]),
          "remat changes the loss")
    for name, want in ((SA, 2 * per_step), (V2, 2 * per_step), (SA_BWD, per_step), (V2_BWD, per_step)):
        check(remat_launches[name] == want, f"remat step: {name} launched {remat_launches[name]} times, not {want}")
    check_routes("train step with remat", remat_fwd_routes, 4 * per_step, "forward")

    totals ={name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0,
                     "flops": 0.0} for name in KERNEL_SOURCE}

    def add(name, calls, ms, plain_ms, library_ms, nbytes, flops):
        t = totals[name]
        t["ms"] += calls * ms
        t["plain_ms"] += calls * plain_ms
        if library_ms is not None:
            t["library_ms"] += calls * library_ms
        t["bytes"] += calls * nbytes
        t["flops"] += calls * flops

    def report(name, label, calls, ms, plain_ms, library_ms, nbytes, flops, peak=BF16_FLOPS_PER_S):
        bms, by = bound(nbytes, flops, peak)
        lib = "null" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"time {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, "
              f"bound {bms:.4f} ms ({by}) per call, x{calls} per train step [{card}]", flush=True)
        add(name, calls, ms, plain_ms, library_ms, nbytes, flops)

    def sdpa_bwd_ms(q4, k4, v4, do4, mask=None):
        leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
        if mask is not None:
            mask = mask.detach().requires_grad_()
            leaves.append(mask)
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=mask)
        return runs_ms(lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True))

    single = {SA: [0.0, 0.0], V2: [0.0, 0.0]}

    def single_call(name, calls, kernel_fn, library_fn):
        """The forward timed one call between two events, as chip_smoke.py
        timed every kernel before it timed runs of launches: the host's
        dispatch of the call counts too.  Printed beside the runs' times."""
        for i, fn in enumerate((kernel_fn, library_fn)):
            single[name][i] += calls * runs_ms(fn, launches=1)

    # B1 at [32, 216, 768] x 6, bf16.
    s = train_vit
    bsz, n, c, heads = s["b"], s["n"], s["c"], s["heads"]
    hd = c // heads
    scale = hd ** -0.5
    q, k, v, do = vit_inputs(s, torch.bfloat16) + (normal((bsz, n, c), torch.bfloat16),)
    split = lambda x: x.view(bsz, n, heads, hd).transpose(1, 2)  # noqa: E731
    with torch.no_grad():
        tk = runs_ms(lambda: wa.self_attention_fused(q, k, v, heads, scale))
        tp = runs_ms(lambda: wa.self_attention_reference(q, k, v, heads, scale))
        tl = runs_ms(lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), scale=scale))
        single_call(SA, 2 * s["calls"], lambda: wa.self_attention_fused(q, k, v, heads, scale),
                    lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), scale=scale))
    elems = bsz * n * c
    report(SA, f"[{bsz},{n},{c}]x{heads} bf16", 2 * s["calls"], tk, tp, tl, 4 * elems * 2,
           4.0 * bsz * heads * n * n * hd)
    tk = runs_ms(lambda: wa.self_attention_bwd_kernel(q, k, v, do, heads, scale))
    tp = runs_ms(lambda: wa.self_attention_bwd_reference(q, k, v, do, heads, scale))
    tl = sdpa_bwd_ms(split(q), split(k), split(v), split(do))
    report(SA_BWD, f"[{bsz},{n},{c}]x{heads} bf16", 2 * s["calls"], tk, tp, tl, 7 * elems * 2,
           10.0 * bsz * heads * n * n * hd)

    # B2 at the four Swin stages of batch 32, bf16.
    for s in train_swin:
        qkv, bias = swin_inputs(s, torch.bfloat16)
        bsz, w, n, c3 = qkv.shape
        c, heads = c3 // 3, s["heads"]
        hd = c // heads
        scale = hd ** -0.5
        do = normal((bsz, w, n, c), torch.bfloat16)
        x = qkv.view(bsz * w, n, 3, heads, hd)
        q4, k4, v4 = (x[:, :, i].transpose(1, 2) for i in range(3))
        do4 = do.view(bsz * w, n, heads, hd).transpose(1, 2)
        mask = bias.to(torch.bfloat16)[None].expand(bsz, w, heads, n, n).reshape(bsz * w, heads, n, n)
        label = f"{list(qkv.shape)} H={heads} bf16"
        with torch.no_grad():
            tk = runs_ms(lambda: wa.window_attention_fused_v2(qkv, bias, heads, scale))
            tp = runs_ms(lambda: wa.window_attention_v2_reference(qkv, bias, heads, scale))
            tl = runs_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale))
            single_call(V2, 2 * s["calls"], lambda: wa.window_attention_fused_v2(qkv, bias, heads, scale),
                        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale))
        elems = bsz * w * n * c
        bias_bytes = w * heads * n * n * 4
        flops = 1.0 * bsz * w * heads * n * n * hd
        report(V2, label, 2 * s["calls"], tk, tp, tl, 4 * elems * 2 + bias_bytes, 4 * flops)
        tk = runs_ms(lambda: wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, scale))
        tp = runs_ms(lambda: wa.window_attention_v2_bwd_reference(qkv, bias, do, heads, scale))
        tl = sdpa_bwd_ms(q4, k4, v4, do4, mask)
        report(V2_BWD, label, 2 * s["calls"], tk, tp, tl, 7 * elems * 2 + 2 * bias_bytes, 10 * flops)
        del qkv, bias, do, mask
        torch.cuda.empty_cache()

    for name, (k_ms, l_ms) in single.items():
        print(f"time {name} per batch-{bt} train step, one call between two events: kernel {k_ms:.3f} ms, "
              f"SDPA {l_ms:.3f} ms [{card}]", flush=True)

    # B3 at [32, 3072] + [32, 3072] f32, forward and backward, each on its
    # own.  The kernels line takes the device-only times (CUDA graphs of 10
    # calls) of the kernel and of its plain version; printed beside them the
    # runs-of-10 times, the host's enqueue per call and one empty kernel's
    # launch (the floor a one-launch call can reach).  No one PyTorch call
    # computes either.
    src = normal((bt, feat_dim), torch.float32)
    tgt = normal((bt, feat_dim), torch.float32) * 1.1 + 0.05
    grad = torch.tensor(1.0, device=dev)
    n_mmd = 2 * bt
    _, mmd_state = kmmd.mk_mmd_fwd_kernel(src, tgt)
    empty = lambda: bwd_lib.edrl_empty_launch(torch._C._cuda_getCurrentRawStream(dev.index or 0))  # noqa: E731
    floor = {"device-only": graph_ms(empty), "runs of 10": runs_ms(empty), "host enqueue": enqueue_ms(empty)}
    # Forward: the features read, the value and the state written; the Gram
    # product.  Backward: the features and the state read, the gradients
    # written; the [n, n] x [n, d] product.
    for name, fn, plain_fn, nbytes in (
            (MMD, lambda: kmmd.mk_mmd_fwd_kernel(src, tgt), lambda: mk_mmd(src, tgt),
             2 * bt * feat_dim * 4 + 4 * (n_mmd * n_mmd + 3)),
            (MMD_BWD, lambda: kmmd.mk_mmd_bwd_kernel(src, tgt, mmd_state, grad),
             lambda: mk_mmd_bwd_reference(src, tgt, grad), 4 * bt * feat_dim * 4 + 4 * (n_mmd * n_mmd + 3))):
        with torch.no_grad():
            tg = {"kernel": graph_ms(fn), "plain": graph_ms(plain_fn)}
            tr = {"kernel": runs_ms(fn), "plain": runs_ms(plain_fn)}
            te = enqueue_ms(fn)
        report(name, f"[{bt},{feat_dim}]+[{bt},{feat_dim}] f32", 1, tg["kernel"], tg["plain"], None, nbytes,
               2.0 * n_mmd * n_mmd * feat_dim, peak=F32_FLOPS_PER_S)
        print(f"  {name} ms per call: device-only (CUDA graphs) kernel {tg['kernel']:.4f}, plain {tg['plain']:.4f}; "
              f"runs of 10 kernel {tr['kernel']:.4f}, plain {tr['plain']:.4f}; host enqueue {te:.4f}; one empty "
              f"kernel's launch: " + ", ".join(f"{k} {v:.4f}" for k, v in floor.items()) + f" [{card}]", flush=True)

    # == 11-16. The fused-LayerNorm + fused-MLP configuration (B4, B5) ======
    slice_cfg = cfg.replace(model=dataclasses.replace(mc, use_fused_ln=True, use_fused_mlp=True))

    def mlp_shapes(c, b):
        """B5 calls {(M, C, H): n} of one forward of config c at batch b,
        site by site as the backbones make them (B4's: pln.ln_shapes)."""
        m_, mlp_calls = c.model, collections.Counter()
        grid, dim = c.data.fundus_size // 4, m_.swin_embed_dim
        for stage, depth in enumerate(m_.swin_depths):
            mlp_calls[(b * grid * grid, dim, 4 * dim)] += depth
            grid, dim = grid // 2, dim * 2
        width = m_.oct_embed_dim
        mlp_calls[(b * m_.oct_tokens, width, 4 * width)] += m_.vit3d_depth
        return mlp_calls

    b_eval = cfg.data.eval_batch_size
    ln_serve, mlp_serve = pln.ln_shapes(slice_cfg, b_eval), mlp_shapes(slice_cfg, b_eval)
    ln_train, mlp_train = pln.ln_shapes(slice_cfg, bt), mlp_shapes(slice_cfg, bt)
    n_ln, n_mlp = sum(ln_train.values()), sum(mlp_train.values())
    check((n_ln, n_mlp) == (54, 24), f"slice: {n_ln} LayerNorms and {n_mlp} MLPs per forward")

    def ln_inputs(m, c, dtype):
        x = (torch.randn((m, c), generator=gen, device=dev) * 2 + 0.5).to(dtype)
        gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device=dev)
        beta = 0.1 * torch.randn((c,), generator=gen, device=dev)
        return x, gamma, beta, normal((m, c), dtype)

    def mlp_inputs(m, c, h, dtype):
        u = normal((m, c), dtype)
        w1 = torch.randn((c, h), generator=gen, device=dev) / c ** 0.5
        b1 = 0.1 * torch.randn((h,), generator=gen, device=dev)
        w2 = torch.randn((h, c), generator=gen, device=dev) / h ** 0.5
        b2 = 0.1 * torch.randn((c,), generator=gen, device=dev)
        return u, w1, b1, w2, b2, normal((m, c), dtype)

    def hold(name, label, dtype, pairs, main_path):
        """pairs: (got, want, bar), the bar relative to the plain result's
        largest magnitude; bf16 absolute errors at main-path shapes go to max_err."""
        worst = 0.0
        for g, w, bar in pairs:
            rel = rel_err(g, w)
            check(rel <= bar and g.dtype == w.dtype, f"{name} {label} {dtype}: relative error {rel} over {bar}")
            worst = max(worst, rel)
            if dtype == torch.bfloat16 and main_path:
                max_err[name] = max(max_err[name], (g.float() - w.float()).abs().max().item())
        print(f"check {name} {label} {str(dtype)[6:]}: worst relative error {worst:.3e}", flush=True)

    def ln_case(m, c, dtype, main_path, twice=False):
        x, gamma, beta, dy = ln_inputs(m, c, dtype)
        bar = BWD_BAR["bf16" if dtype == torch.bfloat16 else "f32"]
        label = f"[{m},{c}]" + ("" if main_path else " (odd)")
        hold(LN, label, dtype, [(ln.layer_norm_fwd_kernel(x, gamma, beta),
                                 ln.layer_norm_reference(x, gamma, beta), bar)], main_path)
        got = ln.layer_norm_bwd_kernel(x, dy, gamma)
        want = ln.layer_norm_bwd_reference(x, dy, gamma)
        hold(LN_BWD, label, dtype, [(got[0], want[0], bar), (got[1], want[1], BWD_BAR["f32"]),
                                    (got[2], want[2], BWD_BAR["f32"])], main_path)
        if twice:
            again = ln.layer_norm_bwd_kernel(x, dy, gamma)
            check(torch.equal(again[1], got[1]) and torch.equal(again[2], got[2]),
                  f"{LN_BWD} {label}: dgamma/dbeta differ between two runs")

    res_train = pln.residual_shapes(cfg, bt)

    def ln_res_case(m, c, dtype, main_path, twice=False):
        """B4's residual form: an f32 cotangent, a residual in x's dtype."""
        x, gamma, _, res = ln_inputs(m, c, dtype)
        dy = torch.randn((m, c), generator=gen, device=dev)
        bar = BWD_BAR["bf16" if dtype == torch.bfloat16 else "f32"]
        label = f"[{m},{c}]" + ("" if main_path else " (odd)")
        got = ln.layer_norm_bwd_residual_kernel(x, dy, gamma, res)
        want = ln.layer_norm_bwd_residual_reference(x, dy, gamma, res)
        hold(LN_RES, label, dtype, [(got[0], want[0], bar), (got[1], want[1], BWD_BAR["f32"]),
                                    (got[2], want[2], BWD_BAR["f32"])], main_path)
        if twice:
            again = ln.layer_norm_bwd_residual_kernel(x, dy, gamma, res)
            check(torch.equal(again[1], got[1]) and torch.equal(again[2], got[2]),
                  f"{LN_RES} {label}: dgamma/dbeta differ between two runs")

    def mlp_case(m, c, h, dtype, main_path, twice=False):
        u, w1, b1, w2, b2, dy = mlp_inputs(m, c, h, dtype)
        bar = BWD_BAR["bf16"] if dtype == torch.bfloat16 else MLP_F32_BAR
        label = f"[{m},{c}]x{h}" + ("" if main_path else " (odd)")
        route = fm.fused_mlp_route(dtype, c, h)
        c_route = build.load_library().edrl_fused_mlp_route(int(dtype == torch.bfloat16), c, h)
        check(route == {1: "wgmma", 0: "mma"}.get(c_route), f"B5 {label}: route {route}, C entry {c_route}")
        check(route == ("wgmma" if dtype == torch.bfloat16 else "mma"), f"B5 {label} {dtype}: route {route}")
        fm.reset_launch_counts()
        hold(MLP, label, dtype, [(fm.fused_mlp_fwd_kernel(u, w1, b1, w2, b2),
                                  fm.fused_mlp_reference(u, w1, b1, w2, b2), bar)], main_path)
        got = fm.fused_mlp_bwd_kernel(u, dy, w1, b1, w2)
        hold(MLP_BWD, label, dtype, [(g, w, bar) for g, w in zip(got, fm.fused_mlp_bwd_reference(u, dy, w1, b1, w2))],
             main_path)
        if twice:
            again = fm.fused_mlp_bwd_kernel(u, dy, w1, b1, w2)
            check(all(torch.equal(a, g) for a, g in zip(again[1:], got[1:])),
                  f"{MLP_BWD} {label}: weight and bias gradients differ between two runs")
        want_routes = {"wgmma": 0, "mma": 0}
        want_routes[route] = 3 if twice else 2
        check(fm.MLP_ROUTES == want_routes, f"B5 {label} {dtype}: routes {fm.MLP_ROUTES}, expected {want_routes}")

    # -- 11. B4 and B5 against their plain versions --------------------------
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            first = dtype == torch.bfloat16
            for m, c in sorted(set(ln_serve) | set(ln_train)):
                ln_case(m, c, dtype, True, twice=first and (m, c) in ln_train)
            for m, c, h in sorted(set(mlp_serve) | set(mlp_train)):
                mlp_case(m, c, h, dtype, True, twice=first and (m, c, h) in mlp_train)
                torch.cuda.empty_cache()
            for m, c in sorted(res_train):
                ln_res_case(m, c, dtype, True, twice=first)
            # Ragged M, and M below the plan's CTA count (200 rows of 2048).
            for m, c in ((37, 128), (1001, 768), (3, 1152), (200, 2048)):
                ln_case(m, c, dtype, False)
                ln_res_case(m, c, dtype, False)
            for m, c, h in ((37, 128, 512), (300, 768, 3072), (40, 1024, 4096)):
                mlp_case(m, c, h, dtype, False)
        for name, fn, args in (
            (LN, ln.layer_norm_fwd_kernel, (normal((4, 200), torch.bfloat16), torch.ones(200, device=dev),
                                            torch.zeros(200, device=dev))),
            (MLP, fm.fused_mlp_fwd_kernel, mlp_inputs(4, 200, 800, torch.bfloat16)[:5]),
        ):
            try:
                fn(*args)
            except ValueError as e:
                print(f"check {name} C=200: refused ({e})", flush=True)
            else:
                check(False, f"{name} took C=200")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 12. serving the slice at full width ----------------------------------
    t0 = time.perf_counter()
    spred = Predictor(slice_cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"slice predictor (use_fused_ln, use_fused_mlp): "
          f"{sum(p.numel() for p in spred.model.parameters())} parameters, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reset_counts()
    s_outputs = [spred.predict_probs(f, o) for f, o in requests]
    s_serve = counts()
    for (f, _), p in zip(requests, s_outputs):
        check(p.shape == (len(f), mc.num_classes) and bool(np.isfinite(p).all()), f"slice probs {p.shape}")
        check(bool(np.allclose(p.sum(-1), 1.0, atol=1e-5)), "slice probs rows sum to 1")
        print(f"slice request {len(f)} pairs -> probs {p.shape}, first row {p[0].tolist()}", flush=True)
    want = {name: 0 for name in s_serve}
    want.update({SA: 12 * batches, V2: 12 * batches, LN: n_ln * batches, MLP: n_mlp * batches})
    s_routes = dict(fm.MLP_ROUTES)
    print(f"slice serving launches over {batches} batches: {s_serve} (expected {want}); B5 routes {s_routes}",
          flush=True)
    check(s_serve == want, f"slice serving launches {s_serve}")
    check(s_routes == {"wgmma": n_mlp * batches, "mma": 0}, f"slice serving: B5 routes {s_routes}")

    # -- 13. training the slice at full width ---------------------------------
    s_state = trainer.init_state(slice_cfg, seed=0, device=dev)
    s_step = trainer.make_train_step(slice_cfg)
    before = {k: v.detach().clone() for k, v in s_state.model.state_dict().items()}
    gen_slice = seeded(11)
    reset_counts()
    s_outs = [s_step(s_state, batch, gen_slice) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    slice_launches = counts()
    slice_mlp_routes = dict(fm.MLP_ROUTES)
    print(f"slice train, {TRAIN_STEPS} steps: B5 routes {slice_mlp_routes}", flush=True)
    check(slice_mlp_routes == {"wgmma": 4 * n_mlp * TRAIN_STEPS, "mma": 0},
          f"slice train: B5 routes {slice_mlp_routes}, expected every launch on wgmma")
    check_routes(f"slice train, {TRAIN_STEPS} steps", dict(wa.BWD_ROUTES), 48 * TRAIN_STEPS)
    check_routes(f"slice train, {TRAIN_STEPS} steps", dict(wa.FWD_ROUTES), 48 * TRAIN_STEPS, "forward")
    for i, out in enumerate(s_outs):
        loss, mmd_v = out["loss"].item(), out["mmd"].item()
        print(f"slice train step {i}: loss {loss:.6f}, mmd {mmd_v:.6f}", flush=True)
        check(np.isfinite(loss) and np.isfinite(mmd_v), f"slice step {i}: loss {loss}, mmd {mmd_v}")
    after = s_state.model.state_dict()
    changed = sum(not torch.equal(before[n], after[n]) for n, _ in s_state.model.named_parameters())
    n_tensors = sum(1 for _ in s_state.model.parameters())
    print(f"slice parameters changed: {changed} of {n_tensors} tensors", flush=True)
    check(changed >= n_tensors - 4, f"slice: only {changed} of {n_tensors} parameter tensors changed")
    del before, after
    want = {name: 0 for name in slice_launches}
    want.update({SA: 24, V2: 24, SA_BWD: 24, V2_BWD: 24, LN: 2 * n_ln, LN_BWD: 2 * n_ln, MLP: 2 * n_mlp,
                 MLP_BWD: 2 * n_mlp})
    want = {name: TRAIN_STEPS * n for name, n in want.items()}
    print(f"slice train launches over {TRAIN_STEPS} steps: {slice_launches} (expected {want})", flush=True)
    check(slice_launches == want, f"slice train launches {slice_launches}")

    # -- 14. every B4/B5 call of a bf16 slice step against the plain versions --
    held_ln = {LN: [], LN_BWD: [], "dgamma/dbeta": [], MLP: [], MLP_BWD: []}
    kernels_of = (ln.layer_norm_fwd_kernel, ln.layer_norm_bwd_kernel, fm.fused_mlp_fwd_kernel,
                  fm.fused_mlp_bwd_kernel)

    def held_ln_fwd(x, gamma, beta, eps=1e-6):
        y = kernels_of[0](x, gamma, beta, eps)
        held_ln[LN].append(rel_err(y, ln.layer_norm_reference(x, gamma, beta, eps)))
        return y

    def held_ln_bwd(x, dy, gamma, eps=1e-6):
        out = kernels_of[1](x, dy, gamma, eps)
        want_ = ln.layer_norm_bwd_reference(x, dy, gamma, eps)
        held_ln[LN_BWD].append(rel_err(out[0], want_[0]))
        held_ln["dgamma/dbeta"].append(max(rel_err(out[1], want_[1]), rel_err(out[2], want_[2])))
        return out

    def held_mlp_fwd(u, w1, b1, w2, b2):
        y = kernels_of[2](u, w1, b1, w2, b2)
        held_ln[MLP].append(rel_err(y, fm.fused_mlp_reference(u, w1, b1, w2, b2)))
        return y

    def held_mlp_bwd(u, dy, w1, b1, w2):
        out = kernels_of[3](u, dy, w1, b1, w2)
        held_ln[MLP_BWD].append(max(rel_err(g, w) for g, w in zip(out, fm.fused_mlp_bwd_reference(u, dy, w1, b1, w2))))
        return out

    ln.layer_norm_fwd_kernel, ln.layer_norm_bwd_kernel = held_ln_fwd, held_ln_bwd
    fm.fused_mlp_fwd_kernel, fm.fused_mlp_bwd_kernel = held_mlp_fwd, held_mlp_bwd
    try:
        s_step(s_state, batch, seeded(12))
        torch.cuda.synchronize()
    finally:
        ln.layer_norm_fwd_kernel, ln.layer_norm_bwd_kernel, fm.fused_mlp_fwd_kernel, fm.fused_mlp_bwd_kernel = kernels_of
    for name, calls, bar in ((LN, 2 * n_ln, BWD_BAR["bf16"]), (LN_BWD, 2 * n_ln, BWD_BAR["bf16"]),
                             ("dgamma/dbeta", 2 * n_ln, BWD_BAR["f32"]), (MLP, 2 * n_mlp, BWD_BAR["bf16"]),
                             (MLP_BWD, 2 * n_mlp, BWD_BAR["bf16"])):
        e = held_ln[name]
        print(f"bf16 slice step, {name} held against its plain version on the step's own tensors: {len(e)} "
              f"calls, worst relative error {max(e):.3e}, median {statistics.median(e):.3e} (bar {bar:g})",
              flush=True)
        check(len(e) == calls and max(e) <= bar, f"bf16 slice step {name}: {len(e)} calls, worst {max(e)}")
    torch.cuda.empty_cache()

    # -- 15. a small f32 model of the slice, one step on the card and on the CPU --
    # Widths that route (multiples of 128).  In f32 the fused MLP still rounds
    # its activation (and dy, dh) to bf16, as the TPU kernel does; card and
    # CPU sum in other orders, so a few of those roundings land the other way,
    # and EPRL's top-k can turn that into a different selection.  So the CPU
    # step replays the card's B5 results, call by call (tools/mlp_replay.py),
    # and each is held at MLP_F32_BAR against the plain version on the inputs
    # the kernel took, and against the witness: the plain version on the CPU
    # step's own inputs with each bf16 rounding that lands one bf16 ulp from
    # the card inputs' taking the card inputs' value.  Printed, not checked:
    # the distance to the plain version on the CPU's inputs without the
    # witness (each flip moves a term by 2^-8 of itself), and the comparison
    # without the replay.  The step's f32 B4 calls are held against their
    # plain versions on their own inputs; everything else as below.
    reset_counts()
    rp = mr.replay_step(dev)
    f_launches = counts()
    f_routes = dict(fm.MLP_ROUTES)
    fcfg, f_gpu, f_cpu, f_free = mr.slice_config(), rp["card"], rp["cpu"], rp["free"]
    g_out, c_out, free_out = rp["card_out"], rp["cpu_out"], rp["free_out"]
    rd = rp["readings"]
    for key, what in (("same", "the plain version on the kernel's inputs"),
                      ("witness", "the witness on the CPU step's inputs")):
        check(len(rd[key]) == rp["calls"] and max(rd[key]) <= MLP_F32_BAR,
              f"small slice step: card B5 vs {what} {max(rd[key])}")
    check(max(rp["b4"]) <= BWD_BAR["f32"], f"small slice step: card B4 vs its plain version {max(rp['b4'])}")

    rows, free_rows = mr.grad_errors(f_gpu, f_cpu), mr.grad_errors(f_gpu, f_free)
    dl = abs(g_out["loss"].item() - c_out["loss"].item())
    print(f"small f32 slice step, card vs CPU with the card's {rp['calls']} B5 results replayed (each within "
          f"{max(rd['same']):.3e} of the plain version on its own inputs and {max(rd['witness']):.3e} of the "
          f"witness on the CPU's, bar {MLP_F32_BAR:.3e}; {max(rd['cpu']):.3e} of the plain version on the CPU's "
          f"inputs, which lie within {max(rd['inputs']):.3e} of the card's; {sum(rd['flips'])} one-ulp flips, "
          f"{sum(rd['wider'])} wider; its {len(rp['b4'])} B4 calls within {max(rp['b4']):.3e} of the plain "
          f"version on their own inputs, bar {BWD_BAR['f32']:g}): loss {g_out['loss'].item():.7g} vs "
          f"{c_out['loss'].item():.7g} (|d| {dl:.3e}, limit 1e-4 relative); per-tensor gradient error outside the "
          f"key biases: median {rows[len(rows) // 2][0]:.3e} (limit 1e-4), worst {rows[-1][0]:.3e} ({rows[-1][1]}; limit "
          f"1e-2). "
          f"Without the replay: loss {free_out['loss'].item():.7g}, median {free_rows[len(free_rows) // 2][0]:.3e}, "
          f"worst {free_rows[-1][0]:.3e} ({free_rows[-1][1]}), {sum(r > 1e-3 for r, _ in free_rows)} of "
          f"{len(free_rows)} tensors over 1e-3; card launches {f_launches}", flush=True)
    check(dl <= 1e-4 * abs(c_out["loss"].item()), f"small slice step loss card vs CPU {dl}")
    # Median 1e-4, worst 1e-2 (phase 9's worst-tensor bar): a gradient that is
    # a sum over the 4 samples that cancels (DILR's attention biases, as
    # poe.phi in phase 9) carries the inputs' rounding at 1e-3 of itself.
    check(rows[len(rows) // 2][0] <= 1e-4 and rows[-1][0] <= 1e-2,
          f"small slice step gradients card vs CPU: median {rows[len(rows) // 2]}, worst {rows[-1]}")
    f_ln, f_mlp = sum(pln.ln_shapes(fcfg, 4).values()), sum(mlp_shapes(fcfg, 4).values())
    fm_ = fcfg.model
    want = {name: 0 for name in f_launches}
    want.update({SA: 2 * fm_.vit3d_depth, SA_BWD: 2 * fm_.vit3d_depth, V2: 2 * sum(fm_.swin_depths),
                 V2_BWD: 2 * sum(fm_.swin_depths), LN: 2 * f_ln, LN_BWD: 2 * f_ln, MLP: 2 * f_mlp,
                 MLP_BWD: 2 * f_mlp})
    check(f_launches == want, f"small slice launches {f_launches}, expected {want}")
    check(f_routes == {"wgmma": 0, "mma": 4 * f_mlp}, f"small f32 slice step: B5 routes {f_routes}, expected mma")
    del f_cpu, f_free, f_gpu, rp

    # -- 16. the slice's step, serving forward and kernels, timed --------------
    ship_state = trainer.init_state(cfg, seed=2, device=dev)
    runs = {}
    for label, st, fn in (("shipped", ship_state, train_step), ("slice", s_state, s_step),
                          ("slice", s_state, s_step), ("shipped", ship_state, train_step)):
        runs.setdefault(label, []).append(step_ms(st, fn))
    for label in ("slice", "shipped"):
        ms = statistics.median(runs[label])
        print(f"time train step, {label} config (kernel path), batch {bt} bf16, host clock to sync: {ms:.3f} "
              f"ms/step, {1000.0 * bt / ms:.1f} pairs/s (runs of 3 steps: {[round(x, 3) for x in runs[label]]}) "
              f"[{card}]", flush=True)
    # Peak memory of each config's step with only its own state resident.
    del ship_state
    for label in ("slice", "shipped"):
        if label == "shipped":
            del s_state
            torch.cuda.empty_cache()
            s_state, s_step = trainer.init_state(cfg, seed=2, device=dev), train_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s_step(s_state, batch, gen_time)
        torch.cuda.synchronize()
        print(f"peak device memory, {label} config train step, its state alone on the card: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    del s_state
    torch.cuda.empty_cache()
    ship_pred = Predictor(cfg, device=dev, seed=0)
    with torch.inference_mode():
        fwd = {}
        for label, p in (("shipped", ship_pred), ("slice", spred), ("slice", spred), ("shipped", ship_pred)):
            fwd.setdefault(label, []).append(runs_ms(lambda: p._forward(f_dev, o_dev), launches=1))
    for label in ("slice", "shipped"):
        ms = statistics.median(fwd[label])
        print(f"time full-width forward, {label} config, batch {b} bf16: {ms:.3f} ms/batch, "
              f"{1000.0 * b / ms:.1f} pairs/s (runs {fwd[label]}) [{card}]", flush=True)
    del ship_pred, spred
    torch.cuda.empty_cache()

    # The library calls take gamma and beta in x's dtype (F.layer_norm on the
    # card refuses f32 parameters beside a bf16 x); they keep f32 statistics.
    # The backward's is the library's LayerNorm backward on the statistics its
    # forward saved, the one call autograd through F.layer_norm makes, called
    # directly so that a CUDA graph can hold it.
    def ln_library(x, gamma, beta, dy):
        shape, g16, b16 = (x.shape[1],), gamma.to(x.dtype), beta.to(x.dtype)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, shape, g16, b16, 1e-6)
        return (lambda: F.layer_norm(x, shape, g16, b16, 1e-6),
                lambda: torch.ops.aten.native_layer_norm_backward(dy, x, shape, mean, rstd, g16, b16,
                                                                  [True, True, True]))

    ln_step = {name: collections.defaultdict(float) for name in (LN, LN_BWD, LN_RES)}

    def ln_timed(name, kind, label, calls, fn, plain_fn, library_fn, m, c, flops):
        """One B4 shape.  The kernels line takes the device-only times (CUDA
        graphs of 10 calls) of the kernel, its plain version and the library
        call alike; printed beside them: the runs-of-10 times of the three,
        the host's enqueue per call, the device time by kernel, the plan and
        the partials' share of the bytes."""
        timed = {"kernel": fn, "plain": plain_fn, "library": library_fn}
        with torch.no_grad():
            tg = {k: None if f is None else graph_ms(f) for k, f in timed.items()}
            tr = {k: None if f is None else runs_ms(f) for k, f in timed.items()}
            te = enqueue_ms(fn)
            parts = psl.phase_ms(fn, pln.FWD_PARTS if kind == "forward" else pln.BWD_PARTS, pln.CALLS,
                                 attempts=PROFILE_ATTEMPTS)
        nbytes = pln.call_bytes(m, c, kind)
        report(name, label, calls, tg["kernel"], tg["plain"], tg["library"], nbytes, flops, peak=F32_FLOPS_PER_S)
        plan = ln.layer_norm_plan(m, c, torch.bfloat16, build.sm_count(dev), kind)
        share = ln.partial_bytes(plan, c) / nbytes
        both = lambda t: ", ".join(f"{k} {v:.4f}" for k, v in t.items() if v is not None)  # noqa: E731
        print(f"  B4 {kind} {label}, ms per call: device-only (CUDA graphs) {both(tg)}; runs of 10 {both(tr)}; "
              f"host enqueue {te:.4f}; by kernel (torch.profiler) "
              + ", ".join(f"{p} {t:.4f}" for p, t in parts.items())
              + f"; plan {tuple(plan)} (threads per row, rows per CTA, CTAs, partials), partials "
              f"{100 * share:.2f}% of the call's bytes [{card}]", flush=True)
        check(share <= 0.1, f"B4 {kind} {label}: partials {share:.3f} of the call's bytes")
        rows = [(f"{k} device-only", v) for k, v in tg.items()] + [(f"{k} runs of 10", v) for k, v in tr.items()]
        for key, v in (*rows, ("host enqueue", te), *parts.items()):
            if v is not None:
                ln_step[name][key] += calls * v

    # ~9 f32 operations per element forward, ~20 backward (21 with the
    # residual), on the CUDA cores.
    for (m, c), calls in sorted(ln_train.items()):
        x, gamma, beta, dy, _ = pln.inputs(m, c, gen)
        lib_fwd, lib_bwd = ln_library(x, gamma, beta, dy)
        ln_timed(LN, "forward", f"[{m},{c}] bf16", 2 * calls, lambda: ln.layer_norm_fwd_kernel(x, gamma, beta),
                 lambda: ln.layer_norm_reference(x, gamma, beta), lib_fwd, m, c, 9.0 * m * c)
        ln_timed(LN_BWD, "backward", f"[{m},{c}] bf16", 2 * calls, lambda: ln.layer_norm_bwd_kernel(x, dy, gamma),
                 lambda: ln.layer_norm_bwd_reference(x, dy, gamma), lib_bwd, m, c, 20.0 * m * c)
        del x, dy, lib_fwd, lib_bwd
    # The residual form at the B6 configuration's shapes: no one PyTorch call
    # computes it (a LayerNorm backward and a sum).
    for (m, c), calls in sorted(res_train.items()):
        x, gamma, _, dy, res = pln.inputs(m, c, gen, residual=True)
        ln_timed(LN_RES, "residual", f"[{m},{c}] bf16 x, f32 dy", 2 * calls,
                 lambda: ln.layer_norm_bwd_residual_kernel(x, dy, gamma, res),
                 lambda: ln.layer_norm_bwd_residual_reference(x, dy, gamma, res), None, m, c, 21.0 * m * c)
        del x, dy, res
    torch.cuda.empty_cache()
    for name in (LN, LN_BWD, LN_RES):
        print(f"B4 {name} per batch-{bt} train step, ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in ln_step[name].items()) + f" [{card}]", flush=True)

    def shipped_mlp_ms(u, w1, b1, w2, b2, dy):
        """The shipped config's Mlp at B5's shape, on B5's weights: two cuBLAS
        Dense (f32 master weights cast to bf16 per call) around the tanh GELU.
        Forward ms, and backward ms through autograd (the input and the four
        parameters).  Timed only: no single PyTorch call computes B5's function."""
        mlp = Mlp(w1.shape[0], w1.shape[1], w2.shape[1], dtype=torch.bfloat16, device=dev)
        with torch.no_grad():
            for dense, w_, b_ in ((mlp.Dense_0, w1, b1), (mlp.Dense_1, w2, b2)):
                dense.weight.copy_(w_.T)
                dense.bias.copy_(b_)
            tf = runs_ms(lambda: mlp(u))
        leaves = [u.detach().requires_grad_(), *mlp.parameters()]
        out = mlp(leaves[0])
        return tf, runs_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))

    for name in (MLP, MLP_BWD):
        totals[name]["shipped_ms"] = 0.0
    for (m, c, h), calls in sorted(mlp_train.items()):
        u, w1, b1, w2, b2, dy = mlp_inputs(m, c, h, torch.bfloat16)
        weights = 2 * c * h * 4  # f32 master weights, read once
        with torch.no_grad():
            tk = runs_ms(lambda: fm.fused_mlp_fwd_kernel(u, w1, b1, w2, b2))
            tp = runs_ms(lambda: fm.fused_mlp_reference(u, w1, b1, w2, b2))
            report(MLP, f"[{m},{c}]x{h} bf16", 2 * calls, tk, tp, None,
                   2 * m * c * 2 + weights + (h + c) * 4, 4.0 * m * c * h)
            tk = runs_ms(lambda: fm.fused_mlp_bwd_kernel(u, dy, w1, b1, w2))
            tp = runs_ms(lambda: fm.fused_mlp_bwd_reference(u, dy, w1, b1, w2))
            report(MLP_BWD, f"[{m},{c}]x{h} bf16", 2 * calls, tk, tp, None,
                   3 * m * c * 2 + 2 * weights + h * 4 + (h + c) * 4, 10.0 * m * c * h)
        tsf, tsb = shipped_mlp_ms(u, w1, b1, w2, b2, dy)
        print(f"  beside it: the shipped Mlp (Dense, GELU, Dense) forward {tsf:.4f} ms, backward through "
              f"autograd {tsb:.4f} ms per call [{card}]", flush=True)
        # The wrappers' host work per call (allocations, weight rounding launches,
        # TMA tensor maps: 3 forward at C = 128, else 4; 10 backward).
        with torch.no_grad():
            hf = enqueue_ms(lambda: fm.fused_mlp_fwd_kernel(u, w1, b1, w2, b2))
            hb = enqueue_ms(lambda: fm.fused_mlp_bwd_kernel(u, dy, w1, b1, w2))
        print(f"  host enqueue per call: forward {hf:.4f} ms ({3 if c == 128 else 4} tensor maps), backward "
              f"{hb:.4f} ms (10 tensor maps)", flush=True)
        totals[MLP]["shipped_ms"] += 2 * calls * tsf
        totals[MLP_BWD]["shipped_ms"] += 2 * calls * tsb
        del u, dy
        torch.cuda.empty_cache()
    print(f"B5 per batch-{bt} train step: forward kernel {totals[MLP]['ms']:.3f} ms against the shipped Mlps' "
          f"{totals[MLP]['shipped_ms']:.3f} ms; backward kernel {totals[MLP_BWD]['ms']:.3f} ms against "
          f"{totals[MLP_BWD]['shipped_ms']:.3f} ms [{card}]", flush=True)
    train_launches.update({name: slice_launches[name] for name in (LN, LN_BWD, MLP, MLP_BWD)})

    # == 17-22. The fused attention-sublayer configuration (B6) ===============
    b6_cfg = cfg.replace(model=dataclasses.replace(mc, use_fused_block_attention=True))

    # B6 calls of one forward: Swin blocks by stage (unshifted with a
    # one-window bias, shifted with bias + shift mask per window), then the
    # ViT's blocks (W = 1, zero bias).
    b6_serve, b6_train = psl.train_shapes(cfg, cfg.data.eval_batch_size), psl.train_shapes(cfg, bt)
    n_b6 = sum(s_["calls"] for s_ in b6_train)
    check(n_b6 == 24, f"B6 config: {n_b6} sublayers per forward")

    def sublayer_inputs(s_, dtype):
        h_, n_ = s_["heads"], s_["n"]
        if s_["vit"]:
            bias_ = torch.zeros((1, h_, n_, n_), device=dev)
        elif s_["grid"] is None:  # odd shapes: a random bias with masked keys
            bias_ = torch.randn((s_["wb"], h_, n_, n_), generator=gen, device=dev)
            bias_[..., 1::3] = -1e9
        else:
            bias_ = swin_bias(s_["grid"], s_["window"], h_, s_["wb"] > 1)
            bias_ = bias_ if s_["wb"] > 1 else bias_[:1].contiguous()
        return psl.sublayer_inputs(s_, dtype, gen, bias_)

    def tpu_order(x_, gamma_, beta_, wqkv_, bqkv_, wproj_, bproj_, bias_, h_, scale_):
        """The TPU kernel's rounding order in bf16: scores and o from the f32
        qkv, o rounded once before the projection."""
        xln_ = ln.layer_norm_reference(x_, gamma_, beta_)
        qkv32 = xln_.float() @ wqkv_.float() + bqkv_
        o_ = wa.window_attention_v2_reference(qkv32, ba._full_bias(bias_, x_.shape[1]), h_, scale_)
        return (x_.float() + (o_.to(x_.dtype).float() @ wproj_.float() + bproj_)).to(x_.dtype)

    def sublayer_label(s_):
        kind = "ViT" if s_["vit"] else ("Swin" if s_["grid"] else "random bias")
        return f"{kind} [{s_['b']},{s_['w']},{s_['n']},{s_['c']}] H={s_['heads']} Wb={s_['wb']}"

    def sublayer_case(s_, dtype, main_path, backward):
        args_, scale_ = sublayer_inputs(s_, dtype)
        h_ = s_["heads"]
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        route = "wgmma" if kind == "bf16" else "fma"
        bar = BWD_BAR[kind]
        label = sublayer_label(s_) + ("" if main_path else " (odd)")
        check(ba.attention_sublayer_route(dtype, s_["c"], h_) == route == {1: "wgmma", 0: "fma"}[
            bwd_lib.edrl_attention_sublayer_route(int(kind == "bf16"), s_["c"], h_)], f"B6 {label} route")
        ba.reset_launch_counts()
        got = ba.attention_sublayer_fwd_kernel(*args_, h_, scale_)
        want_ = ba.attention_sublayer_reference(*args_, h_, scale_)
        hold(B6, label, dtype, [(g, w_, bar) for g, w_ in zip(got, want_)], main_path)
        if dtype == torch.bfloat16:
            tpu_err.append(rel_err(got[0], tpu_order(*args_, h_, scale_)))
        want_routes = {"wgmma": 0, "fma": 0}
        want_routes[route] = 1
        if backward:
            x_, gamma_, _, wqkv_, _, wproj_, _, bias_ = args_
            y_, qkv_, xln_ = got
            dy_ = normal(tuple(y_.shape), dtype)
            res = (x_, xln_, qkv_, gamma_, wqkv_, wproj_, bias_, dy_, h_, scale_)
            grads = ba.attention_sublayer_bwd_kernel(*res)
            plain = list(ba.attention_sublayer_bwd_reference(*res))
            if kind == "bf16":  # two Dense layers' launches, and again for the repeat
                again = ba.attention_sublayer_bwd_kernel(*res)
                check(all(torch.equal(a, g) for a, g in zip(again[1:], grads[1:])),
                      f"{B6_BWD} {label}: weight and bias gradients differ between two runs")
                want_routes["wgmma"] += 4
        check(ba.SUBLAYER_ROUTES == want_routes, f"B6 {label}: routes {ba.SUBLAYER_ROUTES}, expected {want_routes}")
        if backward:
            dbias_bar = sd.DBIAS_BAR if kind == "bf16" else BWD_BAR["f32"]
            hold(B6_BWD, label, dtype, [(g, w_, dbias_bar if i == 7 else bar)
                                        for i, (g, w_) in enumerate(zip(grads, plain))], main_path)
            if kind == "bf16":
                r = sd.readings(grads[7], plain[7], qkv_, wproj_, bias_, dy_, h_, scale_, controls=True)
                print("  dbias: " + ", ".join(f"{k} {v:.3e}" for k, v in r.items())
                      + f" (bars {sd.DBIAS_BAR:g}, kernel_do {sd.KERNEL_DO_BAR:g}; the controls must read above "
                        f"{sd.DBIAS_BAR:g})", flush=True)
                check(r["kernel_do"] <= sd.KERNEL_DO_BAR, f"{B6_BWD} {label}: dbias on the kernel's do {r}")
                check(r["truncated"] > sd.DBIAS_BAR, f"{B6_BWD} {label}: the truncated-do control reads {r}")

    def v1_inputs(b_, w_, h_, n_, d_, dtype, shifted=True, grid=None, window=None):
        q_, k_, v_, do_ = (normal((b_, w_, h_, n_, d_), dtype) for _ in range(4))
        q_ = q_ * d_ ** -0.5
        if grid is not None:
            bias_ = swin_bias(grid, window, h_, shifted)
        else:
            bias_ = torch.randn((w_, h_, n_, n_), generator=gen, device=dev)
            bias_[..., 1::3] = -1e9
        return q_, k_, v_, bias_, do_

    def v1_case(args_, dtype, label, main_path):
        q_, k_, v_, bias_, do_ = args_
        kind = "bf16" if dtype == torch.bfloat16 else "f32"
        leaves = [t.detach().requires_grad_() for t in (q_, k_, v_, bias_)]
        out_ = wa.window_attention_fused(*leaves)
        out_.backward(do_)
        want_ = wa.window_attention_bwd_reference(q_, k_, v_, bias_, do_)
        pairs = [(out_, wa.window_attention_reference(q_, k_, v_, bias_), BWD_BAR[kind])]
        pairs += [(leaf.grad, w_, BWD_BAR["f32"] if i == 3 else BWD_BAR[kind])
                  for i, (leaf, w_) in enumerate(zip(leaves, want_))]
        hold(V1, label, dtype, pairs, main_path)

    v1_train = [(bt, (s_["grid"] // s_["window"]) ** 2, s_["heads"], s_["window"] ** 2, s_["c"] // s_["heads"],
                 s_["shifted"], s_["grid"], s_["window"]) for s_ in train_swin]

    # -- 17. B6 and v1 against their plain versions ---------------------------
    tpu_err = []
    for dtype in (torch.bfloat16, torch.float32):
        with torch.no_grad():
            for s_ in b6_serve:
                sublayer_case(s_, dtype, True, backward=False)
                torch.cuda.empty_cache()
        for s_ in b6_train:
            sublayer_case(s_, dtype, True, backward=True)
            torch.cuda.empty_cache()
        for s_ in (dict(b=3, w=2, n=40, c=128, heads=8, wb=2, grid=None, vit=False),
                   dict(b=2, w=3, n=16, c=256, heads=4, wb=1, grid=None, vit=False)):
            sublayer_case(s_, dtype, False, backward=True)
        for b_, w_, h_, n_, d_, shifted, grid, window in v1_train:
            v1_case(v1_inputs(b_, w_, h_, n_, d_, dtype, shifted, grid, window), dtype,
                    f"[{b_},{w_},{h_},{n_},{d_}]", True)
            torch.cuda.empty_cache()
        v1_case(v1_inputs(3, 2, 2, 16, 16, dtype), dtype, "[3,2,2,16,16] (odd)", False)
    # v1 reads and writes its own layout: forward and backward at a Swin
    # train shape launch its forward, dq, dk/dv and dbias column-sum kernels
    # and nothing else (no copy, permute or cat; the launch counts are held
    # in phase 22, the profiler now and then misses an event); dq, dk, dv and
    # dbias are the same bit for bit over two runs.
    v1_args = v1_inputs(*v1_train[1][:5], torch.bfloat16, *v1_train[1][5:])
    v1_kernels = pv.kernels_of(lambda: pv.v1_step(*v1_args), attempts=PROFILE_ATTEMPTS)
    v1_own = ("attention_fwd_tc_kernel", "attention_bwd_dq_mma_kernel", "attention_bwd_dkv_mma_kernel",
              "column_sum_kernel")
    print(f"v1 forward + backward {list(v1_args[0].shape)} bf16, device kernels per call (torch.profiler): "
          + ", ".join(f"{name[:60]} x{n_:g}" for name, (n_, _) in v1_kernels.items()), flush=True)
    found = sorted(k for name in v1_kernels for k in v1_own if k in name)
    check(found == sorted(v1_own) and len(v1_kernels) == len(v1_own), f"v1 launches other kernels: {v1_kernels}")
    first = wa.window_attention_v1_bwd_kernel(*v1_args[:4], v1_args[4])
    same = all(torch.equal(a_, g_) for a_, g_ in zip(wa.window_attention_v1_bwd_kernel(*v1_args[:4], v1_args[4]),
                                                     first))
    print(f"check {V1_BWD} {list(v1_args[0].shape)} bf16: dq, dk, dv and dbias the same bit for bit over two "
          f"runs: {same}", flush=True)
    check(same, f"{V1_BWD}: two runs differ")
    del v1_args, first
    print(f"B6 bf16 against the TPU kernel's rounding order (scores and o from the f32 qkv): worst relative "
          f"error of y {max(tpu_err):.3e}, median {statistics.median(tpu_err):.3e} over {len(tpu_err)} shapes",
          flush=True)
    for what, shape, heads in (("C=200", (1, 1, 16, 200), 2), ("head_dim 256", (1, 1, 16, 256), 1)):
        s_ = dict(b=shape[0], w=shape[1], n=shape[2], c=shape[3], heads=heads, wb=1, vit=True)
        args_, _ = sublayer_inputs(s_, torch.bfloat16)
        try:
            ba.attention_sublayer_fwd_kernel(*args_, heads, 0.25)
        except ValueError as e:
            print(f"check {B6} {what}: refused ({e})", flush=True)
        else:
            check(False, f"{B6} took {what}")
    args_, _ = sublayer_inputs(dict(b=1, w=1, n=264, c=128, heads=1, wb=1, vit=True), torch.float32)
    try:
        ba.attention_sublayer_fused(args_[0].requires_grad_(), *args_[1:], 1, 0.25)
    except ValueError as e:
        print(f"check {B6} N=264 with a gradient: refused ({e})", flush=True)
    else:
        check(False, f"{B6} took N=264 with a gradient")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- 18. serving the B6 configuration at full width ------------------------
    b6_pred = Predictor(b6_cfg, device=dev, seed=0)
    reset_counts()
    b6_outputs = [b6_pred.predict_probs(f, o) for f, o in requests]
    b6_serve_launches = counts()
    for (f, _), p in zip(requests, b6_outputs):
        check(p.shape == (len(f), mc.num_classes) and bool(np.isfinite(p).all()), f"B6 config probs {p.shape}")
        check(bool(np.allclose(p.sum(-1), 1.0, atol=1e-5)), "B6 config probs rows sum to 1")
        print(f"B6 config request {len(f)} pairs -> probs {p.shape}, first row {p[0].tolist()}", flush=True)
    b6_serve_routes = dict(ba.SUBLAYER_ROUTES)
    want = {name: 0 for name in b6_serve_launches}
    want[B6] = n_b6 * batches
    print(f"B6 config serving launches over {batches} batches: {b6_serve_launches} (expected {want}); B6 routes "
          f"{b6_serve_routes}", flush=True)
    check(b6_serve_launches == want, f"B6 config serving launches {b6_serve_launches}")
    check(b6_serve_routes == {"wgmma": n_b6 * batches, "fma": 0}, f"B6 config serving: routes {b6_serve_routes}")

    # -- 19. training the B6 configuration at full width -----------------------
    b6_state = trainer.init_state(b6_cfg, seed=0, device=dev)
    b6_step = trainer.make_train_step(b6_cfg)
    before = {k: v.detach().clone() for k, v in b6_state.model.state_dict().items()}
    gen_b6 = seeded(21)
    reset_counts()
    b6_outs = [b6_step(b6_state, batch, gen_b6) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    b6_launches = counts()
    b6_routes = dict(ba.SUBLAYER_ROUTES)
    # Per step: 2 * n_b6 forwards and as many backwards, each backward two
    # Dense layers' launches, all on wgmma.
    print(f"B6 config train, {TRAIN_STEPS} steps: B6 routes {b6_routes} (forward and backward)", flush=True)
    check(b6_routes == {"wgmma": 6 * n_b6 * TRAIN_STEPS, "fma": 0},
          f"B6 config train: routes {b6_routes}, expected every launch on wgmma")
    check_routes(f"B6 config train, {TRAIN_STEPS} steps", dict(wa.BWD_ROUTES), 2 * n_b6 * TRAIN_STEPS)
    # Forward: B6's attention phase and the backward's B2 recompute.
    check_routes(f"B6 config train, {TRAIN_STEPS} steps", dict(wa.FWD_ROUTES), 4 * n_b6 * TRAIN_STEPS, "forward")
    for i, out in enumerate(b6_outs):
        loss, mmd_v = out["loss"].item(), out["mmd"].item()
        print(f"B6 config train step {i}: loss {loss:.6f}, mmd {mmd_v:.6f}", flush=True)
        check(np.isfinite(loss) and np.isfinite(mmd_v), f"B6 config step {i}: loss {loss}, mmd {mmd_v}")
    after = b6_state.model.state_dict()
    changed = sum(not torch.equal(before[n], after[n]) for n, _ in b6_state.model.named_parameters())
    n_tensors = sum(1 for _ in b6_state.model.parameters())
    print(f"B6 config parameters changed: {changed} of {n_tensors} tensors", flush=True)
    check(changed >= n_tensors - 4, f"B6 config: only {changed} of {n_tensors} parameter tensors changed")
    del before, after
    want = {name: 0 for name in b6_launches}
    want.update({B6: 2 * n_b6, B6_BWD: 4 * n_b6, V2: 2 * n_b6, V2_BWD: 2 * n_b6, LN_BWD: 2 * n_b6})
    want = {name: TRAIN_STEPS * n for name, n in want.items()}
    print(f"B6 config train launches over {TRAIN_STEPS} steps: {b6_launches} (expected {want})", flush=True)
    check(b6_launches == want, f"B6 config train launches {b6_launches}")
    train_launches[B6] = b6_launches[B6]
    train_launches[B6_BWD] = b6_launches[B6_BWD]
    train_launches[LN_RES] = b6_launches[LN_BWD]

    # -- 20. every B6 call of a bf16 step against the plain versions -----------
    held_b6 = {B6: [], "B6 backward": [], "B6 dbias": [], "B6 dbias on the kernel's do": []}
    b6_controls = []
    b6_kernels = (ba.attention_sublayer_fwd_kernel, ba.attention_sublayer_bwd_kernel)

    def held_b6_fwd(*args_):
        got = b6_kernels[0](*args_)
        held_b6[B6].append(max(rel_err(g, w_) for g, w_ in zip(got, ba.attention_sublayer_reference(*args_))))
        return got

    def held_b6_bwd(*args_):
        got = b6_kernels[1](*args_)
        want_ = ba.attention_sublayer_bwd_reference(*args_)
        held_b6["B6 backward"].append(max(rel_err(g, w_) for g, w_ in zip(got[:7], want_[:7])))
        _, _, qkv_, _, _, wproj_, bias_, dy_, h_, scale_ = args_
        r = sd.readings(got[7], want_[7], qkv_, wproj_, bias_, dy_, h_, scale_, controls=True)
        held_b6["B6 dbias"].append(r["independent"])
        held_b6["B6 dbias on the kernel's do"].append(r["kernel_do"])
        b6_controls.append((r["rounded"], r["truncated"]))
        return got

    ba.attention_sublayer_fwd_kernel, ba.attention_sublayer_bwd_kernel = held_b6_fwd, held_b6_bwd
    try:
        b6_step(b6_state, batch, seeded(22))
        torch.cuda.synchronize()
    finally:
        ba.attention_sublayer_fwd_kernel, ba.attention_sublayer_bwd_kernel = b6_kernels
    for name, bar in ((B6, BWD_BAR["bf16"]), ("B6 backward", BWD_BAR["bf16"]), ("B6 dbias", sd.DBIAS_BAR),
                      ("B6 dbias on the kernel's do", sd.KERNEL_DO_BAR)):
        e = held_b6[name]
        print(f"bf16 B6 config step, {name} held against its plain version on the step's own tensors: {len(e)} "
              f"calls, worst relative error {max(e):.3e}, median {statistics.median(e):.3e} (bar {bar:g})",
              flush=True)
        check(len(e) == 2 * n_b6 and max(e) <= bar, f"bf16 B6 step {name}: {len(e)} calls, worst {max(e)}")
    rounded, truncated = (min(c_) for c_ in zip(*b6_controls))
    print(f"bf16 B6 config step, dbias controls of bf16 precision, smallest over the calls: rounded {rounded:.3e}, "
          f"truncated do {truncated:.3e} (must read above the bar {sd.DBIAS_BAR:g})", flush=True)
    check(truncated > sd.DBIAS_BAR, f"bf16 B6 step: the truncated-do control reads {truncated}")
    torch.cuda.empty_cache()

    # -- 21. a small f32 model of the B6 configuration, card against CPU -------
    gcfg = tiny_test_config(batch_size=4)
    gcfg = gcfg.replace(model=dataclasses.replace(
        gcfg.model, swin_depths=(2, 2), swin_embed_dim=128, swin_heads=(1, 2), fundus_embed_dim=256,
        oct_embed_dim=128, vit3d_heads=2, use_fused_block_attention=True))
    g_cpu = trainer.init_state(gcfg, seed=0, device="cpu")
    g_gpu = trainer.init_state(gcfg, seed=0, device=dev)
    g_gpu.model.load_state_dict(g_cpu.model.state_dict())
    gbatch = trainer.random_views(gcfg, seed=5, device="cpu")
    gbatch["label"] = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    reset_counts()
    g_out = trainer.make_train_step(gcfg)(g_gpu, gbatch, seeded(4), draws=mr.small_draws(sm, dev))
    g_launches = counts()
    g_routes = dict(ba.SUBLAYER_ROUTES)
    c_out = trainer.make_train_step(gcfg)(g_cpu, gbatch, torch.Generator(), draws=mr.small_draws(sm, "cpu"))
    rows = mr.grad_errors(g_gpu, g_cpu)
    dl = abs(g_out["loss"].item() - c_out["loss"].item())
    print(f"small f32 B6 config step, card vs CPU: loss {g_out['loss'].item():.7g} vs {c_out['loss'].item():.7g} "
          f"(|d| {dl:.3e}, limit 1e-4 relative); per-tensor gradient error outside the key biases: median "
          f"{rows[len(rows) // 2][0]:.3e} (limit 1e-4), worst {rows[-1][0]:.3e} ({rows[-1][1]}; limit 1e-2); "
          f"card launches {g_launches}", flush=True)
    check(dl <= 1e-4 * abs(c_out["loss"].item()), f"small B6 step loss card vs CPU {dl}")
    check(rows[len(rows) // 2][0] <= 1e-4 and rows[-1][0] <= 1e-2,
          f"small B6 step gradients card vs CPU: median {rows[len(rows) // 2]}, worst {rows[-1]}")
    g_n = sum(gcfg.model.swin_depths) + gcfg.model.vit3d_depth
    want = {name: 0 for name in g_launches}
    want.update({B6: 2 * g_n, V2: 2 * g_n, V2_BWD: 2 * g_n, LN_BWD: 2 * g_n})
    check(g_launches == want, f"small B6 config launches {g_launches}, expected {want}")
    check(g_routes == {"wgmma": 0, "fma": 2 * g_n}, f"small f32 B6 step: routes {g_routes}, expected fma")
    del g_cpu, g_gpu

    # -- 22. the B6 configuration's step, serving forward and kernels, timed ---
    ship_state = trainer.init_state(cfg, seed=2, device=dev)
    runs = {}
    for label, st, fn in (("shipped", ship_state, train_step), ("B6", b6_state, b6_step),
                          ("B6", b6_state, b6_step), ("shipped", ship_state, train_step)):
        runs.setdefault(label, []).append(step_ms(st, fn))
    for label in ("B6", "shipped"):
        ms = statistics.median(runs[label])
        print(f"time train step, {label} config (kernel path), batch {bt} bf16, host clock to sync: {ms:.3f} "
              f"ms/step, {1000.0 * bt / ms:.1f} pairs/s (runs of 3 steps: {[round(x, 3) for x in runs[label]]}) "
              f"[{card}]", flush=True)
    del ship_state
    for label in ("B6", "shipped"):
        if label == "shipped":
            del b6_state
            torch.cuda.empty_cache()
            b6_state, b6_step = trainer.init_state(cfg, seed=2, device=dev), train_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        b6_step(b6_state, batch, gen_time)
        torch.cuda.synchronize()
        print(f"peak device memory, {label} config train step, its state alone on the card: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    del b6_state
    torch.cuda.empty_cache()
    ship_pred = Predictor(cfg, device=dev, seed=0)
    with torch.inference_mode():
        fwd = {}
        for label, p in (("shipped", ship_pred), ("B6", b6_pred), ("B6", b6_pred), ("shipped", ship_pred)):
            fwd.setdefault(label, []).append(runs_ms(lambda: p._forward(f_dev, o_dev), launches=1))
    for label in ("B6", "shipped"):
        ms = statistics.median(fwd[label])
        print(f"time full-width forward, {label} config, batch {b} bf16: {ms:.3f} ms/batch, "
              f"{1000.0 * b / ms:.1f} pairs/s (runs {fwd[label]}) [{card}]", flush=True)
    del ship_pred, b6_pred
    torch.cuda.empty_cache()

    def shipped_sublayer(x_, gamma_, beta_, wqkv_t, bqkv_, wproj_t, bproj_, bias_full, h_, scale_):
        """The shipped config's sublayer at the same shape: LayerNorm, Dense,
        B2, Dense and the residual, as the port's unfused modules run them
        (Dense weights [out, in], stored in bf16 as serving stores them)."""
        h = ln.layer_norm_reference(x_, gamma_, beta_)
        qkv_ = F.linear(h, wqkv_t, bqkv_.to(x_.dtype))
        o_ = wa.window_attention_fused_v2(qkv_, bias_full, h_, scale_)
        return x_ + F.linear(o_, wproj_t, bproj_.to(x_.dtype))

    def shipped_sublayer_bwd_ms(x_, gamma_, beta_, wqkv_t, bqkv_, wproj_t, bproj_, bias_full, h_, scale_, dy_):
        """The shipped sublayer's backward through autograd (LayerNorm,
        Dense, B2's backward kernel, Dense; the input, the parameters and
        the bias), as the shipped config's step runs it."""
        leaves = [t.detach().requires_grad_() for t in (x_, gamma_, beta_, wqkv_t, bqkv_, wproj_t, bproj_, bias_full)]
        out = shipped_sublayer(*leaves, h_, scale_)
        return runs_ms(lambda: torch.autograd.grad(out, leaves, dy_, retain_graph=True))

    b6_shipped_bwd_ms = 0.0
    b6_phases = {"forward": collections.defaultdict(float), "backward": collections.defaultdict(float)}
    for s_ in b6_train:
        args_, scale_ = sublayer_inputs(s_, torch.bfloat16)
        x_, gamma_, beta_, wqkv_, bqkv_, wproj_, bproj_, bias_ = args_
        h_, (b_, w_, n_, c_) = s_["heads"], x_.shape
        wqkv_t, wproj_t = wqkv_.T.contiguous(), wproj_.T.contiguous()
        bias_full = ba._full_bias(bias_, w_)
        with torch.no_grad():
            tk = runs_ms(lambda: ba.attention_sublayer_fwd_kernel(*args_, h_, scale_))
            tp = runs_ms(lambda: ba.attention_sublayer_reference(*args_, h_, scale_))
            ts = runs_ms(lambda: shipped_sublayer(x_, gamma_, beta_, wqkv_t, bqkv_, wproj_t, bproj_,
                                                         bias_full, h_, scale_))
            y_, qkv_, xln_ = ba.attention_sublayer_fwd_kernel(*args_, h_, scale_)
            dy_ = normal(tuple(y_.shape), torch.bfloat16)
            res = (x_, xln_, qkv_, gamma_, wqkv_, wproj_, bias_, dy_, h_, scale_)
            tb = runs_ms(lambda: ba.attention_sublayer_bwd_kernel(*res))
            tbp = runs_ms(lambda: ba.attention_sublayer_bwd_reference(*res))
            phases = {"forward": psl.phase_ms(lambda: ba.attention_sublayer_fwd_kernel(*args_, h_, scale_),
                                              psl.FWD_PHASES, attempts=PROFILE_ATTEMPTS),
                      "backward": psl.phase_ms(lambda: ba.attention_sublayer_bwd_kernel(*res), psl.BWD_PHASES,
                                               attempts=PROFILE_ATTEMPTS)}
        tsb = shipped_sublayer_bwd_ms(x_, gamma_, beta_, wqkv_t, bqkv_, wproj_t, bproj_, bias_full, h_, scale_, dy_)
        m_ = b_ * w_ * n_
        calls = 2 * s_["calls"]
        attn = 1.0 * b_ * w_ * n_ * n_ * c_
        # Forward bytes: x read; y, xln (C each) and qkv (3C) written; the weights, vectors and bias read once.
        nbytes = 2 * m_ * c_ * 6 + 2 * 4 * c_ * c_ + 4 * 6 * c_ + 4 * bias_.numel()
        report(B6, sublayer_label(s_) + " bf16", calls, tk, tp, None, nbytes, 8.0 * m_ * c_ * c_ + 4 * attn)
        # Backward bytes: x, xln, qkv (3C) and dy read, dx written (7 M C in
        # bf16); the weights read and their gradients written; gamma, the
        # biases' gradients; the bias read and its gradient written.
        # Operations: the four products (dwproj, do: 2 M C^2 each; dwqkv,
        # dxln: 6 M C^2 each) and what the attention needs from these
        # inputs, 2 per token pair and channel for each of S and PV (o, for
        # dwproj), dV, dP, dQ and dK; the kernel's second S is its own
        # recompute and not counted.
        nbytes = 2 * m_ * c_ * 7 + 2 * 2 * 4 * c_ * c_ + 4 * 8 * c_ + 2 * 4 * bias_.numel()
        report(B6_BWD, sublayer_label(s_) + " bf16", calls, tb, tbp, None, nbytes, 16.0 * m_ * c_ * c_ + 12 * attn)
        print(f"  beside them: the shipped sublayer (LayerNorm, Dense, B2, Dense) forward {ts:.4f} ms, backward "
              f"through autograd {tsb:.4f} ms per call [{card}]", flush=True)
        for kind, ms in phases.items():
            print(f"  B6 {kind} by phase (torch.profiler), ms per call: {ms['total']:.4f} in all; " + ", ".join(
                f"{p} {t:.4f}" for p, t in ms.items() if p != "total"), flush=True)
            for p, t in ms.items():
                b6_phases[kind][p] += calls * t
        b6_shipped_bwd_ms += calls * tsb
        totals[B6].setdefault("shipped_ms", 0.0)
        totals[B6]["shipped_ms"] += calls * ts
        del args_, x_, y_, qkv_, xln_, dy_, bias_full, res
        torch.cuda.empty_cache()
    print(f"B6 per batch-{bt} train step: forward kernel {totals[B6]['ms']:.3f} ms against the shipped sublayers' "
          f"{totals[B6]['shipped_ms']:.3f} ms; backward {totals[B6_BWD]['ms']:.3f} ms against the shipped "
          f"sublayers' autograd backward {b6_shipped_bwd_ms:.3f} ms [{card}]", flush=True)
    for kind, ms in b6_phases.items():
        print(f"B6 {kind} per batch-{bt} train step by phase (torch.profiler), ms: {ms['total']:.3f} in all; "
              + ", ".join(f"{p} {t:.3f}" for p, t in ms.items() if p != "total") + f" [{card}]", flush=True)

    # v1's own path: one forward and backward at each Swin stage of a batch-32
    # step, in v1's layout, counts set to 0 before and read after.
    v1_cases = []
    for b_, w_, h_, n_, d_, shifted, grid, window in v1_train:
        v1_cases.append(v1_inputs(b_, w_, h_, n_, d_, torch.bfloat16, shifted, grid, window))
    reset_counts()
    for q_, k_, v_, bias_, do_ in v1_cases:
        leaves = [t.detach().requires_grad_() for t in (q_, k_, v_, bias_)]
        wa.window_attention_fused(*leaves).backward(do_)
    torch.cuda.synchronize()
    v1_launches = counts()
    check_routes("v1 path", dict(wa.FWD_ROUTES), len(v1_cases), "forward")
    want = {name: 0 for name in v1_launches}
    want.update({V1: len(v1_cases), V1_BWD: len(v1_cases)})
    print(f"v1 path (one forward and backward per Swin stage, batch {bt}): launches {v1_launches}", flush=True)
    check(v1_launches == want, f"v1 path launches {v1_launches}, expected {want}")
    train_launches[V1] = v1_launches[V1] + v1_launches[V1_BWD]

    def v1_plain(q_, k_, v_, bias_, do_):
        return wa.window_attention_reference(q_, k_, v_, bias_), wa.window_attention_bwd_reference(
            q_, k_, v_, bias_, do_)

    # The kernels line takes the device-only times (CUDA graphs of 10 calls)
    # of v1, its plain version and SDPA's forward and backward (the bias as a
    # bf16 mask) alike; printed beside them their runs-of-10 times and v1's
    # host enqueue per call.
    v1_step_ms = collections.defaultdict(float)
    for case in v1_cases:
        b_, w_, h_, n_, d_ = case[0].shape
        timed = {"kernel": lambda: pv.v1_step(*case), "plain": lambda: v1_plain(*case),
                 "SDPA": lambda: pv.sdpa_step(*case)}
        tg = {k: graph_ms(f) for k, f in timed.items()}
        tr = {k: runs_ms(f) for k, f in timed.items()}
        te = enqueue_ms(timed["kernel"])
        elems = b_ * w_ * h_ * n_ * d_
        bias_bytes = w_ * h_ * n_ * n_ * 4
        # Forward and backward: q, k, v, do and bias read, o, dq, dk, dv and dbias written.
        report(V1, f"[{b_},{w_},{h_},{n_},{d_}] bf16 forward + backward", 1, tg["kernel"], tg["plain"], tg["SDPA"],
               8 * elems * 2 + 2 * bias_bytes, 14.0 * b_ * w_ * h_ * n_ * n_ * d_)
        both = lambda t: ", ".join(f"{k} {v:.4f}" for k, v in t.items())  # noqa: E731
        print(f"  {V1} [{b_},{w_},{h_},{n_},{d_}] ms per call: device-only (CUDA graphs) {both(tg)}; runs of 10 "
              f"{both(tr)}; host enqueue {te:.4f} [{card}]", flush=True)
        for key, v in (*((f"{k} device-only", v) for k, v in tg.items()),
                       *((f"{k} runs of 10", v) for k, v in tr.items()), ("host enqueue", te)):
            v1_step_ms[key] += v
    print(f"{V1} per batch-{bt} step (one forward and backward per Swin stage), ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in v1_step_ms.items()) + f" [{card}]", flush=True)
    del v1_cases
    torch.cuda.empty_cache()

    kernels = []
    for name in KERNEL_SOURCE:
        t = totals[name]
        peak = F32_FLOPS_PER_S if name in (MMD, MMD_BWD, LN, LN_BWD, LN_RES) else BF16_FLOPS_PER_S
        bms, by = bound(t["bytes"], t["flops"], peak)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE[name],
            "replaces": KERNEL_REPLACES[name],
            "launches": train_launches[name],
            "max_abs_err": max_err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None if name in (MMD, MMD_BWD, MLP, MLP_BWD, B6, B6_BWD, LN_RES) else t["library_ms"],
        })
    print("kernels: ms / plain_ms / library_ms / bound_ms are the device time of the launches one "
          f"batch-{bt} train step makes (sum over its shapes; B3 runs once each way, with use_pallas_mmd; B4 and B5 "
          f"in the use_fused_ln + use_fused_mlp config, B4's three rows, B3's two and v1's (ms, plain_ms and "
          f"library_ms alike) the device-only time of CUDA graphs of 10 calls, every other row runs of 10 calls "
          f"between CUDA events, which count the host where it is slower than the card; B4's residual form, B6's "
          f"LayerNorm backward, in the "
          f"use_fused_block_attention config; B6 its forward and backward launches in the "
          f"use_fused_block_attention config, the backward's row the whole composition of B2's kernels, the two "
          f"Dense layers' backwards and B4's; v1 one forward and backward per Swin stage of its own path); "
          f"launches: the main path's run ({TRAIN_STEPS} steps; B3: its one step; B4, B5, B6 and B4's residual "
          f"form: their configs' "
          f"{TRAIN_STEPS} steps; v1: its path's forward and backward launches); max_abs_err: worst bf16 check "
          f"at the main-path shapes (B3: f32, its backward's the worst gradient element) [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (serving, training, the CLIs, the baseline zoo, real data), and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is nonzero):

1. Require CUDA; print the card's name and power limit; turn TF32 off.
2. Build the CUDA kernels from ``edrl_tpu_torch/kernels/csrc`` (one nvcc per
   source, in parallel) and print the build time and the compiler's
   register/shared-memory report; for the attention's wgmma kernels,
   forward and backward (the rows and keys kernels; none may spill),
   registers at launch and after setmaxnreg, spills, shared memory and
   resident blocks per SM at the main-path shapes (N = 144 and 216,
   head_dim 128), and their CTAs and waves at each batch-32 call, and the
   forward's tensor maps (the C plan held to the layouts' dims and
   strides); the forward and the backward at B1's, B2's and v1's layouts on
   a view whose next group holds NaN (the tail tile's rows and keys past N
   come from TMA's zero fill: finite results within the bf16 bars), and at
   shapes where a consumer warpgroup has no tile in a work unit (forward:
   N = 100, half-items at N = 144 and 150; backward: B2 N = 100 over 1024
   items, B1 N = 150 and 17), CTAs walking 3 or more units, within the bf16
   bars three calls running;
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
   forward and backward launch on the wgmma route.  Then
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
    its plain version (B1 and B2 forward also device-only, CUDA graphs,
    beside their runs of 10 and the host enqueue, and one call between two
    events, the dispatch included, with SDPA's time taken the same way), one
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

Then the system's own entry points, in the shipped config:

23. ``python -m edrl_tpu_torch.cli.train`` in this process (``main``): 2
    epochs at batch 16 over 48 synthetic samples, clean uint8 batches from
    the host loader, augmented and corrupted on the card in each step
    (device noise on, the CLI's default), checkpoints and logs in a
    temporary directory that the phase removes.  Checked: each epoch's Train
    and Val lines with finite losses, the CSV rows, a ``best`` checkpoint,
    the Test line, the 10-metric uncertainty suite and the fundus-only and
    oct-only lines; the model's inputs and parameters on the card; B1's and
    B2's launches (24 a step forward and backward, 12 an eval batch forward,
    every one on the tensor-core route) and no other kernel's.  Then
    ``cli.test`` on that ``best``: the same four lines as the train&test
    block.  Then the step's input stage on the card against the CPU at
    batch 16 with the same draws (atol 1e-6).  Printed: train pairs/s per
    epoch, the host's wait on the loader per batch and its share of the
    epoch, the seconds of each checkpoint save and restore, the input
    stage's ms per batch and the kernels it launches.

Then the baseline zoo (``edrl_tpu_torch.baselines``) and the evaluation
surfaces over it:

24. Every registry name at full width in the shipped config: one dual-view
    train step at batch 4 and one eval forward, with a finite loss,
    probabilities that sum to 1 and the JAX model's feature width
    (``ZOO_FEATURE_WIDTH``); B1 and B2 launched (in the names with a Swin or
    ViT), all on the tensor cores.  ``Multi_ResNet`` in f32 with cuDNN's
    TF32 off (``trainer.set_conv_precision``), on the card against the CPU
    at batch 2: the eval forward (1e-4 of the largest magnitude), the
    eval-mode loss's gradients in f64 (1e-10) and a train step in f64 (loss
    1e-4, gradients at phase 9's f32 bars), the f32 train step's loss
    (1e-4), and the f32 gradients of the eval-mode loss and of the train
    step, the card's and the CPU's each against the CPU's f64 ones (the
    card's within ``ZOO_WITNESS`` times the CPU's or the CPU tests' floors,
    below 1); then 3 timed
    steps at batch 32 (ms, pairs/s, peak memory), and the same with TF32
    on, printed as a finding only.  ``Trans_cross`` in bf16 with the
    shipped flags at batch 32: every attention call of one step held against
    its plain version (phase 9's hook), 48 + 48 tensor-core launches a step,
    3 timed steps.  Then, in a temporary directory under ``build/`` that the
    phase removes: ``cli.ensemble --members 2`` (``Metric.txt`` with its
    10 metrics, finite), ``Predictor.from_checkpoints`` over the two members
    on 21 pairs against the softmax of the mean of the members' logits
    computed one member at a time (f32 atol 1e-5), ``cli.train --model_name
    Multi_dropout_ResNet`` and ``cli.test --mc_samples 4 --sweep gaussian
    --sweep_levels 0.0 0.3`` on its checkpoint (a nonzero mean predictive
    std, the sweep's 6 cells).

Then the serving half of A10, in the shipped config:

25. ``Predictor(quantize_int8=True)`` at full width (seeded weights): every
    int8 product of one batch (``torch._int_mm``, the M = 16 calls padded)
    equal to an exact f64 reference of its operands; the three requests
    against the bf16 ``Predictor`` at the JAX package's int8 bars (top-1
    agreement >= 0.9, max |dp| < 0.15), the card's int8 against the CPU's on
    two pairs, B1/B2 12 launches each a batch on the tensor cores; the same
    with static scales calibrated on the 40-pair request (percentile 100 and
    99.9); ``chunk_batches=4`` on 70 pairs, bf16, int8 and static int8: equal to the
    per-batch forward at 1e-6, the graph captured once and replayed, B1/B2's
    counts = replays x the capture's + the eager tail; the serving forward's
    ms and pairs/s at batch 16 (section 2's method), device busy and kernels
    a batch, for bf16, int8 dynamic, int8 static and the three chunk graphs;
    ``_int_mm`` against bf16 ``F.linear`` (and the whole int8 Dense against
    the bf16 Dense) at the four heaviest Dense shapes; ``export`` round trips
    (bf16, int8) with max |d| 0, the loaded program's 12 + 12 B1/B2
    operators launching the kernels on a second seed's weights equal to a
    live predictor; ``cli.predict --num 40 --int8 --int8_calibrate 16
    --chunk_batches 2`` (40 CSV rows) in a temporary directory under
    ``build/`` that the phase removes.

Then the real-data path (ROADMAP A7's second half), in the shipped config:

26. A GAMMA tree in a temporary directory under ``build/``, written by the
    port's own writers (no cv2, PIL or pandas): 40 samples, each a
    2000x2992x3 fundus PNG (smooth and structured, its rows cycling the
    five filter types) and a (256, 256, 200) f32 OCT NIfTI; every third id
    zero-padded on disk, one ``processed_data_`` fallback; xlsx labels for
    dr2 (two rows with no directory), csv labels for glu2 in a shuffled
    order.  Checked: a decoded fundus equals the pixels written;
    ``tools.verify_dataset --deep`` (four samples) exits 0, and 1 on a copy
    of three samples with a planted bad CRC, naming the file;
    ``tools.build_cache --workers 2`` caches half the ids; ``cli.train
    --dataset dr2`` (fold 0: 32 train, 8 val; batch 16, 2 epochs) reads
    both cache hits and misses in epoch 1, and each miss equals its cached
    read byte for byte; ``cli.test`` on its best (with a 2-level sweep over
    every sample) prints the train run's test block; ``cli.train --dataset
    glu2`` (1 epoch, 80/20 in the csv's order); B1's and B2's launches in
    each run at phase 23's per-step counts, all tensor-core; no module of
    cv2, PIL or pandas imported.  Printed: ms per sample of each cache-miss
    stage (PNG decode, cubic resize, NIfTI read, volume zoom), ms per cache
    hit, each epoch's train pairs/s and the loader's wait as a share of it.

Then data and tensor parallelism (ROADMAP A11), on the one card, in the
shipped config at full width made f32 (the bars of a step's results):

27. (a) World 1 over NCCL (a TCP store on a free localhost port): for plain
    MK-MMD, B3's, and ZeRO-1 (``ZeroRedundancyOptimizer`` built directly:
    on one rank ``make_optimizer`` keeps the plain Adam, as the JAX package
    shards nothing on one device), 3 steps at global batch 32 through the
    mesh's step path (the data axis current, ``gather_rows`` before the
    MK-MMD, DILR's summed BatchNorm statistics and gathered Barlow, the
    flat all-reduce of the gradients) held against the step with no mesh on
    the same inputs and draws, loss, MMD, probabilities and every gradient
    at atol 2e-4 / rtol 1e-3, with B1's and B2's launches equal on both;
    the ZeRO-1 state saved through the mesh's checkpoint manager
    (consolidated) restores on one card.  (b) World 2 on the same card, two
    spawned processes over gloo, 16 rows each: each collective the step
    uses is first tried on CUDA tensors, and the part is left out, naming
    the collective, where gloo refuses one; else the first step is held
    against (a)'s at the same bars, and a ZeRO-1 state with a 0-d parameter
    (as EPRL's ``alpha``), saved consolidated and restored on both ranks,
    steps on exactly as the state never saved.  (c) ``cli.train`` (1 epoch, batch 16)
    and ``cli.test`` on its best with ``torchrun``'s environment at
    ``WORLD_SIZE=1``: they join no process group and build no mesh (the JAX
    CLI's rule: a mesh only over more than one device), equal test blocks,
    B1 and B2 launched.  The CLIs' mesh branch needs two cards (NCCL takes
    one rank a card); ``tools/profile_data_parallel.py`` drives it on four.
28. Tensor parallelism on the one card: two spawned processes over gloo on
    CUDA tensors as a ``(1, 2)`` mesh (each collective the model axis uses
    tried first on CUDA tensors; a refusal fails the phase, naming it).
    The shipped model at full width and depth, f32, global batch 8: two
    steps against one card's (loss, MMD, probabilities, every gradient
    gathered to full shape, at atol 2e-4 / rtol 1e-3), the replicated
    parameters' gradients as the two ranks computed them, before the
    step's broadcast from model rank 0, equal bit for bit, B1 and B2
    launched a step on each rank on both routes (Swin's stage 0 of 1 head
    gathered, its other stages and ViT's 6 heads head-local, forward and
    backward); the checkpoint saved through the mesh (full shapes) restored
    in one process equal to the sharded state; the ``(1, 2)`` ``Predictor``
    against one card's on a 16-pair request, bf16 at 2e-2 and int8 at 1e-4.
    ``tools/profile_data_parallel.py --num_model_shards 2 4`` drives
    ``(2, 2)`` and ``(1, 4)`` on four cards.
29. The baseline zoo over a model axis on the one card: two spawned
    processes over gloo as a ``(1, 2)`` mesh, started once for every family
    (``ZOO_TP_PLAN``), f32 at global batch 8: Trans_cross at full width and
    depth, two steps; 2D_transformer, 3D_transformer, MLC_trans and IMDR one
    step each at full width cut to one block a Swin stage and one ViT block,
    Multi_ResNet_cross and Multi_ResNet one step each.  Each held against
    one card's steps on the same inputs and draws (loss, MMD,
    probabilities, every gradient gathered to full shape) at atol 2e-4 /
    rtol 1e-3, printed beside the one-card steps' own reading under a
    one-ulp move of every input; the replicated gradients as the two ranks
    computed them, before the step's broadcast from model rank 0, equal bit
    for bit (the CNN families, whose cuDNN weight gradients and pool
    backwards sum in no fixed order on the card: within 2e-4, the bars'
    atol); the model axis's collectives a step, the broadcast's among
    them; B1 and B2 launched on each rank on the routes each family's
    heads give, forward and backward.  Trans_cross's ``Predictor`` on the
    mesh (shipped bf16, full depth) in chunks of 2 on the staged route
    equal to its batch-by-batch output at 1e-6.  ``cli.train`` with no mesh,
    1 epoch at batch 16, ``--scan_batches 4`` against ``0``: the CSV rows
    and the ``best`` checkpoint bit-equal.

Then the accuracy study (ROADMAP A8):

30. ``tools.ablation_study`` (the port's ``scripts/ablation_study.py``) on
    the fusion protocol at full width, cut in depth: full EDRL, seed 0, one
    epoch of 32 train and 16 val samples at batch 16, warmup 100, sigmas 0
    and 0.5, into a temporary directory under ``build/``, with the JAX
    package's table as the parity rows (no row has this protocol).  Checked:
    one row with the JAX rows' keys, its sweep the 3 modalities x 2 sigmas
    cells of 16 samples with finite metrics, per-epoch histories, B1's and
    B2's launches in ``fit`` (2 steps and one val batch) and in the sweep
    all on "wgmma", no B3, B4, B5 or B6 launch; a second call trains
    nothing (the row cached, the file unchanged, no launch).  Printed: the
    step's ms, ``fit``'s seconds and the phase's.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script imports no JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import queue
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
# How far from the CPU's f64 results the card's f32 gradients of a CNN
# baseline may read: within ZOO_WITNESS times the CPU's own f32 distance, or
# the floors, at the median over the tensors and at the worst, and below 1
# at the worst.  The CPU tests' rule (tests/test_torch_baselines.py WITNESS,
# GRAD_REL, GRAD_WORST_REL: a ReLU or max-pool window flipped by f32
# rounding in one run moves one tensor by a few 1e-2).
ZOO_WITNESS, ZOO_MEDIAN_FLOOR, ZOO_WORST_FLOOR = 3.0, 1e-3, 5e-2
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
# The attention backward's wgmma route (B1, B2, v1, B2 under B6): the rows
# kernel (dq, the row statistics, dbias) and the keys kernel (dk, dv).
ATTENTION_BWD_KERNELS = ("attention_bwd_rows_kernel", "attention_bwd_keys_kernel")
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
# The route each row's bf16 main-path launches take on the card (the routes'
# counts are checked where the main path runs); rows with one route: None.
DEVICE_ROUTE = {SA: "wgmma", V2: "wgmma", SA_BWD: "wgmma", V2_BWD: "wgmma", MLP: "wgmma", MLP_BWD: "wgmma",
                B6: "wgmma", B6_BWD: "wgmma", V1: "wgmma", MMD: "cluster"}
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


# Each registry name's feature width at the shipped config, as the JAX model
# gives it (``jax.eval_shape`` of its eval forward).
ZOO_FEATURE_WIDTH = {
    "MedFusion": 3072, "IMDR": 3072, "Res2Net2D": 2048, "ResNet3D": 512, "Multi_ResNet": 2560,
    "Multi_ResNet_cross": 512, "Multi_EF_ResNet": 512, "Multi_CBAM_ResNet": 2560, "Multi_dropout_ResNet": 2560,
    "Base_transformer": 768, "2D_transformer": 768, "3D_transformer": 768, "Trans_cross": 1024, "MLC": 2560,
    "MLC_trans": 1792, "Medical_2DNet": 2048, "Medical_base_dropout_2DNet": 2048, "Medical_3DNet": 512,
    "Medical_base_dropout_3DNet": 512, "Multi_ensemble_ResNet": 2560, "Multi_ensemble_3D_ResNet": 2560,
    "Multi_DE1_ResNet": 2560, "Multi_DE2_ResNet": 2560, "Multi_DE3_ResNet": 2560, "Multi_DE4_ResNet": 2560,
    "Multi_DE5_ResNet": 2560,
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


class TimedLoader:
    """A loader whose epochs record the host's wait for each batch."""

    def __init__(self, loader):
        self.loader, self.dataset, self.waits = loader, loader.dataset, collections.defaultdict(list)

    def __len__(self):
        return len(self.loader)

    def epoch(self, epoch):
        it = self.loader.epoch(epoch)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits[epoch].append(time.perf_counter() - t)
            yield batch


class Tee(io.StringIO):
    """Captures what is printed and passes it on."""

    def write(self, s):
        sys.__stdout__.write(s)
        return super().write(s)


def test_block(log):
    """The Test, uncertainty-suite and missing-modality lines of a CLI log."""
    import numpy as np

    keys = ("Test: Acc", "Uncertainty suite: ", "Missing-modality [fundus-only]", "Missing-modality [oct-only]")
    lines = [line.split("===> ", 1)[1] for line in log.splitlines() if any(k in line for k in keys)]
    check(len(lines) == 4, f"test block lines {lines}")
    # The dict the CLI printed, with its floats rounded.
    suite = eval(lines[1].split("Uncertainty suite: ", 1)[1], {"nan": float("nan")})
    check(len(suite) == 10 and all(np.isfinite(v) for v in suite.values()), f"uncertainty suite {suite}")
    return lines


def serving_half(cfg, card, requests, reset_counts, counts) -> None:
    """Phase 25: int8 (dynamic and calibrated), the chunk graph, export and
    ``cli.predict`` on the shipped config at full width (seeded weights);
    ``requests`` are phase 4's uint8 requests of 16, 5 and 40 pairs."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from edrl_tpu_torch.cli import predict as predict_cli
    from edrl_tpu_torch.kernels import window_attention as wa
    from edrl_tpu_torch.models.layers import Dense, init_parameters
    from edrl_tpu_torch.ops import quantization as quant
    from edrl_tpu_torch.serve import export
    from edrl_tpu_torch.serve.predictor import Predictor
    from edrl_tpu_torch.tools.timing import runs_ms
    from edrl_tpu_torch.train import trainer

    dev = torch.device("cuda")
    mc, d = cfg.model, cfg.data
    b = d.eval_batch_size
    n_batches = sum(-(-len(f) // b) for f, _ in requests)
    f16, o16 = requests[0]

    t0 = time.perf_counter()
    p16 = Predictor(cfg, device=dev, seed=0)
    ref = np.concatenate([p16.predict_probs(f, o) for f, o in requests])
    print(f"serving half: bf16 predictor built and served in {time.perf_counter() - t0:.1f} s; its probabilities of "
          f"class 1 over the {len(ref)} pairs lie in [{ref[:, 1].min():.4f}, {ref[:, 1].max():.4f}]", flush=True)

    def served(label, pred):
        """Serve the three requests, hold them against bf16 at JAX's int8
        bars, and check B1/B2's launches (12 each a batch, tensor cores)."""
        reset_counts()
        quant.reset_launch_counts()
        got = np.concatenate([pred.predict_probs(f, o) for f, o in requests])
        launches, routes = counts(), dict(wa.FWD_ROUTES)
        agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
        dp = float(np.abs(got - ref).max())
        print(f"{label}: against bf16 over {len(got)} pairs top-1 agreement {agree:.4f} (bar 0.9), max |dp| "
              f"{dp:.4e} (bar 0.15); B1/B2 launches {launches[SA]}/{launches[V2]} over {n_batches} batches, "
              f"forward routes {routes}; int8 products {dict(quant.INT8_MATMULS)}", flush=True)
        check(bool(np.isfinite(got).all()) and agree >= 0.9 and dp < 0.15, f"{label} against bf16: {agree} {dp}")
        check(launches[SA] == launches[V2] == 12 * n_batches and routes == {"wgmma": 24 * n_batches, "fma": 0},
              f"{label} launches {launches} routes {routes}")
        return got

    # int8, dynamic: every product of one batch against its exact reference.
    t0 = time.perf_counter()
    p8 = Predictor(cfg, device=dev, seed=0, quantize_int8=True)
    r = p8.quant_report
    kept = [n for n, m in p8.model.named_modules() if isinstance(m, Dense)]
    print(f"int8 predictor built in {time.perf_counter() - t0:.1f} s: {r['dense_modules_quantized']}/"
          f"{r['dense_modules_seen']} Dense modules quantized (float: {kept}); parameter bytes "
          f"{r['param_bytes_before']} -> {r['param_bytes_after']}", flush=True)
    check(r["dense_modules_quantized"] > 0 and r["dense_modules_seen"] == r["dense_modules_quantized"] + len(kept),
          f"int8 report {r['dense_modules_seen']} {r['dense_modules_quantized']} {kept}")
    calls = []
    original = quant.int8_matmul

    def recorded(x_q, w_q):
        out = original(x_q, w_q)
        # Exact in f64: |sum| <= K * 127^2 < 2^53.
        calls.append((tuple(x_q.shape), tuple(w_q.shape), torch.equal(out.double(), x_q.double() @ w_q.double().t())))
        return out

    quant.int8_matmul = recorded
    try:
        p8.predict_probs(f16, o16)
    finally:
        quant.int8_matmul = original
    shapes = sorted({(x[0], x[1], w[0]) for x, w, _ in calls})
    padded = [c for c in calls if c[0][0] < quant.INT_MM_MIN_ROWS]
    print(f"int8 products of one batch: {len(calls)} calls at {len(shapes)} shapes (M, K, N) {shapes}; "
          f"{len(padded)} with M <= 16, padded to {quant.INT_MM_MIN_ROWS} rows; every result equal to the exact "
          f"reference: {all(c[2] for c in calls)}", flush=True)
    check(len(calls) >= r["dense_modules_quantized"] and all(c[2] for c in calls) and padded,
          f"int8 products: {len(calls)} calls, {sum(not c[2] for c in calls)} inexact, {len(padded)} padded")
    got8 = served("int8 dynamic", p8)

    # The card's int8 against the CPU's on the 5-pair request's first two
    # pairs (batch 2 on the CPU, the card's guided uniforms of those rows).
    cpu_cfg = cfg.replace(data=dataclasses.replace(d, eval_batch_size=2))
    master = trainer.make_model(cfg, dev).eval()
    init_parameters(master, torch.Generator(device=dev).manual_seed(0))
    cpu_model = trainer.make_model(cpu_cfg, "cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in master.state_dict().items()})
    del master
    u2 = tuple(t[:2].cpu().numpy() for t in p8.guided_uniform)
    t0 = time.perf_counter()
    p8_cpu = Predictor(cpu_cfg, cpu_model, device="cpu", quantize_int8=True, guided_uniform=u2)
    cpu_probs = p8_cpu.predict_probs(requests[1][0][:2], requests[1][1][:2])
    card_rows = got8[len(f16):len(f16) + 2]
    dp_cpu = float(np.abs(cpu_probs - card_rows).max())
    print(f"int8 dynamic, card against CPU on 2 pairs: max |dp| {dp_cpu:.4e} (bar 0.15), top-1 "
          f"{(cpu_probs.argmax(-1) == card_rows.argmax(-1)).tolist()}; CPU {time.perf_counter() - t0:.1f} s", flush=True)
    check(dp_cpu < 0.15, f"int8 card against CPU {dp_cpu}")
    del p8_cpu, cpu_model

    # int8, static: calibrated on the 40-pair request.
    static = {}
    for pct in (100.0, 99.9):
        t0 = time.perf_counter()
        ps = Predictor(cfg, device=dev, seed=0, quantize_int8=True, int8_calibration=requests[2],
                       int8_calib_percentile=pct)
        print(f"int8 static, percentile {pct}: built and calibrated on 40 pairs in {time.perf_counter() - t0:.1f} s, "
              f"{ps.quant_report['static_activation_scales']} static activation scales", flush=True)
        served(f"int8 static p{pct}", ps)
        static[pct] = ps
    p8s = static.pop(100.0)
    del static
    torch.cuda.empty_cache()

    # chunk_batches = 4 on 70 pairs: one chunk of 4 batches and a tail.
    rng = np.random.default_rng(25)
    f70 = rng.integers(0, 256, (70, d.fundus_size, d.fundus_size, 3), dtype=np.uint8)
    o70 = rng.integers(0, 256, (70, *d.oct_size, 1), dtype=np.uint8)
    chunked = {}
    for label, base, kw in (("bf16", p16, {}), ("int8", p8, dict(quantize_int8=True)),
                            ("int8 static", p8s, dict(quantize_int8=True, int8_calibration=requests[2]))):
        per_batch = base.predict_probs(f70, o70)
        pc = Predictor(cfg, device=dev, seed=0, chunk_batches=4, **kw)
        t0 = time.perf_counter()
        first = pc.predict_probs(f70, o70)
        capture_s = time.perf_counter() - t0
        graph = pc.chunk_graph
        reset_counts()
        quant.reset_launch_counts()
        second = pc.predict_probs(f70, o70)
        launches, int8_calls = counts(), dict(quant.INT8_MATMULS)
        captured = graph.launches[0]
        err = max(float(np.abs(first - per_batch).max()), float(np.abs(second - per_batch).max()))
        print(f"chunk_batches 4, {label}, 70 pairs (a chunk of 4 batches and a tail): max |dp| against the per-batch "
              f"forward {err:.3e} (bar 1e-6); the first request {capture_s:.1f} s with the capture; captures 1, "
              f"replays {graph.replays}; per replay B1/B2 {captured[SA]}/{captured[V2]} launches; the second "
              f"request's B1/B2 {launches[SA]}/{launches[V2]}, int8 products {int8_calls}", flush=True)
        check(err <= 1e-6 and pc.chunk_graph is graph and graph.replays == 2, f"chunked {label}: {err}")
        check(captured[SA] == captured[V2] == 48 and launches[SA] == launches[V2] == 48 + 12,
              f"chunked {label} launches {captured} {launches}")
        if kw:
            check(int8_calls[quant.INT_MM] == graph.launches[-1][quant.INT_MM] * 5 // 4,
                  f"chunked int8 products {int8_calls} {graph.launches[-1]}")
        chunked[label] = pc
        del per_batch, first, second

    # Timings: ms per batch of 16 (PERF.md section 2), device busy and kernels.
    from torch.profiler import ProfilerActivity, profile

    f_dev, o_dev = p16._to_device(f16), p16._to_device(o16)
    fc = p16._to_device(f70[:64]).reshape(4, b, *f70.shape[1:])
    oc = p16._to_device(o70[:64]).reshape(4, b, *o70.shape[1:])
    paths = {
        "bf16 eager": (lambda: p16._forward(f_dev, o_dev), 1),
        "int8 dynamic eager": (lambda: p8._forward(f_dev, o_dev), 1),
        "int8 static eager": (lambda: p8s._forward(f_dev, o_dev), 1),
        "bf16 chunk graph": (lambda: chunked["bf16"]._forward_chunk(fc, oc), 4),
        "int8 dynamic chunk graph": (lambda: chunked["int8"]._forward_chunk(fc, oc), 4),
        "int8 static chunk graph": (lambda: chunked["int8 static"]._forward_chunk(fc, oc), 4),
    }
    times = {label: [] for label in paths}
    with torch.inference_mode():
        for label in [*paths, *reversed(paths)]:
            fn, per = paths[label]
            times[label].append(runs_ms(fn, launches=1) / per)
        for label, (fn, per) in paths.items():
            ms = statistics.median(times[label])
            busy, kernels = None, 0
            for _ in range(PROFILE_ATTEMPTS):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                events = [e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
                if events:
                    busy = sum(e.time_range.elapsed_us() for e in events) / 1000.0 / per
                    kernels = len(events) / per
                    break
            print(f"time serving forward, {label}, batch {b}: {ms:.3f} ms/batch, {1000.0 * b / ms:.1f} pairs/s "
                  f"(runs {[round(t, 3) for t in times[label]]}); device busy "
                  f"{'not measured' if busy is None else f'{busy:.3f} ms'} over {kernels:.0f} kernels a batch "
                  f"(torch.profiler) [{card}]", flush=True)
    del chunked, p8s
    torch.cuda.empty_cache()

    # _int_mm against bf16 F.linear at the forward's four heaviest Dense shapes.
    for m, k, n in ((3456, 768, 3072), (3456, 3072, 768), (9216, 512, 2048), (147456, 128, 512)):
        gen = torch.Generator(device=dev).manual_seed(m + k)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        dense = Dense(k, n, dtype=torch.bfloat16, device=dev)
        init_parameters(dense, gen)
        int8_dense = quant.Int8Dense(dense, *quant.quantize_weight(dense.weight))
        x_q, w_q = quant._dynamic_quantize_rows(x.float())[0], int8_dense.weight
        w_bf16 = dense.weight.to(torch.bfloat16)
        with torch.inference_mode():
            t_int = runs_ms(lambda: torch._int_mm(x_q, w_q.t()))
            t_bf = runs_ms(lambda: F.linear(x, w_bf16))
            t_q = runs_ms(lambda: int8_dense(x))
            t_d = runs_ms(lambda: dense(x))
        b_int, by_int = bound(m * k + n * k + 4 * m * n, 2.0 * m * k * n, 2 * BF16_FLOPS_PER_S)
        b_bf, by_bf = bound(2 * (m * k + n * k + m * n), 2.0 * m * k * n, BF16_FLOPS_PER_S)
        print(f"time [{m},{k}]->{n}: _int_mm {t_int:.4f} ms (bound {b_int:.4f}, {by_int}), bf16 F.linear "
              f"{t_bf:.4f} ms (bound {b_bf:.4f}, {by_bf}); the whole int8 Dense (quantize, product, rescale) "
              f"{t_q:.4f} ms against the bf16 Dense {t_d:.4f} ms [{card}]", flush=True)
        del x, dense, int8_dense, x_q, w_q, w_bf16
    torch.cuda.empty_cache()

    # Export: the round trip, the program's operators, another seed's weights.
    f32_in = (f_dev.float() / 255.0, o_dev.float() / 255.0)
    for label, pred in (("bf16", p16), ("int8", p8)):
        t0 = time.perf_counter()
        same, delta = export.roundtrip_check(pred, *f32_in)
        print(f"export round trip, {label}: same shape and dtype {same}, max |d| {delta} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        check(same and delta == 0.0, f"export round trip {label}: {same} {delta}")
    blob = export.export_forward(p16)
    loaded = export.ExportedForward(blob)
    ops = export.program_ops(loaded.program)
    other = Predictor(cfg, device=dev, seed=1)
    reset_counts()
    served_other = loaded(other.serving_state(), *f32_in)
    launches = counts()
    with torch.inference_mode():
        live_other, live = other._forward(*f32_in), p16._forward(*f32_in)
    print(f"exported bf16 program: {len(blob) / 2**20:.1f} MiB, no weights in it "
          f"({len(loaded.program.state_dict)} tensors); it calls {collections.Counter(ops)}; on a second seed's "
          f"weights B1/B2 launch {launches[SA]}/{launches[V2]} times and the result equals the live predictor's: "
          f"{torch.equal(served_other, live_other)}", flush=True)
    check(ops.count("self_attention_fwd") == 12 and ops.count("window_attention_v2_fwd") == 12
          and not loaded.program.state_dict and loaded.program.example_inputs is None,
          f"exported program {collections.Counter(ops)}")
    check(launches[SA] == launches[V2] == 12 and torch.equal(served_other, live_other)
          and not torch.equal(served_other, live), f"exported program on other weights {launches}")
    del p16, p8, loaded, other
    torch.cuda.empty_cache()

    # cli.predict in this process.
    tmp = Path(tempfile.mkdtemp(prefix="predict_cli_", dir=REPO / "build"))
    try:
        t0 = time.perf_counter()
        predict_cli.main(["--num", "40", "--int8", "--int8_calibrate", "16", "--chunk_batches", "2",
                          "--output", str(tmp / "probs.csv")])
        rows = np.loadtxt(tmp / "probs.csv", delimiter=",")
        print(f"cli.predict --num 40 --int8 --int8_calibrate 16 --chunk_batches 2: {rows.shape[0]} CSV rows in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(rows.shape == (40, mc.num_classes) and bool(np.allclose(rows.sum(-1), 1.0, atol=1e-4)),
              f"cli.predict CSV {rows.shape}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not tmp.exists(), "cli.predict's temporary directory is removed")


# Phase 26, the real-data path: the tree it writes (a GAMMA layout at the
# sizes the reference's readers are written for) and what it samples.
REAL_SAMPLES = 40
REAL_FUNDUS = (2000, 2992)        # the clip window's scan (edrl_tpu/data/gamma.py:269-270)
REAL_OCT_HWD = (256, 256, 200)    # stored (H, W, D); 200 x 256 x 256 after the transpose (SURVEY.md:79)


def _fundus_photo(seed: int):
    """A smooth, structured fundus-like RGB image (a lit field, a bright disc,
    vessel-like ridges and sensor grain), so that it compresses as a
    photograph does."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = REAL_FUNDUS
    y = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(-1.5, 1.5, w, dtype=np.float32)[None, :]
    lum = 150.0 * np.exp(-(x * x + y * y) * rng.uniform(0.8, 1.2))
    lum = lum + 90.0 * np.exp(-((x - rng.uniform(0.3, 0.6)) ** 2 + (y - rng.uniform(-0.2, 0.2)) ** 2) / 0.01)
    lum = lum + 25.0 * np.sin(20.0 * x + 13.0 * y + rng.uniform(0, 6)) * np.sin(9.0 * y - 4.0 * x)
    img = lum[..., None] * np.array([1.0, 0.55, 0.3], np.float32) + rng.normal(0, 2, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def real_data_path(cfg, card, reset_counts, counts, check_routes) -> None:
    """Phase 26: the real-data path (a GAMMA tree written by the port's own
    writers; the dataset tools; ``cli.train`` / ``cli.test`` on ``dr2`` and
    ``glu2``) at full width, in a temporary directory under ``build/``."""
    import concurrent.futures
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from edrl_tpu_torch.cli import test as test_cli
    from edrl_tpu_torch.cli import train as train_cli
    from edrl_tpu_torch.data import gamma
    from edrl_tpu_torch.data.nifti import read_nifti, write_nifti
    from edrl_tpu_torch.data.png import read_png, write_png
    from edrl_tpu_torch.data.transforms import resize_image, resize_volume
    from edrl_tpu_torch.data.xlsx import write_xlsx
    from edrl_tpu_torch.kernels import window_attention as wa
    from edrl_tpu_torch.tools import build_cache, verify_dataset

    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="edrl_real_", dir=REPO / "build"))
    root = work / "data"
    ids = list(range(1, REAL_SAMPLES + 1))

    def on_disk(i):  # every third id zero-padded on disk, the others not
        return f"{i:05d}" if i % 3 == 0 else str(i)

    def write_sample(i):
        sid = on_disk(i)
        (root / sid).mkdir(parents=True)
        fundus = _fundus_photo(i)
        write_png(str(root / sid / f"data_{sid}_fundus.png"), fundus)  # rows cycle filters 0..4
        vol = np.random.default_rng(1000 + i).integers(0, 256, REAL_OCT_HWD, dtype=np.uint8).astype(np.float32)
        write_nifti(str(root / sid / (f"processed_data_{sid}.nii" if i == 5 else f"data_{sid}.nii")), vol)
        return fundus if i == 1 else None

    real_load = gamma.GammaDataset._load_raw
    loads, misses = [], {}

    def recording_load(self, sid):
        hit = os.path.exists(self.cache_path(sid))
        t = time.perf_counter()
        out = real_load(self, sid)
        loads.append((sid, hit, time.perf_counter() - t))
        if not hit:
            misses[sid] = tuple(np.array(a, copy=True) for a in out)
        return out

    timed = {}
    real_make_loaders = train_cli.make_loaders

    def make_timed_loaders(c, *mesh):
        tl, vl = real_make_loaders(c, *mesh)
        timed["train"] = TimedLoader(tl)
        return timed["train"], vl

    try:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            written = [f for f in pool.map(write_sample, ids) if f is not None][0]
        labels = [[f"{i:05d}" if i % 2 else i, i % 2, 1 - i % 2] for i in ids]
        # dr2: xlsx, ids padded and numeric, two rows with no directory; glu2:
        # csv in a shuffled order (its split follows the file).
        write_xlsx(str(work / "dr2.xlsx"), ["data", "class_0", "class_1"], labels + [[41, 1, 0], ["00042", 0, 1]])
        order = np.random.default_rng(0).permutation(REAL_SAMPLES)
        (work / "glu2.csv").write_text("data,class_0,class_1\n" + "".join(
            f"{labels[k][0]},{labels[k][1]},{labels[k][2]}\n" for k in order))
        (work / "half.csv").write_text("data,class_0,class_1\n" + "".join(
            f"{a},{b},{c}\n" for a, b, c in labels[: REAL_SAMPLES // 2]))
        write_s = time.perf_counter() - t0
        png_mb = sum((root / on_disk(i) / f"data_{on_disk(i)}_fundus.png").stat().st_size for i in ids) / 2 ** 20
        raw_mb = REAL_SAMPLES * np.prod(REAL_FUNDUS) * 3 / 2 ** 20
        print(f"real-data tree: {REAL_SAMPLES} samples, fundus PNG {REAL_FUNDUS[0]}x{REAL_FUNDUS[1]}x3 "
              f"({png_mb / REAL_SAMPLES:.2f} MiB each, {png_mb / raw_mb:.3f} of raw), OCT NIfTI f32 {REAL_OCT_HWD}; "
              f"written in {write_s:.1f} s (8 threads)", flush=True)
        first = root / on_disk(1) / f"data_{on_disk(1)}_fundus.png"
        check(np.array_equal(read_png(str(first)), written), "a decoded fundus equals the pixels written")

        # Each stage of a cache miss, one sample at a time, on four samples.
        stage_ms = collections.defaultdict(list)
        for i in ids[:4]:
            sid = on_disk(i)
            nii = root / sid / (f"processed_data_{sid}.nii" if i == 5 else f"data_{sid}.nii")
            t = time.perf_counter()
            fundus = read_png(str(root / sid / f"data_{sid}_fundus.png"))
            stage_ms["PNG decode"].append(time.perf_counter() - t)
            t = time.perf_counter()
            resize_image(fundus / 255.0, cfg.data.fundus_size)
            stage_ms["cubic resize"].append(time.perf_counter() - t)
            t = time.perf_counter()
            vol = read_nifti(str(nii))
            stage_ms["NIfTI read"].append(time.perf_counter() - t)
            t = time.perf_counter()
            resize_volume(np.transpose(vol, (2, 0, 1)), cfg.data.oct_size)
            stage_ms["volume zoom"].append(time.perf_counter() - t)
        print("cache-miss stages, ms per sample (4 samples, one thread): " + ", ".join(
            f"{k} {1000 * statistics.mean(v):.1f}" for k, v in stage_ms.items()) + f" [{card}]", flush=True)

        # The preflight verifier: the tree is ready (every sample at the
        # default depth, timed; deep on four); a copy of three samples with
        # one bad CRC is not.
        def verify(data_path, label_file, *extra):
            buf = Tee()
            with contextlib.redirect_stdout(buf):
                rc = verify_dataset.main(["--dataset", "dr2", "--data_path", str(data_path), "--label_file",
                                          str(label_file), *extra])
            return rc, buf.getvalue()

        sizes = ["--fundus_size", str(cfg.data.fundus_size), "--oct_size", str(cfg.data.oct_size[0])]
        t0 = time.perf_counter()
        rc, out = verify(root, work / "dr2.xlsx", *sizes)
        verify_s = time.perf_counter() - t0
        check(rc == 0 and f"checked {REAL_SAMPLES}; 0 errors" in out, f"verify_dataset on every sample: rc {rc}")
        t0 = time.perf_counter()
        rc, out = verify(root, work / "dr2.xlsx", "--deep", "--max_samples", "4", *sizes)
        deep_s = time.perf_counter() - t0
        check(rc == 0 and "READY: --dataset dr2 will load 40 samples" in out, f"verify_dataset --deep: rc {rc}")
        faulty = work / "faulty"
        for i in ids[:3]:
            shutil.copytree(root / on_disk(i), faulty / on_disk(i), copy_function=os.link)
        bad = faulty / on_disk(2) / f"data_{on_disk(2)}_fundus.png"
        raw = bytearray(bad.read_bytes())
        raw[raw.index(b"IDAT") + 100] ^= 0xFF
        bad.unlink()  # a hard link: write a new file
        bad.write_bytes(bytes(raw))
        rc, out = verify(faulty, work / "dr2.xlsx")
        check(rc == 1 and f"undecodable image {bad}" in out and "bad CRC" in out,
              f"verify_dataset on a planted bad CRC: rc {rc}")
        print(f"verify_dataset: the tree exits 0, all {REAL_SAMPLES} samples in {verify_s:.2f} s "
              f"({1000 * verify_s / REAL_SAMPLES:.1f} ms a sample), --deep on 4 in {deep_s:.2f} s; a copy with "
              f"one bad CRC exits 1, naming the file [{card}]", flush=True)

        # tools.build_cache on half the ids (two processes).
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(Tee()):
            rc = build_cache.main(["--data_path", str(root), "--label_file", str(work / "half.csv"),
                                   "--workers", "2", *sizes])
        build_s = time.perf_counter() - t0
        cached = {p.parent.name for p in root.rglob("_edrl_cache8_*.npz")}
        check(rc == 0 and len(cached) >= REAL_SAMPLES // 2, f"build_cache: rc {rc}, {len(cached)} cached")
        print(f"build_cache --workers 2: {REAL_SAMPLES // 2} samples in {build_s:.1f} s; {len(cached)} of "
              f"{REAL_SAMPLES} cached before training [{card}]", flush=True)

        # cli.train --dataset dr2 (fold 0: 32 train, 8 val), cli.test --sweep
        # on its best, cli.train --dataset glu2.
        bt, epochs = 16, 2
        base = ["--batch_size", str(bt), "--plot_dir", "", "--checkpoint_dir", str(work / "ckpt"), "--log_dir",
                str(work / "log"), "--name", "smoke", "--data_path", str(root)]
        dr2 = base + ["--dataset", "dr2", "--label_file", str(work / "dr2.xlsx")]
        gamma.GammaDataset._load_raw = recording_load
        train_cli.make_loaders = make_timed_loaders
        out_buf = Tee()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_buf):
            train_cli.main(dr2 + ["--end_epochs", str(epochs)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches, train_fwd, train_bwd = counts(), dict(wa.FWD_ROUTES), dict(wa.BWD_ROUTES)
        train_cli.make_loaders = real_make_loaders
        gamma.GammaDataset._load_raw = real_load
        steps, val_batches = epochs * (32 // bt), 1
        reset_counts()
        t0 = time.perf_counter()
        test_cli.main(dr2 + ["--checkpoint", str(work / "ckpt" / "dr2_0.5_smoke" / "best"), "--sweep", "gaussian",
                             "--sweep_levels", "0.0", "0.3"])
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_launches = counts()
        shutil.rmtree(work / "ckpt")  # one full-width checkpoint on disk at a time
        reset_counts()
        t0 = time.perf_counter()
        glu2_buf = Tee()
        with contextlib.redirect_stdout(glu2_buf):
            train_cli.main(base + ["--dataset", "glu2", "--label_file", str(work / "glu2.csv"), "--end_epochs", "1"])
        torch.cuda.synchronize()
        glu2_s = time.perf_counter() - t0
        glu2_launches = counts()
        logs = {n: (work / "log" / f"{n}.log").read_text()
                for n in ("dr2_smoke_train", "dr2_smoke_test", "glu2_smoke_train")}

        # Every sample read on a miss equals its cached read, byte for byte.
        ds = gamma.GammaDataset(dataclasses.replace(cfg.data, dataset="dr2", data_path=str(root),
                                                    label_file=str(work / "dr2.xlsx"), device_noise=True,
                                                    uint8_transport=True), mode="val")
        hit_s = []
        for sid, (fundus_u8, oct_u8) in sorted(misses.items()):
            t = time.perf_counter()
            f2, o2 = ds._load_raw(sid)
            hit_s.append(time.perf_counter() - t)
            check(f2.dtype == fundus_u8.dtype == np.uint8 and np.array_equal(f2, fundus_u8)
                  and np.array_equal(o2, oct_u8), f"sample {sid}: the cached read differs from the miss")
    finally:
        gamma.GammaDataset._load_raw = real_load
        train_cli.make_loaders = real_make_loaders
        shutil.rmtree(work, ignore_errors=True)
    check(not work.exists(), "the real-data phase's directory is removed")

    first_read = {}
    for sid, hit, _ in loads:
        first_read.setdefault(sid, hit)
    n_hit = sum(first_read.values())
    check(len(first_read) == REAL_SAMPLES and 0 < n_hit < REAL_SAMPLES
          and set(misses) == {sid for sid, hit in first_read.items() if not hit},
          f"dr2: first reads {len(first_read)}, {n_hit} cache hits, misses {sorted(misses)}")
    print(f"dr2 epoch 1: {n_hit} cache hits, {len(misses)} misses; each miss equals its cached read byte for "
          f"byte; ms per cache hit {1000 * statistics.mean(hit_s):.2f} (one thread), per miss in the loader "
          f"{1000 * statistics.mean(s for _, h, s in loads if not h):.1f} (8 threads) [{card}]", flush=True)
    printed = out_buf.getvalue().splitlines()
    waits = timed["train"].waits
    for epoch in range(1, epochs + 1):
        tl = [line for line in printed if line.startswith(f"Train Epoch: {epoch} ")]
        vl = [line for line in printed if line.startswith(f"Val   Epoch: {epoch} ")]
        check(len(tl) == 1 and len(vl) == 1, f"dr2 epoch {epoch}: Train and Val lines {tl} {vl}")
        check(all(np.isfinite(float(line.split("Loss: ")[1].split()[0])) for line in (tl[0], vl[0])),
              f"dr2 epoch {epoch}: losses {tl} {vl}")
        pairs_s = float(tl[0].rsplit("(", 1)[1].split(" pairs/s")[0])
        epoch_s = (32 // bt) * bt / pairs_s
        w = waits[epoch]
        print(f"dr2 epoch {epoch}: {pairs_s:.2f} train pairs/s; host wait on the loader {1000 * sum(w) / len(w):.1f} "
              f"ms per batch, {100 * sum(w) / epoch_s:.1f}% of the epoch's {epoch_s:.3f} s [{card}]", flush=True)
    hint = f"{len(misses)} of {REAL_SAMPLES} samples have no decoded cache yet"
    check(logs["dr2_smoke_train"].count(hint) == 1 and "no decoded cache" not in logs["glu2_smoke_train"],
          "cli.train names the uncached samples once on dr2, and not on glu2 (all cached by then)")
    tt_block, test_block_lines = test_block(logs["dr2_smoke_train"]), test_block(logs["dr2_smoke_test"])
    check(tt_block == test_block_lines, f"dr2: cli.test on best {test_block_lines} vs the train&test block {tt_block}")
    sweep = logs["dr2_smoke_test"].split("Robustness sweep [gaussian]:", 1)[-1]
    check(sum(f"\t{s}\t" in sweep for s in ("0", "0.3")) == 2, "dr2: the sweep's grid")
    glu2_lines = glu2_buf.getvalue().splitlines()
    check(sum(line.startswith("Train Epoch: 1 ") for line in glu2_lines) == 1 and len(
        test_block(logs["glu2_smoke_train"])) == 4, "glu2: one epoch and its test block")

    def want(**n):
        w = {name: 0 for name in train_launches}
        w.update(n)
        return w

    sa, v2, sa_bwd, v2_bwd = ("self_attention_fused", "window_attention_fused_v2", "self_attention_fused_bwd",
                              "window_attention_fused_v2_bwd")
    fwd = 24 * steps + 12 * 5 * val_batches
    check(train_launches == want(**{sa: fwd, v2: fwd, sa_bwd: 24 * steps, v2_bwd: 24 * steps}),
          f"dr2 cli.train launches {train_launches}")
    check_routes("dr2 cli.train", train_bwd, 2 * 24 * steps)
    check_routes("dr2 cli.train", train_fwd, 2 * fwd, "forward")
    sweep_fwd = 12 * 3 * val_batches + 12 * 2 * 3 * -(-REAL_SAMPLES // cfg.data.eval_batch_size)
    check(test_launches == want(**{sa: sweep_fwd, v2: sweep_fwd}), f"dr2 cli.test --sweep launches {test_launches}")
    glu2_fwd = 24 * (32 // bt) + 12 * 4 * val_batches
    check(glu2_launches == want(**{sa: glu2_fwd, v2: glu2_fwd, sa_bwd: 24 * (32 // bt), v2_bwd: 24 * (32 // bt)}),
          f"glu2 cli.train launches {glu2_launches}")
    print(f"real-data launches, B1 / B2 forward and backward (all tensor-core): dr2 cli.train ({steps} steps, "
          f"{5 * val_batches} eval batches) {fwd} / {fwd} and {24 * steps} / {24 * steps}; cli.test with a 2-level "
          f"sweep {sweep_fwd} / {sweep_fwd}; glu2 cli.train (1 epoch) {glu2_fwd} / {glu2_fwd} and {24 * (32 // bt)} / "
          f"{24 * (32 // bt)}; wall s: dr2 train {train_s:.1f}, test {test_s:.1f}, glu2 {glu2_s:.1f} [{card}]",
          flush=True)
    loaded = sorted(n for n in sys.modules if n.split(".")[0] in ("cv2", "PIL", "pandas"))
    check(not loaded, f"the real-data path imported {loaded}")
    print("real-data path: no module of cv2, PIL or pandas was imported", flush=True)


DP_BATCH = 32                     # phase 27's global batch
DP_STEPS = 3


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dp_config():
    """Phase 27's config: the shipped one at full width, in f32 (the bars a
    whole step's results are held to)."""
    from edrl_tpu_torch.config import EDRLConfig

    base = EDRLConfig()
    return base.replace(model=dataclasses.replace(base.model, use_bfloat16=False))


def _dp_zero1_resume(mesh, dev, directory: str) -> float:
    """A ZeRO-1 state of a 0-d parameter (as EPRL's ``alpha``) and a vector,
    one a rank, after two Adam steps: saved through the mesh's checkpoint
    manager (consolidated on rank 0), restored on every rank into a fresh
    ZeRO-1 state, and stepped once more beside the state never saved.  The
    largest |difference| of their parameters (0 when the resume is exact)."""
    import torch

    from edrl_tpu_torch import parallel
    from edrl_tpu_torch.train import trainer
    from edrl_tpu_torch.train.checkpoint import CheckpointManager

    def fresh():
        model = torch.nn.ParameterDict({"alpha": torch.nn.Parameter(torch.tensor(0.5, device=dev)),
                                        "w": torch.nn.Parameter(torch.linspace(-1.0, 1.0, 8, device=dev))})
        optimizer = parallel.zero1_optimizer(model.parameters(), mesh, lr=0.1)
        return trainer.TrainState(model, optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambda i: 1.0))

    def step(state, i):
        state.optimizer.zero_grad()
        (state.model["alpha"] * (i + 1) + state.model["w"].square().sum()).backward()
        state.optimizer.step()

    kept, saved = fresh(), fresh()
    for i in range(2):
        step(kept, i)
        step(saved, i)
    manager = CheckpointManager(directory, mesh=mesh)
    manager.save(saved, "latest")
    resumed = manager.restore(fresh(), "latest")
    step(kept, 2)
    step(resumed, 2)
    torch.cuda.synchronize()
    return max(float((a - b).detach().abs().max()) for a, b in zip(kept.model.parameters(), resumed.model.parameters()))


def _dp_world2_rank(rank: int, port: int, outbox, grads_path: str) -> None:
    """Phase 27(b): one of two ranks on the one card, the group on gloo.  It
    first runs each collective the step uses on CUDA tensors; where gloo
    refuses one it posts the collective's name and stops.  Else it runs the
    first step of phase 27(a) on its 16 rows of the global 32 and posts the
    global results (rank 0 writes the averaged gradients to ``grads_path``),
    with :func:`_dp_zero1_resume`'s reading."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from edrl_tpu_torch import parallel
    from edrl_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer.set_conv_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        x = torch.ones(4, device=dev)
        for name, call in (("all_reduce", lambda: dist.all_reduce(x.clone())),
                           ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x)),
                           ("broadcast", lambda: dist.broadcast(x.clone(), src=0)),
                           ("barrier", dist.barrier)):
            try:
                call()
                torch.cuda.synchronize()
            except (RuntimeError, ValueError) as exc:
                outbox.put((rank, "refused", f"{name}: {exc}"))
                return
        mesh = parallel.make_mesh(device="cuda")
        cfg = _dp_config()
        state = trainer.init_state(cfg, seed=0, device=dev, mesh=mesh)
        batch = parallel.shard_batch(trainer.random_views(cfg, seed=31, device=dev), mesh)
        out = trainer.make_train_step(cfg, mesh)(state, batch, torch.Generator(device=dev).manual_seed(40))
        if rank == 0:
            torch.save({n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}, grads_path)
        del state
        resume = _dp_zero1_resume(mesh, dev, grads_path + ".zero1")
        # numpy, which the queue copies: a tensor would be shared by a
        # handle that dies with this process.
        outbox.put((rank, "done", dict({k: v.detach().cpu().numpy() for k, v in out.items()}, zero1_resume=resume)))
    finally:
        dist.destroy_process_group()


def data_parallel_path(card, reset_counts, counts) -> None:
    """27. Data parallelism on the one card (see the module docstring)."""
    import multiprocessing
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from edrl_tpu_torch import parallel
    from edrl_tpu_torch.cli import test as test_cli
    from edrl_tpu_torch.cli import train as train_cli
    from edrl_tpu_torch.kernels import window_attention as wa
    from edrl_tpu_torch.train import trainer
    from edrl_tpu_torch.train.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = _dp_config()
    batch = trainer.random_views(cfg, seed=31, device=dev, batch_size=DP_BATCH)
    atol, rtol = 2e-4, 1e-3          # the port's f32 bars for a step's results

    def attention(launches):
        """B1's and B2's launches, forward and backward."""
        return (launches[wa.SELF_ATTENTION] + launches[wa.WINDOW_ATTENTION_V2],
                launches[wa.SELF_ATTENTION_BWD] + launches[wa.WINDOW_ATTENTION_V2_BWD])

    def worst(a, b):
        """The largest |a - b| over atol + rtol |b|: at most 1 is within the bars."""
        a, b = a.detach().double(), b.detach().double().to(a.device)
        return float(((a - b).abs() / (atol + rtol * b.abs())).max())

    # -- (a) world 1 over NCCL, held against the step with no mesh -------------
    store = dist.TCPStore("127.0.0.1", _free_port(), 1, True)
    parallel.init_distributed("cuda", store=store)
    mesh = parallel.make_mesh(device="cuda")
    first = None
    work = Path(tempfile.mkdtemp(prefix="edrl_dp_", dir=REPO / "build"))
    try:
        for label, train in (("plain MK-MMD", {}), ("B3's MK-MMD", {"use_pallas_mmd": True}),
                             ("ZeRO-1", {"zero1": True})):
            c = cfg.replace(train=dataclasses.replace(cfg.train, **train))
            plain = trainer.init_state(c, seed=0, device=dev)
            ranks = trainer.init_state(c, seed=0, device=dev, mesh=mesh)
            if c.train.zero1:
                # One rank: make_optimizer keeps the plain Adam, as the JAX
                # package shards nothing on one device; ZeRO-1's library
                # path is built here on purpose, to run it over NCCL.
                ranks.optimizer = parallel.zero1_optimizer(ranks.model.parameters(), mesh, lr=c.train.lr,
                                                           weight_decay=c.train.weight_decay)
                ranks.scheduler = torch.optim.lr_scheduler.LambdaLR(
                    ranks.optimizer, lambda i: trainer.warmup_factor(i, c.train.warmup_steps))
            step_plain, step_ranks = trainer.make_train_step(c), trainer.make_train_step(c, mesh)
            errs = collections.defaultdict(float)
            for i in range(DP_STEPS):
                reset_counts()
                out_p = step_plain(plain, batch, torch.Generator(device=dev).manual_seed(40 + i))
                launches_p = counts()
                reset_counts()
                out_r = step_ranks(ranks, batch, torch.Generator(device=dev).manual_seed(40 + i))
                launches_r = counts()
                check(launches_r == launches_p and min(attention(launches_r)) > 0,
                      f"{label} step {i}: launches {launches_r} against {launches_p}")
                for key in ("loss", "mmd", "probs"):
                    errs[key] = max(errs[key], worst(out_r[key], out_p[key]))
                errs["grads"] = max(errs["grads"], max(worst(a.grad, b.grad) for a, b in zip(
                    ranks.model.parameters(), plain.model.parameters())))
                if i == 0 and not train:
                    first = ({k: v.detach().cpu() for k, v in out_r.items()},
                             {n: p.grad.detach().cpu() for n, p in ranks.model.named_parameters()})
            print(f"data parallel, world 1 over NCCL, {label}: {DP_STEPS} f32 steps at batch {DP_BATCH} against the "
                  f"step with no mesh, worst |err| / (atol + rtol |want|) {dict(errs)} (at most 1 passes; "
                  f"B1 + B2 launches a step, forward / backward, {attention(launches_r)}, the same on both)",
                  flush=True)
            check(max(errs.values()) <= 1.0, f"{label}: {dict(errs)}")
            if c.train.zero1:
                # The consolidated ZeRO-1 checkpoint restores on one card.
                mgr = CheckpointManager(str(work / "ckpt"), mesh=mesh)
                mgr.save(ranks, "latest")
                mgr.wait()
                one = CheckpointManager(str(work / "ckpt")).restore(trainer.init_state(c, device=dev), "latest")
                same = all(torch.equal(a, b) for a, b in zip(ranks.model.parameters(), one.model.parameters()))
                moments = sum(len(s) for s in one.optimizer.state_dict()["state"].values())
                print(f"  ZeRO-1 checkpoint consolidated over NCCL and restored on one card: parameters "
                      f"{'equal' if same else 'DIFFER'}, {moments} moment entries", flush=True)
                check(same and moments > 0, "ZeRO-1 checkpoint restore")
                del one
            del plain, ranks, step_plain, step_ranks
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)

    # -- (b) world 2 on the one card, over gloo, where gloo takes CUDA tensors -
    grads_path = REPO / "build" / "dp_world2_grads.pt"
    ctx = multiprocessing.get_context("spawn")
    outbox = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_dp_world2_rank, args=(r, port, outbox, str(grads_path))) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        posted = [outbox.get(timeout=600) for _ in range(2)]
        for p in procs:
            p.join(timeout=120)
            check(p.exitcode == 0, f"phase 27(b) rank exited with {p.exitcode}")
        refused = [msg for _, what, msg in posted if what == "refused"]
        if refused:
            print(f"data parallel, world 2 on one card over gloo: left out, gloo refuses CUDA tensors in "
                  f"{refused}", flush=True)
        else:
            out2 = {r: m for r, _, m in posted}[0]
            grads2 = torch.load(grads_path, weights_only=True)
            e_out = {k: worst(torch.from_numpy(out2[k]), first[0][k]) for k in ("loss", "mmd", "probs")}
            e_grad = max(worst(grads2[n], g) for n, g in first[1].items())
            print(f"data parallel, world 2 on one card over gloo (16 rows each of {DP_BATCH}), its first step "
                  f"against (a)'s: worst |err| / (atol + rtol |want|) {e_out}, gradients {e_grad:.3f} "
                  f"({time.perf_counter() - t0:.1f} s with the ranks' start)", flush=True)
            check(max(e_out.values()) <= 1.0 and e_grad <= 1.0, f"world 2 against world 1: {e_out} {e_grad}")
            resumed = [m["zero1_resume"] for _, _, m in posted]
            print(f"data parallel, world 2 on one card over gloo: a ZeRO-1 state with a 0-d parameter saved "
                  f"consolidated, restored on both ranks and stepped beside the state never saved: largest "
                  f"|difference| {resumed} (0 passes)", flush=True)
            check(resumed == [0.0, 0.0], f"ZeRO-1 resume at world 2: {resumed}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        grads_path.unlink(missing_ok=True)
        shutil.rmtree(f"{grads_path}.zero1", ignore_errors=True)

    # -- (c) cli.train and cli.test with torchrun's environment at WORLD_SIZE=1 --
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cli_dir = Path(tempfile.mkdtemp(prefix="edrl_dp_cli_", dir=REPO / "build"))
    args = ["--dataset", "synthetic", "--batch_size", "16", "--synthetic_samples", "32", "--end_epochs", "1",
            "--plot_dir", "", "--checkpoint_dir", str(cli_dir / "ckpt"), "--log_dir", str(cli_dir / "log"),
            "--name", "dp"]
    try:
        t0 = time.perf_counter()
        reset_counts()
        with contextlib.redirect_stdout(Tee()):
            train_cli.main(args)
            joined = dist.is_initialized()
            test_cli.main(args + ["--checkpoint", str(cli_dir / "ckpt" / "synthetic_0.5_dp" / "best")])
            joined = joined or dist.is_initialized()
        launches = counts()
        blocks = [test_block((cli_dir / "log" / f"synthetic_dp_{p}.log").read_text()) for p in ("train", "test")]
        print(f"data parallel, cli.train (1 epoch, batch 16) and cli.test on its best with torchrun's environment "
              f"at WORLD_SIZE=1: {time.perf_counter() - t0:.1f} s, a process group joined: {joined} (no mesh on "
              f"one process, as the JAX CLI on one device; the mesh branch runs in tools/profile_data_parallel.py "
              f"on 4 cards), B1 + B2 launches forward / backward {attention(launches)}, test blocks equal: "
              f"{blocks[0] == blocks[1]}", flush=True)
        check(not joined and blocks[0] == blocks[1] and min(attention(launches)) > 0, "phase 27(c)")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(cli_dir, ignore_errors=True)
    print(f"wall s: phase 27 {time.perf_counter() - t_phase:.1f} [{card}]", flush=True)


TP_BATCH = 8                      # phase 28's global batch
TP_STEPS = 2
# B1's and B2's launches by route that each step of phase 28 must make
# (forward and backward): ViT's 6 heads split 3 and 3, Swin's stage 0 of 1
# head gathered, its other stages split.
TP_ROUTE_KEYS = ("self_attention_fused/head_local", "self_attention_fused_bwd/head_local",
                 "window_attention_fused_v2/gathered", "window_attention_fused_v2_bwd/gathered",
                 "window_attention_fused_v2/head_local", "window_attention_fused_v2_bwd/head_local")


def _tp_request():
    """Phase 28's serving request: 16 uint8 pairs of the shipped sizes (numpy seed 28)."""
    import numpy as np

    d = _dp_config().data
    rng = np.random.default_rng(28)
    return (rng.integers(0, 256, (16, d.fundus_size, d.fundus_size, 3), dtype=np.uint8),
            rng.integers(0, 256, (16, *d.oct_size, 1), dtype=np.uint8))


def _tp_rank(rank: int, port: int, outbox, ref_path: str, work: str) -> None:
    """Phase 28: one of two ranks on the one card, the group on gloo, the
    ``(1, 2)`` mesh.  It first runs each collective the model axis uses on
    CUDA tensors (a refusal is posted by name, and fails the phase); then
    two f32 steps of the shipped model at global batch 8 held against the
    one-card steps in ``ref_path`` (rank 0 reads them), B1's and B2's
    launches a step by route, the replicated gradients' drift over the two
    ranks before the step's broadcast, a checkpoint saved through the mesh and restored in one process
    (rank 0), and the (1, 2) ``Predictor`` in bf16 and int8."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from edrl_tpu_torch import parallel
    from edrl_tpu_torch.config import EDRLConfig
    from edrl_tpu_torch.kernels import window_attention as wa
    from edrl_tpu_torch.parallel import tensor
    from edrl_tpu_torch.serve.predictor import Predictor
    from edrl_tpu_torch.tools.profile_data_parallel import replica_drift
    from edrl_tpu_torch.train import trainer
    from edrl_tpu_torch.train.checkpoint import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer.set_conv_precision()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        x = torch.ones(4, device=dev)
        for name, call in (("all_reduce", lambda: dist.all_reduce(x.clone())),
                           ("all_reduce max", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX)),
                           ("all_reduce int32", lambda: dist.all_reduce(x.int())),
                           ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x)),
                           ("broadcast", lambda: dist.broadcast(x.clone(), src=0)), ("barrier", dist.barrier)):
            try:
                call()
                torch.cuda.synchronize()
            except (RuntimeError, ValueError) as exc:
                outbox.put((rank, "refused", f"{name}: {exc}"))
                return
        atol, rtol = 2e-4, 1e-3

        def worst(a, b):
            a, b = a.detach().double(), b.detach().double().to(a.device)
            return float(((a - b).abs() / (atol + rtol * b.abs())).max())

        mesh = parallel.make_mesh(2, device="cuda")
        cfg = _dp_config()
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=TP_BATCH))
        ref = torch.load(ref_path, weights_only=True) if rank == 0 else None
        t0 = time.perf_counter()
        state = trainer.init_state(cfg, seed=0, device=dev, mesh=mesh)
        step = trainer.make_train_step(cfg, mesh)
        result = {"errs": collections.defaultdict(float), "routes": [],
                  "param_gib": sum(p.numel() * p.element_size() for p in state.model.parameters()) / 2**30}
        tensor.reset_collective_counts()
        for i in range(TP_STEPS):
            batch = trainer.random_views(cfg, seed=81 + i, device=dev)
            wa.reset_launch_counts()
            out = step(state, batch, torch.Generator(device=dev).manual_seed(90 + i))
            result["routes"].append({k: wa.TP_ROUTES[k] for k in wa.TP_ROUTES if wa.TP_ROUTES[k]})
            full = tensor.gather_full(state.model, {n: p.grad for n, p in state.model.named_parameters()})
            if rank == 0:
                for key in ("loss", "mmd", "probs"):
                    result["errs"][key] = max(result["errs"][key], worst(out[key], ref["out"][i][key]))
                result["errs"]["grads"] = max(result["errs"]["grads"], max(
                    worst(full[n], g) for n, g in ref["grads"][i].items()))
                result["grads_compared"] = len(ref["grads"][i]) == len(full)
            del full
        result["drift"] = replica_drift(mesh)
        torch.cuda.synchronize()
        result["steps_s"] = time.perf_counter() - t0
        del ref
        manager = CheckpointManager(work, mesh=mesh)
        manager.save(state, "latest")
        manager.wait()
        full = tensor.gather_full(state.model, state.model.state_dict())
        if rank == 0:
            one = CheckpointManager(work).restore(trainer.init_state(cfg, device=dev), "latest")
            mine = one.model.state_dict()
            result["restored_equal"] = set(mine) == set(full) and all(torch.equal(v, full[k]) for k, v in mine.items())
            result["restored_step"] = one.step
            del one, mine
        del state, full
        torch.cuda.empty_cache()
        fundus, oct_vol = _tp_request()
        shipped = EDRLConfig()
        result["probs"] = {mode: Predictor(shipped, seed=0, device=dev, mesh=mesh, **kw).predict_probs(fundus, oct_vol)
                           for mode, kw in (("bf16", {}), ("int8", {"quantize_int8": True}))}
        outbox.put((rank, "done", dict(result, errs=dict(result["errs"]))))
    finally:
        dist.destroy_process_group()


def tensor_parallel_path(card) -> None:
    """28. Tensor parallelism on the one card (see the module docstring)."""
    import multiprocessing
    import shutil
    import tempfile

    import numpy as np
    import torch

    from edrl_tpu_torch.config import EDRLConfig
    from edrl_tpu_torch.serve.predictor import Predictor
    from edrl_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = _dp_config()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=TP_BATCH))
    # One card's references: the two f32 steps, and the bf16 and int8 Predictor.
    one = trainer.init_state(cfg, seed=0, device=dev)
    step = trainer.make_train_step(cfg)
    ref = {"out": [], "grads": []}
    for i in range(TP_STEPS):
        out = step(one, trainer.random_views(cfg, seed=81 + i, device=dev),
                   torch.Generator(device=dev).manual_seed(90 + i))
        ref["out"].append({k: v.detach().cpu() for k, v in out.items()})
        ref["grads"].append({n: p.grad.detach().cpu() for n, p in one.model.named_parameters()})
    del one, step
    fundus, oct_vol = _tp_request()
    shipped = EDRLConfig()
    want = {mode: Predictor(shipped, seed=0, device=dev, **kw).predict_probs(fundus, oct_vol)
            for mode, kw in (("bf16", {}), ("int8", {"quantize_int8": True}))}
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="edrl_tp_", dir=REPO / "build"))
    ref_path = work / "one_card.pt"
    torch.save(ref, ref_path)
    del ref
    t_ref = time.perf_counter() - t_phase

    ctx = multiprocessing.get_context("spawn")
    outbox = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_tp_rank, args=(r, port, outbox, str(ref_path), str(work / "ckpt")))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        posted = {r: (what, msg) for r, what, msg in (outbox.get(timeout=600) for _ in range(2))}
        for p in procs:
            p.join(timeout=120)
            check(p.exitcode == 0, f"phase 28 rank exited with {p.exitcode}")
        refused = [msg for what, msg in posted.values() if what == "refused"]
        check(not refused, f"phase 28: gloo refuses CUDA tensors in {refused}")
        ranks = [posted[r][1] for r in range(2)]
        errs = ranks[0]["errs"]
        print(f"tensor parallel, (1, 2) mesh on one card over gloo, the shipped model in f32: {TP_STEPS} steps at "
              f"batch {TP_BATCH} against one card's, worst |err| / (atol + rtol |want|) {errs} (at most 1 passes; "
              f"every gradient gathered to full shape: {ranks[0]['grads_compared']}); replicated gradients' largest "
              f"|difference| over the ranks before the step's broadcast {max(r['drift'] for r in ranks)} (0 "
              f"passes); a rank's parameters "
              f"{ranks[0]['param_gib']:.3f} GiB; the ranks' steps {ranks[0]['steps_s']:.1f} s", flush=True)
        check(max(errs.values()) <= 1.0 and ranks[0]["grads_compared"], f"tensor parallel step: {errs}")
        check(all(r["drift"] == 0.0 for r in ranks), "replicated gradients differ over the model ranks")
        for rank, r in enumerate(ranks):
            print(f"  rank {rank}: B1 and B2 launches a step by route (forward and backward): {r['routes']}",
                  flush=True)
            for routes in r["routes"]:
                check(all(routes.get(k, 0) > 0 for k in TP_ROUTE_KEYS) and "self_attention_fused/gathered" not in routes,
                      f"rank {rank}: launches by route {routes}")
        print(f"  checkpoint saved on (1, 2) (full shapes) and restored in one process: equal "
              f"{ranks[0]['restored_equal']}, step {ranks[0]['restored_step']}", flush=True)
        check(ranks[0]["restored_equal"] and ranks[0]["restored_step"] == TP_STEPS, "tensor-parallel checkpoint")
        for mode, bar in (("bf16", 2e-2), ("int8", 1e-4)):
            diff = max(float(np.abs(r["probs"][mode] - want[mode]).max()) for r in ranks)
            print(f"  Predictor on (1, 2), {mode}, a request of 16: max |probabilities - one card's| {diff:.2e} "
                  f"(bar {bar})", flush=True)
            check(diff <= bar and ranks[0]["probs"][mode].shape == (16, 2), f"tensor-parallel {mode} serving")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(work, ignore_errors=True)
    print(f"wall s: phase 28 {time.perf_counter() - t_phase:.1f} (one card's references {t_ref:.1f}, the ranks "
          f"{time.perf_counter() - t0:.1f}) [{card}]", flush=True)


# Phase 29: the baseline zoo over a (1, 2) mesh.  (name, steps, depth cut):
# Trans_cross at full width and depth, every other family one step at full
# width, the transformers cut to one block a Swin stage and one ViT block.
ONE_BLOCK = {"swin_depths": (1, 1, 1, 1), "vit3d_depth": 1}
ZOO_TP_PLAN = (("Trans_cross", 2, {}), ("2D_transformer", 1, ONE_BLOCK), ("3D_transformer", 1, ONE_BLOCK),
               ("MLC_trans", 1, ONE_BLOCK), ("Multi_ResNet_cross", 1, {}), ("Multi_ResNet", 1, {}),
               ("IMDR", 1, ONE_BLOCK))
ZOO_TP_BATCH = 8
# B1's and B2's launches by route a step of each family must make at (1, 2),
# forward and backward: Swin's stage 0 of 1 head gathered and its other
# stages head-local, ViT's 6 heads head-local (Multi_ResNet_cross's and
# Trans_cross's cross attention attend over one token: no kernel).
SWIN_ROUTES = ("window_attention_fused_v2/gathered", "window_attention_fused_v2_bwd/gathered",
               "window_attention_fused_v2/head_local", "window_attention_fused_v2_bwd/head_local")
VIT_ROUTES = ("self_attention_fused/head_local", "self_attention_fused_bwd/head_local")
ZOO_TP_ROUTES = {"Trans_cross": SWIN_ROUTES + VIT_ROUTES, "2D_transformer": SWIN_ROUTES,
                 "3D_transformer": VIT_ROUTES, "MLC_trans": SWIN_ROUTES + VIT_ROUTES, "Multi_ResNet_cross": (),
                 "Multi_ResNet": (), "IMDR": SWIN_ROUTES + VIT_ROUTES}
ZOO_CNN = ("Multi_ResNet_cross", "Multi_ResNet")
ZOO_SERVE_PAIRS = 32              # phase 29's request: two serving batches of 16, one chunk of 2


def _zoo_tp_config(name: str, cut: dict):
    """Phase 29's config of ``name``: the shipped one in f32 at batch 8, with
    the depth cut ``cut``."""
    cfg = _dp_config()
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=ZOO_TP_BATCH),
                       model=dataclasses.replace(cfg.model, model_name=name, **cut))


def _zoo_tp_rank(rank: int, port: int, outbox) -> None:
    """Phase 29: one of two ranks on the one card, the group on gloo, the
    ``(1, 2)`` mesh, started once for every family: each family's steps
    (``ZOO_TP_PLAN``) against one card's on rank 0 with its one-ulp witness
    (``tools.profile_data_parallel.check_against_one_card``: the replicated
    gradients' drift over the ranks among its readings), B1's and B2's
    launches a step by route and the model axis's collectives a step; then
    Trans_cross's ``Predictor`` on the mesh (shipped bf16, full depth) in
    chunks of 2 and batch by batch."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from edrl_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer.set_conv_precision()
    torch.cuda.set_device(torch.device("cuda", 0))
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        _zoo_tp_rank_work(rank, outbox)
    except BaseException:
        import traceback

        outbox.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def _zoo_tp_rank_work(rank: int, outbox) -> None:
    """The work of ``_zoo_tp_rank`` once the group is joined; posts ``(rank,
    "done", results)``."""
    import numpy as np
    import torch

    from edrl_tpu_torch import parallel
    from edrl_tpu_torch.config import EDRLConfig
    from edrl_tpu_torch.kernels import window_attention as wa
    from edrl_tpu_torch.parallel import tensor
    from edrl_tpu_torch.serve import predictor as serve
    from edrl_tpu_torch.tools.profile_data_parallel import check_against_one_card
    from edrl_tpu_torch.train import trainer

    dev = torch.device("cuda", 0)
    mesh = parallel.make_mesh(2, device="cuda")
    result = {"families": {}}
    for name, steps, cut in ZOO_TP_PLAN:
        cfg = _zoo_tp_config(name, cut)
        meta = trainer.make_model(cfg, "meta")
        split = sum(dim is not None for dim in parallel.param_shardings(meta, 2).values())
        wa.reset_launch_counts()
        tensor.reset_collective_counts()
        t = time.perf_counter()
        errs = check_against_one_card(cfg, mesh, dev, steps=steps)
        result["families"][name] = {
            "errs": errs, "s": time.perf_counter() - t, "split": split,
            "routes": {k: v // steps for k, v in wa.TP_ROUTES.items() if v},
            "collectives": {k: v // steps if k != "bytes" else round(v / steps / 2**20, 3)
                            for k, v in tensor.COLLECTIVES.items()}}
    rng = np.random.default_rng(29)
    d = EDRLConfig().data
    request = (rng.integers(0, 256, (ZOO_SERVE_PAIRS, d.fundus_size, d.fundus_size, 3), dtype=np.uint8),
               rng.integers(0, 256, (ZOO_SERVE_PAIRS, *d.oct_size, 1), dtype=np.uint8))
    shipped = EDRLConfig().replace(model=dataclasses.replace(EDRLConfig().model, model_name="Trans_cross"))
    served = {}
    for chunk in (1, 2):
        serve.reset_chunk_counts()
        pred = serve.Predictor(shipped, seed=0, device=dev, chunk_batches=chunk, mesh=mesh)
        wa.reset_launch_counts()
        t = time.perf_counter()
        probs = pred.predict_probs(*request)
        served[chunk] = {"probs": probs, "route": pred.chunk_route, "chunks": dict(serve.CHUNK_ROUTES),
                         "s": time.perf_counter() - t, "launches": {k: v for k, v in wa.TP_ROUTES.items() if v}}
        del pred
        torch.cuda.empty_cache()
    result["served"] = served
    outbox.put((rank, "done", result))


def _scan_cli_runs(card, work: Path) -> None:
    """Phase 29's last part: ``cli.train`` for 1 epoch at batch 16 (64
    synthetic pairs a split: four batches), with no mesh,
    at ``--scan_batches 0`` and ``4``: the CSV rows (losses included) and
    the ``best`` checkpoint must be bit-equal."""
    import torch

    from edrl_tpu_torch.cli import train as train_cli
    from edrl_tpu_torch.train.checkpoint import _FILE

    runs, seconds = {}, {}
    for scan in (0, 4):
        args = ["--dataset", "synthetic", "--batch_size", "16", "--synthetic_samples", "64", "--end_epochs", "1",
                "--plot_dir", "", "--mode", "train", "--checkpoint_dir", str(work / "ckpt"), "--log_dir",
                str(work / "log"), "--name", f"scan{scan}", "--scan_batches", str(scan)]
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(args)
        seconds[scan] = time.perf_counter() - t
        rows = (work / "log" / f"synthetic_0.5_scan{scan}.csv").read_text().splitlines()
        best = work / "ckpt" / f"synthetic_0.5_scan{scan}" / "best" / _FILE
        check(best.is_file(), f"cli.train --scan_batches {scan} wrote no best checkpoint")
        runs[scan] = rows, torch.load(best, weights_only=True, map_location="cpu")
    (rows0, snap0), (rows4, snap4) = runs[0], runs[4]
    equal = (snap0["step"] == snap4["step"] == 4 and snap0["model"].keys() == snap4["model"].keys()
             and all(torch.equal(snap0["model"][k], snap4["model"][k]) for k in snap0["model"])
             and all(torch.equal(a, b) for k in snap0["optimizer"]["state"]
                     for a, b in zip(snap0["optimizer"]["state"][k].values(),
                                     snap4["optimizer"]["state"][k].values())))
    print(f"  cli.train 1 epoch at batch 16, --scan_batches 0 / 4: {seconds[0]:.1f} / {seconds[4]:.1f} s; CSV "
          f"rows equal {rows0 == rows4} ({rows4[-1]}); best checkpoints (parameters, BN "
          f"statistics, Adam's moments, step {snap4['step']}) bit-equal {equal} [{card}]", flush=True)
    check(rows0 == rows4 and len(rows0) == 2, f"--scan_batches 4's CSV {rows4} against {rows0}")
    check(equal, "--scan_batches 4's best checkpoint differs from --scan_batches 0's")


def zoo_tensor_parallel_path(card) -> None:
    """29. The baseline zoo over a model axis on the one card (see the module
    docstring)."""
    import multiprocessing
    import shutil
    import tempfile

    import numpy as np
    import torch

    from edrl_tpu_torch.tools.profile_data_parallel import READINGS

    t_phase = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    outbox = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_zoo_tp_rank, args=(r, port, outbox)) for r in range(2)]
    for p in procs:
        p.start()
    work = Path(tempfile.mkdtemp(prefix="edrl_zoo_tp_", dir=REPO / "build"))
    try:
        posted = {}
        deadline = time.perf_counter() + 600
        while len(posted) < 2:
            try:
                rank, what, result = outbox.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                check(not dead and time.perf_counter() < deadline, f"phase 29 ranks: exit codes {dead}")
                continue
            check(what == "done", f"phase 29 rank {rank}:\n{result}")
            posted[rank] = result
        for p in procs:
            p.join(timeout=120)
            check(p.exitcode == 0, f"phase 29 rank exited with {p.exitcode}")
        t_ranks = time.perf_counter() - t_phase
        cuts = {name: cut for name, _, cut in ZOO_TP_PLAN if cut}
        print(f"baseline zoo over a (1, 2) mesh on one card over gloo, f32 at batch {ZOO_TP_BATCH}, each family's "
              f"steps against one card's: worst |err| / (atol 2e-4 + rtol 1e-3 |want|), beside the one-card "
              f"steps' own reading under a one-ulp move of every input (ulp_*); a reading passes at 1; the "
              f"replicated gradients' largest |difference| over the ranks before the step's broadcast "
              f"(replica_drift) passes at 0 ({', '.join(ZOO_CNN)}: at 2e-4); collectives a step, MB put in a "
              f"rank; depth cut: "
              f"{ {n: c for n, c in cuts.items()} } (Trans_cross at full depth) [{card}]", flush=True)
        for name, steps, _ in ZOO_TP_PLAN:
            fam = [posted[r]["families"][name] for r in range(2)]
            errs = fam[0]["errs"]
            print(f"  {name}: {steps} step(s), {fam[0]['split']} split parameters, {errs}; B1/B2 launches a step "
                  f"by route, rank 0 / 1: {fam[0]['routes']} / {fam[1]['routes']}; model-axis collectives a step "
                  f"{fam[0]['collectives']}; {fam[0]['s']:.1f} s", flush=True)
            check(max(errs[k] for k in READINGS) <= 1.0, f"phase 29 {name} bars: {errs}")
            check(errs["replica_drift"] <= (2e-4 if name in ZOO_CNN else 0.0), f"phase 29 {name} replicas: {errs}")
            for rank, f in enumerate(fam):
                check(all(f["routes"].get(k, 0) > 0 for k in ZOO_TP_ROUTES[name]) and
                      set(f["routes"]) <= set(ZOO_TP_ROUTES[name]),
                      f"phase 29 {name} rank {rank}: launches by route {f['routes']}")
        served = [posted[r]["served"] for r in range(2)]
        diff = max(float(np.abs(s[2]["probs"] - s[1]["probs"]).max()) for s in served)
        print(f"  Trans_cross Predictor on (1, 2), shipped bf16, {ZOO_SERVE_PAIRS} pairs: chunks of 2 on the "
              f"{served[0][2]['route']} route (chunks by route {served[0][2]['chunks']}) against batch by batch, "
              f"max |difference| {diff:.2e} (bar 1e-6); {served[0][1]['s']:.2f} / {served[0][2]['s']:.2f} s; B1/B2 "
              f"launches a request by route {served[0][2]['launches']}", flush=True)
        check(all(s[2]["route"] == "staged" and s[2]["chunks"] == {"graph": 0, "staged": 1}
                  and s[1]["chunks"] == {"graph": 0, "staged": 0} for s in served), "phase 29 chunk routes")
        check(diff <= 1e-6 and all(s[2]["probs"].shape == (ZOO_SERVE_PAIRS, 2) for s in served),
              f"phase 29 chunked serving {diff}")
        torch.cuda.empty_cache()
        _scan_cli_runs(card, work)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(work, ignore_errors=True)
    check(not work.exists(), "phase 29's temporary directory is removed")
    print(f"wall s: phase 29 {time.perf_counter() - t_phase:.1f} (the ranks {t_ranks:.1f}) [{card}]", flush=True)


ABLATION_ARGS = ["--protocol", "fusion", "--epochs", "1", "--warmup_steps", "100", "--train_samples", "32",
                 "--val_samples", "16", "--batch_size", "16", "--lr", "3e-5", "--sigmas", "0", "0.5",
                 "--seeds", "0"]


def ablation_path(card, reset_counts, counts) -> None:
    """Phase 30: the ablation study on the card (see the module docstring)."""
    import math
    import shutil
    import tempfile

    from edrl_tpu_torch.kernels import window_attention as wa
    from edrl_tpu_torch.tools import ablation_study as ab

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="edrl_ablation_", dir=REPO / "build"))
    out = work / "STUDY.md"
    jsonl = Path(f"{out}.jsonl")
    argv = ABLATION_ARGS + ["--variants", ab.FULL, "--output", str(out),
                            "--parity_jsonl", str(REPO / "ABLATION_FUSION_DEFAULT.md.jsonl")]
    try:
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            check(ab.main(argv) == 0, "ablation_study exit code")
        launches = counts()
        rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
        check(len(rows) == 1, f"ablation rows {len(rows)}")
        r = rows[0]
        jax_keys = set(json.loads((REPO / "ABLATION_FUSION_DEFAULT.md.jsonl").read_text().splitlines()[0]))
        check(jax_keys <= set(r), f"row keys: {jax_keys - set(r)} missing")
        cells = [(m, s, c) for m, by in r["sweep"].items() for s, c in by.items()]
        check(sorted((m, s) for m, s, _ in cells) == sorted((m, s) for m in ab.MODALITIES for s in ("0.0", "0.5"))
              and all(c["num_samples"] == 16 and all(math.isfinite(c[k]) for k in ("loss", "accuracy", "auc"))
                      for _, _, c in cells), f"sweep cells {[(m, s) for m, s, _ in cells]}")
        check(r["sweep"]["both"]["0.0"]["loss"] != r["sweep"]["both"]["0.5"]["loss"], "the sweep's sigmas differ")
        check(len(r["train_loss_history"]) == len(r["val_acc_history"]) == 1
              and math.isfinite(r["final_train_loss"]) and r["card"] == card, f"row {r['card']}")
        fit_l, sweep_l = r["launches"]["fit"], r["launches"]["sweep"]
        # Two steps of two forwards (12 B1 + 12 B2 each) and their backwards,
        # one val batch of 12 + 12 forwards; the sweep one batch a cell (a
        # missing modality's input is zeroed and its backbone still runs).
        check(fit_l["forward"] == {"wgmma": 2 * 48 + 24, "fma": 0} and fit_l["backward"] == {"wgmma": 2 * 48, "fma": 0},
              f"fit's attention launches by route {fit_l}")
        check(sweep_l["forward"] == {"wgmma": 2 * 3 * 24, "fma": 0} and sweep_l["backward"] == {"wgmma": 0, "fma": 0},
              f"the sweep's attention launches by route {sweep_l}")
        attention = (wa.SELF_ATTENTION, wa.WINDOW_ATTENTION_V2, wa.SELF_ATTENTION_BWD, wa.WINDOW_ATTENTION_V2_BWD)
        check(all(launches[k] > 0 and launches[k] == fit_l["kernels"][k] + sweep_l["kernels"][k] for k in attention)
              and not any(v for k, v in launches.items() if k not in attention), f"phase 30 launches {launches}")
        md = out.read_text()
        check(all(h in md for h in ("## Fusion advantage", "## Paired per seed", "## Runs", "## Parity")),
              "the study's markdown")
        before = jsonl.read_text()
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(ab.main(argv) == 0, "ablation_study exit code, cached")
        check("(cached)" in buf.getvalue() and jsonl.read_text() == before and not any(counts().values()),
              "a second call trains nothing")
        print(f"ablation study, full EDRL seed 0, 1 epoch of 32 + 16 samples at full width: best val acc "
              f"{r['best_val_acc']:.4f}, train loss {r['final_train_loss']:.4f}, fit {r['train_time_s']} s (its "
              f"first epoch {r['first_epoch_s']:.1f} s, {r['step_ms']:.1f} ms a step), B1/B2 launches by route: "
              f"fit {fit_l['forward']} / {fit_l['backward']}, sweep {sweep_l['forward']}; sweep cells "
              f"{len(cells)}; a second call cached [{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(not work.exists(), "phase 30's temporary directory is removed")
    print(f"wall s: phase 30 {time.perf_counter() - t_phase:.1f} [{card}]", flush=True)


def main() -> None:
    t_start = time.perf_counter()
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
    from edrl_tpu_torch.tools import profile_attention_fwd as pa
    from edrl_tpu_torch.tools import profile_layer_norm as pln
    from edrl_tpu_torch.tools import profile_sublayer as psl
    from edrl_tpu_torch.tools import profile_v1_mmd as pv
    from edrl_tpu_torch.tools import sublayer_dbias as sd
    from edrl_tpu_torch.tools.timing import enqueue_ms, graph_ms, runs_ms
    from edrl_tpu_torch.train import trainer

    trainer.set_conv_precision()

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
            elif "Used " in line and " registers" in line and entry:  # not the (C7519) notes on wgmma's registers
                regs[entry] = int(line.split("Used ")[1].split(" registers")[0])
            elif "spill stores" in line and entry and int(line.split(" bytes spill stores")[0].split()[-1]):
                spills.append(f"{entry}: {line.strip()}")
        print(f"  ptxas: {len(regs)} entries, registers {min(regs.values())}..{max(regs.values())}; "
              f"{len(spills)} spill", flush=True)
        for line in spills:
            print(f"  ptxas spill: {line}")
        for kernel in ("attention_fwd_wgmma_kernel", *ATTENTION_BWD_KERNELS, *B5_WGMMA_KERNELS):
            found = [r for e, r in regs.items() if kernel in e]
            print(f"  ptxas {kernel}: registers {found}, "
                  f"spilling: {[line for line in spills if kernel in line] or 'none'}", flush=True)
        check(not [line for line in spills for k in B5_WGMMA_KERNELS if k in line], "B5's wgmma kernels spill")
        check(not [line for line in spills if "attention_fwd_wgmma_kernel" in line],
              "the attention forward's wgmma kernel spills")
        check(not [line for line in spills for k in ATTENTION_BWD_KERNELS if k in line],
              "the attention backward's wgmma kernels spill")
        for epilogue in B6_EPILOGUES:
            found = [r for e, r in regs.items() if "wgmma_gemm_kernel" in e and epilogue in e]
            print(f"  ptxas B6 wgmma_gemm_kernel<{epilogue}>: registers {found}, spilling: "
                  f"{[line for line in spills if 'wgmma_gemm_kernel' in line and epilogue in line] or 'none'}",
                  flush=True)
            check(bool(found), f"ptxas reported no wgmma_gemm_kernel<{epilogue}>")
    # The attention's tensor-core kernels at the main-path shapes: resident
    # blocks per SM (occupancy calculator) and shared memory; the forward's
    # persistent grid (one CTA per SM) at each batch-32 call: CTAs and the
    # (group, head) items each walks (waves).
    import ctypes

    bwd_lib = build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, n_fwd, with_bias, items in (("B1, N=216", 216, 0, (32 * 6,)),
                                           ("B2, N=144, Swin stages 0-3", 144, 1, (2048, 1024, 512, 256)),
                                           ("B2 and B6's attention phase, N=216", 216, 1, (32 * 6,))):
        occ = (ctypes.c_int * 3)()
        check(bwd_lib.edrl_attention_fwd_occupancy(1, n_fwd, 128, with_bias, occ) == 0, "occupancy query")
        grids = []
        for i in items:
            grid_ = (ctypes.c_int * 2)()
            check(bwd_lib.edrl_attention_fwd_grid(n_fwd, i, grid_) == 0, "grid query")
            grids.append(tuple(grid_))
        ctas, units = [g_[0] for g_ in grids], [g_[1] for g_ in grids]
        print(f"  attention fwd wgmma, {label}, head_dim 128: {occ[0]} blocks of {occ[2]} warps per SM "
              f"({occ[0] * occ[2]} warps), {occ[1]} bytes of shared memory per block; (group, head) items "
              f"{list(items)} as {units} work units (the last wave's items in halves where it is at most half "
              f"the CTAs) over {ctas} CTAs on {sms} SMs: {[-(-u // c) for u, c in zip(units, ctas)]} waves",
              flush=True)
    # The wgmma forward's tensor maps (q's box of 64 rows, then k's and v's
    # of the keys held) at B1's and B2's batch-32 layouts: dims (D, heads, N,
    # groups), the byte strides of a head, a token and a group.
    plan = (ctypes.c_longlong * 11)()
    for label, n_, heads_, groups_, row_, keys in (("B1", 216, 6, 32, 768, 224),
                                                   ("B2 stage 0", 144, 1, 2048, 384, 144)):
        group_, head_, row_ = wa.attention_strides(n_, 128, heads_, row_)
        for box in (64, keys):
            check(bwd_lib.edrl_attention_fwd_map_plan(128, heads_, n_, groups_, head_, row_, group_, box, plan) == 0,
                  "map plan query")
            want = (128, heads_, n_, groups_, 2 * head_, 2 * row_, 2 * group_, 64, 1, box, 1)
            check(tuple(plan) == want, f"{label} map plan {tuple(plan)}, not {want}")
            print(f"  attention fwd wgmma, {label}: tensor map dims {tuple(plan)[:4]}, byte strides "
                  f"{tuple(plan)[4:7]}, box {tuple(plan)[7:]}", flush=True)
    # The rows past N of a group's last query tile and its keys past N come
    # from TMA's zero fill, not from the next group: NaN in the group after
    # the last, a view of the first groups, o finite and within the bar (B1's
    # packed layout at N = 216, B2's at N = 144 with a bias, v1's).
    nan_gen = torch.Generator(device=dev).manual_seed(18)

    def nan_after(shape):
        t = torch.randn((shape[0] + 1, *shape[1:]), generator=nan_gen, device=dev).to(torch.bfloat16)
        t[shape[0]] = float("nan")
        return t

    nan_bias = torch.randn((4, 2, 144, 144), generator=nan_gen, device=dev)
    nan_bias[..., 1::3] = -1e9
    q_, k_, v_ = (nan_after((4, 216, 768)) for _ in range(3))
    qkv_ = nan_after((2, 4, 144, 768))
    vq, vk, vv = (nan_after((2, 3, 2, 144, 128)) for _ in range(3))
    wa.reset_launch_counts()
    for label, got, want in (
            ("B1 [4,216,768]x6", wa.self_attention_fused(q_[:4], k_[:4], v_[:4], 6, 128 ** -0.5),
             lambda: wa.self_attention_reference(q_[:4], k_[:4], v_[:4], 6, 128 ** -0.5)),
            ("B2 [2,4,144,768] H=2", wa.window_attention_fused_v2(qkv_[:2], nan_bias, 2, 128 ** -0.5),
             lambda: wa.window_attention_v2_reference(qkv_[:2], nan_bias, 2, 128 ** -0.5)),
            ("v1 [2,3,2,144,128]", wa.window_attention_v1_fwd_kernel(vq[:2], vk[:2], vv[:2], nan_bias[:3].contiguous()),
             lambda: wa.window_attention_reference(vq[:2], vk[:2], vv[:2], nan_bias[:3].contiguous()))):
        err = (got.float() - want().float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        print(f"check attention fwd wgmma {label}, NaN in the next group: finite {finite}, max_abs_err {err:.3e} "
              f"(atol {BF16_ATOL:g})", flush=True)
        check(finite and err <= BF16_ATOL, f"attention fwd {label} reads the next group")
    check(wa.FWD_ROUTES == {"wgmma": 3, "fma": 0}, f"NaN-neighbour routes {wa.FWD_ROUTES}")
    del q_, k_, v_, qkv_, vq, vk, vv, nan_bias
    # A consumer warpgroup with no query tile in a work unit must still
    # release the unit's K and V in step with the others: B2 at N = 100 (two
    # tiles for three warpgroups) over 1024 items, and B1 at N = 144 and 150
    # with a last wave in half-items (tiles 2 + 1), each CTA walking 3 or more
    # units; each call three times against its plain version.
    wa.reset_launch_counts()
    idle_b = 3 * sms + sms // 2 - 6
    qkv_ = torch.randn((8, 64, 100, 384), generator=nan_gen, device=dev).to(torch.bfloat16)
    idle_bias = torch.randn((64, 2, 100, 100), generator=nan_gen, device=dev)
    idle_bias[..., 1::3] = -1e9
    idle_cases = [("B2 [8,64,100,384] H=2", 100, 8 * 64 * 2,
                   lambda: wa.window_attention_fused_v2(qkv_, idle_bias, 2, 64 ** -0.5),
                   wa.window_attention_v2_reference(qkv_, idle_bias, 2, 64 ** -0.5))]
    for n_ in (144, 150):
        q_, k_, v_ = (torch.randn((idle_b, n_, 128), generator=nan_gen, device=dev).to(torch.bfloat16)
                      for _ in range(3))
        idle_cases.append((f"B1 [{idle_b},{n_},128]x1", n_, idle_b,
                           lambda q_=q_, k_=k_, v_=v_: wa.self_attention_fused(q_, k_, v_, 1, 128 ** -0.5),
                           wa.self_attention_reference(q_, k_, v_, 1, 128 ** -0.5)))
    for label, n_, items_, run, want in idle_cases:
        grid_ = (ctypes.c_int * 2)()
        check(bwd_lib.edrl_attention_fwd_grid(n_, items_, grid_) == 0, "grid query")
        errs = [(run().float() - want.float()).abs().max().item() for _ in range(3)]
        print(f"check attention fwd wgmma {label}, warpgroups without a tile: {items_} items as {grid_[1]} work "
              f"units over {grid_[0]} CTAs, max_abs_err of three calls {errs} (atol {BF16_ATOL:g})", flush=True)
        check(max(errs) <= BF16_ATOL, f"attention fwd {label}: {errs}")
    check(wa.FWD_ROUTES == {"wgmma": 9, "fma": 0}, f"idle-warpgroup routes {wa.FWD_ROUTES}")
    del qkv_, idle_bias, idle_cases, q_, k_, v_

    def bwd_held(label, got, want, dbias=None):
        """A backward's results finite and within the bars (bf16 1e-2 of the
        plain result's largest magnitude, dbias 1e-4); returns the worst."""
        pairs = [(g_, w_, BWD_BAR["bf16"]) for g_, w_ in zip(got, want)]
        if dbias is not None:
            pairs.append((*dbias, BWD_BAR["f32"]))
        finite = all(bool(torch.isfinite(g_).all()) for g_, _, _ in pairs)
        rels = [(g_.float() - w_.float()).abs().max().item() / max(w_.float().abs().max().item(), 1e-30)
                for g_, w_, _ in pairs]
        check(finite and all(r_ <= bar for r_, (_, _, bar) in zip(rels, pairs)), f"attention bwd {label}: {rels}")
        return max(rels)

    # The backward reads q, k, v and do through the same 4-D maps: with NaN
    # in the group after a view's last, dq, dk, dv and dbias are finite and
    # within the bars (B1's packed layout at N = 216, B2's at N = 144 with a
    # bias, v1's [B, W, H, N, D]).
    nan_bias = torch.randn((4, 2, 144, 144), generator=nan_gen, device=dev)
    nan_bias[..., 1::3] = -1e9
    wa.reset_launch_counts()
    q_, k_, v_, do_ = (nan_after((4, 216, 768)) for _ in range(4))
    worst = [("B1 [4,216,768]x6", bwd_held("B1 NaN", wa.self_attention_bwd_kernel(
        q_[:4], k_[:4], v_[:4], do_[:4], 6, 128 ** -0.5), wa.self_attention_bwd_reference(
        q_[:4], k_[:4], v_[:4], do_[:4], 6, 128 ** -0.5)))]
    qkv_, do_ = nan_after((2, 4, 144, 768)), nan_after((2, 4, 144, 256))
    got_ = wa.window_attention_v2_bwd_kernel(qkv_[:2], nan_bias, do_[:2], 2, 128 ** -0.5)
    want_ = wa.window_attention_v2_bwd_reference(qkv_[:2], nan_bias, do_[:2], 2, 128 ** -0.5)
    worst.append(("B2 [2,4,144,768] H=2", bwd_held("B2 NaN", got_[:1], want_[:1], (got_[1], want_[1]))))
    vq, vk, vv, vdo = (nan_after((2, 3, 2, 144, 128)) for _ in range(4))
    v1_bias = nan_bias[:3].contiguous()
    got_ = wa.window_attention_v1_bwd_kernel(vq[:2], vk[:2], vv[:2], v1_bias, vdo[:2])
    want_ = wa.window_attention_bwd_reference(vq[:2], vk[:2], vv[:2], v1_bias, vdo[:2])
    worst.append(("v1 [2,3,2,144,128]", bwd_held("v1 NaN", got_[:3], want_[:3], (got_[3], want_[3]))))
    print("check attention bwd wgmma, NaN in the next group: finite, worst relative errors "
          + ", ".join(f"{label} {r_:.3e}" for label, r_ in worst)
          + f" (bars {BWD_BAR['bf16']:g} / dbias {BWD_BAR['f32']:g})", flush=True)
    check(wa.BWD_ROUTES == {"wgmma": 3, "fma": 0}, f"NaN-neighbour backward routes {wa.BWD_ROUTES}")
    del q_, k_, v_, do_, qkv_, vq, vk, vv, vdo, got_, want_
    # Units where a consumer warpgroup has no key to work on (the rows
    # kernel's second half of the keys past N: N = 17 holds 64 keys, N =
    # 100 and 150 hold 160) or a pipeline no unit, each CTA walking 3 or more
    # units: B2 at N = 100 over 1024 items, B1 at N = 150 and 17; each call
    # three times against its plain version.
    wa.reset_launch_counts()
    qkv_ = torch.randn((8, 64, 100, 384), generator=nan_gen, device=dev).to(torch.bfloat16)
    do_ = torch.randn((8, 64, 100, 128), generator=nan_gen, device=dev).to(torch.bfloat16)
    idle_bias = torch.randn((64, 2, 100, 100), generator=nan_gen, device=dev)
    idle_bias[..., 1::3] = -1e9
    want_ = wa.window_attention_v2_bwd_reference(qkv_, idle_bias, do_, 2, 64 ** -0.5)
    errs = [bwd_held("B2 N=100", got_[:1], want_[:1], (got_[1], want_[1])) for got_ in
            (wa.window_attention_v2_bwd_kernel(qkv_, idle_bias, do_, 2, 64 ** -0.5) for _ in range(3))]
    grid_ = (ctypes.c_int * 7)()
    check(bwd_lib.edrl_attention_bwd_grid(100, 8, 64, 2, 1, grid_) == 0, "grid query")
    print(f"check attention bwd wgmma B2 [8,64,100,384] H=2, 1024 items (rows kernel {grid_[1]}+ units over "
          f"{grid_[0]} CTAs, keys kernel {grid_[3]} over {grid_[2]}): worst relative error of three calls {errs}",
          flush=True)
    del qkv_, do_, idle_bias, want_
    idle_b = 6 * sms + sms // 2 - 6  # keys kernel units at N = 17: three or more a pipeline
    for n_ in (150, 17):
        q_, k_, v_, do_ = (torch.randn((idle_b, n_, 128), generator=nan_gen, device=dev).to(torch.bfloat16)
                           for _ in range(4))
        want_ = wa.self_attention_bwd_reference(q_, k_, v_, do_, 1, 128 ** -0.5)
        errs = [bwd_held(f"B1 N={n_}", wa.self_attention_bwd_kernel(q_, k_, v_, do_, 1, 128 ** -0.5), want_)
                for _ in range(3)]
        check(bwd_lib.edrl_attention_bwd_grid(n_, idle_b, 1, 1, 1, grid_) == 0, "grid query")
        print(f"check attention bwd wgmma B1 [{idle_b},{n_},128]x1 ({grid_[4]} keys held; rows kernel {grid_[1]} "
              f"units over {grid_[0]} CTAs, keys kernel {grid_[3]} over {grid_[2]}): worst relative error of three "
              f"calls {errs}", flush=True)
        check(grid_[1] >= 3 * grid_[0] and grid_[3] >= 3 * 2 * grid_[2], f"B1 N={n_}: {tuple(grid_)}")
    check(wa.BWD_ROUTES == {"wgmma": 9, "fma": 0}, f"idle-warpgroup backward routes {wa.BWD_ROUTES}")
    del q_, k_, v_, do_, want_
    # The backward's wgmma kernels (rows: dq, the row statistics and dbias;
    # keys: dk and dv) at each batch-32 call: resident CTAs per SM (the
    # occupancy calculator), dynamic shared memory, registers of a consumer
    # thread after setmaxnreg (at launch: ptxas's, above), and the persistent
    # grids' CTAs, units and waves (the rows kernel's units walk the batch
    # chunks dbias_chunking plans; B1's one entry each).
    for label, n_bwd, with_dbias, calls_ in (
            ("B1, N=216", 216, 0, ((32, 1, 6),)),
            ("B2, N=144, Swin stages 0-3", 144, 1, ((32, 64, 1), (32, 16, 2), (32, 4, 4), (32, 1, 8))),
            ("B2 under B6, N=216", 216, 1, ((32, 1, 6),))):
        occ = (ctypes.c_int * 4)()
        check(bwd_lib.edrl_attention_bwd_occupancy(1, n_bwd, 128, with_dbias, occ) == 0, "occupancy query")
        check(occ[0] >= 1 and occ[1] >= 1, f"attention bwd {label}: a kernel fits no CTA on an SM")
        plans = []
        for b_, w_, h_ in calls_:
            per_block = 1
            if with_dbias:
                per_block, _ = wa.dbias_chunking(b_, w_ * h_ * -(-n_bwd // 64), occ[0] * sms,
                                                 wa.dbias_chunk_cost("wgmma", w_, h_, n_bwd, 128, sms))
            grid_ = (ctypes.c_int * 7)()
            check(bwd_lib.edrl_attention_bwd_grid(n_bwd, b_, w_, h_, per_block, grid_) == 0, "grid query")
            plans.append((per_block, *grid_))
        print(f"  attention bwd wgmma, {label}, head_dim 128: rows kernel {occ[0]} CTA per SM, {occ[2]} bytes of "
              f"dynamic shared memory, {plans[0][5]} keys held, consumers at {plans[0][6]} registers after "
              f"setmaxnreg; keys kernel {occ[1]} CTA per SM, {occ[3]} bytes, consumers at {plans[0][7]}; per call: "
              + "; ".join(f"rows {g[2]} units of {g[0]} batch entries over {g[1]} CTAs ({-(-g[2] // g[1])} waves), "
                          f"keys {g[4]} units over {g[3]} CTAs of two pipelines ({-(-g[4] // (2 * g[3]))} waves)"
                          for g in plans), flush=True)
    # v1 runs the same device code through B2's entry points with its own
    # strides: its kernels at the Swin stages' shape.
    occ = (ctypes.c_int * 4)()
    check(bwd_lib.edrl_attention_fwd_occupancy(1, 144, 128, 1, occ) == 0, "occupancy query")
    print(f"  v1 fwd wgmma, N=144, head_dim 128: {occ[0]} blocks of {occ[2]} warps per SM, {occ[1]} bytes of "
          f"shared memory per block", flush=True)
    check(bwd_lib.edrl_attention_bwd_occupancy(1, 144, 128, 1, occ) == 0, "occupancy query")
    print(f"  v1 bwd wgmma, N=144, head_dim 128: rows kernel {occ[0]} CTA per SM, {occ[2]} bytes; keys kernel "
          f"{occ[1]} CTA per SM, {occ[3]} bytes", flush=True)
    if log.exists():
        for kernel in ("attention_fwd_wgmma_kernel", "attention_bwd_rows_kernel", "attention_bwd_keys_kernel",
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
        c_route = {1: "wgmma", 0: "fma"}[c_route(int(dtype == torch.bfloat16), n_, d_)]
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
        # A head-local tensor-parallel shard of each (phase 28's layout at
        # M = 2): B1's 3 of 6 heads, B2's one of Swin stage 1's two.
        sa_bwd_case((bt, mc.oct_tokens, c_vit // 2), h_vit // 2, dtype)
        shard = train_swin[1]
        v2_bwd_case(normal((bt, (shard["grid"] // shard["window"]) ** 2, shard["window"] ** 2,
                            3 * shard["c"] // 2), dtype),
                     swin_bias(shard["grid"], shard["window"], shard["heads"] // 2, shard["shifted"]),
                     shard["heads"] // 2, dtype, "Swin stage 1, a head-local shard of 1 of 2 heads")
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
        print(f"{label}: {kind} launches by route {routes} (expected {launches} on wgmma, "
              f"none on the CUDA cores)", flush=True)
        check(routes == {"wgmma": launches, "fma": 0}, f"{label}: {kind} routes {routes}")

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

    def bwd_times(name, label, calls, kernel_fn, plain_fn, sdpa):
        """B1's and B2's backward rows: runs of 10 calls of the kernel, its
        plain version and SDPA's backward (the rows' ms, plain_ms and
        library_ms, as in every earlier run), and beside them the
        device-only times (CUDA graphs of 10 calls; SDPA's backward a graph
        of its forward and backward less its forward's: pa.sdpa_backward;
        the rows' device_only_* keys)."""
        tr = {"kernel": runs_ms(kernel_fn), "plain": runs_ms(plain_fn), "SDPA": runs_ms(sdpa["runs"])}
        tg = {"kernel": graph_ms(kernel_fn), "plain": graph_ms(plain_fn),
              "SDPA": graph_ms(sdpa["graph"]) - graph_ms(sdpa["less"])}
        both = lambda t: ", ".join(f"{k_} {v_:.4f}" for k_, v_ in t.items())  # noqa: E731
        print(f"  {name} {label} ms per call: runs of 10 {both(tr)}; device-only (CUDA graphs) {both(tg)}; "
              f"the kernel's host enqueue {enqueue_ms(kernel_fn):.4f} [{card}]", flush=True)
        for key, who in (("device_only_ms", "kernel"), ("device_only_plain_ms", "plain"),
                         ("device_only_library_ms", "SDPA")):
            totals[name][key] = totals[name].get(key, 0.0) + calls * tg[who]
        return tr["kernel"], tr["plain"], tr["SDPA"]

    single = {SA: [0.0, 0.0], V2: [0.0, 0.0]}

    def fwd_times(name, label, calls, timed):
        """B1's and B2's forward rows: runs of 10 calls of the kernel, its
        plain version and SDPA (the rows' ms, plain_ms and library_ms, as in
        every earlier run), and beside them the device-only times (CUDA
        graphs of 10 calls; the rows' device_only_* keys) and the kernel's
        host enqueue per call: the host is slower than B1's forward on the
        card, so B1's runs of 10 read the host's time."""
        tg = {k_: graph_ms(f) for k_, f in timed.items()}
        tr = {k_: runs_ms(f) for k_, f in timed.items()}
        both = lambda t: ", ".join(f"{k_} {v_:.4f}" for k_, v_ in t.items())  # noqa: E731
        print(f"  {name} {label} ms per call: runs of 10 {both(tr)}; device-only (CUDA graphs) {both(tg)}; "
              f"the kernel's host enqueue {enqueue_ms(timed['kernel']):.4f} [{card}]", flush=True)
        for key, who in (("device_only_ms", "kernel"), ("device_only_plain_ms", "plain"),
                         ("device_only_library_ms", "SDPA")):
            totals[name][key] = totals[name].get(key, 0.0) + calls * tg[who]
        return tr["kernel"], tr["plain"], tr["SDPA"]

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
        tk, tp, tl = fwd_times(SA, f"[{bsz},{n},{c}]x{heads} bf16", 2 * s["calls"], {
            "kernel": lambda: wa.self_attention_fused(q, k, v, heads, scale),
            "plain": lambda: wa.self_attention_reference(q, k, v, heads, scale),
            "SDPA": lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), scale=scale)})
        single_call(SA, 2 * s["calls"], lambda: wa.self_attention_fused(q, k, v, heads, scale),
                    lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), scale=scale))
    elems = bsz * n * c
    report(SA, f"[{bsz},{n},{c}]x{heads} bf16", 2 * s["calls"], tk, tp, tl, 4 * elems * 2,
           4.0 * bsz * heads * n * n * hd)
    tk, tp, tl = bwd_times(SA_BWD, f"[{bsz},{n},{c}]x{heads} bf16", 2 * s["calls"],
                           lambda: wa.self_attention_bwd_kernel(q, k, v, do, heads, scale),
                           lambda: wa.self_attention_bwd_reference(q, k, v, do, heads, scale),
                           pa.sdpa_backward(split(q), split(k), split(v), split(do), scale=scale))
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
            tk, tp, tl = fwd_times(V2, label, 2 * s["calls"], {
                "kernel": lambda: wa.window_attention_fused_v2(qkv, bias, heads, scale),
                "plain": lambda: wa.window_attention_v2_reference(qkv, bias, heads, scale),
                "SDPA": lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale)})
            single_call(V2, 2 * s["calls"], lambda: wa.window_attention_fused_v2(qkv, bias, heads, scale),
                        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale))
        elems = bsz * w * n * c
        bias_bytes = w * heads * n * n * 4
        flops = 1.0 * bsz * w * heads * n * n * hd
        report(V2, label, 2 * s["calls"], tk, tp, tl, 4 * elems * 2 + bias_bytes, 4 * flops)
        tk, tp, tl = bwd_times(V2_BWD, label, 2 * s["calls"],
                               lambda: wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, scale),
                               lambda: wa.window_attention_v2_bwd_reference(qkv, bias, do, heads, scale),
                               pa.sdpa_backward(q4, k4, v4, do4, mask, scale))
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
    # train shape launch its forward, bias-tiles, rows (dq), keys (dk/dv)
    # and dbias column-sum kernels and nothing else (no copy, permute or
    # cat; the launch counts are held
    # in phase 22, the profiler now and then misses an event); dq, dk, dv and
    # dbias are the same bit for bit over two runs.
    v1_args = v1_inputs(*v1_train[1][:5], torch.bfloat16, *v1_train[1][5:])
    v1_kernels = pv.kernels_of(lambda: pv.v1_step(*v1_args), attempts=PROFILE_ATTEMPTS)
    v1_own = ("attention_fwd_wgmma_kernel", "attention_bwd_bias_tiles_kernel", "attention_bwd_rows_kernel",
              "attention_bwd_keys_kernel", "column_sum_kernel")
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

    # -- 23. the train and test CLIs at full width ------------------------------
    # `python -m edrl_tpu_torch.cli.train` in the shipped config on clean uint8
    # synthetic batches, augmented and corrupted on the card, then
    # `cli.test` on its `best` checkpoint; checkpoints and logs in a temporary
    # directory removed afterwards.
    import shutil
    import tempfile

    from edrl_tpu_torch.cli import test as test_cli
    from edrl_tpu_torch.cli import train as train_cli
    from edrl_tpu_torch.data import device_augment as dag
    from edrl_tpu_torch.data import device_noise as dno
    from edrl_tpu_torch.models.medfusion import MedFusion
    from edrl_tpu_torch.train.checkpoint import CheckpointManager

    cli_bt, cli_samples, cli_epochs = 16, 48, 2
    cli_steps = cli_epochs * (cli_samples // cli_bt)
    cli_val = -(-cli_samples // cfg.data.eval_batch_size)
    cli_dir = Path(tempfile.mkdtemp(prefix="edrl_cli_"))

    timed = {}
    real_make_loaders = train_cli.make_loaders

    def make_timed_loaders(c, *mesh):
        tl, vl = real_make_loaders(c, *mesh)
        timed["train"] = TimedLoader(tl)
        return timed["train"], vl

    ckpt_s = collections.defaultdict(list)
    real_save_best, real_restore = CheckpointManager.save_best, CheckpointManager.restore

    def timed_method(name, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ckpt_s[name].append(time.perf_counter() - t)
            return out
        return call

    seen = collections.defaultdict(set)

    def medfusion_inputs(module, inputs):
        if isinstance(module, MedFusion):
            seen["inputs"].update(str(x.device) for x in inputs[:2])
            seen["dtypes"].update(str(x.dtype) for x in inputs[:2])
            seen["params"].update(str(p.device) for p in module.parameters())

    cli_args = ["--dataset", "synthetic", "--batch_size", str(cli_bt), "--synthetic_samples", str(cli_samples),
                "--end_epochs", str(cli_epochs), "--plot_dir", "", "--checkpoint_dir", str(cli_dir / "ckpt"),
                "--log_dir", str(cli_dir / "log"), "--name", "smoke"]
    hook = torch.nn.modules.module.register_module_forward_pre_hook(medfusion_inputs)
    train_cli.make_loaders = make_timed_loaders
    CheckpointManager.save_best = timed_method("save", real_save_best)
    CheckpointManager.restore = timed_method("restore", real_restore)
    try:
        out_buf = Tee()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out_buf):
            train_cli.main(cli_args)
        torch.cuda.synchronize()
        cli_wall = time.perf_counter() - t0
        cli_launches, cli_fwd, cli_bwd = counts(), dict(wa.FWD_ROUTES), dict(wa.BWD_ROUTES)
        train_cli.make_loaders = real_make_loaders
        reset_counts()
        t0 = time.perf_counter()
        test_cli.main(cli_args + ["--checkpoint", str(cli_dir / "ckpt" / "synthetic_0.5_smoke" / "best")])
        torch.cuda.synchronize()
        test_wall = time.perf_counter() - t0
        test_launches = counts()
        train_log = (cli_dir / "log" / "synthetic_smoke_train.log").read_text()
        test_log = (cli_dir / "log" / "synthetic_smoke_test.log").read_text()
        has_best = (cli_dir / "ckpt" / "synthetic_0.5_smoke" / "best").is_dir()
        csv_rows = (cli_dir / "log" / "synthetic_0.5_smoke.csv").read_text().splitlines()
    finally:
        hook.remove()
        train_cli.make_loaders = real_make_loaders
        CheckpointManager.save_best, CheckpointManager.restore = real_save_best, real_restore
        shutil.rmtree(cli_dir, ignore_errors=True)
    printed = out_buf.getvalue().splitlines()
    print(f"CLI train&test: {cli_wall:.1f} s, cli.test: {test_wall:.1f} s; model inputs on {sorted(seen['inputs'])} "
          f"({sorted(seen['dtypes'])}), parameters on {sorted(seen['params'])} [{card}]", flush=True)
    check(seen["inputs"] == {"cuda:0"} and seen["params"] == {"cuda:0"}, f"CLI devices {dict(seen)}")
    check(not cli_dir.exists(), "the CLI's temporary directory is removed")
    pairs_s = {}
    for epoch in range(1, cli_epochs + 1):
        tl = [line for line in printed if line.startswith(f"Train Epoch: {epoch} ")]
        vl = [line for line in printed if line.startswith(f"Val   Epoch: {epoch} ")]
        check(len(tl) == 1 and len(vl) == 1, f"epoch {epoch}: Train and Val lines {tl} {vl}")
        for line in (tl[0], vl[0]):
            loss = float(line.split("Loss: ")[1].split()[0])
            check(np.isfinite(loss), f"CLI loss: {line}")
        pairs_s[epoch] = float(tl[0].rsplit("(", 1)[1].split(" pairs/s")[0])
    check(len(csv_rows) == 1 + cli_epochs, f"CLI CSV rows {csv_rows}")
    check(has_best and "Best val accuracy" in train_log, "CLI saved a best checkpoint")

    tt_block, test_block_lines = test_block(train_log), test_block(test_log)
    for line in tt_block:
        print(f"  train&test: {line}", flush=True)
    check(tt_block == test_block_lines, f"cli.test on best {test_block_lines} vs the train&test block {tt_block}")
    print("  cli.test on best prints the same Test, uncertainty and missing-modality lines", flush=True)
    want = {name: 0 for name in cli_launches}
    want.update({SA: 24 * cli_steps + 12 * 5 * cli_val, V2: 24 * cli_steps + 12 * 5 * cli_val,
                 SA_BWD: 24 * cli_steps, V2_BWD: 24 * cli_steps})
    print(f"CLI train&test launches ({cli_steps} steps, {5 * cli_val} eval batches): {cli_launches} "
          f"(expected {want})", flush=True)
    check(cli_launches == want, f"CLI launches {cli_launches}, expected {want}")
    check_routes("CLI train&test", cli_bwd, 2 * want[SA_BWD])
    check_routes("CLI train&test", cli_fwd, 2 * want[SA], "forward")
    want_test = {name: 0 for name in test_launches}
    want_test.update({SA: 12 * 3 * cli_val, V2: 12 * 3 * cli_val})
    check(test_launches == want_test, f"cli.test launches {test_launches}, expected {want_test}")
    waits = timed["train"].waits
    for epoch in range(1, cli_epochs + 1):
        epoch_s = (cli_samples // cli_bt) * cli_bt / pairs_s[epoch]
        w = waits[epoch]
        print(f"CLI epoch {epoch}: {pairs_s[epoch]:.2f} train pairs/s; host wait on the loader "
              f"{1000 * sum(w) / len(w):.2f} ms per batch (first {1000 * w[0]:.2f}), {100 * sum(w) / epoch_s:.1f}% of "
              f"the epoch's {epoch_s:.3f} s [{card}]", flush=True)
    print(f"checkpoint save (best, {len(ckpt_s['save'])}x): " + ", ".join(f"{s:.2f}" for s in ckpt_s["save"])
          + " s; restore: " + ", ".join(f"{s:.2f}" for s in ckpt_s["restore"]) + f" s [{card}]", flush=True)

    # The input stage of a step (dequantize, augmentation, both noise views)
    # on the card against the CPU with the same draws, at the CLI's batch.
    rng = np.random.default_rng(5)
    d = cfg.data
    clean = {"fundus": rng.integers(0, 256, (cli_bt, d.fundus_size, d.fundus_size, 3), dtype=np.uint8),
             "oct": rng.integers(0, 256, (cli_bt, *d.oct_size, 1), dtype=np.uint8),
             "label": rng.integers(0, 2, cli_bt).astype(np.int32)}
    gen_cpu = torch.Generator().manual_seed(6)
    in_draws = {"fundus_augment": dag.draw_fundus_augment(cli_bt, gen_cpu, "cpu", d.color_jitter_strength),
                "oct_augment": dag.draw_oct_augment(cli_bt, gen_cpu, "cpu"),
                "views": dno.draw_views((cli_bt, d.fundus_size, d.fundus_size, 3), (cli_bt, *d.oct_size, 1),
                                        d.noise, gen_cpu, "cpu")}

    def to_card(m):
        return {k: (to_card(v) if isinstance(v, dict) else v.to(dev)) for k, v in m.items()}

    cpu_views = trainer.train_views(clean, cfg, "cpu", None, in_draws)
    card_clean = trainer.to_device(clean, dev)
    card_draws = to_card(in_draws)
    card_views = trainer.train_views(card_clean, cfg, dev, None, card_draws)
    view_err = max((card_views[k].cpu() - cpu_views[k]).abs().max().item() for k in trainer.VIEW_KEYS)
    print(f"input stage, card vs CPU on the same draws, batch {cli_bt}: max abs err {view_err:.3e} (atol 1e-6)",
          flush=True)
    check(view_err <= 1e-6 and all(card_views[k].dtype == torch.float32 for k in trainer.VIEW_KEYS),
          f"input stage card vs CPU {view_err}")
    del cpu_views, card_views
    gen_in = seeded(7)
    stage = lambda: trainer.train_views(card_clean, cfg, dev, gen_in)  # noqa: E731
    stage_ms = runs_ms(stage)
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            stage()
            torch.cuda.synchronize()
        device_events = [e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        if device_events:
            break
    stage_kernels = [e for e in device_events if "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    stage_dev_ms = sum(e.time_range.elapsed_us() for e in stage_kernels) / 1000.0
    print(f"input stage per batch of {cli_bt} (dequantize, augmentation, two noise views; device noise on): "
          f"{stage_ms:.3f} ms (runs of 10), device busy {stage_dev_ms:.3f} ms over {len(stage_kernels)} kernels "
          f"(torch.profiler) [{card}]", flush=True)
    check(len(stage_kernels) > 0, "the input stage launched no kernel")
    del card_clean, card_draws
    torch.cuda.empty_cache()

    # -- 24. the baseline zoo at full width -------------------------------------
    # Every registry name at full width in the shipped config: one dual-view
    # train step at batch 4 and one eval forward.  Then Multi_ResNet (f32,
    # TF32 off) on the card against the CPU and timed at batch 32 (TF32 on
    # beside it); Trans_cross (bf16, shipped flags) at batch 32 with its
    # attention held call by call; and the evaluation CLIs (deep ensemble,
    # MC-dropout, the sweep) with the ensemble Predictor, in a temporary
    # directory under build/ that the phase removes.
    from edrl_tpu_torch.baselines import ENSEMBLE_LRS, MODEL_REGISTRY
    from edrl_tpu_torch.cli import ensemble as ensemble_cli
    from edrl_tpu_torch.train.ensemble import restore_members

    def named(name, c=None):
        c = c or cfg
        return c.replace(model=dataclasses.replace(c.model, model_name=name))

    zoo_bt = 4
    zoo_batch = trainer.random_views(cfg, seed=11, batch_size=zoo_bt, device=dev)
    zoo_eval = {"fundus_low": zoo_batch["fundus_low"], "oct_low": zoo_batch["oct_low"], "label": zoo_batch["label"]}
    check(list(MODEL_REGISTRY) == list(ZOO_FEATURE_WIDTH), "the registry's names are the JAX registry's")
    reset_counts()
    zoo_fwd_routes0, zoo_bwd_routes0 = dict(wa.FWD_ROUTES), dict(wa.BWD_ROUTES)
    zoo_t0 = time.perf_counter()
    for name in MODEL_REGISTRY:
        ncfg = named(name)
        t0 = time.perf_counter()
        st = trainer.init_state(ncfg, seed=0, device=dev)
        out = trainer.make_train_step(ncfg)(st, zoo_batch, seeded(20))
        ev = trainer.make_eval_step(ncfg)(st, zoo_eval)
        with torch.no_grad():
            feat = trainer._normalize_output(st.model(zoo_eval["fundus_low"], zoo_eval["oct_low"], train=False))[2]
        loss = out["loss"].item()
        psum = ev["probs"].sum(-1)
        torch.cuda.synchronize()
        print(f"zoo {name}: {sum(p.numel() for p in st.model.parameters())} parameters, train step (batch "
              f"{zoo_bt}) loss {loss:.6f}, eval probabilities sum to 1 within "
              f"{(psum - 1).abs().max().item():.1e}, features {tuple(feat.shape)} "
              f"({time.perf_counter() - t0:.1f} s with the build)", flush=True)
        check(np.isfinite(loss) and np.isfinite(ev["loss"].item()), f"zoo {name}: loss {loss}")
        check(bool(torch.isfinite(ev["probs"]).all()) and (psum - 1).abs().max().item() <= 1e-5,
              f"zoo {name}: eval probabilities {ev['probs']}")
        check(tuple(feat.shape) == (zoo_bt, ZOO_FEATURE_WIDTH[name]),
              f"zoo {name}: features {tuple(feat.shape)}, the JAX model's width {ZOO_FEATURE_WIDTH[name]}")
        del st, out, ev, feat
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    zoo_launches = counts()
    zoo_fwd = {k: v - zoo_fwd_routes0.get(k, 0) for k, v in wa.FWD_ROUTES.items()}
    zoo_bwd = {k: v - zoo_bwd_routes0.get(k, 0) for k, v in wa.BWD_ROUTES.items()}
    print(f"zoo: {len(MODEL_REGISTRY)} registry names stepped and evaluated in {time.perf_counter() - zoo_t0:.1f} s; "
          f"launches {zoo_launches}; forward routes {zoo_fwd}, backward routes {zoo_bwd}", flush=True)
    # B1 and B2 run in the 8 names with a Swin or ViT backbone (MedFusion,
    # IMDR and the six transformer baselines); nothing else launches a kernel.
    for kname in (SA, V2, SA_BWD, V2_BWD):
        check(zoo_launches[kname] > 0, f"the zoo's path launched no {kname}")
    check(zoo_fwd["fma"] == 0 and zoo_bwd["fma"] == 0, f"zoo attention on the CUDA cores: {zoo_fwd} {zoo_bwd}")

    # Multi_ResNet, f32 with TF32 off, the card against the CPU at batch 2
    # with the same weights and inputs, and against the CPU's f64 results
    # (``model.double()``) where f32 rounding is amplified:
    # - the eval forward's logits at 1e-4 of the largest magnitude;
    # - the eval-mode loss's gradients (BatchNorm on its running statistics)
    #   in f64 on both at 1e-10 of a tensor's largest, and one train step in
    #   f64 on both: the loss at 1e-4, the gradients at phase 9's f32 bars;
    # - the gradients of the eval-mode loss and of the f32 train step, the
    #   card's and the CPU's each against the CPU's f64 ones, the card's
    #   within the CPU tests' rule (ZOO_WITNESS times the CPU's distance, the
    #   train step's the larger of the batch's two orders).  At full width a
    #   few ReLUs and max-pool windows sit within f32 rounding of their kinks
    #   and ties even in eval mode; train-mode BatchNorm at random init
    #   amplifies the rounding itself (the CPU tests' f32 steps read ~1e-2 of
    #   a tensor's largest gradient at the median against f64).
    mr_cfg = named("Multi_ResNet")
    small = trainer.random_views(mr_cfg, seed=12, batch_size=2, device="cpu")
    init_sd = {k: v.clone() for k, v in trainer.init_state(mr_cfg, seed=3, device="cpu").model.state_dict().items()}
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")

    def mr_state(device, double=False):
        st = trainer.init_state(mr_cfg, seed=3, device=device)
        st.model.load_state_dict(init_sd)
        if double:
            st.model.double()
        return st

    def mr_eval(device, double=False):
        """The eval forward's logits and its loss's gradients (f64, on the host)."""
        model = mr_state(device, double).model.eval()
        logits, loss, _ = model(small["fundus_low"].to(device), small["oct_low"].to(device),
                                small["label"].to(device).long(), train=False)
        loss.backward()
        return logits.detach().cpu(), {n: p.grad.cpu().double() for n, p in model.named_parameters()}

    def mr_step(device, double=False, reverse=False):
        """One train step: its loss, gradients (f64, on the host) and seconds."""
        st = mr_state(device, double)
        views = {k: v.flip(0) for k, v in small.items()} if reverse else small
        t0 = time.perf_counter()
        out = trainer.make_train_step(mr_cfg)(st, views, torch.Generator(device=device).manual_seed(0))
        loss = out["loss"].item()
        return loss, {n: p.grad.cpu().double() for n, p in st.model.named_parameters()}, time.perf_counter() - t0

    def grad_errors64(grads_a, grads_b):
        """``grad_errors`` of f64 gradients, computed in f64."""
        return sorted((((grads_a[n] - g).abs().max() / g.abs().max()).item(), n)
                      for n, g in grads_b.items() if g.abs().max() > 0)

    def witness(card, cpus, ref):
        """Per-tensor errors against ``ref``: the card's, and the CPU's (the
        largest over ``cpus``); each sorted."""
        cpu = sorted((max(rel_err(c[n], g) for c in cpus), n) for n, g in ref.items() if g.abs().max() > 0)
        return grad_errors(card, ref), cpu

    def within_witness(card, cpu):
        return (median_err(card) <= max(ZOO_MEDIAN_FLOOR, ZOO_WITNESS * median_err(cpu))
                and card[-1][0] <= min(max(ZOO_WORST_FLOOR, ZOO_WITNESS * cpu[-1][0]), 1.0))

    (lc, gc_eval), (lg, gg_eval), (_, g64_eval) = mr_eval("cpu"), mr_eval(dev), mr_eval("cpu", double=True)
    eval64 = grad_errors64(mr_eval(dev, double=True)[1], g64_eval)
    e_eval = rel_err(lg, lc)
    eval_direct = grad_errors(gg_eval, gc_eval)
    eval_card, eval_cpu = witness(gg_eval, [gc_eval], g64_eval)
    loss64_cpu, g64_cpu, cpu64_s = mr_step("cpu", double=True)
    loss64_gpu, g64_gpu, _ = mr_step(dev, double=True)
    errs64 = grad_errors64(g64_gpu, g64_cpu)
    loss_cpu, g32_cpu, cpu32_s = mr_step("cpu")
    _, g32_cpu_rev, _ = mr_step("cpu", reverse=True)
    loss_gpu, g32_gpu, _ = mr_step(dev)
    card_w, cpu_w = witness(g32_gpu, [g32_cpu, g32_cpu_rev], g64_cpu)
    dl64, dl = abs(loss64_gpu - loss64_cpu), abs(loss_gpu - loss_cpu)

    def med_worst(errs):
        return f"median {median_err(errs):.3e}, worst {errs[-1][0]:.3e} ({errs[-1][1]})"

    print(f"Multi_ResNet, card vs CPU at batch 2 over {len(errs64)} gradient tensors: eval logits {e_eval:.3e} of the "
          f"largest (bar 1e-4); f64 train step: loss {loss64_gpu:.15g} vs {loss64_cpu:.15g} (|d| {dl64:.3e}), "
          f"gradients {med_worst(errs64)} (bars 1e-3, 1e-2); f64 eval-mode gradients {med_worst(eval64)} (bar 1e-10); f32 "
          f"eval-mode gradients card vs CPU {med_worst(eval_direct)}"
          f", against the CPU's f64: the card's {med_worst(eval_card)}, the CPU's {med_worst(eval_cpu)}; f32 train "
          f"step: loss {loss_gpu:.7g} vs {loss_cpu:.7g} (|d| {dl:.3e}), gradients against the CPU's f64 step: the "
          f"card's {med_worst(card_w)}, the CPU's (the larger of two orders) {med_worst(cpu_w)}; CPU steps "
          f"{cpu32_s:.1f} s (f32), {cpu64_s:.1f} s (f64)", flush=True)
    check(e_eval <= 1e-4, f"Multi_ResNet eval card vs CPU {e_eval}")
    check(eval64[-1][0] <= 1e-10, f"Multi_ResNet f64 eval-mode gradients card vs CPU: worst {eval64[-1]}")
    check(dl64 <= 1e-4 * abs(loss64_cpu) and median_err(errs64) <= 1e-3 and errs64[-1][0] <= 1e-2,
          f"Multi_ResNet f64 step card vs CPU: loss {dl64}, gradients median {median_err(errs64)}, worst {errs64[-1]}")
    check(within_witness(eval_card, eval_cpu),
          f"Multi_ResNet eval-mode gradients against f64: the card's {eval_card[len(eval_card) // 2]}, "
          f"{eval_card[-1]}; the CPU's {eval_cpu[len(eval_cpu) // 2]}, {eval_cpu[-1]}")
    check(dl <= 1e-4 * abs(loss_cpu), f"Multi_ResNet f32 step loss card vs CPU {dl}")
    check(within_witness(card_w, cpu_w),
          f"Multi_ResNet f32 step gradients against f64: the card's {card_w[len(card_w) // 2]}, {card_w[-1]}; "
          f"the CPU's {cpu_w[len(cpu_w) // 2]}, {cpu_w[-1]}")
    del gc_eval, gg_eval, g64_eval, g64_cpu, g64_gpu, g32_cpu, g32_cpu_rev, g32_gpu, small, init_sd
    torch.cuda.empty_cache()

    def timed_steps(c, label, steps=TRAIN_STEPS, tf32=False):
        """Build, warm with one step, then time ``steps`` steps at batch 32:
        ms a step, pairs/s, peak memory (``max_memory_allocated``).  With
        ``tf32`` f32 convolutions run in cuDNN's TF32 (the port's entry
        points keep them in f32), and in f32 again at the end."""
        st = trainer.init_state(c, seed=0, device=dev)
        fn = trainer.make_train_step(c)
        b32 = trainer.random_views(c, seed=13, device=dev)
        gen = seeded(21)
        trainer.set_conv_precision(tf32)
        fn(st, b32, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        outs_ = [fn(st, b32, gen) for _ in range(steps)]
        torch.cuda.synchronize()
        ms = 1000.0 * (time.perf_counter() - t) / steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [o["loss"].item() for o in outs_]
        print(f"{label}: {ms:.1f} ms a step at batch {c.data.batch_size}, {1000.0 * c.data.batch_size / ms:.1f} "
              f"pairs/s, peak device memory {peak:.2f} GiB; losses {[round(x, 5) for x in losses]} [{card}]",
              flush=True)
        check(all(np.isfinite(x) for x in losses), f"{label}: losses {losses}")
        trainer.set_conv_precision()
        del st, b32, outs_
        torch.cuda.empty_cache()
        return ms, peak

    mr_f32 = mr_cfg.replace(model=dataclasses.replace(mr_cfg.model, use_bfloat16=False))
    zoo_times = {"Multi_ResNet f32, TF32 off": timed_steps(mr_f32, "Multi_ResNet f32 train step, TF32 off")}
    zoo_times["Multi_ResNet f32, TF32 on"] = timed_steps(
        mr_f32, "Multi_ResNet f32 train step, cuDNN TF32 on (a finding only; the port runs f32 convolutions in "
        "f32)", tf32=True)

    # Trans_cross, bf16 with the shipped flags, batch 32: B1 and B2 on the
    # tensor cores forward and backward, each attention call of one step held
    # against its plain version on its own tensors (phase 9's hook).
    tc_cfg = named("Trans_cross")
    tc_st = trainer.init_state(tc_cfg, seed=0, device=dev)
    tc_batch = trainer.random_views(tc_cfg, seed=14, device=dev)
    tc_fwd0, tc_bwd0 = dict(wa.FWD_ROUTES), dict(wa.BWD_ROUTES)
    reset_counts()
    tc_held = {name: [] for name in (SA, SA_BWD, V2, V2_BWD, "dbias")}
    with held_attention(tc_held):
        trainer.make_train_step(tc_cfg)(tc_st, tc_batch, seeded(22))
    torch.cuda.synchronize()
    del tc_st, tc_batch
    torch.cuda.empty_cache()
    reset_counts()
    tc_fwd0, tc_bwd0 = dict(wa.FWD_ROUTES), dict(wa.BWD_ROUTES)
    zoo_times["Trans_cross bf16"] = timed_steps(tc_cfg, "Trans_cross bf16 train step (shipped flags)")
    tc_launches = counts()
    tc_fwd = {k: (v - tc_fwd0.get(k, 0)) // (TRAIN_STEPS + 1) for k, v in wa.FWD_ROUTES.items()}
    tc_bwd = {k: (v - tc_bwd0.get(k, 0)) // (TRAIN_STEPS + 1) for k, v in wa.BWD_ROUTES.items()}
    print(f"Trans_cross per train step: forward routes {tc_fwd}, backward routes {tc_bwd}; launches over "
          f"{TRAIN_STEPS + 1} steps {dict((k, v) for k, v in tc_launches.items() if v)}", flush=True)
    check(tc_fwd == {"wgmma": 2 * per_step, "fma": 0} and tc_bwd == {"wgmma": 2 * per_step, "fma": 0},
          f"Trans_cross routes per step {tc_fwd} {tc_bwd}")
    for kname, bar in ((SA, BWD_BAR["bf16"]), (SA_BWD, BWD_BAR["bf16"]), (V2, BWD_BAR["bf16"]),
                       (V2_BWD, BWD_BAR["bf16"]), ("dbias", BWD_BAR["f32"])):
        e = tc_held[kname]
        print(f"Trans_cross bf16 step, {kname} held against its plain version on the step's own tensors: "
              f"{len(e)} calls, worst relative error {max(e):.3e} (bar {bar:g})", flush=True)
        check(len(e) == per_step and max(e) <= bar, f"Trans_cross {kname}: {len(e)} calls, worst {max(e)}")

    # The evaluation CLIs in the shipped config, in-process.
    zoo_dir = Path(tempfile.mkdtemp(prefix="zoo_cli_", dir=REPO / "build"))
    zoo_args = ["--dataset", "synthetic", "--batch_size", "16", "--synthetic_samples", "32", "--end_epochs", "1",
                "--plot_dir", "", "--checkpoint_dir", str(zoo_dir / "ckpt"), "--log_dir", str(zoo_dir / "log")]
    try:
        buf = Tee()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            suite = ensemble_cli.main(zoo_args + ["--name", "de", "--members", "2",
                                                  "--metric_path", str(zoo_dir / "Metric.txt")])
        ens_s = time.perf_counter() - t0
        metric_lines = (zoo_dir / "Metric.txt").read_text().splitlines()
        metric = {line.split(": ")[0]: float(line.split(": ")[1]) for line in metric_lines}
        de_cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(zoo_args + ["--name", "de"]))
        member_dirs = [ensemble_cli.member_checkpoint_dir(de_cfg, m) for m in list(ENSEMBLE_LRS)[:2]]
        ckpt_gb = sum(f.stat().st_size for d_ in member_dirs for f in Path(d_).rglob("*") if f.is_file()) / 2**30
        print(f"cli.ensemble, 2 members, 1 epoch each: {ens_s:.1f} s; Metric.txt {metric}; member checkpoints "
              f"{ckpt_gb:.2f} GiB on disk [{card}]", flush=True)
        keys = ("accuracy", "auc", "aurc", "eaurc", "nll", "brier", "f1", "recall", "kappa", "ece")
        check(all(k in metric and np.isfinite(metric[k]) for k in keys) and len(suite) == 11,
              f"Metric.txt {metric_lines}")

        # The ensemble Predictor over the two members: the softmax of the mean
        # of the members' logits, each member's forward run on its own and the
        # mean and softmax taken in numpy, at f32 1e-5.
        rng = np.random.default_rng(15)
        req = (rng.integers(0, 256, (21, d.fundus_size, d.fundus_size, 3), dtype=np.uint8),
               rng.integers(0, 256, (21, *d.oct_size, 1), dtype=np.uint8))
        ens_cfg = named("Multi_DE1_ResNet")
        ens_pred = Predictor.from_checkpoints(ens_cfg, member_dirs, device=dev)
        got = ens_pred.predict_probs(*req)
        members_ = restore_members(ens_cfg, member_dirs, device=dev)
        with torch.no_grad():
            fu = torch.from_numpy(req[0]).to(dev).float() / 255.0
            ou = torch.from_numpy(req[1]).to(dev).float() / 255.0
            member_logits = [np.concatenate([m(fu[i:i + 7], ou[i:i + 7])[0].cpu().numpy() for i in range(0, 21, 7)])
                             for m in members_]
        mean_logits = np.mean(np.stack(member_logits).astype(np.float64), axis=0)
        want = np.exp(mean_logits - mean_logits.max(-1, keepdims=True))
        want /= want.sum(-1, keepdims=True)
        e_pred = float(np.abs(got - want).max())
        print(f"ensemble Predictor (2 members) on 21 pairs against the members' forwards averaged in numpy: "
              f"max abs err "
              f"{e_pred:.3e} (atol 1e-5)", flush=True)
        check(got.shape == (21, 2) and e_pred <= 1e-5, f"ensemble Predictor {e_pred}")
        del ens_pred, members_
        torch.cuda.empty_cache()
        for d_ in member_dirs:
            shutil.rmtree(d_, ignore_errors=True)

        # cli.train on Multi_dropout_ResNet, then cli.test with MC-dropout and the sweep.
        dr_args = zoo_args + ["--name", "dr", "--model_name", "Multi_dropout_ResNet", "--save_latest_every", "1"]
        buf = Tee()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train_cli.main(dr_args)
            train_s = time.perf_counter() - t0
            ckpt = zoo_dir / "ckpt" / "synthetic_0.5_dr"
            name_ = "best" if (ckpt / "best").is_dir() else "latest"
            test_cli.main(dr_args + ["--checkpoint", str(ckpt / name_), "--mc_samples", "4", "--sweep", "gaussian",
                                     "--sweep_levels", "0.0", "0.3"])
        test_s = time.perf_counter() - t0 - train_s
        printed = buf.getvalue().splitlines()
        test_log = (zoo_dir / "log" / "synthetic_dr_test.log").read_text()
        mc_lines = [line for line in printed if line.startswith("MC-dropout (K=4): ")]
        check(len(mc_lines) == 1, f"MC block {mc_lines}")
        mc_std = float(mc_lines[0].rsplit(" ", 1)[1])
        grid = [line for line in test_log.splitlines() if "\t" in line]
        print(f"cli.train Multi_dropout_ResNet 1 epoch: {train_s:.1f} s; cli.test on {name_} with --mc_samples 4 "
              f"--sweep gaussian: {test_s:.1f} s; {mc_lines[0]}; sweep grid: {grid}", flush=True)
        check(mc_std > 0.0, f"MC-dropout mean predictive std {mc_std}")
        check("Robustness sweep [gaussian]:" in test_log and len(grid) == 1 + 3 * 2
              and all(f"{m}\t{s}\t" in test_log for m in ("both", "fundus-only", "oct-only") for s in ("0", "0.3")),
              f"sweep grid {grid}")
    finally:
        shutil.rmtree(zoo_dir, ignore_errors=True)
    check(not zoo_dir.exists(), "the zoo CLIs' temporary directory is removed")
    for label, (ms, peak) in zoo_times.items():
        print(f"zoo timing, {label}: {ms:.1f} ms a step at batch {bt}, {1000.0 * bt / ms:.1f} pairs/s, peak "
              f"{peak:.2f} GiB [{card}]", flush=True)

    # -- 25. the serving half: int8, the chunk graph, export, cli.predict -------
    serving_half(cfg, card, requests, reset_counts, counts)

    # -- 26. the real-data path: a GAMMA tree, the tools, dr2 and glu2 ---------
    t_real = time.perf_counter()
    real_data_path(cfg, card, reset_counts, counts, check_routes)

    # -- 27. data parallelism on the one card: world 1 over NCCL, world 2 over gloo, the CLIs at world 1
    data_parallel_path(card, reset_counts, counts)

    # -- 28. tensor parallelism on the one card: a (1, 2) mesh over gloo -------
    tensor_parallel_path(card)

    # -- 29. the baseline zoo over a (1, 2) mesh, chunked serving there, scan_batches
    zoo_tensor_parallel_path(card)
    t_end = time.perf_counter()
    print(f"wall s: phases 26-29 {t_end - t_real:.1f} [{card}]", flush=True)

    # -- 30. the ablation study at full width, cut in depth --------------------
    ablation_path(card, reset_counts, counts)
    print(f"wall s: the script {time.perf_counter() - t_start:.1f} (its kernels' builds included) [{card}]",
          flush=True)

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
            "device_route": DEVICE_ROUTE.get(name),
            **{key: t[key] for key in ("device_only_ms", "device_only_plain_ms", "device_only_library_ms")
               if key in t},
        })
    print("kernels: ms / plain_ms / library_ms / bound_ms are the device time of the launches one "
          f"batch-{bt} train step makes (sum over its shapes; B3 runs once each way, with use_pallas_mmd; B4 and B5 "
          f"in the use_fused_ln + use_fused_mlp config, B4's three rows, B3's two and v1's "
          f"(ms, plain_ms and library_ms alike) the device-only time of CUDA graphs of 10 calls, every other row "
          f"runs of 10 calls "
          f"between CUDA events, which count the host where it is slower than the card (B1's and B2's forwards "
          f"and backwards add device_only_ms, device_only_plain_ms and device_only_library_ms, CUDA graphs of 10 "
          f"calls; SDPA's backward a graph of its forward and backward less its forward's); B4's "
          f"residual form, B6's "
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

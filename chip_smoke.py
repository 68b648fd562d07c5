#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU, and check it.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is nonzero):

1. Require CUDA; print the card's name and power limit; turn TF32 off.
2. Build the CUDA kernels from ``edrl_tpu_torch/kernels/csrc`` and print the
   build time and the compiler's register/shared-memory report.
3. Check each kernel against its plain PyTorch version at every main-path
   shape and at odd shapes, in bf16 (atol 3e-2) and f32 (atol 1e-4).
4. Serve three uint8 requests (16, 5 and 40 pairs) with a full-width
   ``Predictor`` (``EDRLConfig()`` defaults, seeded random weights) and
   check the probabilities and that each kernel ran 12 times per batch.
5. Compare the kernel path with the plain path (both fused flags off) on
   the same weights, in bf16 (2e-2) and f32 (1e-4), and a small f32 model on
   the card against the same model on the CPU (1e-4).
6. Time each kernel against its plain version at the main-path shapes, and
   the full-width forward at batch 16 on both paths (CUDA events, median).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TIMING_REPS = 20
KERNEL_SOURCE = {
    "self_attention_fused": "edrl_tpu_torch/kernels/csrc/self_attention_fwd.cu",
    "window_attention_fused_v2": "edrl_tpu_torch/kernels/csrc/window_attention_v2_fwd.cu",
}
KERNEL_REPLACES = {
    "self_attention_fused": "edrl_tpu/kernels/window_attention.py:536",
    "window_attention_fused_v2": "edrl_tpu/kernels/window_attention.py:328",
}
BF16_ATOL, F32_ATOL = 3e-2, 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = TIMING_REPS) -> float:
    """Median per-call device time of ``fn`` over ``reps`` calls after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not (REPO / "edrl_tpu_torch").is_dir() or not (REPO / "edrl_tpu").is_dir():
        raise SystemExit("chip_smoke.py: no edrl_tpu_torch/ beside this script; run it from a checkout")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False; this needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from edrl_tpu.config import EDRLConfig
    from edrl_tpu_torch.kernels import build
    from edrl_tpu_torch.kernels import window_attention as wa
    from edrl_tpu_torch.models.swin2d import rel_bias_from_table, relative_position_index, shift_attn_mask
    from edrl_tpu_torch.serve.predictor import Predictor

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.relative_to(REPO)}", flush=True)
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    # -- 3. kernels against their plain versions ---------------------------
    mc = EDRLConfig().model
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

    # Main-path shapes at eval batch 16, with how often one forward calls each.
    b = EDRLConfig().data.eval_batch_size
    c_vit, h_vit = mc.oct_embed_dim, mc.vit3d_heads
    vit_shape = dict(b=b, n=mc.oct_tokens, c=c_vit, heads=h_vit, calls=mc.vit3d_depth)
    swin_shapes = []
    grid, dim = EDRLConfig().data.fundus_size // 4, mc.swin_embed_dim
    for depth, heads in zip(mc.swin_depths, mc.swin_heads):
        window = min(mc.swin_window, grid)
        swin_shapes.append(dict(b=b, grid=grid, window=window, c=dim, heads=heads,
                                shifted=window < grid, calls=depth))
        grid, dim = grid // 2, dim * 2

    max_err = {wa.SELF_ATTENTION: 0.0, wa.WINDOW_ATTENTION_V2: 0.0}

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

    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = vit_inputs(vit_shape, dtype)
            scale = (c_vit // h_vit) ** -0.5
            compare(wa.SELF_ATTENTION, f"[{b},{mc.oct_tokens},{c_vit}]x{h_vit}", dtype,
                    wa.self_attention_fused(q, k, v, h_vit, scale),
                    wa.self_attention_reference(q, k, v, h_vit, scale))
            for s in swin_shapes:
                qkv, bias = swin_inputs(s, dtype)
                scale = (s["c"] // s["heads"]) ** -0.5
                compare(wa.WINDOW_ATTENTION_V2,
                        f"{list(qkv.shape)} H={s['heads']} shifted={s['shifted']}", dtype,
                        wa.window_attention_fused_v2(qkv, bias, s["heads"], scale),
                        wa.window_attention_v2_reference(qkv, bias, s["heads"], scale))
            # Odd shapes: N=16 with head_dim 16 (the bf16 tensor-core kernel),
            # head_dim 8 and N=240 (the CUDA-core kernel in bf16 as well).
            for shape, heads in (((3, 16, 32), 2), ((2, 40, 16), 2), ((2, 240, 128), 1)):
                q, k, v = (normal(shape, dtype) for _ in range(3))
                compare(wa.SELF_ATTENTION, f"{list(shape)}x{heads} (odd)", dtype,
                        wa.self_attention_fused(q, k, v, heads, 0.25),
                        wa.self_attention_reference(q, k, v, heads, 0.25))
            for shape, heads in (((3, 2, 16, 96), 2), ((2, 1, 240, 48), 2)):
                qkv = normal(shape, dtype)
                bias = torch.randn((shape[1], heads, shape[2], shape[2]), generator=gen, device=dev)
                compare(wa.WINDOW_ATTENTION_V2, f"{list(shape)} H={heads} (odd)", dtype,
                        wa.window_attention_fused_v2(qkv, bias, heads, 0.25),
                        wa.window_attention_v2_reference(qkv, bias, heads, 0.25))
    torch.cuda.synchronize()

    # -- 4. the serving path at full width ---------------------------------
    cfg = EDRLConfig()
    check(cfg.model.use_bfloat16 and cfg.model.use_fused_attention and cfg.model.vit_fused_attention,
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
    wa.reset_launch_counts()
    outputs = [pred.predict_probs(f, o) for f, o in requests]
    launches = dict(wa.LAUNCHES)
    batches = sum(-(-len(f) // cfg.data.eval_batch_size) for f, _ in requests)
    for (f, _), p in zip(requests, outputs):
        check(p.shape == (len(f), cfg.model.num_classes), f"probs shape {p.shape}")
        check(bool(np.isfinite(p).all()), "probs finite")
        check(bool(np.allclose(p.sum(-1), 1.0, atol=1e-5)), "probs rows sum to 1")
        print(f"request {len(f)} pairs -> probs {p.shape}, first row {p[0].tolist()}", flush=True)
    expected = 12 * batches
    print(f"launches over {batches} batches: {launches} (expected {expected} each)", flush=True)
    for name, count in launches.items():
        check(count == expected, f"{name} launched {count} times, expected {expected}")

    # -- 5. kernel path against the plain path -----------------------------
    def plain_cfg(c):
        return c.replace(model=dataclasses.replace(
            c.model, use_fused_attention=False, vit_fused_attention=False))

    f16, o16 = requests[0]
    max_dprobs = {}
    for label, bf16 in (("bf16", True), ("f32", False)):
        kcfg = cfg.replace(model=dataclasses.replace(cfg.model, use_bfloat16=bf16))
        kpred = pred if bf16 else Predictor(kcfg, device=dev, seed=0)
        ppred = Predictor(plain_cfg(kcfg), device=dev, seed=0)
        ppred.model.load_state_dict(kpred.model.state_dict())
        delta = float(np.abs(kpred.predict_probs(f16, o16) - ppred.predict_probs(f16, o16)).max())
        limit = 2e-2 if bf16 else 1e-4
        print(f"full width {label}: max |dprobs| kernel vs plain path {delta:.3e} (limit {limit:g})", flush=True)
        check(delta <= limit, f"{label} kernel path vs plain path: {delta}")
        max_dprobs[label] = delta
        if bf16:
            plain_pred = ppred
        else:
            del kpred, ppred

    # The port on the card against the same port on the CPU, small f32 model.
    from edrl_tpu.config import tiny_test_config

    tcfg = tiny_test_config(batch_size=4)
    # vit3d_heads 2: the kernels take head_dim % 8 == 0 (48 / 2 = 24).
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

    # -- 6. timings ---------------------------------------------------------
    kernel_ms = {wa.SELF_ATTENTION: 0.0, wa.WINDOW_ATTENTION_V2: 0.0}
    plain_ms = dict(kernel_ms)
    with torch.inference_mode():
        q, k, v = vit_inputs(vit_shape, torch.bfloat16)
        scale = (c_vit // h_vit) ** -0.5
        tk = time_ms(torch, lambda: wa.self_attention_fused(q, k, v, h_vit, scale))
        tp = time_ms(torch, lambda: wa.self_attention_reference(q, k, v, h_vit, scale))
        print(f"time {wa.SELF_ATTENTION} [{b},{mc.oct_tokens},{c_vit}]x{h_vit} bf16: kernel {tk:.4f} ms, "
              f"plain {tp:.4f} ms per call, x{vit_shape['calls']} per forward [{card}]", flush=True)
        kernel_ms[wa.SELF_ATTENTION] += vit_shape["calls"] * tk
        plain_ms[wa.SELF_ATTENTION] += vit_shape["calls"] * tp
        for s in swin_shapes:
            qkv, bias = swin_inputs(s, torch.bfloat16)
            scale = (s["c"] // s["heads"]) ** -0.5
            tk = time_ms(torch, lambda: wa.window_attention_fused_v2(qkv, bias, s["heads"], scale))
            tp = time_ms(torch, lambda: wa.window_attention_v2_reference(qkv, bias, s["heads"], scale))
            print(f"time {wa.WINDOW_ATTENTION_V2} {list(qkv.shape)} H={s['heads']} bf16: kernel {tk:.4f} ms, "
                  f"plain {tp:.4f} ms per call, x{s['calls']} per forward [{card}]", flush=True)
            kernel_ms[wa.WINDOW_ATTENTION_V2] += s["calls"] * tk
            plain_ms[wa.WINDOW_ATTENTION_V2] += s["calls"] * tp

        f_dev = pred._to_device(f16)
        o_dev = pred._to_device(o16)
        fwd = {}
        for label, p in (("plain", plain_pred), ("kernel", pred), ("kernel", pred), ("plain", plain_pred)):
            fwd.setdefault(label, []).append(time_ms(torch, lambda: p._forward(f_dev, o_dev), reps=10))
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

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE[name],
            "replaces": KERNEL_REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": kernel_ms[name],
            "plain_ms": plain_ms[name],
        }
        for name in (wa.SELF_ATTENTION, wa.WINDOW_ATTENTION_V2)
    ]
    print("kernel ms / plain_ms: device time of the launches one batch-16 forward makes "
          "(sum over the main-path shapes); max_abs_err: worst bf16 main-path check")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

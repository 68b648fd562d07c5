"""v1's (``window_attention_fused``) and B3's (``mk_mmd_fused``) device time
per call at the shapes of a batch-32 train step.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m edrl_tpu_torch.tools.profile_v1_mmd

On seeded random inputs:

- v1, one forward and backward (``torch.autograd.grad``) in bf16 at each
  Swin stage of a batch-32 step (``[B, W, H, N, D]`` with q pre-scaled and a
  bias with masked keys), beside SDPA's forward and backward on the same
  tensors (the bias as a mask in bf16, q's dtype);
- B3, the MK-MMD of two ``[32, 3072]`` f32 feature batches: the forward,
  and the forward with its backward (``torch.autograd.grad``; the backward's
  row is their difference); beside them one empty kernel's launch, where the
  tree's library has one (the floor a one-launch call can reach), and, on a
  tree with the one-launch forward, its host enqueue split into its parts
  (:func:`mmd_enqueue_split`).

For each it prints ``graph`` (device ms per call: CUDA events around the
replay of a CUDA graph of ``CALLS`` calls, the host's enqueue not counted),
``runs`` (ms over runs of ``CALLS`` eager calls, which counts the host where
its enqueue is longer than the call), ``enqueue`` (the host's ms per call)
and the device kernels one call launches, by name, with their device ms
(``torch.profiler``).  The timers are ``tools/timing.py``'s.  It calls only
the public wrappers, so copying it and ``tools/timing.py`` into an older
tree of the port measures that tree the same way.
"""

from __future__ import annotations

import collections
import subprocess

import torch
import torch.nn.functional as F

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.kernels import build
from edrl_tpu_torch.kernels import mmd as kmmd
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.tools.timing import CALLS, enqueue_ms, graph_ms, runs_ms

BATCH = 32


def v1_shapes(cfg: EDRLConfig, batch: int = BATCH) -> list:
    """``(B, W, H, N, D)`` of v1 at each Swin stage of ``cfg`` at ``batch``."""
    m, shapes = cfg.model, []
    grid, dim = cfg.data.fundus_size // 4, m.swin_embed_dim
    for heads in m.swin_heads:
        window = min(m.swin_window, grid)
        shapes.append((batch, (grid // window) ** 2, heads, window * window, dim // heads))
        grid, dim = grid // 2, dim * 2
    return shapes


def mmd_shape(cfg: EDRLConfig, batch: int = BATCH) -> tuple:
    """``(n, d)`` of each of B3's two feature batches in a train step."""
    return batch, 3 * cfg.model.fundus_embed_dim


def kernels_of(fn, calls: int = CALLS, attempts: int = 3) -> dict:
    """``{kernel name: (launches, device ms)}`` per call of ``fn``: two
    warm-up calls, then ``calls`` calls under ``torch.profiler`` (taken again,
    up to ``attempts`` profiles, where one recorded no device time)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        if events:
            break
    else:
        raise SystemExit("profile_v1_mmd: the profiler recorded no device time")
    launches, us = collections.Counter(), collections.defaultdict(float)
    for e in events:
        launches[e.name] += 1
        us[e.name] += e.time_range.elapsed_us()
    return {name: (launches[name] / calls, us[name] / (1000.0 * calls)) for name in launches}


def timings(fn) -> dict:
    """``graph``, ``runs`` and ``enqueue`` ms per call of ``fn`` (``graph``
    nan, with the reason printed, where the call cannot be captured)."""
    try:
        graph = graph_ms(fn)
    except RuntimeError as e:
        print(f"profile_v1_mmd: no CUDA graph of the call: {e}", flush=True)
        graph = float("nan")
    return {"graph": graph, "runs": runs_ms(fn), "enqueue": enqueue_ms(fn)}


def v1_inputs(shape, gen: torch.Generator):
    """bf16 q (pre-scaled by 1/sqrt(D)), k, v and do of ``shape``, and an f32
    bias ``[W, H, N, N]`` with every third key masked at -1e9."""
    b, w, h, n, d = shape
    dev = gen.device
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    bias = torch.randn((w, h, n, n), generator=gen, device=dev)
    bias[..., 1::3] = -1e9
    return q * d ** -0.5, k, v, bias, do


def v1_step(q, k, v, bias, do):
    """One forward and backward of v1: ``(dq, dk, dv, dbias)``."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    return torch.autograd.grad(wa.window_attention_fused(*leaves), leaves, do)


def sdpa_step(q, k, v, bias, do):
    """SDPA's forward and backward on v1's tensors, the bias a mask in q's dtype."""
    b, w, h, n, d = q.shape
    mask = bias.to(q.dtype)[None].expand(b, w, h, n, n).reshape(b * w, h, n, n)
    leaves = [t.reshape(b * w, h, n, d).detach().requires_grad_() for t in (q, k, v)] + [
        mask.detach().requires_grad_()]
    out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
    return torch.autograd.grad(out, leaves, do.reshape(b * w, h, n, d))


def _show(label: str, t: dict, kernels: dict = None) -> str:
    line = f"{label}: graph {t['graph']:.4f}, runs {t['runs']:.4f}, enqueue {t['enqueue']:.4f} ms"
    if kernels is not None:
        line += "; kernels per call: " + ", ".join(
            f"{name[:60]} x{n:g} {ms:.4f} ms" for name, (n, ms) in sorted(kernels.items(), key=lambda x: -x[1][1]))
    return line


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_v1_mmd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = EDRLConfig()
    print(f"v1 (bf16) and B3 (f32) ms per call, batch {BATCH} train step's shapes [{card}]", flush=True)
    step = collections.defaultdict(float)
    for shape in v1_shapes(cfg):
        args = v1_inputs(shape, gen)
        tk, kk = timings(lambda: v1_step(*args)), kernels_of(lambda: v1_step(*args))
        tl = timings(lambda: sdpa_step(*args))
        print(_show(f"v1 fwd + bwd {list(shape)}", tk, kk), flush=True)
        print(_show(f"  SDPA fwd + bwd {list(shape)}", tl), flush=True)
        for key, ms in tk.items():
            step[f"v1 {key}"] += ms
        for key, ms in tl.items():
            step[f"SDPA {key}"] += ms
        step["v1 launches"] += sum(n for n, _ in kk.values())
        del args
        torch.cuda.empty_cache()
    print("v1 per batch-32 step (one forward and backward per Swin stage), ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in step.items()) + f" [{card}]", flush=True)

    n, d = mmd_shape(cfg)
    src = torch.randn((n, d), generator=gen, device="cuda")
    tgt = torch.randn((n, d), generator=gen, device="cuda") * 1.1 + 0.05
    with torch.no_grad():
        fwd = lambda: kmmd.mk_mmd_fused(src, tgt)  # noqa: E731
        tf, kf = timings(fwd), kernels_of(fwd)
    print(_show(f"B3 forward [{n},{d}]+[{n},{d}]", tf, kf), flush=True)
    leaves = [t.detach().requires_grad_() for t in (src, tgt)]
    both = lambda: torch.autograd.grad(kmmd.mk_mmd_fused(*leaves), leaves)  # noqa: E731
    tb, kb = timings(both), kernels_of(both)
    print(_show(f"B3 forward + backward [{n},{d}]+[{n},{d}]", tb, kb), flush=True)
    launches = sum(c for c, _ in kb.values()) - sum(c for c, _ in kf.values())
    print("B3 backward (forward + backward less forward): " + ", ".join(f"{k} {tb[k] - tf[k]:.4f}" for k in tb)
          + f" ms; {launches:g} device launches [{card}]", flush=True)
    lib = build.load_library()
    empty = getattr(lib, "edrl_empty_launch", None)
    if empty is not None:
        launch = lambda: empty(torch._C._cuda_getCurrentRawStream(0))  # noqa: E731
        print(_show("one empty kernel's launch", timings(launch)) + f" [{card}]", flush=True)
    if hasattr(kmmd, "mk_mmd_fwd_kernel"):  # the one-launch forward, on trees that have it
        print("B3 forward, host enqueue by part, ms per call: " + ", ".join(
            f"{k} {v:.4f}" for k, v in mmd_enqueue_split(src, tgt).items()) + f" [{card}]", flush=True)


def mmd_enqueue_split(src, tgt, calls: int = 200) -> dict:
    """The host's ms per call of B3's forward wrapper (``mk_mmd_fwd_kernel``)
    and of its parts, each alone in a loop of ``calls``: the Python checks
    of the features, the two ``torch.empty`` (state and value), the entry
    point called through ctypes (argument conversion and the driver's
    launch), the same through ``build.launch`` (stream, device, count), and
    one empty kernel's launch through ctypes, the floor."""
    lib = build.load_library()
    n_s, d = src.shape
    n = n_s + tgt.shape[0]
    state = torch.empty(n * n + 2, device=src.device)
    out = torch.empty((), device=src.device)
    counts = {kmmd.MK_MMD: 0}
    args = lambda: (src.data_ptr(), tgt.data_ptr(), n_s, n - n_s, d, 2.0, 5, None,  # noqa: E731
                    out.data_ptr(), state.data_ptr())
    parts = {
        "wrapper": lambda: kmmd.mk_mmd_fwd_kernel(src, tgt),
        "checks": lambda: kmmd._features(kmmd.MK_MMD, src, tgt),
        "two torch.empty": lambda: (torch.empty(n * n + 2, device=src.device), torch.empty((), device=src.device)),
        "entry point via ctypes": lambda: lib.edrl_mk_mmd_fwd(*args(), torch._C._cuda_getCurrentRawStream(0)),
        "entry point via build.launch": lambda: build.launch(counts, kmmd.MK_MMD, lib.edrl_mk_mmd_fwd,
                                                             src.device, *args()),
        "empty kernel via ctypes": lambda: lib.edrl_empty_launch(torch._C._cuda_getCurrentRawStream(0)),
    }
    return {name: enqueue_ms(fn, calls) for name, fn in parts.items()}


if __name__ == "__main__":
    main()

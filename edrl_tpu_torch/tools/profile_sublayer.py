"""Where the fused attention sublayer's (B6) time goes on the card, phase by phase.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m edrl_tpu_torch.tools.profile_sublayer

For each B6 shape of a batch-32 bf16 train step of the
``use_fused_block_attention`` configuration (the Swin stages' blocks with a
one-window bias, Wb = 1, and with a per-window one, Wb = W; the ViT's blocks,
W = 1), on seeded random inputs, it runs ``CALLS`` forward calls
(``attention_sublayer_fwd_kernel``) and then ``CALLS`` backward calls
(``attention_sublayer_bwd_kernel``) under ``torch.profiler`` and prints the
device time per call of each phase, from the names of the kernels that ran:

- forward: LayerNorm, weight transposes, the qkv product, the attention, the
  proj product (with the bias and the residual);
- backward: B2's forward (o recomputed) and backward, the products that give
  do and dxln, the weight gradients, the bias gradients, B4's LayerNorm
  backward (its row kernel and its sums of dgamma/dbeta partials), the bias
  gradients' sums of partials, cuBLAS products, and PyTorch's copies, casts,
  reductions and elementwise kernels;

then the same summed over a train step (two forwards and their backwards).
TF32 is off, as in ``chip_smoke.py``.  It calls only the module's public
kernel wrappers, so it measures any tree of the port that has them.
"""

from __future__ import annotations

import collections
import subprocess

import torch

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.kernels import block_attention as ba

CALLS = 10
BATCH = 32
# (phase, substrings of a kernel name); the first match wins.
FWD_PHASES = (
    ("LayerNorm", ("layer_norm_fwd",)),
    ("weight transposes", ("transpose_bf16",)),
    ("qkv product", ("QkvEpilogue", "BiasEpilogue")),
    ("attention", ("attention_fwd",)),
    ("proj product", ("ResidualEpilogue",)),
)
BWD_PHASES = (
    ("B2 forward (o recomputed)", ("attention_fwd",)),
    ("B2 backward", ("attention_bwd",)),
    ("do and dxln products", ("StoreEpilogue", "StoreF32Epilogue")),
    ("weight gradients", ("WgradEpilogue", "column_sum4_kernel")),
    ("bias gradients", ("col_partials_kernel",)),
    ("LayerNorm backward (B4)", ("layer_norm_bwd",)),
    ("sums of partials", ("column_sum_kernel",)),
    ("cuBLAS products", ("gemm", "xmma", "nvjet", "cutlass", "sm90_", "sm80_", "cublas", "Kernel2")),
    ("copies and casts", ("copy", "Copy")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
)


def _phase(name: str, phases) -> str:
    for label, keys in phases:
        if any(k in name for k in keys):
            return label
    return "other"


def phase_ms(fn, phases, calls: int = CALLS, attempts: int = 3) -> dict:
    """Device ms per call of ``fn`` by phase (and ``"total"``): two warm-up
    calls, then ``calls`` calls under ``torch.profiler``.  A profile that
    recorded no device time (now and then one of many in a process does) is
    taken again, up to ``attempts`` profiles in all."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(attempts):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
        if kernels:
            break
        print(f"profile_sublayer: profile {attempt + 1} of {attempts} recorded no device time", flush=True)
    else:
        raise SystemExit("profile_sublayer: the profiler recorded no device time")
    out = collections.defaultdict(float)
    for e in kernels:
        out[_phase(e.name, phases)] += e.time_range.elapsed_us() / (1000.0 * calls)
    out["total"] = sum(out.values())
    return dict(out)


def train_shapes(cfg: EDRLConfig, batch: int = BATCH) -> list:
    """The B6 calls of one forward at ``batch``: per Swin stage its unshifted
    blocks (Wb = 1) and its shifted ones (Wb = W), then the ViT's blocks;
    each a dict of b, w, n, c, heads, wb, calls (per forward), the stage's
    token grid and window (None for the ViT) and vit."""
    m = cfg.model
    out = []
    grid, dim = cfg.data.fundus_size // 4, m.swin_embed_dim
    for depth, heads in zip(m.swin_depths, m.swin_heads):
        window = min(m.swin_window, grid)
        w = (grid // window) ** 2
        shifted = depth // 2 if window < grid else 0
        for wb, calls in ((1, depth - shifted), (w, shifted)):
            if calls:
                out.append(dict(b=batch, w=w, n=window * window, c=dim, heads=heads, wb=wb, calls=calls,
                                grid=grid, window=window, vit=False))
        grid, dim = grid // 2, dim * 2
    out.append(dict(b=batch, w=1, n=m.oct_tokens, c=m.oct_embed_dim, heads=m.vit3d_heads, wb=1, calls=m.vit3d_depth,
                    grid=None, window=None, vit=True))
    return out


def sublayer_inputs(s: dict, dtype, gen: torch.Generator, bias: torch.Tensor | None = None):
    """Seeded inputs of one call, on the card: ``(x, gamma, beta, wqkv, bqkv,
    wproj, bproj, bias)`` and the softmax scale; the bias, when not given,
    0.02 times a normal draw."""
    dev = gen.device
    b, w, n, c, h = s["b"], s["w"], s["n"], s["c"], s["heads"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if bias is None:
        bias = 0.02 * randn(s["wb"], h, n, n)
    args = (randn(b, w, n, c).to(dtype), 1 + 0.1 * randn(c), 0.1 * randn(c), (randn(c, 3 * c) / c ** 0.5).to(dtype),
            0.1 * randn(3 * c), (randn(c, c) / c ** 0.5).to(dtype), 0.1 * randn(c), bias)
    return args, (c // h) ** -0.5


def label(s: dict) -> str:
    return f"[{s['b']},{s['w']},{s['n']},{s['c']}] H={s['heads']} Wb={s['wb']}"


def _line(ms: dict, phases) -> str:
    names = [p for p, _ in phases if ms.get(p)] + [p for p in ms if p == "other"]
    return ", ".join(f"{p} {ms[p]:.4f}" for p in names)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_sublayer: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = {"forward": collections.defaultdict(float), "backward": collections.defaultdict(float)}
    print(f"B6 phases, device ms per call, bf16, batch {BATCH} [{card}]")
    for s in train_shapes(EDRLConfig()):
        args, scale = sublayer_inputs(s, torch.bfloat16, gen)
        h = s["heads"]
        with torch.no_grad():
            fwd = phase_ms(lambda: ba.attention_sublayer_fwd_kernel(*args, h, scale), FWD_PHASES)
            y, qkv, xln = ba.attention_sublayer_fwd_kernel(*args, h, scale)
            dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
            x, gamma, _, wqkv, _, wproj, _, bias = args
            bwd = phase_ms(lambda: ba.attention_sublayer_bwd_kernel(x, xln, qkv, gamma, wqkv, wproj, bias, dy, h,
                                                                    scale), BWD_PHASES)
        per_step = 2 * s["calls"]
        print(f"{label(s)}, x{per_step} per step")
        print(f"  forward {fwd['total']:.4f}: {_line(fwd, FWD_PHASES)}")
        print(f"  backward {bwd['total']:.4f}: {_line(bwd, BWD_PHASES)}", flush=True)
        for kind, ms in (("forward", fwd), ("backward", bwd)):
            for p, t in ms.items():
                step[kind][p] += per_step * t
        del args, y, qkv, xln, dy
        torch.cuda.empty_cache()
    for kind, phases in (("forward", FWD_PHASES), ("backward", BWD_PHASES)):
        print(f"per batch-{BATCH} train step, {kind} {step[kind]['total']:.3f} ms: {_line(step[kind], phases)} "
              f"[{card}]")


if __name__ == "__main__":
    main()

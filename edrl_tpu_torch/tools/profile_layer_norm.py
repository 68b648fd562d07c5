"""B4's (fused LayerNorm) device time per call at each shape of a train step.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m edrl_tpu_torch.tools.profile_layer_norm

For each B4 shape of a batch-32 bf16 train step, on seeded random inputs:
the forward and the backward of the ``use_fused_ln`` configuration (every
backbone LayerNorm), and the backward's residual form (B6's LayerNorm
backward in the ``use_fused_block_attention`` configuration: an f32
cotangent and a bf16 residual).  Per call it prints

- ``graph``: device ms, CUDA events around the replay of a CUDA graph of
  ``CALLS`` calls, so the host's enqueue is not counted;
- ``runs``: ms over runs of ``CALLS`` eager calls between CUDA events,
  which counts the host wherever its enqueue is longer than the call;
- ``enqueue``: the host's ms per call to enqueue it;
- device ms by kernel from ``torch.profiler`` (the backward's row kernel
  and its sums of dgamma/dbeta partials);
- the bound (bytes over 3.35 TB/s) and, where the tree has
  ``layer_norm_plan``, the plan and the partials' bytes against the call's;

then the sums over a step.  The timers are ``tools/timing.py``'s.  It calls
only the public kernel wrappers, so copying it and ``tools/timing.py`` into
an older tree of the port measures that tree the same way.
"""

from __future__ import annotations

import collections
import subprocess

import torch

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.kernels import layer_norm as ln
from edrl_tpu_torch.tools import profile_sublayer as psl
from edrl_tpu_torch.tools.timing import CALLS, enqueue_ms, graph_ms, runs_ms

BATCH = 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# (part, substrings of a kernel name); the first match wins.
FWD_PARTS = (("forward", ("layer_norm_fwd",)),)
BWD_PARTS = (("row kernel", ("layer_norm_bwd_kernel",)),
             ("column sums", ("layer_norm_bwd_sums", "column_sum")))


def ln_shapes(cfg: EDRLConfig, batch: int = BATCH) -> collections.Counter:
    """B4 calls ``{(M, C): n}`` of one forward of the ``use_fused_ln``
    configuration at ``batch``, site by site as the backbones make them."""
    m, calls = cfg.model, collections.Counter()
    grid, dim = cfg.data.fundus_size // 4, m.swin_embed_dim
    calls[(batch * grid * grid, dim)] += 1  # after the patch embedding
    for stage, depth in enumerate(m.swin_depths):
        calls[(batch * grid * grid, dim)] += 2 * depth
        if stage != len(m.swin_depths) - 1:
            grid //= 2
            calls[(batch * grid * grid, 4 * dim)] += 1  # the patch merge
            dim *= 2
    calls[(batch * grid * grid, dim)] += 1  # final_norm
    calls[(batch * m.oct_tokens, m.oct_embed_dim)] += 2 * m.vit3d_depth + 1
    return calls


def residual_shapes(cfg: EDRLConfig, batch: int = BATCH) -> collections.Counter:
    """Residual-form calls ``{(M, C): n}`` of one backward of the
    ``use_fused_block_attention`` configuration: one per B6 sublayer."""
    calls = collections.Counter()
    for s in psl.train_shapes(cfg, batch):
        calls[(s["b"] * s["w"] * s["n"], s["c"])] += s["calls"]
    return calls


def call_bytes(m: int, c: int, kind: str, elem: int = 2) -> int:
    """Bytes one call must move: each input read once, each output written
    once.  Forward x, y; backward x, dy, dx and dgamma, dbeta; residual form
    x, dy (f32), res, dx and dgamma, dbeta; gamma (and beta) read once."""
    if kind == "forward":
        return 2 * m * c * elem + 2 * c * 4
    if kind == "backward":
        return 3 * m * c * elem + 3 * c * 4
    return m * c * (3 * elem + 4) + 3 * c * 4


def inputs(m: int, c: int, gen: torch.Generator, residual: bool = False):
    """Seeded bf16 inputs of one call on the card: ``(x, gamma, beta, dy,
    res)``; dy is f32 in the residual form, res None outside it."""
    dev = gen.device
    x = (torch.randn((m, c), generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn((c,), generator=gen, device=dev)
    beta = 0.1 * torch.randn((c,), generator=gen, device=dev)
    dy = torch.randn((m, c), generator=gen, device=dev)
    if residual:
        return x, gamma, beta, dy, torch.randn((m, c), generator=gen, device=dev).to(torch.bfloat16)
    return x, gamma, beta, dy.to(torch.bfloat16), None


def measure(kind: str, m: int, c: int, gen: torch.Generator) -> dict:
    """One shape's numbers (see the module's docstring); ``kind`` is
    ``"forward"``, ``"backward"`` or ``"residual"``."""
    x, gamma, beta, dy, res = inputs(m, c, gen, kind == "residual")
    fn = {"forward": lambda: ln.layer_norm_fwd_kernel(x, gamma, beta),
          "backward": lambda: ln.layer_norm_bwd_kernel(x, dy, gamma),
          "residual": lambda: ln.layer_norm_bwd_residual_kernel(x, dy, gamma, res)}[kind]
    with torch.no_grad():
        out = {"graph": graph_ms(fn), "runs": runs_ms(fn), "enqueue": enqueue_ms(fn),
               "parts": psl.phase_ms(fn, FWD_PARTS if kind == "forward" else BWD_PARTS, CALLS)}
    nbytes = call_bytes(m, c, kind)
    out["bound"] = 1000.0 * nbytes / HBM_BYTES_PER_S
    plan = getattr(ln, "layer_norm_plan", None)
    if plan is not None:
        p = plan(m, c, torch.bfloat16, torch.cuda.get_device_properties(0).multi_processor_count, kind)
        out["plan"] = p
        out["partial_share"] = ln.partial_bytes(p, c) / nbytes
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_layer_norm: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = EDRLConfig()
    cases = [("forward", ln_shapes(cfg)), ("backward", ln_shapes(cfg)), ("residual", residual_shapes(cfg))]
    print(f"B4 device ms per call, bf16, batch {BATCH} train step [{card}]")
    for kind, shapes in cases:
        step = collections.defaultdict(float)
        for (m, c), n in sorted(shapes.items()):
            per_step = 2 * n  # two forwards per step, each with its backward
            r = measure(kind, m, c, gen)
            parts = ", ".join(f"{p} {t:.4f}" for p, t in r["parts"].items() if p != "total")
            plan = "" if "plan" not in r else (f"; plan {r['plan']}, partials "
                                                 f"{100 * r['partial_share']:.2f}% of the bytes")
            print(f"{kind} [{m},{c}] x{per_step}: graph {r['graph']:.4f}, runs {r['runs']:.4f}, enqueue "
                  f"{r['enqueue']:.4f}, bound {r['bound']:.4f} ms; profiler {parts}{plan}", flush=True)
            for key in ("graph", "runs", "enqueue", "bound"):
                step[key] += per_step * r[key]
            for p, t in r["parts"].items():
                step[p] += per_step * t
            torch.cuda.empty_cache()
        print(f"{kind} per batch-{BATCH} step, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in step.items())
              + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()

"""B1's and B2's forward (``self_attention_fused``, ``window_attention_fused_v2``)
per call at the shapes of a batch-32 train step, beside SDPA's.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m edrl_tpu_torch.tools.profile_attention_fwd

On seeded random bf16 inputs: B1 at the ViT-3D's ``[B, N, C]`` with its
heads, B2 at each Swin stage's packed qkv ``[B, W, N, 3C]`` with an f32
bias ``[W, H, N, N]``, and SDPA on the same tensors (the bias as a bf16
mask).  For each it prints ``graph`` (device ms per call: CUDA events around
the replay of a CUDA graph of ``CALLS`` calls), ``runs`` (ms over runs of
``CALLS`` eager calls, which counts the host where its enqueue is longer
than the call) and ``enqueue`` (the host's ms per call), then each one's ms
a train step (calls a step times ms a call).  The timers are
``tools/timing.py``'s.  It calls only the public wrappers, so copying it
and ``tools/timing.py`` into an older tree of the port measures that tree
the same way (run parent, change, change, parent in one call).
"""

from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

from edrl_tpu_torch.config import EDRLConfig
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.tools.timing import enqueue_ms, graph_ms, runs_ms

BATCH = 32


def shapes(cfg: EDRLConfig, batch: int = BATCH) -> list:
    """``(name, shape, heads, calls a train step)``: B1's ``(B, N, C)`` and
    B2's ``(B, W, N, C)`` at each Swin stage (two forwards a step)."""
    m = cfg.model
    out = [("B1", (batch, m.oct_tokens, m.oct_embed_dim), m.vit3d_heads, 2 * m.vit3d_depth)]
    grid, dim = cfg.data.fundus_size // 4, m.swin_embed_dim
    for depth, heads in zip(m.swin_depths, m.swin_heads):
        window = min(m.swin_window, grid)
        out.append(("B2", (batch, (grid // window) ** 2, window * window, dim), heads, 2 * depth))
        grid, dim = grid // 2, dim * 2
    return out


def calls(name: str, shape: tuple, heads: int, gen: torch.Generator) -> dict:
    """``{"kernel": fn, "SDPA": fn}`` on one set of seeded inputs."""
    dev = gen.device
    if name == "B1":
        b, n, c = shape
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        hd = c // heads
        split = lambda x: x.view(b, n, heads, hd).transpose(1, 2)  # noqa: E731
        return {"kernel": lambda: wa.self_attention_fused(q, k, v, heads, hd ** -0.5),
                "SDPA": lambda: F.scaled_dot_product_attention(split(q), split(k), split(v), scale=hd ** -0.5)}
    b, w, n, c = shape
    hd = c // heads
    qkv = torch.randn((b, w, n, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn((w, heads, n, n), generator=gen, device=dev)
    bias[..., 1::3] = -1e9
    x = qkv.view(b * w, n, 3, heads, hd)
    q4, k4, v4 = (x[:, :, i].transpose(1, 2) for i in range(3))
    mask = bias.to(torch.bfloat16)[None].expand(b, w, heads, n, n).reshape(b * w, heads, n, n)
    return {"kernel": lambda: wa.window_attention_fused_v2(qkv, bias, heads, hd ** -0.5),
            "SDPA": lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=hd ** -0.5)}


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(18)
    step = {}
    with torch.no_grad():
        for name, shape, heads, per_step in shapes(EDRLConfig()):
            for who, fn in calls(name, shape, heads, gen).items():
                t = {"graph": graph_ms(fn), "runs": runs_ms(fn), "enqueue": enqueue_ms(fn)}
                print(f"{name} {list(shape)} H={heads} {who}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                      + f" ms a call, x{per_step} a step [{card}]", flush=True)
                for kind in ("graph", "runs"):
                    key = f"{name} {who} {kind}"
                    step[key] = step.get(key, 0.0) + per_step * t[kind]
    print("ms a batch-32 train step: " + ", ".join(f"{k} {v:.3f}" for k, v in step.items()) + f" [{card}]",
          flush=True)


if __name__ == "__main__":
    main()

"""B1's and B2's forward (``self_attention_fused``, ``window_attention_fused_v2``)
and backward (``self_attention_bwd_kernel``, ``window_attention_v2_bwd_kernel``)
per call at the shapes of a batch-32 train step, beside SDPA's.

Run from the root of a checkout, on a machine with one CUDA card:

    python -m edrl_tpu_torch.tools.profile_attention_fwd

On seeded random bf16 inputs: B1 at the ViT-3D's ``[B, N, C]`` with its
heads, B2 at each Swin stage's packed qkv ``[B, W, N, 3C]`` with an f32
bias ``[W, H, N, N]``, and SDPA on the same tensors (the bias as a bf16
mask), forward, then backward with a seeded bf16 cotangent (SDPA's through
autograd on one saved forward, with the mask's gradient as B2's dbias).  For
each it prints ``graph`` (device ms per call: CUDA events around the replay
of a CUDA graph of ``CALLS`` calls; SDPA's backward: its forward and
backward captured together, less its forward), ``runs`` (ms over runs of
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


def sdpa_backward(q4, k4, v4, do4, mask=None, scale=None) -> dict:
    """SDPA's backward on ``[G, H, N, D]`` bf16 tensors (and a bf16 mask,
    whose gradient it computes as B2's dbias): ``{"runs": fn, "graph": fn,
    "less": fn}``, ``runs`` the backward alone on one saved forward (for runs
    and the enqueue), ``graph`` the forward and backward and ``less`` the
    forward, on leaves of their own (captured: autograd's backward runs on
    its forward's stream, so a graph holds the backward only with its
    forward, and a leaf whose graph another forward keeps alive would tie
    the capture to that forward's stream)."""
    def leaves():
        return [t.detach().requires_grad_() for t in (q4, k4, v4)] + (
            [] if mask is None else [mask.detach().requires_grad_()])

    def forward(ls):
        return F.scaled_dot_product_attention(*ls[:3], attn_mask=None if mask is None else ls[3], scale=scale)

    saved, captured = leaves(), leaves()
    out = forward(saved)
    return {"runs": lambda: torch.autograd.grad(out, saved, do4, retain_graph=True),
            "graph": lambda: torch.autograd.grad(forward(captured), captured, do4),
            "less": lambda: forward(captured)}


def bwd_calls(name: str, shape: tuple, heads: int, gen: torch.Generator) -> dict:
    """``{"kernel": fn, "SDPA": sdpa_backward(...)}`` of the backward on one
    set of seeded inputs and cotangent."""
    dev = gen.device
    if name == "B1":
        b, n, c = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
        hd = c // heads
        split = lambda x: x.view(b, n, heads, hd).transpose(1, 2)  # noqa: E731
        return {"kernel": lambda: wa.self_attention_bwd_kernel(q, k, v, do, heads, hd ** -0.5),
                "SDPA": sdpa_backward(split(q), split(k), split(v), split(do), scale=hd ** -0.5)}
    b, w, n, c = shape
    hd = c // heads
    qkv = torch.randn((b, w, n, 3 * c), generator=gen, device=dev).to(torch.bfloat16)
    do = torch.randn((b, w, n, c), generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn((w, heads, n, n), generator=gen, device=dev)
    bias[..., 1::3] = -1e9
    x = qkv.view(b * w, n, 3, heads, hd)
    q4, k4, v4 = (x[:, :, i].transpose(1, 2) for i in range(3))
    do4 = do.view(b * w, n, heads, hd).transpose(1, 2)
    mask = bias.to(torch.bfloat16)[None].expand(b, w, heads, n, n).reshape(b * w, heads, n, n)
    return {"kernel": lambda: wa.window_attention_v2_bwd_kernel(qkv, bias, do, heads, hd ** -0.5),
            "SDPA": sdpa_backward(q4, k4, v4, do4, mask, hd ** -0.5)}


def times(fn) -> dict:
    """graph, runs and enqueue ms of a call; for SDPA's backward
    (sdpa_backward's dict) its graph less its forward's."""
    if isinstance(fn, dict):
        return {"graph": graph_ms(fn["graph"]) - graph_ms(fn["less"]), "runs": runs_ms(fn["runs"]),
                "enqueue": enqueue_ms(fn["runs"])}
    return {"graph": graph_ms(fn), "runs": runs_ms(fn), "enqueue": enqueue_ms(fn)}


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(18)
    step = {}
    for name, shape, heads, per_step in shapes(EDRLConfig()):
        # No input of the forwards requires a gradient: autograd records
        # only SDPA's backward calls.
        for direction, make in (("fwd", calls), ("bwd", bwd_calls)):
            fns = make(name, shape, heads, gen)
            for who, fn in fns.items():
                t = times(fn)
                print(f"{name} {direction} {list(shape)} H={heads} {who}: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in t.items()) + f" ms a call, x{per_step} a step [{card}]",
                      flush=True)
                for kind in ("graph", "runs"):
                    key = f"{name} {direction} {who} {kind}"
                    step[key] = step.get(key, 0.0) + per_step * t[kind]
            del fns
            torch.cuda.empty_cache()
    print("ms a batch-32 train step: " + ", ".join(f"{k} {v:.3f}" for k, v in step.items()) + f" [{card}]",
          flush=True)


if __name__ == "__main__":
    main()

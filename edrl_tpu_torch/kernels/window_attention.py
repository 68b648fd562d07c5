"""Fused attention forwards on the H100, with their plain PyTorch versions.

Counterparts of two Pallas kernels of ``edrl_tpu/kernels/window_attention.py``:

- :func:`self_attention_fused` (B1): per head softmax(q k^T * scale) v over
  three ``[B, N, C]`` tensors with the heads packed in columns, as the ViT-3D
  q/k/v projections emit them.  CUDA source: ``csrc/self_attention_fwd.cu``.
- :func:`window_attention_fused_v2` (B2): per (batch, window, head)
  softmax(q k^T * scale + bias) v read from the packed qkv ``[B, W, N, 3C]``
  with a ``[W, H, N, N]`` f32 bias.  CUDA source:
  ``csrc/window_attention_v2_fwd.cu``.

A CPU tensor takes the plain version beside each kernel
(:func:`self_attention_reference`, :func:`window_attention_v2_reference`);
a CUDA tensor launches the hand-written kernel or raises.  Only the forward
exists: a CUDA call that would need a gradient raises ``NotImplementedError``
(the backward kernels are ROADMAP item A6).

Each kernel wrapper counts its launches in :data:`LAUNCHES`, so that a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from edrl_tpu_torch.kernels import build

SELF_ATTENTION = "self_attention_fused"
WINDOW_ATTENTION_V2 = "window_attention_fused_v2"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {SELF_ATTENTION: 0, WINDOW_ATTENTION_V2: 0}
MAX_HEAD_DIM = 128
_SMEM_LIMIT = 232448 - 4 * 64  # opt-in per-block limit, less the 64 static f32 row sums


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions: einsum with f32 scores and softmax, in the kernels' layouts.
# ---------------------------------------------------------------------------


def self_attention_reference(q, k, v, num_heads: int, scale: float):
    """softmax((q * scale) k^T) v per head; q, k, v ``[B, N, C]`` -> ``[B, N, C]``."""
    b, n, c = q.shape
    d = c // num_heads

    def split(x):
        return x.float().reshape(x.shape[0], x.shape[1], num_heads, d)

    s = torch.einsum("bqhd,bkhd->bhqk", split(q) * scale, split(k))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, split(v))
    return o.reshape(b, n, c).to(q.dtype)


def window_attention_v2_reference(qkv, bias, num_heads: int, scale: float):
    """softmax((q * scale) k^T + bias) v per (batch, window, head).

    qkv ``[B, W, N, 3C]`` with columns [q heads | k heads | v heads]; bias
    ``[W, H, N, N]`` f32.  Returns ``[B, W, N, C]`` in qkv's dtype.
    """
    b, w, n, c3 = qkv.shape
    c = c3 // 3
    x = qkv.float().reshape(b, w, n, 3, num_heads, c // num_heads)
    q, k, v = x.unbind(3)  # each [B, W, N, H, D]
    s = torch.einsum("bwqhd,bwkhd->bwhqk", q * scale, k) + bias.float()[None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bwhqk,bwkhd->bwqhd", p, v)
    return o.reshape(b, w, n, c).to(qkv.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check_cuda_inputs(name: str, tensors, num_heads: int, c: int, n: int) -> int:
    """Validate what the kernels take; returns the head dim."""
    t0 = tensors[0]
    for t in tensors:
        if t.device != t0.device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != t0.dtype:
            raise TypeError(f"{name}: inputs of different dtypes")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if t0.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: takes bfloat16 or float32, got {t0.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward-only; its backward is "
            "ROADMAP item A6 (training slice). Run under torch.no_grad()."
        )
    if num_heads <= 0 or c % num_heads:
        raise ValueError(f"{name}: {c} channels do not split into {num_heads} heads")
    d = c // num_heads
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: head_dim must be a multiple of 8 and at most "
            f"{MAX_HEAD_DIM}, got {d}"
        )
    if n < 1:
        raise ValueError(f"{name}: no tokens")
    return d


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _check_smem(name: str, lib, n: int, d: int) -> None:
    smem = lib.edrl_attention_smem_bytes(n, d)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{name}: {n} tokens need {smem} bytes of shared memory per block, "
            f"over the {_SMEM_LIMIT} a block may use"
        )


def self_attention_fused(q, k, v, num_heads: int, scale: float):
    """softmax(q k^T * scale) v per head, transpose-free.

    q, k, v: ``[B, N, C]`` with heads packed along the channel axis.  Returns
    ``[B, N, C]`` in q's dtype.  CPU tensors take
    :func:`self_attention_reference`; CUDA tensors the kernel.
    """
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 3:
        raise ValueError(f"q, k, v must share a [B, N, C] shape, got {q.shape}, {k.shape}, {v.shape}")
    if q.device.type == "cpu":
        return self_attention_reference(q, k, v, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{SELF_ATTENTION}: no kernel for device {q.device}")
    b, n, c = q.shape
    d = _check_cuda_inputs(SELF_ATTENTION, (q, k, v), num_heads, c, n)
    lib = build.load_library()
    _check_smem(SELF_ATTENTION, lib, n, d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(
        SELF_ATTENTION, lib.edrl_self_attention_fwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, n, c, num_heads, float(scale), int(q.dtype == torch.bfloat16),
    )
    return out


def window_attention_fused_v2(qkv, bias, num_heads: int, scale: float):
    """softmax(q k^T * scale + bias) v from packed qkv, transpose-free.

    qkv: ``[B, W, N, 3C]`` (columns [q heads | k heads | v heads]); bias
    ``[W, H, N, N]`` f32.  Returns ``[B, W, N, C]`` in qkv's dtype.  CPU
    tensors take :func:`window_attention_v2_reference`; CUDA tensors the
    kernel.
    """
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, W, N, 3C], got {tuple(qkv.shape)}")
    b, w, n, c3 = qkv.shape
    c = c3 // 3
    if tuple(bias.shape) != (w, num_heads, n, n):
        raise ValueError(
            f"bias must be [W, H, N, N] = {(w, num_heads, n, n)}, got {tuple(bias.shape)}"
        )
    if qkv.device.type == "cpu":
        return window_attention_v2_reference(qkv, bias, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"{WINDOW_ATTENTION_V2}: no kernel for device {qkv.device}")
    if bias.dtype != torch.float32 or bias.device != qkv.device or not bias.is_contiguous():
        raise ValueError(
            f"{WINDOW_ATTENTION_V2}: bias must be a contiguous float32 tensor on {qkv.device}"
        )
    if torch.is_grad_enabled() and bias.requires_grad:
        raise NotImplementedError(
            f"{WINDOW_ATTENTION_V2}: the CUDA kernel is forward-only; its "
            "backward is ROADMAP item A6 (training slice). Run under torch.no_grad()."
        )
    d = _check_cuda_inputs(WINDOW_ATTENTION_V2, (qkv,), num_heads, c, n)
    lib = build.load_library()
    _check_smem(WINDOW_ATTENTION_V2, lib, n, d)
    out = torch.empty((b, w, n, c), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    _launch(
        WINDOW_ATTENTION_V2, lib.edrl_window_attention_v2_fwd, qkv.device,
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, w, n, c, num_heads, float(scale), int(qkv.dtype == torch.bfloat16),
    )
    return out

"""Fused attention on the H100, forward and backward, with plain PyTorch versions.

Counterparts of two Pallas kernels of ``edrl_tpu/kernels/window_attention.py``:

- :func:`self_attention_fused` (B1): per head softmax(q k^T * scale) v over
  three ``[B, N, C]`` tensors with the heads packed in columns, as the ViT-3D
  q/k/v projections emit them.  CUDA sources: ``csrc/self_attention_fwd.cu``
  and ``csrc/self_attention_bwd.cu``.
- :func:`window_attention_fused_v2` (B2): per (batch, window, head)
  softmax(q k^T * scale + bias) v read from the packed qkv ``[B, W, N, 3C]``
  with a ``[W, H, N, N]`` f32 bias.  CUDA sources:
  ``csrc/window_attention_v2_fwd.cu`` and ``csrc/window_attention_v2_bwd.cu``.

Each is a ``torch.autograd.Function``: the forward saves its inputs (not the
probabilities) and the backward recomputes them, as the JAX VJPs do.  A CPU
tensor takes the plain versions beside each kernel, forward
(:func:`self_attention_reference`, :func:`window_attention_v2_reference`) and
backward (:func:`self_attention_bwd_reference`,
:func:`window_attention_v2_bwd_reference`); a CUDA tensor launches the
hand-written kernels or raises.

Each kernel wrapper counts its launches in :data:`LAUNCHES`, so that a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from edrl_tpu_torch.kernels import build

SELF_ATTENTION = "self_attention_fused"
WINDOW_ATTENTION_V2 = "window_attention_fused_v2"
SELF_ATTENTION_BWD = "self_attention_fused_bwd"
WINDOW_ATTENTION_V2_BWD = "window_attention_fused_v2_bwd"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {SELF_ATTENTION: 0, WINDOW_ATTENTION_V2: 0, SELF_ATTENTION_BWD: 0, WINDOW_ATTENTION_V2_BWD: 0}
MAX_HEAD_DIM = 128
MAX_BWD_TOKENS = 256  # the backward keeps [32, N] f32 score rows per block in shared memory
_SMEM_LIMIT = 232448 - 4 * 64  # opt-in per-block limit, less the 64 static f32 row sums
_BLOCKS_PER_SM = 4  # the B2 backward sizes its batch chunks to fill the SMs this many times


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions: einsum with f32 scores and softmax, in the kernels' layouts.
# ---------------------------------------------------------------------------


def _split_heads(x, num_heads: int):
    """[..., N, C] -> f32 [..., N, H, D]."""
    return x.float().reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)


def self_attention_reference(q, k, v, num_heads: int, scale: float):
    """softmax((q * scale) k^T) v per head; q, k, v ``[B, N, C]`` -> ``[B, N, C]``."""
    b, n, c = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", _split_heads(q, num_heads) * scale, _split_heads(k, num_heads))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, _split_heads(v, num_heads))
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


def _attention_bwd_math(qs, k, v, do, bias, scale: float):
    """The Pallas backward's math on f32 ``[..., N, H, D]`` operands, q scaled.

    Recomputes p, then dp, delta and ds; dq is scaled and dk uses the scaled
    q.  Returns ``(dq, dk, dv, ds)`` with ds ``[..., H, N, N]``.
    """
    s = torch.einsum("...qhd,...khd->...hqk", qs, k)
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("...qhd,...khd->...hqk", do, v)
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dv = torch.einsum("...hqk,...qhd->...khd", p, do)
    dq = torch.einsum("...hqk,...khd->...qhd", ds, k) * scale
    dk = torch.einsum("...hqk,...qhd->...khd", ds, qs)
    return dq, dk, dv, ds


def self_attention_bwd_reference(q, k, v, dout, num_heads: int, scale: float):
    """Backward of :func:`self_attention_reference`: ``(dq, dk, dv)``, each
    ``[B, N, C]`` in q's dtype."""
    b, n, c = q.shape
    dq, dk, dv, _ = _attention_bwd_math(
        _split_heads(q, num_heads) * scale, _split_heads(k, num_heads),
        _split_heads(v, num_heads), _split_heads(dout, num_heads), None, scale,
    )
    return tuple(t.reshape(b, n, c).to(q.dtype) for t in (dq, dk, dv))


def window_attention_v2_bwd_reference(qkv, bias, dout, num_heads: int, scale: float):
    """Backward of :func:`window_attention_v2_reference`.

    Returns ``(dqkv, dbias)``: dqkv ``[B, W, N, 3C]`` in qkv's dtype, packed
    as qkv is; dbias ``[W, H, N, N]`` f32, summed over the batch.
    """
    b, w, n, c3 = qkv.shape
    x = qkv.float().reshape(b, w, n, 3, num_heads, c3 // (3 * num_heads))
    q, k, v = x.unbind(3)
    dq, dk, dv, ds = _attention_bwd_math(
        q * scale, k, v, _split_heads(dout, num_heads), bias.float()[None], scale,
    )
    dqkv = torch.stack([dq, dk, dv], dim=3).reshape(b, w, n, c3).to(qkv.dtype)
    return dqkv, ds.sum(dim=0)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check_cuda_inputs(name: str, tensors, num_heads: int, c: int, n: int) -> int:
    """Validate what the kernels take; returns the head dim."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t0.device}")
    for t in tensors:
        if t.device != t0.device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != t0.dtype:
            raise TypeError(f"{name}: inputs of different dtypes")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if t0.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: takes bfloat16 or float32, got {t0.dtype}")
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


def _check_bwd_shape(name: str, n: int) -> None:
    if n > MAX_BWD_TOKENS:
        raise ValueError(
            f"{name}: the backward kernel takes at most {MAX_BWD_TOKENS} tokens, got {n}"
        )


def _check_smem(name: str, smem: int, n: int) -> None:
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{name}: {n} tokens need {smem} bytes of shared memory per block, "
            f"over the {_SMEM_LIMIT} a block may use"
        )


def _grad_output(dout, like):
    """The cotangent as the kernels take it: contiguous, in the output's dtype."""
    return dout.to(like.dtype).contiguous()


# -- B1 ----------------------------------------------------------------------


def _self_attention_fwd_kernel(q, k, v, num_heads: int, scale: float):
    b, n, c = q.shape
    d = _check_cuda_inputs(SELF_ATTENTION, (q, k, v), num_heads, c, n)
    lib = build.load_library()
    _check_smem(SELF_ATTENTION, lib.edrl_attention_smem_bytes(n, d), n)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    build.launch(
        LAUNCHES, SELF_ATTENTION, lib.edrl_self_attention_fwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, n, c, num_heads, float(scale), int(q.dtype == torch.bfloat16),
    )
    return out


def self_attention_bwd_kernel(q, k, v, dout, num_heads: int, scale: float):
    """``(dq, dk, dv)`` from the B1 backward kernel; CUDA tensors only."""
    if not q.shape == k.shape == v.shape == dout.shape or q.dim() != 3:
        raise ValueError(f"{SELF_ATTENTION_BWD}: q, k, v and dout must share a [B, N, C] shape")
    b, n, c = q.shape
    d = _check_cuda_inputs(SELF_ATTENTION_BWD, (q, k, v, dout), num_heads, c, n)
    _check_bwd_shape(SELF_ATTENTION_BWD, n)
    lib = build.load_library()
    _check_smem(SELF_ATTENTION_BWD, lib.edrl_attention_bwd_smem_bytes(n, d, 0), n)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    stats = torch.empty((3, b * num_heads * n), dtype=torch.float32, device=q.device)
    build.launch(
        LAUNCHES, SELF_ATTENTION_BWD, lib.edrl_self_attention_bwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        b, n, c, num_heads, float(scale), int(q.dtype == torch.bfloat16),
    )
    return dq, dk, dv


class _SelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        if q.device.type == "cpu":
            return self_attention_reference(q, k, v, num_heads, scale)
        if any(ctx.needs_input_grad[:3]):
            _check_bwd_shape(SELF_ATTENTION_BWD, q.shape[1])
        return _self_attention_fwd_kernel(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dout = _grad_output(dout, q)
        if q.device.type == "cpu":
            grads = self_attention_bwd_reference(q, k, v, dout, ctx.num_heads, ctx.scale)
        else:
            grads = self_attention_bwd_kernel(q, k, v, dout, ctx.num_heads, ctx.scale)
        return (*grads, None, None)


def self_attention_fused(q, k, v, num_heads: int, scale: float):
    """softmax(q k^T * scale) v per head, transpose-free, differentiable.

    q, k, v: ``[B, N, C]`` with heads packed along the channel axis.  Returns
    ``[B, N, C]`` in q's dtype.  CPU tensors take the plain versions
    (:func:`self_attention_reference` and its backward); CUDA tensors the
    kernels.
    """
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 3:
        raise ValueError(f"q, k, v must share a [B, N, C] shape, got {q.shape}, {k.shape}, {v.shape}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{SELF_ATTENTION}: no kernel for device {q.device}")
    return _SelfAttention.apply(q, k, v, num_heads, scale)


# -- B2 ----------------------------------------------------------------------


def _window_attention_v2_fwd_kernel(qkv, bias, num_heads: int, scale: float):
    b, w, n, c3 = qkv.shape
    c = c3 // 3
    d = _check_cuda_inputs(WINDOW_ATTENTION_V2, (qkv,), num_heads, c, n)
    lib = build.load_library()
    _check_smem(WINDOW_ATTENTION_V2, lib.edrl_attention_smem_bytes(n, d), n)
    out = torch.empty((b, w, n, c), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    build.launch(
        LAUNCHES, WINDOW_ATTENTION_V2, lib.edrl_window_attention_v2_fwd, qkv.device,
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, w, n, c, num_heads, float(scale), int(qkv.dtype == torch.bfloat16),
    )
    return out


def window_attention_v2_bwd_kernel(qkv, bias, dout, num_heads: int, scale: float):
    """``(dqkv, dbias)`` from the B2 backward kernel; CUDA tensors only."""
    b, w, n, c3 = qkv.shape
    c = c3 // 3
    d = _check_cuda_inputs(WINDOW_ATTENTION_V2_BWD, (qkv,), num_heads, c, n)
    _check_cuda_inputs(WINDOW_ATTENTION_V2_BWD, (dout,), num_heads, c, n)
    if dout.dtype != qkv.dtype or tuple(dout.shape) != (b, w, n, c):
        raise ValueError(f"{WINDOW_ATTENTION_V2_BWD}: dout must be {(b, w, n, c)} in {qkv.dtype}")
    if (tuple(bias.shape) != (w, num_heads, n, n) or bias.dtype != torch.float32
            or bias.device != qkv.device or not bias.is_contiguous()):
        raise ValueError(f"{WINDOW_ATTENTION_V2_BWD}: bias must be a contiguous float32 "
                         f"{(w, num_heads, n, n)} tensor on {qkv.device}")
    _check_bwd_shape(WINDOW_ATTENTION_V2_BWD, n)
    lib = build.load_library()
    _check_smem(WINDOW_ATTENTION_V2_BWD, lib.edrl_attention_bwd_smem_bytes(n, d, 1), n)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    if qkv.numel() == 0:
        return dqkv, dbias.zero_()
    stats = torch.empty((3, b * w * num_heads * n), dtype=torch.float32, device=qkv.device)
    # Batch entries one dq block sums ds over: as many as leave the grid at
    # least _BLOCKS_PER_SM blocks per SM.
    sms = build.sm_count(qkv.device)
    base = w * num_heads * -(-n // 32)
    chunks = min(b, max(1, -(-_BLOCKS_PER_SM * sms // base)))
    per_block = -(-b // chunks)
    chunks = -(-b // per_block)
    partial = dbias if chunks == 1 else torch.empty(
        (chunks, *bias.shape), dtype=torch.float32, device=qkv.device)
    build.launch(
        LAUNCHES, WINDOW_ATTENTION_V2_BWD, lib.edrl_window_attention_v2_bwd, qkv.device,
        qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), partial.data_ptr(),
        dbias.data_ptr(), stats.data_ptr(), b, w, n, c, num_heads, per_block, float(scale),
        int(qkv.dtype == torch.bfloat16),
    )
    return dqkv, dbias


class _WindowAttentionV2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, num_heads, scale):
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads, ctx.scale = num_heads, scale
        if qkv.device.type == "cpu":
            return window_attention_v2_reference(qkv, bias, num_heads, scale)
        if any(ctx.needs_input_grad[:2]):
            _check_bwd_shape(WINDOW_ATTENTION_V2_BWD, qkv.shape[2])
        return _window_attention_v2_fwd_kernel(qkv, bias, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dout = _grad_output(dout, qkv)
        if qkv.device.type == "cpu":
            dqkv, dbias = window_attention_v2_bwd_reference(qkv, bias, dout, ctx.num_heads, ctx.scale)
        else:
            dqkv, dbias = window_attention_v2_bwd_kernel(qkv, bias, dout, ctx.num_heads, ctx.scale)
        return dqkv, dbias, None, None


def window_attention_fused_v2(qkv, bias, num_heads: int, scale: float):
    """softmax(q k^T * scale + bias) v from packed qkv, transpose-free, differentiable.

    qkv: ``[B, W, N, 3C]`` (columns [q heads | k heads | v heads]); bias
    ``[W, H, N, N]`` f32; its gradient is summed over the batch.  Returns
    ``[B, W, N, C]`` in qkv's dtype.  CPU tensors take the plain versions
    (:func:`window_attention_v2_reference` and its backward); CUDA tensors
    the kernels.
    """
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be [B, W, N, 3C], got {tuple(qkv.shape)}")
    b, w, n, c3 = qkv.shape
    if tuple(bias.shape) != (w, num_heads, n, n):
        raise ValueError(
            f"bias must be [W, H, N, N] = {(w, num_heads, n, n)}, got {tuple(bias.shape)}"
        )
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{WINDOW_ATTENTION_V2}: no kernel for device {qkv.device}")
    if qkv.device.type == "cuda" and (
        bias.dtype != torch.float32 or bias.device != qkv.device or not bias.is_contiguous()
    ):
        raise ValueError(
            f"{WINDOW_ATTENTION_V2}: bias must be a contiguous float32 tensor on {qkv.device}"
        )
    return _WindowAttentionV2.apply(qkv, bias, num_heads, scale)

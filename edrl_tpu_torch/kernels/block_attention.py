"""Fused attention sublayer on the H100 (B6), with its plain versions.

Counterpart of ``edrl_tpu/kernels/block_attention.py``
(``attention_sublayer_fused``): over ``x [B, W, N, C]``,

    y = x + (softmax(LN(x) Wq (LN(x) Wk)^T * scale + bias) LN(x) Wv) Wp + bp

with the LayerNorm's statistics in f32 (eps 1e-6), gamma, beta, bqkv and
bproj f32, wqkv ``[C, 3C]`` and wproj ``[C, C]`` in x's dtype, and bias ``[Wb,
H, N, N]`` f32 with Wb 1 (one bias for every window) or W.  The forward also
emits ``qkv [B, W, N, 3C]`` and ``xln [B, W, N, C]``, the residuals of the
backward.  CUDA source ``csrc/attention_sublayer_fwd.cu``: three phases on
one stream (LayerNorm, then xln . wqkv + bqkv; the attention per (b, w, h);
then o . wproj + bproj + x), which take C a multiple of 128 up to 2048, a
head dim that is a multiple of 8 up to 128, and, when a gradient is needed,
N up to 256.

Where it rounds.  In bf16 the TPU kernel forms the scores and the attention
output from the f32 qkv and rounds only the emitted qkv and the attention
output o.  The kernel here runs its attention phase on the emitted bf16 qkv,
so q, k and v are rounded first, and (as B2's tensor-core kernel does) the
probabilities are rounded to bf16 before the value product.  The JAX VJP
recomputes o from that rounded qkv as well, so here the forward and the
backward see the same o.  :func:`attention_sublayer_reference` copies
the kernel's roundings: xln and qkv rounded to x's dtype, the attention of
B2's plain version on the rounded qkv, o rounded, the products and biases in
f32, y rounded once.  In f32 nothing is rounded and both are the TPU
kernel's function.

The backward is the JAX VJP step for step: B2's forward recomputes o, the
weight and bias gradients and the cotangents of o and xln are f32 products
(``torch.matmul``, as the JAX package leaves them to XLA), B2's backward
gives dqkv and dbias, and the LayerNorm backward is B4's plain backward
(:func:`layer_norm_bwd_reference`) on the f32 x.  On the card the two
attention steps are the B2 kernels, on the CPU their plain versions.  Every
cotangent has its primal's dtype.

:func:`attention_sublayer_fused` is a ``torch.autograd.Function``; a CPU
tensor takes the plain versions, a CUDA tensor the kernel or raises.  The
kernel wrapper counts its launches in :data:`LAUNCHES`, and its attention
phase under its route in ``window_attention.FWD_ROUTES``; the backward's B2
launches count under B2's names.
"""

from __future__ import annotations

import torch

from edrl_tpu_torch.kernels import build
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.kernels.layer_norm import MAX_C, layer_norm_bwd_reference, layer_norm_reference

ATTENTION_SUBLAYER = "attention_sublayer_fused"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {ATTENTION_SUBLAYER: 0}
LN_EPS = 1e-6


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _full_bias(bias, windows: int):
    """A Wb = 1 bias broadcast to the B2 kernels' contiguous ``[W, H, N, N]``."""
    if bias.shape[0] == windows:
        return bias
    return bias.expand(windows, *bias.shape[1:]).contiguous()


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def attention_sublayer_reference(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads: int,
                                 scale: float):
    """The kernel's function with its roundings: ``(y, qkv, xln)``, all in x's dtype."""
    xln = layer_norm_reference(x, gamma, beta, LN_EPS)
    qkv = (torch.matmul(xln.float(), wqkv.float()) + bqkv.float()).to(x.dtype)
    o = wa.window_attention_v2_reference(qkv, _full_bias(bias, x.shape[1]), num_heads, scale)
    y = x.float() + (torch.matmul(o.float(), wproj.float()) + bproj.float())
    return y.to(x.dtype), qkv, xln


def _bwd(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads, scale, attention_fwd, attention_bwd):
    """The JAX VJP ``_v4_bwd`` with the given B2 forward and backward."""
    b, w, n, c = x.shape
    dy = dy.to(x.dtype).contiguous()
    dy32 = dy.float().reshape(-1, c)
    bias_full = _full_bias(bias, w)
    o = attention_fwd(qkv, bias_full, num_heads, scale)  # recomputed from the saved qkv
    dwproj = torch.matmul(o.float().reshape(-1, c).T, dy32)
    dbproj = dy32.sum(dim=0)
    do = torch.matmul(dy32, wproj.float().T).to(x.dtype).reshape(b, w, n, c)
    dqkv, dbias = attention_bwd(qkv, bias_full, do, num_heads, scale)
    dqkv32 = dqkv.float().reshape(-1, 3 * c)
    dwqkv = torch.matmul(xln.float().reshape(-1, c).T, dqkv32)
    dbqkv = dqkv32.sum(dim=0)
    dxln = torch.matmul(dqkv32, wqkv.float().T)
    dx_ln, dgamma, dbeta = layer_norm_bwd_reference(x.float().reshape(-1, c), dxln, gamma, LN_EPS)
    dx = (dy32 + dx_ln).to(x.dtype).reshape(x.shape)
    if bias.shape[0] == 1:
        dbias = dbias.sum(dim=0, keepdim=True)
    return dx, dgamma, dbeta, dwqkv.to(wqkv.dtype), dbqkv, dwproj.to(wproj.dtype), dbproj, dbias


def attention_sublayer_bwd_reference(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads: int, scale: float):
    """The backward on B2's plain versions: ``(dx, dgamma, dbeta, dwqkv, dbqkv,
    dwproj, dbproj, dbias)``; dx in x's dtype, the weight gradients in the
    weights', the rest f32."""
    return _bwd(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads, scale,
                wa.window_attention_v2_reference, wa.window_attention_v2_bwd_reference)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads: int) -> int:
    """Validate what the kernel takes; returns the head dim."""
    name = ATTENTION_SUBLAYER
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous() or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be a contiguous [B, W, N, C] bfloat16 or float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    b, w, n, c = x.shape
    if c % 128 or c > MAX_C:
        raise ValueError(f"{name}: the kernel takes C a multiple of 128 up to {MAX_C}, got {c}")
    d = wa._check_cuda_inputs(name, (x,), num_heads, c, n)
    for t, shape, dtype, what in ((gamma, (c,), torch.float32, "gamma"), (beta, (c,), torch.float32, "beta"),
                                  (bqkv, (3 * c,), torch.float32, "bqkv"), (bproj, (c,), torch.float32, "bproj"),
                                  (wqkv, (c, 3 * c), x.dtype, "wqkv"), (wproj, (c, c), x.dtype, "wproj")):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {list(shape)} {dtype} tensor on {x.device}, "
                             f"got {list(t.shape)} {t.dtype}")
    if (bias.dim() != 4 or bias.shape[0] not in (1, w) or tuple(bias.shape[1:]) != (num_heads, n, n)
            or bias.dtype != torch.float32 or bias.device != x.device or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 [1 or {w}, {num_heads}, {n}, {n}] "
                         f"tensor on {x.device}, got {list(bias.shape)} {bias.dtype}")
    return d


def attention_sublayer_fwd_kernel(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads: int, scale: float):
    """``(y, qkv, xln)`` from the B6 kernel; CUDA tensors only."""
    d = _check_cuda(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads)
    b, w, n, c = x.shape
    lib = build.load_library()
    wa._check_smem(ATTENTION_SUBLAYER, wa._fwd_smem(lib, x.dtype, n, d, True), n)
    y, xln, o = (torch.empty_like(x) for _ in range(3))
    qkv = torch.empty((b, w, n, 3 * c), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y, qkv, xln
    bf16 = x.dtype == torch.bfloat16
    route = wa.attention_fwd_route(x.dtype, n, d)  # the attention phase's
    (bias,) = wa._aligned_operands(route, (bias,))
    # bf16: the weights transposed (K contiguous) for the tensor-core products.
    wt = [torch.empty(shape, dtype=torch.bfloat16, device=x.device) if bf16 else None
          for shape in ((3 * c, c), (c, c))]
    build.launch(
        LAUNCHES, ATTENTION_SUBLAYER, lib.edrl_attention_sublayer_fwd, x.device,
        *(None if t is None else t.data_ptr()
          for t in (x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, y, qkv, xln, o, *wt)),
        b, w, bias.shape[0], n, c, num_heads, float(scale), int(bf16),
    )
    wa.FWD_ROUTES[route] += 1
    return y, qkv, xln


def attention_sublayer_bwd_kernel(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads: int, scale: float):
    """The backward through the B2 kernels; CUDA tensors only.  Returns what
    :func:`attention_sublayer_bwd_reference` returns."""
    return _bwd(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads, scale,
                wa.window_attention_v2_fwd_kernel, wa.window_attention_v2_bwd_kernel)


class _AttentionSublayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads, scale):
        if x.device.type == "cpu":
            y, qkv, xln = attention_sublayer_reference(
                x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads, scale)
        else:
            if any(ctx.needs_input_grad[:8]):
                wa._check_bwd_shape(ATTENTION_SUBLAYER, x.shape[2])
            y, qkv, xln = attention_sublayer_fwd_kernel(
                x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads, scale)
        ctx.save_for_backward(x, xln, qkv, gamma, wqkv, wproj, bias)
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.dtypes = (beta.dtype, bqkv.dtype, bproj.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        bwd = attention_sublayer_bwd_reference if saved[0].device.type == "cpu" else attention_sublayer_bwd_kernel
        dx, dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias = bwd(*saved, dy, ctx.num_heads, ctx.scale)
        beta_dtype, bqkv_dtype, bproj_dtype = ctx.dtypes
        return (dx, dgamma.to(saved[3].dtype), dbeta.to(beta_dtype), dwqkv, dbqkv.to(bqkv_dtype), dwproj,
                dbproj.to(bproj_dtype), dbias, None, None)


def attention_sublayer_fused(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads: int, scale: float):
    """``x + proj(window_attention(qkv(LN(x))))`` in one kernel, differentiable.

    x ``[B, W, N, C]`` (W = 1 serves the ViT's self-attention); gamma, beta,
    bqkv, bproj f32; wqkv ``[C, 3C]`` and wproj ``[C, C]`` in x's dtype; bias
    ``[Wb, H, N, N]`` f32 with Wb 1 or W.  Returns ``[B, W, N, C]`` in x's
    dtype.  CPU tensors take the plain versions, CUDA tensors the kernel (the
    backward the B2 kernels).
    """
    if (x.dim() != 4 or bias.dim() != 4 or bias.shape[0] not in (1, x.shape[1])
            or tuple(bias.shape[1:]) != (num_heads, x.shape[2], x.shape[2])):
        raise ValueError(f"{ATTENTION_SUBLAYER}: x must be [B, W, N, C] and bias must be [1 or W, H, N, N], "
                         f"got {tuple(x.shape)}, {tuple(bias.shape)} with H = {num_heads}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{ATTENTION_SUBLAYER}: no kernel for device {x.device}")
    if x.device.type == "cuda":
        x = x.contiguous()
    return _AttentionSublayer.apply(x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, num_heads, scale)

"""Fused attention sublayer on the H100 (B6), with its plain versions.

Counterpart of ``edrl_tpu/kernels/block_attention.py``
(``attention_sublayer_fused``): over ``x [B, W, N, C]``,

    y = x + (softmax(LN(x) Wq (LN(x) Wk)^T * scale + bias) LN(x) Wv) Wp + bp

with the LayerNorm's statistics in f32 (eps 1e-6), gamma, beta, bqkv and
bproj f32, wqkv ``[C, 3C]`` and wproj ``[C, C]`` in x's dtype, and bias ``[Wb,
H, N, N]`` f32 with Wb 1 (one bias for every window) or W.  The forward also
emits ``qkv [B, W, N, 3C]`` and ``xln [B, W, N, C]``, the residuals of the
backward.  CUDA source ``csrc/attention_sublayer_fwd.cu``: four launches on
one stream (B4's LayerNorm; xln . wqkv + bqkv; the attention per (b, w, h);
o . wproj + bproj + x), which take C a multiple of 128 up to 2048, a head
dim that is a multiple of 8 up to 128, and, when a gradient is needed, N up
to 256.

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

The backward is the JAX VJP step for step: B2's forward recomputes o; dwproj
= o^T dy, dbproj, do = dy wproj^T (in x's dtype); B2's backward gives dqkv
and dbias; dwqkv = xln^T dqkv, dbqkv, dxln = dqkv wqkv^T (f32); and the
LayerNorm backward in B4's residual form, which adds dy to its dx in f32
and rounds once.  Every cotangent has its primal's dtype.  On the card:

- bf16: the two Dense layers' backwards are ``csrc/attention_sublayer_bwd.cu``
  (each a launch of ``edrl_attention_sublayer_dense_bwd``: its three
  products on the wgmma mainloop of ``csrc/hopper_gemm.cuh``, bf16 in, f32
  sums, no f32 copy of any operand, the weight gradients split over M by
  :func:`fused_mlp.wgmma_wgrad_splits`), the attention steps B2's kernels, and
  the LayerNorm B4's kernel (``layer_norm.layer_norm_bwd_residual_kernel``).
- f32: the products are f32 ``torch.matmul`` (as the JAX package leaves
  them to XLA; f32 inputs are not bf16 values), the rest as in bf16.

On the CPU every step is its plain version (:func:`attention_sublayer_bwd_reference`).

The products' route, forward and backward, is chosen in the C entry points
from x's dtype and mirrored by :func:`attention_sublayer_route`: ``"wgmma"``
for bf16, ``"fma"`` (f32 FMA on the CUDA cores; the backward's products
are then ``torch.matmul``) for f32.  :func:`attention_sublayer_fused` is a
``torch.autograd.Function``; a CPU tensor takes the plain versions, a CUDA
tensor the kernels or raises.  The forward counts its launches in
:data:`LAUNCHES` under ``attention_sublayer_fused``, the bf16 backward its
two Dense launches under ``attention_sublayer_fused_bwd``; each launch also
counts under its route in :data:`SUBLAYER_ROUTES`.  The attention phase
counts under its route in ``window_attention.FWD_ROUTES``; the backward's B2
and B4 launches count under their own names.
"""

from __future__ import annotations

import torch

from edrl_tpu_torch.kernels import build
from edrl_tpu_torch.kernels import layer_norm as ln
from edrl_tpu_torch.kernels import window_attention as wa
from edrl_tpu_torch.kernels.fused_mlp import wgmma_wgrad_splits

ATTENTION_SUBLAYER = "attention_sublayer_fused"
ATTENTION_SUBLAYER_BWD = "attention_sublayer_fused_bwd"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {ATTENTION_SUBLAYER: 0, ATTENTION_SUBLAYER_BWD: 0}
# Forward and backward launches since the last reset, by the products' route.
SUBLAYER_ROUTES = {"wgmma": 0, "fma": 0}
LN_EPS = 1e-6
# Column partials of the bias gradients: blocks of a multiple of 64 rows, at
# most this many partials (column_sum_kernel then adds them in order).
_BIAS_PARTS = 256


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, SUBLAYER_ROUTES):
        for name in counts:
            counts[name] = 0


def attention_sublayer_route(dtype, c: int, num_heads: int):
    """The products' route of a call, forward and backward: ``"wgmma"`` for
    bf16, ``"fma"`` for f32, ``None`` where the kernel refuses the dtype or
    the shape (C a multiple of 128 up to 2048, C / heads a multiple of 8 up
    to 128).

    Mirrors ``edrl_attention_sublayer_route`` in
    ``csrc/attention_sublayer_fwd.cu``, which picks the route before the launch.
    """
    if c % 128 or not 128 <= c <= ln.MAX_C or num_heads < 1 or c % num_heads:
        return None
    d = c // num_heads
    if d % 8 or d > wa.MAX_HEAD_DIM:
        return None
    return {torch.bfloat16: "wgmma", torch.float32: "fma"}.get(dtype)


def bias_grad_rows(m: int) -> int:
    """Rows per column partial of the bf16 backward's bias gradients: a
    multiple of 64, so that there are at most 256 partials."""
    return 64 * -(-m // (64 * _BIAS_PARTS))


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
    xln = ln.layer_norm_reference(x, gamma, beta, LN_EPS)
    qkv = (torch.matmul(xln.float(), wqkv.float()) + bqkv.float()).to(x.dtype)
    o = wa.window_attention_v2_reference(qkv, _full_bias(bias, x.shape[1]), num_heads, scale)
    y = x.float() + (torch.matmul(o.float(), wproj.float()) + bproj.float())
    return y.to(x.dtype), qkv, xln


def _bwd(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads, scale, attention_fwd, attention_bwd, ln_bwd):
    """The JAX VJP ``_v4_bwd`` with f32 products and the given B2 forward and
    backward and LayerNorm backward (residual form)."""
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
    dx, dgamma, dbeta = ln_bwd(x.reshape(-1, c), dxln, gamma, dy.reshape(-1, c), LN_EPS)
    if bias.shape[0] == 1:
        dbias = dbias.sum(dim=0, keepdim=True)
    return (dx.reshape(x.shape), dgamma, dbeta, dwqkv.to(wqkv.dtype), dbqkv, dwproj.to(wproj.dtype), dbproj,
            dbias)


def attention_sublayer_bwd_reference(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads: int, scale: float):
    """The backward on B2's and B4's plain versions: ``(dx, dgamma, dbeta,
    dwqkv, dbqkv, dwproj, dbproj, dbias)``; dx in x's dtype, the weight
    gradients in the weights', the rest f32."""
    return _bwd(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads, scale, wa.window_attention_v2_reference,
                wa.window_attention_v2_bwd_reference, ln.layer_norm_bwd_residual_reference)


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
    if c % 128 or c > ln.MAX_C:
        raise ValueError(f"{name}: the kernel takes C a multiple of 128 up to {ln.MAX_C}, got {c}")
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
    route = attention_sublayer_route(x.dtype, c, num_heads)
    attention_route = wa.attention_fwd_route(x.dtype, n, d)
    (bias,) = wa._aligned_operands(attention_route, (bias,))
    if route == "wgmma":  # TMA reads the weights in place
        wqkv, wproj = build.aligned16(wqkv), build.aligned16(wproj)
    build.launch(
        LAUNCHES, ATTENTION_SUBLAYER, lib.edrl_attention_sublayer_fwd, x.device,
        *(t.data_ptr() for t in (x, gamma, beta, wqkv, bqkv, wproj, bproj, bias, y, qkv, xln, o)),
        b, w, bias.shape[0], n, c, num_heads, float(scale), int(x.dtype == torch.bfloat16),
    )
    SUBLAYER_ROUTES[route] += 1
    wa.FWD_ROUTES[attention_route] += 1
    return y, qkv, xln


def _dense_bwd(a, dout, w, da_dtype):
    """One Dense layer's backward on the wgmma route (bf16 ``a [M, P]``,
    ``dout [M, Q]``, ``w [P, Q]``): ``(dw, db, da)`` with dw = a^T dout in
    w's dtype, db the column sums of dout (f32), da = dout w^T in da_dtype."""
    m, p = a.shape
    q = dout.shape[1]
    a, dout, w = (build.aligned16(t) for t in (a, dout, w))
    f32 = dict(dtype=torch.float32, device=a.device)
    splits, chunk = wgmma_wgrad_splits(m, p, q, build.sm_count(a.device))
    rows = bias_grad_rows(m)
    dw = torch.empty((p, q), dtype=w.dtype, device=a.device)
    db = torch.empty((q,), **f32)
    da = torch.empty((m, p), dtype=da_dtype, device=a.device)
    dw_part = torch.empty((splits, p, q), **f32)
    db_part = torch.empty((-(-m // rows), q), **f32)
    build.launch(LAUNCHES, ATTENTION_SUBLAYER_BWD, build.load_library().edrl_attention_sublayer_dense_bwd, a.device,
                 *(t.data_ptr() for t in (a, dout, w, dw, db, da, dw_part, db_part)),
                 m, p, q, splits, chunk, rows, int(da_dtype == torch.float32))
    SUBLAYER_ROUTES["wgmma"] += 1
    return dw, db, da


def attention_sublayer_bwd_kernel(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads: int, scale: float):
    """The backward on the card; CUDA tensors only.  Returns what
    :func:`attention_sublayer_bwd_reference` returns.

    bf16: B2's kernels, the two Dense layers' backwards on the wgmma route
    and B4's residual LayerNorm backward; f32: the same with f32
    ``torch.matmul`` products (:func:`_bwd`).
    """
    route = attention_sublayer_route(x.dtype, x.shape[-1], num_heads)
    if x.device.type != "cuda" or route is None or any(t.dtype != x.dtype for t in (xln, qkv, wqkv, wproj)):
        raise ValueError(f"{ATTENTION_SUBLAYER_BWD}: the kernels take CUDA tensors of a shape and dtype the forward "
                         f"takes, got x {tuple(x.shape)} {x.dtype} on {x.device} with {num_heads} heads")
    if route == "fma":
        return _bwd(x, xln, qkv, gamma, wqkv, wproj, bias, dy, num_heads, scale, wa.window_attention_v2_fwd_kernel,
                    wa.window_attention_v2_bwd_kernel, ln.layer_norm_bwd_residual_kernel)
    b, w, n, c = x.shape
    m = b * w * n
    dy = dy.to(x.dtype).contiguous()
    bias_full = _full_bias(bias, w)
    o = wa.window_attention_v2_fwd_kernel(qkv, bias_full, num_heads, scale)  # recomputed from the saved qkv
    dwproj, dbproj, do = _dense_bwd(o.view(m, c), dy.view(m, c), wproj, x.dtype)
    dqkv, dbias = wa.window_attention_v2_bwd_kernel(qkv, bias_full, do.view(b, w, n, c), num_heads, scale)
    dwqkv, dbqkv, dxln = _dense_bwd(xln.view(m, c), dqkv.view(m, 3 * c), wqkv, torch.float32)
    dx, dgamma, dbeta = ln.layer_norm_bwd_residual_kernel(x.view(m, c), dxln, gamma, dy.view(m, c), LN_EPS)
    if bias.shape[0] == 1:
        dbias = dbias.sum(dim=0, keepdim=True)
    return dx.view(x.shape), dgamma, dbeta, dwqkv, dbqkv, dwproj, dbproj, dbias


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
    dtype.  CPU tensors take the plain versions, CUDA tensors the kernels.
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

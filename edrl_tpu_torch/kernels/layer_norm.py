"""Fused LayerNorm on the H100 (B4), forward and backward, with plain versions.

Counterpart of ``edrl_tpu/kernels/layer_norm.py`` (``fused_layer_norm``):
row LayerNorm over ``x [M, C]`` with f32 statistics, eps 1e-6, f32 gamma and
beta, the result in x's dtype.  CUDA sources ``csrc/layer_norm_fwd.cu`` and
``csrc/layer_norm_bwd.cu``; the kernels take C a multiple of 128 up to 2048.

:func:`fused_layer_norm` is a ``torch.autograd.Function``: the forward saves
x and gamma, the backward recomputes the statistics, as the JAX VJP does.  A
CPU tensor takes the plain versions (:func:`layer_norm_reference`,
:func:`layer_norm_bwd_reference`); a CUDA tensor launches the kernels or
raises.  Each kernel wrapper counts its launches in :data:`LAUNCHES`.

The backward also has a residual form (:func:`layer_norm_bwd_residual_kernel`,
:func:`layer_norm_bwd_residual_reference`), the LayerNorm part of the fused
attention sublayer's backward (``_v4_bwd``): an f32 cotangent, and a
residual cotangent in x's dtype that is added to dx in f32 before dx is
rounded once.  It counts under the backward's name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from edrl_tpu_torch.kernels import build

LAYER_NORM = "fused_layer_norm"
LAYER_NORM_BWD = "fused_layer_norm_bwd"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {LAYER_NORM: 0, LAYER_NORM_BWD: 0}
MAX_C = 2048
_BWD_BLOCKS_PER_SM = 8  # dgamma/dbeta partials: 8 row blocks per SM


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def layer_norm_reference(x, gamma, beta, eps: float = 1e-6):
    """Row LayerNorm with f32 statistics; the result has x's dtype.

    (x - mean) * rsqrt(var + eps) * gamma + beta over the last axis, all in
    f32, as the JAX reference computes it; ``F.layer_norm`` on the f32 input
    does that in one pass instead of ten elementwise launches.
    """
    y = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(), eps)
    return y.to(x.dtype)


def layer_norm_bwd_reference(x, dy, gamma, eps: float = 1e-6):
    """The Pallas backward's formula: ``(dx, dgamma, dbeta)`` for ``x, dy [M, C]``.

    dx = rstd * (dy*g - mean(dy*g) - xhat * mean(dy*g*xhat)) in x's dtype;
    dgamma = sum of dy * xhat and dbeta = sum of dy over rows, f32.
    """
    xf, dyf, g = x.float(), dy.float(), gamma.float()
    mu = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (xf - mu) * rstd
    dyg = dyf * g
    s1 = dyg.mean(dim=-1, keepdim=True)
    s2 = (dyg * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dyg - s1 - xhat * s2)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def layer_norm_bwd_residual_reference(x, dy, gamma, res, eps: float = 1e-6):
    """The residual form: ``(dx, dgamma, dbeta)`` for x ``[M, C]``, an f32
    cotangent dy and a residual cotangent res in x's dtype.

    dx = res + the LayerNorm's dx, added in f32 and rounded once to x's
    dtype; dgamma and dbeta as :func:`layer_norm_bwd_reference` gives them
    from the f32 dy.
    """
    dx, dgamma, dbeta = layer_norm_bwd_reference(x.float(), dy.float(), gamma, eps)
    return (res.float() + dx).to(x.dtype), dgamma, dbeta


def _check_cuda(name: str, x, params) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous() or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: x must be a contiguous 2-D bfloat16 or float32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    if c % 128 or c > MAX_C:
        raise ValueError(f"{name}: the kernel takes C a multiple of 128 up to {MAX_C}, got {c}")
    for t in params:
        if (t.dtype != torch.float32 or t.device != x.device or tuple(t.shape) != (c,)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: gamma and beta must be contiguous float32 [{c}] on {x.device}")


def layer_norm_fwd_kernel(x, gamma, beta, eps: float = 1e-6):
    """The B4 forward kernel's ``[M, C]`` result; CUDA tensors only."""
    _check_cuda(LAYER_NORM, x, (gamma, beta))
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    m, c = x.shape
    build.launch(LAUNCHES, LAYER_NORM, build.load_library().edrl_layer_norm_fwd, x.device,
                 x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), m, c, float(eps),
                 int(x.dtype == torch.bfloat16))
    return y


def layer_norm_bwd_kernel(x, dy, gamma, eps: float = 1e-6):
    """``(dx, dgamma, dbeta)`` from the B4 backward kernel; CUDA tensors only."""
    _check_cuda(LAYER_NORM_BWD, x, (gamma,))
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"{LAYER_NORM_BWD}: dy must be a contiguous {tuple(x.shape)} {x.dtype} tensor")
    m, c = x.shape
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    if m == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    blocks = min(m, _BWD_BLOCKS_PER_SM * build.sm_count(x.device))
    partial = torch.empty((2, blocks, c), dtype=torch.float32, device=x.device)
    build.launch(LAUNCHES, LAYER_NORM_BWD, build.load_library().edrl_layer_norm_bwd, x.device,
                 x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
                 dbeta.data_ptr(), partial.data_ptr(), m, c, blocks, float(eps),
                 int(x.dtype == torch.bfloat16))
    return dx, dgamma, dbeta


def layer_norm_bwd_residual_kernel(x, dy, gamma, res, eps: float = 1e-6):
    """``(dx, dgamma, dbeta)`` of the residual form from the B4 backward
    kernel (what :func:`layer_norm_bwd_residual_reference` returns); CUDA
    tensors only, dy f32, res in x's dtype."""
    _check_cuda(LAYER_NORM_BWD, x, (gamma,))
    for t, dtype, what in ((dy, torch.float32, "dy"), (res, x.dtype, "res")):
        if t.shape != x.shape or t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{LAYER_NORM_BWD}: {what} must be a contiguous {tuple(x.shape)} {dtype} tensor")
    m, c = x.shape
    dx = torch.empty_like(x)
    dgamma = torch.empty((c,), dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    if m == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    blocks = min(m, _BWD_BLOCKS_PER_SM * build.sm_count(x.device))
    partial = torch.empty((2, blocks, c), dtype=torch.float32, device=x.device)
    build.launch(LAUNCHES, LAYER_NORM_BWD, build.load_library().edrl_layer_norm_bwd_residual, x.device,
                 x.data_ptr(), dy.data_ptr(), res.data_ptr(), gamma.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
                 dbeta.data_ptr(), partial.data_ptr(), m, c, blocks, float(eps), int(x.dtype == torch.bfloat16))
    return dx, dgamma, dbeta


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_reference(x, gamma, beta, eps)
        return layer_norm_fwd_kernel(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            dx, dgamma, dbeta = layer_norm_bwd_reference(x, dy, gamma, ctx.eps)
        else:
            dx, dgamma, dbeta = layer_norm_bwd_kernel(x, dy, gamma, ctx.eps)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def fused_layer_norm(x, gamma, beta, eps: float = 1e-6):
    """Row LayerNorm of ``x [M, C]`` (bf16 or f32) with f32 ``gamma``/``beta``
    ``[C]``, differentiable; the result has x's dtype.  CPU tensors take the
    plain versions, CUDA tensors the kernels."""
    if x.dim() != 2:
        raise ValueError(f"{LAYER_NORM}: x must be [M, C], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{LAYER_NORM}: no kernel for device {x.device}")
    if x.device.type == "cuda":
        x = x.contiguous()
    return _FusedLayerNorm.apply(x, gamma, beta, eps)

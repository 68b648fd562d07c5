"""Fused LayerNorm on the H100 (B4), forward and backward, with plain versions.

Counterpart of ``edrl_tpu/kernels/layer_norm.py`` (``fused_layer_norm``):
row LayerNorm over ``x [M, C]`` with f32 statistics, eps 1e-6, f32 gamma and
beta, the result in x's dtype.  CUDA sources ``csrc/layer_norm_fwd.cu`` and
``csrc/layer_norm_bwd.cu``; the kernels take C a multiple of 128 up to 2048.
The C side plans every launch (``ln_plan`` in ``csrc/layer_norm.cuh``, entry
point ``edrl_layer_norm_plan``); :func:`layer_norm_plan` mirrors it to size
the backward's partials, and the C side refuses a count that is not its own.

:func:`fused_layer_norm` is a ``torch.autograd.Function``: the forward saves
x and gamma, the backward recomputes the statistics, as the JAX VJP does.  A
CPU tensor takes the plain versions (:func:`layer_norm_reference`,
:func:`layer_norm_bwd_reference`); a CUDA tensor launches the kernels or
raises.  Each kernel wrapper counts its launches in :data:`LAUNCHES`.  The
forward is also the operator ``torch.ops.edrl_tpu_torch.layer_norm_fwd``
(:func:`layer_norm_fwd`; ``window_attention`` says why).

The backward also has a residual form (:func:`layer_norm_bwd_residual_kernel`,
:func:`layer_norm_bwd_residual_reference`), the LayerNorm part of the fused
attention sublayer's backward (``_v4_bwd``): an f32 cotangent, and a
residual cotangent in x's dtype that is added to dx in f32 before dx is
rounded once.  It counts under the backward's name.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from edrl_tpu_torch.kernels import build

LAYER_NORM = "fused_layer_norm"
LAYER_NORM_BWD = "fused_layer_norm_bwd"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {LAYER_NORM: 0, LAYER_NORM_BWD: 0}
MAX_C = 2048
KINDS = ("forward", "backward", "residual")  # the C side's kind 0, 1, 2
# csrc/layer_norm.cuh: threads a CTA aims at (its row groups: threads // G),
# resident threads per SM the kernels are built for, and the partials' share.
_CTA_THREADS = {"forward": 256, "backward": 512, "residual": 512}
_RESIDENT_THREADS, _RESIDENT_THREADS_WIDE = 1024, 512
_MAX_CTAS_PER_SM = 4  # the occupancy calculator's most for a CTA with static shared memory
_PARTIAL_SHARE = 10


class LayerNormPlan(NamedTuple):
    """A call's launch: G threads per row, R row groups per CTA, the
    persistent grid's CTAs, and the backward's rows of dgamma/dbeta
    partials (one per CTA; 0 in the forward)."""

    threads_per_row: int
    rows_per_cta: int
    ctas: int
    partials: int


def _row_bytes(dtype, kind: str) -> int:
    """Bytes per element of a call's rows: x and y; x, dy and dx; x, dy
    (f32), res and dx."""
    e = 2 if dtype == torch.bfloat16 else 4
    return {"forward": 2 * e, "backward": 3 * e, "residual": 3 * e + 4}[kind]


@functools.lru_cache(maxsize=None)
def layer_norm_plan(m: int, c: int, dtype, sm_count: int, kind: str) -> LayerNormPlan:
    """The kernels' launch for ``x [m, c]`` of ``dtype`` on a card of
    ``sm_count`` SMs; ``kind`` is ``"forward"``, ``"backward"`` or
    ``"residual"`` (the backward's residual form).

    A row group of G = C / 8 threads owns a row (C / 4 where C / 128 is odd
    and at least 3, so a group is half a warp or whole warps); a CTA runs R =
    max(1, T // G) row groups (T = 256 forward, 512 backward).  The forward
    launches one persistent wave: SMs x min(4, 1024 // (R G)) CTAs.  The backward
    writes one partial row of dgamma and dbeta per CTA, so it launches as
    many whole waves (at most 1024 resident threads per SM for a bf16 call,
    512 for an f32 one and for the residual form) as keep the partials'
    bytes, 16 P C written and read, within a tenth of the call's bytes of
    x, dy (res) and dx; with fewer rows than that for one wave, that many
    CTAs, at least one.  No grid exceeds the row groups ceil(m / R).

    Mirrors ``ln_plan`` in ``csrc/layer_norm.cuh`` (``edrl_layer_norm_plan``).
    """
    if c % 128 or not 128 <= c <= MAX_C:
        raise ValueError(f"{LAYER_NORM}: the kernel takes C a multiple of 128 up to {MAX_C}, got {c}")
    if m < 1 or sm_count < 1 or kind not in KINDS:
        raise ValueError(f"{LAYER_NORM}: no plan for m={m}, sm_count={sm_count}, kind={kind!r}")
    ept = 8 if c // 128 == 1 or (c // 128) % 2 == 0 else 4
    group = c // ept
    rows = max(1, _CTA_THREADS[kind] // group)
    wide = kind == "residual" or (kind == "backward" and dtype != torch.bfloat16)
    waves = min(_MAX_CTAS_PER_SM, max(1, (_RESIDENT_THREADS_WIDE if wide else _RESIDENT_THREADS) // (rows * group)))
    ctas = waves * sm_count
    if kind != "forward":
        most = m * _row_bytes(dtype, kind) // (16 * _PARTIAL_SHARE)
        k = min(most // sm_count, waves)
        ctas = k * sm_count if k >= 1 else max(most, 1)
    ctas = min(ctas, -(-m // rows))
    return LayerNormPlan(group, rows, ctas, 0 if kind == "forward" else ctas)


def partial_bytes(plan: LayerNormPlan, c: int) -> int:
    """Bytes of the backward's dgamma/dbeta partials, written once and read once."""
    return 2 * 2 * 4 * plan.partials * c


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
    if c % 128 or not 128 <= c <= MAX_C:
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
    x, gamma, beta = map(build.aligned16, (x, gamma, beta))
    build.launch(LAUNCHES, LAYER_NORM, build.load_library().edrl_layer_norm_fwd, x.device,
                 x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), m, c, float(eps),
                 int(x.dtype == torch.bfloat16))
    return y


def _bwd_kernel(x, dy, res, gamma, eps):
    """Launch the backward (the residual form where res is given):
    ``(dx, dgamma, dbeta)``, dgamma and dbeta the rows of one ``[2, C]``
    tensor.  Two launches: the row kernel, then the partials' column sums."""
    m, c = x.shape
    dx = torch.empty_like(x)
    dgb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    if m == 0:
        dgb.zero_()
        return dx, dgb[0], dgb[1]
    x, dy, res, gamma = map(build.aligned16, (x, dy, res, gamma))
    kind = "backward" if res is None else "residual"
    plan = layer_norm_plan(m, c, x.dtype, build.sm_count(x.device), kind)
    partial = torch.empty((2, plan.partials, c), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    head = (x.data_ptr(), dy.data_ptr()) if res is None else (x.data_ptr(), dy.data_ptr(), res.data_ptr())
    build.launch(LAUNCHES, LAYER_NORM_BWD,
                 lib.edrl_layer_norm_bwd if res is None else lib.edrl_layer_norm_bwd_residual, x.device,
                 *head, gamma.data_ptr(), dx.data_ptr(), dgb.data_ptr(), partial.data_ptr(), m, c, plan.partials,
                 float(eps), int(x.dtype == torch.bfloat16))
    return dx, dgb[0], dgb[1]


def layer_norm_bwd_kernel(x, dy, gamma, eps: float = 1e-6):
    """``(dx, dgamma, dbeta)`` from the B4 backward kernel; CUDA tensors only."""
    _check_cuda(LAYER_NORM_BWD, x, (gamma,))
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"{LAYER_NORM_BWD}: dy must be a contiguous {tuple(x.shape)} {x.dtype} tensor")
    return _bwd_kernel(x, dy, None, gamma, eps)


def layer_norm_bwd_residual_kernel(x, dy, gamma, res, eps: float = 1e-6):
    """``(dx, dgamma, dbeta)`` of the residual form from the B4 backward
    kernel (what :func:`layer_norm_bwd_residual_reference` returns); CUDA
    tensors only, dy f32, res in x's dtype."""
    _check_cuda(LAYER_NORM_BWD, x, (gamma,))
    for t, dtype, what in ((dy, torch.float32, "dy"), (res, x.dtype, "res")):
        if t.shape != x.shape or t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{LAYER_NORM_BWD}: {what} must be a contiguous {tuple(x.shape)} {dtype} tensor")
    return _bwd_kernel(x, dy, res, gamma, eps)


@torch.library.custom_op(f"{build.OP_NAMESPACE}::layer_norm_fwd", mutates_args=(), device_types="cuda",
                         schema="(Tensor x, Tensor gamma, Tensor beta, float eps) -> Tensor")
def layer_norm_fwd(x, gamma, beta, eps):
    """B4's forward as an operator (``window_attention.self_attention_fwd``
    says why)."""
    return layer_norm_fwd_kernel(x, gamma, beta, eps)


@layer_norm_fwd.register_kernel("cpu")
def _(x, gamma, beta, eps):
    return layer_norm_reference(x, gamma, beta, eps)


layer_norm_fwd.register_fake(lambda x, gamma, beta, eps: torch.empty_like(x))


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layer_norm_fwd(x, gamma, beta, eps)

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
    if not build.needs_grad(x, gamma, beta):
        return layer_norm_fwd(x, gamma, beta, eps)
    return _FusedLayerNorm.apply(x, gamma, beta, eps)

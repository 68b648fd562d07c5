"""Fused transformer MLP on the H100 (B5), forward and backward, with plain versions.

Counterpart of ``edrl_tpu/kernels/fused_mlp.py`` (``fused_mlp``):
``gelu_tanh(u . bf16(w1) + b1)``, rounded to bf16, ``. bf16(w2) + b2`` over
``u [M, C]`` (bf16 or f32) with ``w1 [C, H]``, ``b1 [H]``, ``w2 [H, C]``,
``b2 [C]``; the result has u's dtype.  CUDA sources ``csrc/fused_mlp_fwd.cu``
and ``csrc/fused_mlp_bwd.cu``; the kernels take C a multiple of 128 up to
1024 and H a multiple of 128.

The plain versions copy the Pallas kernel's rounding, not ``mlp_reference``'s
and not the port's unfused ``Mlp``'s: u keeps its dtype (an f32 u is not
rounded), the weights and the activation are rounded to bf16, b1 and b2 are
added in f32, and the backward rounds dy and dh to bf16 where the kernel
does.  :func:`fused_mlp` is a ``torch.autograd.Function`` that saves
``(u, w1, b1, w2)``, not the hidden, as the JAX VJP does.  A CPU tensor takes
the plain versions; a CUDA tensor launches the kernels or raises.  Each
kernel wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

from edrl_tpu_torch.kernels import build

FUSED_MLP = "fused_mlp"
FUSED_MLP_BWD = "fused_mlp_bwd"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {FUSED_MLP: 0, FUSED_MLP_BWD: 0}
MAX_C = 1024
_ROW_TILE = 128  # rows per block of the backward's row kernels (csrc/fused_mlp_bwd.cu)
_WGRAD_BLOCKS_PER_SM = 4  # the weight-gradient grid: at least this many blocks per SM
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions, with the Pallas kernel's rounding.
# ---------------------------------------------------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)))


def _gelu_grad(x):
    x2 = x * x
    t = torch.tanh(_SQRT_2_OVER_PI * (x + _GELU_C * x * x2))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * x2)


def fused_mlp_reference(u, w1, b1, w2, b2):
    """The Pallas forward's function: ``[M, C]`` in u's dtype."""
    hidden = u.float() @ _bf16(w1) + b1.float()
    y = _bf16(_gelu(hidden)) @ _bf16(w2) + b2.float()
    return y.to(u.dtype)


def fused_mlp_bwd_reference(u, dy, w1, b1, w2):
    """The Pallas backward's function: ``(du, dw1, db1, dw2, db2)``; du in u's
    dtype, the rest f32."""
    uf, dyf = u.float(), dy.float()
    w1b = _bf16(w1)
    hidden = uf @ w1b + b1.float()
    dh = (_bf16(dyf) @ _bf16(w2).T) * _gelu_grad(hidden)
    dhb = _bf16(dh)
    du = (dhb @ w1b.T).to(u.dtype)
    return du, uf.T @ dhb, dh.sum(dim=0), _bf16(_gelu(hidden)).T @ _bf16(dyf), dyf.sum(dim=0)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _check_cuda(name: str, u, w1, b1, w2, b2=None) -> tuple:
    """Validate what the kernels take; returns ``(m, c, h)``."""
    if u.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {u.device}")
    if u.dim() != 2 or not u.is_contiguous() or u.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: u must be a contiguous 2-D bfloat16 or float32 tensor, "
                         f"got {tuple(u.shape)} {u.dtype}")
    m, c = u.shape
    h = w1.shape[-1] if w1.dim() == 2 else -1
    if c % 128 or c > MAX_C or h <= 0 or h % 128:
        raise ValueError(f"{name}: the kernel takes C a multiple of 128 up to {MAX_C} and H a "
                         f"multiple of 128, got C={c}, H={h}")
    for w, shape in ((w1, (c, h)), (w2, (h, c))):
        if (tuple(w.shape) != shape or w.dtype not in (torch.bfloat16, torch.float32)
                or w.dtype != w1.dtype or w.device != u.device or not w.is_contiguous()):
            raise ValueError(f"{name}: w1 [C, H] and w2 [H, C] must be contiguous, of one dtype "
                             f"(float32 or bfloat16), on {u.device}; got {tuple(w1.shape)} "
                             f"{w1.dtype}, {tuple(w2.shape)} {w2.dtype}")
    for b, n in ((b1, h), (b2, c)):
        if b is not None and (tuple(b.shape) != (n,) or b.dtype != torch.float32
                              or b.device != u.device or not b.is_contiguous()):
            raise ValueError(f"{name}: b1 [H] and b2 [C] must be contiguous float32 on {u.device}")
    return m, c, h


def fused_mlp_fwd_kernel(u, w1, b1, w2, b2):
    """The B5 forward kernel's ``[M, C]`` result; CUDA tensors only."""
    m, c, h = _check_cuda(FUSED_MLP, u, w1, b1, w2, b2)
    y = torch.empty_like(u)
    if m == 0:
        return y
    bf16 = dict(dtype=torch.bfloat16, device=u.device)
    w1t, w2t = torch.empty((h, c), **bf16), torch.empty((c, h), **bf16)
    build.launch(LAUNCHES, FUSED_MLP, build.load_library().edrl_fused_mlp_fwd, u.device,
                 u.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 y.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), m, c, h,
                 int(u.dtype == torch.bfloat16), int(w1.dtype == torch.bfloat16))
    return y


def _wgrad_splits(m: int, c: int, h: int, sms: int) -> tuple:
    """``(splits, chunk)``: the weight-gradient products split M so that
    their grid of 128 x 128 tiles has at least 4 blocks per SM, in chunks
    of at least 256 rows (a multiple of 32)."""
    tiles = (c // 128) * (h // 128)
    splits = max(1, min(-(-_WGRAD_BLOCKS_PER_SM * sms // tiles), -(-m // 256)))
    chunk = -(-(-(-m // splits)) // 32) * 32
    return -(-m // chunk), chunk


def fused_mlp_bwd_kernel(u, dy, w1, b1, w2):
    """``(du, dw1, db1, dw2, db2)`` from the B5 backward kernels; CUDA tensors only."""
    m, c, h = _check_cuda(FUSED_MLP_BWD, u, w1, b1, w2)
    if dy.shape != u.shape or dy.dtype != u.dtype or dy.device != u.device or not dy.is_contiguous():
        raise ValueError(f"{FUSED_MLP_BWD}: dy must be a contiguous {tuple(u.shape)} {u.dtype} tensor")
    f32 = dict(dtype=torch.float32, device=u.device)
    bf16 = dict(dtype=torch.bfloat16, device=u.device)
    du = torch.empty_like(u)
    dw1, dw2 = torch.empty((c, h), **f32), torch.empty((h, c), **f32)
    db1, db2 = torch.empty((h,), **f32), torch.empty((c,), **f32)
    if m == 0:
        return du, dw1.zero_(), db1.zero_(), dw2.zero_(), db2.zero_()
    splits, chunk = _wgrad_splits(m, c, h, build.sm_count(u.device))
    tiles = -(-m // _ROW_TILE)
    w_f32 = w1.dtype == torch.float32
    w1t = torch.empty((h, c), **bf16)
    w1b = torch.empty((c, h), **bf16) if w_f32 else None
    w2b = torch.empty((h, c), **bf16) if w_f32 else None
    dh, act = torch.empty((m, h), **bf16), torch.empty((m, h), **bf16)
    db1_part, db2_part = torch.empty((tiles, h), **f32), torch.empty((tiles, c), **f32)
    dw1_part = torch.empty((splits, c, h), **f32) if splits > 1 else None
    dw2_part = torch.empty((splits, h, c), **f32) if splits > 1 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch(LAUNCHES, FUSED_MLP_BWD, build.load_library().edrl_fused_mlp_bwd, u.device,
                 *map(ptr, (u, dy, w1, b1, w2, du, dw1, db1, dw2, db2, w1t, w1b, w2b, dh, act,
                            db1_part, db2_part, dw1_part, dw2_part)),
                 m, c, h, splits, chunk, int(u.dtype == torch.bfloat16), int(not w_f32))
    return du, dw1, db1, dw2, db2


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, w1, b1, w2, b2):
        ctx.save_for_backward(u, w1, b1, w2)
        ctx.b2_dtype = b2.dtype
        if u.device.type == "cpu":
            return fused_mlp_reference(u, w1, b1, w2, b2)
        return fused_mlp_fwd_kernel(u, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        u, w1, b1, w2 = ctx.saved_tensors
        dy = dy.to(u.dtype).contiguous()
        if u.device.type == "cpu":
            du, dw1, db1, dw2, db2 = fused_mlp_bwd_reference(u, dy, w1, b1, w2)
        else:
            du, dw1, db1, dw2, db2 = fused_mlp_bwd_kernel(u, dy, w1, b1, w2)
        return du, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype)


def fused_mlp(u, w1, b1, w2, b2):
    """``gelu(u . w1 + b1) . w2 + b2`` over ``u [M, C]`` with the hidden kept
    on chip, differentiable; the result has u's dtype.  CPU tensors take the
    plain versions, CUDA tensors the kernels."""
    if u.dim() != 2 or w1.dim() != 2 or u.shape[1] != w1.shape[0]:
        raise ValueError(f"{FUSED_MLP}: u must be [M, C] and w1 [C, H], got {tuple(u.shape)}, "
                         f"{tuple(w1.shape)}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{FUSED_MLP}: no kernel for device {u.device}")
    if u.device.type == "cuda":
        u = u.contiguous()
    return _FusedMlp.apply(u, w1, b1, w2, b2)


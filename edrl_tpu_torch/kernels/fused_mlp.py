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

The kernels take one of two routes, forward and backward alike, chosen in
the C entry points from u's dtype and mirrored by :func:`fused_mlp_route`:
``"wgmma"`` for bf16 u (Hopper's warpgroup MMA fed by TMA,
``csrc/hopper_gemm.cuh``) and ``"mma"`` for f32 u (``mma.sync``, the
correctness-check mode).  Each launch also counts under its route in
:data:`MLP_ROUTES`.
"""

from __future__ import annotations

import functools

import torch

from edrl_tpu_torch.kernels import build

FUSED_MLP = "fused_mlp"
FUSED_MLP_BWD = "fused_mlp_bwd"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {FUSED_MLP: 0, FUSED_MLP_BWD: 0}
# Forward and backward launches since the last reset, by route.
MLP_ROUTES = {"wgmma": 0, "mma": 0}
MAX_C = 1024
_ROW_TILE = 128  # rows per block of the backward's row kernels (csrc/fused_mlp_bwd.cu)
_DB2_ROWS = 64  # rows per partial of db2 on the wgmma route
_WGRAD_BLOCKS_PER_SM = 4  # the mma route's weight-gradient grid: at least this many blocks per SM
# The wgmma route's weight gradients (csrc/hopper_gemm.cuh): 128 x 128 tiles,
# 2 CTAs per SM, 64 rows of M per ring stage.  The split planner's cost model
# (tuned on an H100): ~0.85 us per CTA stage with two CTAs on an SM, and the
# split partials moving at ~3 TB/s.
_WGMMA_CTAS_PER_SM = 2
_WGRAD_SLICE = 64
_WGRAD_STAGE_US = 0.85
_PARTIAL_BYTES_PER_US = 3.0e6
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, MLP_ROUTES):
        for name in counts:
            counts[name] = 0


def fused_mlp_route(dtype, c: int, h: int):
    """The kernels' route for a call, forward and backward: ``"wgmma"`` for
    bf16 u, ``"mma"`` for f32 u, ``None`` where the kernels refuse the
    dtype or the shape (C a multiple of 128 up to 1024, H a multiple of 128).

    Mirrors ``edrl_fused_mlp_route`` in ``csrc/fused_mlp_fwd.cu``, which picks
    the route before the launch.
    """
    if c % 128 or not 128 <= c <= MAX_C or h % 128 or h < 128:
        return None
    return {torch.bfloat16: "wgmma", torch.float32: "mma"}.get(dtype)


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


def _launch(name: str, route: str, fn, device, *args) -> None:
    build.launch(LAUNCHES, name, fn, device, *args)
    MLP_ROUTES[route] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_mlp_fwd_kernel(u, w1, b1, w2, b2):
    """The B5 forward kernels' ``[M, C]`` result; CUDA tensors only."""
    m, c, h = _check_cuda(FUSED_MLP, u, w1, b1, w2, b2)
    y = torch.empty_like(u)
    if m == 0:
        return y
    route = fused_mlp_route(u.dtype, c, h)
    u, w1, w2 = map(build.aligned16, (u, w1, w2))
    bf16 = dict(dtype=torch.bfloat16, device=u.device)
    w_bf16 = w1.dtype == torch.bfloat16
    if route == "wgmma":  # bf16 copies of f32 weights, and the activation
        wa = None if w_bf16 else torch.empty((c, h), **bf16)
        wb = None if w_bf16 else torch.empty((h, c), **bf16)
        act = torch.empty((m, h), **bf16)
    else:  # transposed bf16 weights
        wa, wb, act = torch.empty((h, c), **bf16), torch.empty((c, h), **bf16), None
    _launch(FUSED_MLP, route, build.load_library().edrl_fused_mlp_fwd, u.device,
            *map(_ptr, (u, w1, b1, w2, b2, y, wa, wb, act)), m, c, h,
            int(u.dtype == torch.bfloat16), int(w_bf16))
    return y


def _wgrad_splits(m: int, c: int, h: int, sms: int) -> tuple:
    """``(splits, chunk)`` of the mma route: the weight-gradient products
    split M so that their grid of 128 x 128 tiles has at least 4 blocks per
    SM, in chunks of at least 256 rows (a multiple of 32)."""
    tiles = (c // 128) * (h // 128)
    splits = max(1, min(-(-_WGRAD_BLOCKS_PER_SM * sms // tiles), -(-m // 256)))
    chunk = -(-(-(-m // splits)) // 32) * 32
    return -(-m // chunk), chunk


@functools.lru_cache(maxsize=256)
def wgmma_wgrad_splits(m: int, c: int, h: int, sms: int) -> tuple:
    """``(splits, chunk)`` of the wgmma route's weight gradients.

    Each of ``splits`` splits of M (``chunk`` rows, a multiple of 64, at
    least 256 unless M is smaller) runs the (C / 128) x (H / 128) output
    tiles; the persistent grid holds 2 CTAs per SM, so the products take
    about ceil(tiles * splits / (2 * sms)) * chunk / 64 ring stages, and
    splits > 1 add (2 * splits + 1) * C * H * 4 bytes of partials to write,
    read and sum.  Returns the split with the least estimated time (of
    equal times, the fewest splits).  Cached: a step repeats its shapes, and
    the search over up to 1024 candidates would cost the host ~1 ms a call.
    """
    tiles = (c // 128) * (h // 128)
    slots = _WGMMA_CTAS_PER_SM * sms
    best = None
    for want in range(1, min(max(1, m // 256), 1024) + 1):
        chunk = -(-(-(-m // want)) // _WGRAD_SLICE) * _WGRAD_SLICE
        splits = -(-m // chunk)
        est = -(-tiles * splits // slots) * (chunk // _WGRAD_SLICE) * _WGRAD_STAGE_US
        if splits > 1:
            est += (2 * splits + 1) * c * h * 4 / _PARTIAL_BYTES_PER_US
        if best is None or (est, splits) < best[0]:
            best = ((est, splits), splits, chunk)
    return best[1], best[2]


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
    route = fused_mlp_route(u.dtype, c, h)
    u, dy, w1, w2 = map(build.aligned16, (u, dy, w1, w2))
    plan = wgmma_wgrad_splits if route == "wgmma" else _wgrad_splits
    splits, chunk = plan(m, c, h, build.sm_count(u.device))
    tiles = -(-m // _ROW_TILE)
    w_f32 = w1.dtype == torch.float32
    w1t = torch.empty((h, c), **bf16) if route == "mma" else None
    w1b = torch.empty((c, h), **bf16) if w_f32 else None
    w2b = torch.empty((h, c), **bf16) if w_f32 else None
    dh, act = torch.empty((m, h), **bf16), torch.empty((m, h), **bf16)
    db2_rows = -(-m // _DB2_ROWS) if route == "wgmma" else tiles
    db1_part, db2_part = torch.empty((tiles, h), **f32), torch.empty((db2_rows, c), **f32)
    dw1_part = torch.empty((splits, c, h), **f32) if splits > 1 else None
    dw2_part = torch.empty((splits, h, c), **f32) if splits > 1 else None
    _launch(FUSED_MLP_BWD, route, build.load_library().edrl_fused_mlp_bwd, u.device,
            *map(_ptr, (u, dy, w1, b1, w2, du, dw1, db1, dw2, db2, w1t, w1b, w2b, dh, act,
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


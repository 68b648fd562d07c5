"""Fused attention on the H100, forward and backward, with plain PyTorch versions.

Counterparts of three Pallas kernels of ``edrl_tpu/kernels/window_attention.py``:

- :func:`self_attention_fused` (B1): per head softmax(q k^T * scale) v over
  three ``[B, N, C]`` tensors with the heads packed in columns, as the ViT-3D
  q/k/v projections emit them.  CUDA sources: ``csrc/self_attention_fwd.cu``
  and ``csrc/self_attention_bwd.cu``.
- :func:`window_attention_fused_v2` (B2): per (batch, window, head)
  softmax(q k^T * scale + bias) v read from the packed qkv ``[B, W, N, 3C]``
  with a ``[W, H, N, N]`` f32 bias.  CUDA sources:
  ``csrc/window_attention_v2_fwd.cu`` and ``csrc/window_attention_v2_bwd.cu``.
- :func:`window_attention_fused` (v1): B2's function in the ``[B, W, H, N,
  D]`` layout, with q pre-scaled and no scale applied inside (dq is then
  unscaled and dk takes the pre-scaled q, as the v1 Pallas backward computes
  them).  No model calls it.  The same CUDA entry points as B2's, which
  address every operand through the (group, head, row) strides the wrapper
  passes (:func:`attention_strides`), so v1's layout is read and written in
  place.

Each is a ``torch.autograd.Function``: the forward saves its inputs (not the
probabilities) and the backward recomputes them, as the JAX VJPs do.  A CPU
tensor takes the plain versions beside each kernel, forward
(:func:`self_attention_reference`, :func:`window_attention_v2_reference`) and
backward (:func:`self_attention_bwd_reference`,
:func:`window_attention_v2_bwd_reference`); a CUDA tensor launches the
hand-written kernels or raises.

B1's and B2's forwards are also operators, ``torch.ops.edrl_tpu_torch.
self_attention_fwd`` and ``window_attention_v2_fwd`` (:func:`self_attention_fwd`,
:func:`window_attention_v2_fwd`): the kernel for CUDA tensors, the plain
version for CPU ones, shapes alone under tracing, so that ``torch.export``
keeps the kernels in a program (``serve.export``).  The autograd Functions'
forwards call them, and a call that autograd does not record calls them
alone.

Each kernel wrapper counts its launches in :data:`LAUNCHES`, so that a run
can show that its main path went through the kernels.  The forward and the
backward kernels each take one of two routes, chosen from the dtype and
shape in the C entry points and mirrored by :func:`attention_fwd_route` and
:func:`attention_bwd_route`.  bf16 with head_dim % 16 == 0 and N <= 224
takes the tensor cores: the forward's ``"wgmma"`` (TMA loads through 4-D
tensor maps over (column, head, token, group), ``wgmma`` products) and the
backward's ``"mma"`` (``mma.sync``); f32 and the other bf16 shapes take
``"fma"`` (CUDA cores).
Each forward launch also counts under its route in :data:`FWD_ROUTES` (the
fused attention sublayer's attention phase and v1's included), each
backward launch in :data:`BWD_ROUTES`.  Under tensor parallelism
(``parallel.tensor``) a model names the route its attention takes over the
model axis (:func:`tensor_parallel_route`: ``"head_local"``, each rank its
H/M heads, or ``"gathered"``, every rank all heads), and each B1 and B2
launch, forward and backward, also counts under it in :data:`TP_ROUTES`.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes

import torch

from edrl_tpu_torch.kernels import build

SELF_ATTENTION = "self_attention_fused"
WINDOW_ATTENTION_V2 = "window_attention_fused_v2"
SELF_ATTENTION_BWD = "self_attention_fused_bwd"
WINDOW_ATTENTION_V2_BWD = "window_attention_fused_v2_bwd"
WINDOW_ATTENTION_V1 = "window_attention_fused"
WINDOW_ATTENTION_V1_BWD = "window_attention_fused_bwd"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {SELF_ATTENTION: 0, WINDOW_ATTENTION_V2: 0, SELF_ATTENTION_BWD: 0, WINDOW_ATTENTION_V2_BWD: 0,
            WINDOW_ATTENTION_V1: 0, WINDOW_ATTENTION_V1_BWD: 0}
# Forward launches (B1, B2, v1 and B6's attention phase) and backward
# launches (B1, B2 and v1) since the last reset, by route.
FWD_ROUTES = {"wgmma": 0, "fma": 0}
BWD_ROUTES = {"mma": 0, "fma": 0}
# B1's and B2's launches under tensor parallelism, by "<wrapper name>/<route>".
TP_ROUTE_NAMES = ("head_local", "gathered")
TP_ROUTES = {f"{name}/{route}": 0 for name in (SELF_ATTENTION, SELF_ATTENTION_BWD, WINDOW_ATTENTION_V2,
                                               WINDOW_ATTENTION_V2_BWD) for route in TP_ROUTE_NAMES}
_TP_ROUTE: contextvars.ContextVar = contextvars.ContextVar("edrl_tpu_torch_tp_route", default=None)
MAX_HEAD_DIM = 128
MAX_BWD_TOKENS = 256  # the CUDA-core backward keeps [32, N] f32 score rows per block in shared memory
MMA_MAX_TOKENS = 224  # the tensor-core routes, forward (wgmma) and backward (mma), take the same calls
_SMEM_LIMIT = 232448 - 4 * 64  # opt-in per-block limit, less the 64 static f32 row sums
_BWD_QUERY_TILE = {"mma": 64, "fma": 32}  # queries per dq block of each route
_DQ_BLOCKS_PER_SM: dict = {}  # (device index, dtype, n, d) -> resident dq blocks per SM with dbias


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, FWD_ROUTES, BWD_ROUTES, TP_ROUTES):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def tensor_parallel_route(route):
    """Count the B1 and B2 launches made inside (and in the backward of the
    calls made inside) under ``route`` in :data:`TP_ROUTES`; ``None``
    counts nothing there."""
    if route is not None and route not in TP_ROUTE_NAMES:
        raise ValueError(f"no tensor-parallel route {route!r}")
    token = _TP_ROUTE.set(route)
    try:
        yield
    finally:
        _TP_ROUTE.reset(token)


def _count_tp_route(name: str) -> None:
    route = _TP_ROUTE.get()
    key = f"{name}/{route}"
    if route is not None and key in TP_ROUTES:
        TP_ROUTES[key] += 1


def _tensor_cores(dtype, n: int, d: int) -> bool:
    return dtype == torch.bfloat16 and d % 16 == 0 and n <= MMA_MAX_TOKENS


def attention_fwd_route(dtype, n: int, d: int) -> str:
    """The forward kernel's route for a call: ``"wgmma"`` (TMA and ``wgmma``
    on the tensor cores) for bf16 with head_dim % 16 == 0 and N <= 224, else
    ``"fma"`` (CUDA cores).

    Mirrors ``attention_fwd_route_wgmma`` in ``csrc/attention_fwd.cuh``,
    which picks the route before the launch (``edrl_attention_fwd_route``
    exposes it).  Shapes the kernels refuse altogether (head_dim % 8) are
    checked elsewhere.
    """
    return "wgmma" if _tensor_cores(dtype, n, d) else "fma"


def attention_bwd_route(dtype, n: int, d: int) -> str:
    """The backward kernels' route for a call: ``"mma"`` (``mma.sync`` on the
    tensor cores) for the calls whose forward takes ``"wgmma"``, else
    ``"fma"``.

    Mirrors ``attention_bwd_route_mma`` in ``csrc/attention_bwd.cuh``, which
    picks the route before the launch (``edrl_attention_bwd_route`` exposes
    it).  Shapes the kernels refuse altogether (head_dim % 8, N > 256) are
    checked elsewhere.
    """
    return "mma" if _tensor_cores(dtype, n, d) else "fma"


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


def window_attention_reference(q, k, v, bias):
    """softmax(q k^T + bias) v per (batch, window, head), q pre-scaled (v1).

    q, k, v ``[B, W, H, N, D]``; bias ``[W, H, N, N]`` f32.  Returns
    ``[B, W, H, N, D]`` in q's dtype.
    """
    s = torch.einsum("bwhnd,bwhmd->bwhnm", q.float(), k.float()) + bias.float()[None]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bwhnm,bwhmd->bwhnd", p, v.float()).to(q.dtype)


def window_attention_bwd_reference(q, k, v, bias, dout):
    """Backward of :func:`window_attention_reference`: ``(dq, dk, dv, dbias)``.

    dq, dk, dv ``[B, W, H, N, D]`` in q's dtype, dq unscaled and dk from the
    pre-scaled q; dbias ``[W, H, N, N]`` f32, summed over the batch.
    """
    heads_last = [t.float().transpose(2, 3) for t in (q, k, v, dout)]  # [B, W, N, H, D]
    dq, dk, dv, ds = _attention_bwd_math(*heads_last[:3], heads_last[3], bias.float()[None], 1.0)
    return (*(t.transpose(2, 3).to(q.dtype) for t in (dq, dk, dv)), ds.sum(dim=0))


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


def _aligned_operands(route: str, tensors):
    """A kernel's inputs as its route takes them: the tensor-core routes
    read rows by TMA (forward) or 16-byte copies (backward), so a view that
    starts off a 16-byte boundary is copied (a fresh allocation is
    aligned)."""
    if route == "fma":
        return tuple(tensors)
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors)


def _launch_fwd(name: str, route: str, fn, device, *args) -> None:
    build.launch(LAUNCHES, name, fn, device, *args)
    FWD_ROUTES[route] += 1
    _count_tp_route(name)


def _launch_bwd(name: str, route: str, fn, device, *args) -> None:
    build.launch(LAUNCHES, name, fn, device, *args)
    BWD_ROUTES[route] += 1
    _count_tp_route(name)


def _fwd_smem(lib, dtype, n: int, d: int, with_bias: bool) -> int:
    return lib.edrl_attention_fwd_smem_bytes(int(dtype == torch.bfloat16), n, d, int(with_bias))


def dbias_chunking(b: int, base: int, slots: int) -> tuple[int, int]:
    """``(batch entries per dq block, chunks)`` for the B2 backward's dbias.

    A dq block walks over its chunk of the batch one entry after another and
    writes the chunk's partial dbias; ``base`` blocks (query tiles x windows
    x heads) take each chunk, and ``slots`` blocks fit on the card at once.
    The kernel then takes about ceil(base * chunks / slots) * per_block
    entries' time: the smallest such time, and of those the fewest chunks
    (the fewest partials to add).
    """
    best = None
    for per_block in range(1, b + 1):
        chunks = -(-b // per_block)
        key = (-(-base * chunks // slots) * per_block, chunks)
        if best is None or key < best[0]:
            best = (key, per_block, chunks)
    return best[1], best[2]


def _dq_blocks_per_sm(lib, device, dtype, n: int, d: int) -> int:
    """Resident blocks per SM of the dq kernel with dbias, from the card's
    occupancy calculator (cached)."""
    key = (device.index, dtype, n, d)
    if key not in _DQ_BLOCKS_PER_SM:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(device):
            err = lib.edrl_attention_bwd_occupancy(int(dtype == torch.bfloat16), n, d, 1, out)
        if err != 0 or out[0] < 1:
            raise RuntimeError(f"{WINDOW_ATTENTION_V2_BWD}: occupancy query failed with CUDA error {err}")
        _DQ_BLOCKS_PER_SM[key] = out[0]
    return _DQ_BLOCKS_PER_SM[key]


# -- B1 ----------------------------------------------------------------------


def _self_attention_fwd_kernel(q, k, v, num_heads: int, scale: float):
    b, n, c = q.shape
    d = _check_cuda_inputs(SELF_ATTENTION, (q, k, v), num_heads, c, n)
    lib = build.load_library()
    _check_smem(SELF_ATTENTION, _fwd_smem(lib, q.dtype, n, d, False), n)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    route = attention_fwd_route(q.dtype, n, d)
    q, k, v = _aligned_operands(route, (q, k, v))
    _launch_fwd(
        SELF_ATTENTION, route, lib.edrl_self_attention_fwd, q.device,
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
    route = attention_bwd_route(q.dtype, n, d)
    q, k, v, dout = _aligned_operands(route, (q, k, v, dout))
    stats = torch.empty((3, b * num_heads * n), dtype=torch.float32, device=q.device)
    _launch_bwd(
        SELF_ATTENTION_BWD, route, lib.edrl_self_attention_bwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        b, n, c, num_heads, float(scale), int(q.dtype == torch.bfloat16),
    )
    return dq, dk, dv


@torch.library.custom_op(f"{build.OP_NAMESPACE}::self_attention_fwd", mutates_args=(), device_types="cuda",
                         schema="(Tensor q, Tensor k, Tensor v, int num_heads, float scale) -> Tensor")
def self_attention_fwd(q, k, v, num_heads, scale):
    """B1's forward as an operator: the kernel for CUDA tensors, the plain
    version for CPU ones, and a shape-only version for tracing, so that
    ``torch.export`` keeps the kernel in the program it exports."""
    return _self_attention_fwd_kernel(q, k, v, num_heads, scale)


@self_attention_fwd.register_kernel("cpu")
def _(q, k, v, num_heads, scale):
    # The plain version is looked up at the call, as the CUDA implementation's
    # kernel is, so that a caller may wrap either (tools/mlp_replay.py does).
    return self_attention_reference(q, k, v, num_heads, scale)


self_attention_fwd.register_fake(lambda q, k, v, num_heads, scale: torch.empty_like(q))


class _SelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale, ctx.tp_route = num_heads, scale, _TP_ROUTE.get()
        if q.device.type == "cuda" and any(ctx.needs_input_grad[:3]):
            _check_bwd_shape(SELF_ATTENTION_BWD, q.shape[1])
        return self_attention_fwd(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dout = _grad_output(dout, q)
        if q.device.type == "cpu":
            grads = self_attention_bwd_reference(q, k, v, dout, ctx.num_heads, ctx.scale)
        else:
            with tensor_parallel_route(ctx.tp_route):
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
    if not build.needs_grad(q, k, v):
        return self_attention_fwd(q, k, v, num_heads, scale)
    return _SelfAttention.apply(q, k, v, num_heads, scale)


# -- B2 ----------------------------------------------------------------------


def _packed_qkv(qkv, c: int) -> tuple:
    """The data pointers of q, k and v in a packed ``[.., 3C]`` tensor:
    column blocks 0, C and 2C."""
    base, step = qkv.data_ptr(), c * qkv.element_size()
    return base, base + step, base + 2 * step


def window_attention_v2_fwd_kernel(qkv, bias, num_heads: int, scale: float, name: str = WINDOW_ATTENTION_V2):
    """The B2 forward kernel's ``[B, W, N, C]`` result; CUDA tensors only.
    The launch counts under ``name``."""
    b, w, n, c3 = qkv.shape
    c = c3 // 3
    d = _check_cuda_inputs(name, (qkv,), num_heads, c, n)
    lib = build.load_library()
    _check_smem(name, _fwd_smem(lib, qkv.dtype, n, d, True), n)
    out = torch.empty((b, w, n, c), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    route = attention_fwd_route(qkv.dtype, n, d)
    qkv, bias = _aligned_operands(route, (qkv, bias))
    _launch_fwd(
        name, route, lib.edrl_window_attention_fwd, qkv.device,
        *_packed_qkv(qkv, c), bias.data_ptr(), out.data_ptr(), b, w, num_heads, n, d,
        *attention_strides(n, d, num_heads, 3 * c), *attention_strides(n, d, num_heads, c),
        float(scale), int(qkv.dtype == torch.bfloat16),
    )
    return out


def window_attention_v2_bwd_kernel(qkv, bias, dout, num_heads: int, scale: float,
                                   name: str = WINDOW_ATTENTION_V2_BWD):
    """``(dqkv, dbias)`` from the B2 backward kernel; CUDA tensors only.
    The launch counts under ``name``."""
    b, w, n, c3 = qkv.shape
    c = c3 // 3
    d = _check_cuda_inputs(name, (qkv,), num_heads, c, n)
    _check_cuda_inputs(name, (dout,), num_heads, c, n)
    if dout.dtype != qkv.dtype or tuple(dout.shape) != (b, w, n, c):
        raise ValueError(f"{name}: dout must be {(b, w, n, c)} in {qkv.dtype}")
    if (tuple(bias.shape) != (w, num_heads, n, n) or bias.dtype != torch.float32
            or bias.device != qkv.device or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 "
                         f"{(w, num_heads, n, n)} tensor on {qkv.device}")
    _check_bwd_shape(name, n)
    lib = build.load_library()
    _check_smem(name, lib.edrl_attention_bwd_smem_bytes(n, d, 1), n)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias)
    if qkv.numel() == 0:
        return dqkv, dbias.zero_()
    route = attention_bwd_route(qkv.dtype, n, d)
    qkv, bias, dout = _aligned_operands(route, (qkv, bias, dout))
    stats = torch.empty((3, b * w * num_heads * n), dtype=torch.float32, device=qkv.device)
    # Batch entries one dq block sums ds over (dbias_chunking).
    slots = _dq_blocks_per_sm(lib, qkv.device, qkv.dtype, n, d) * build.sm_count(qkv.device)
    per_block, chunks = dbias_chunking(b, w * num_heads * -(-n // _BWD_QUERY_TILE[route]), slots)
    partial = dbias if chunks == 1 else torch.empty(
        (chunks, *bias.shape), dtype=torch.float32, device=qkv.device)
    _launch_bwd(
        name, route, lib.edrl_window_attention_bwd, qkv.device,
        *_packed_qkv(qkv, c), bias.data_ptr(), dout.data_ptr(), *_packed_qkv(dqkv, c), partial.data_ptr(),
        dbias.data_ptr(), stats.data_ptr(), b, w, num_heads, n, d,
        *attention_strides(n, d, num_heads, 3 * c), *attention_strides(n, d, num_heads, c),
        per_block, float(scale), int(qkv.dtype == torch.bfloat16),
    )
    return dqkv, dbias


@torch.library.custom_op(f"{build.OP_NAMESPACE}::window_attention_v2_fwd", mutates_args=(), device_types="cuda",
                         schema="(Tensor qkv, Tensor bias, int num_heads, float scale) -> Tensor")
def window_attention_v2_fwd(qkv, bias, num_heads, scale):
    """B2's forward as an operator (as :func:`self_attention_fwd`)."""
    return window_attention_v2_fwd_kernel(qkv, bias, num_heads, scale)


@window_attention_v2_fwd.register_kernel("cpu")
def _(qkv, bias, num_heads, scale):
    return window_attention_v2_reference(qkv, bias, num_heads, scale)


window_attention_v2_fwd.register_fake(
    lambda qkv, bias, num_heads, scale: qkv.new_empty((*qkv.shape[:-1], qkv.shape[-1] // 3)))


class _WindowAttentionV2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, num_heads, scale):
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads, ctx.scale, ctx.tp_route = num_heads, scale, _TP_ROUTE.get()
        if qkv.device.type == "cuda" and any(ctx.needs_input_grad[:2]):
            _check_bwd_shape(WINDOW_ATTENTION_V2_BWD, qkv.shape[2])
        return window_attention_v2_fwd(qkv, bias, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias = ctx.saved_tensors
        dout = _grad_output(dout, qkv)
        if qkv.device.type == "cpu":
            dqkv, dbias = window_attention_v2_bwd_reference(qkv, bias, dout, ctx.num_heads, ctx.scale)
        else:
            with tensor_parallel_route(ctx.tp_route):
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
    if not build.needs_grad(qkv, bias):
        return window_attention_v2_fwd(qkv, bias, num_heads, scale)
    return _WindowAttentionV2.apply(qkv, bias, num_heads, scale)


# -- v1 ----------------------------------------------------------------------


def attention_strides(n: int, d: int, heads: int, row_width=None) -> tuple[int, int, int]:
    """``(group, head, row)``: the element strides through which the
    window attention entry points (``edrl_window_attention_fwd`` and
    ``_bwd``) address an operand, for a group (batch entry and window) of
    ``heads`` heads of ``n`` tokens of ``d`` features.  B2's and v1's
    launches take them from here.

    - ``row_width=None``: v1's contiguous ``[.., H, N, D]``, where a head is a
      block of N rows: ``(H * N * D, N * D, D)``;
    - ``row_width=w``: packed rows ``[.., N, w]`` with head h in columns
      ``[h * D, (h + 1) * D)``: ``(N * w, D, w)``; B2's qkv and dqkv (``w =
      3C``) and its o and do (``w = C``).  B1 and B6 fill in the same packed
      strides in their own C entry points.
    """
    if row_width is None:
        return heads * n * d, n * d, d
    return n * row_width, d, row_width


def _check_v1_bias(name: str, bias, q) -> None:
    b, w, h, n, d = q.shape
    if (tuple(bias.shape) != (w, h, n, n) or bias.dtype != torch.float32 or bias.device != q.device
            or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 {(w, h, n, n)} tensor on {q.device}")


def window_attention_v1_fwd_kernel(q, k, v, bias):
    """The v1 forward kernel's ``[B, W, H, N, D]`` result; CUDA tensors only.

    q (pre-scaled), k and v are read in place through
    :func:`attention_strides` and o written so; scale 1 inside."""
    if q.dim() != 5 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{WINDOW_ATTENTION_V1}: q, k, v must share a [B, W, H, N, D] shape")
    b, w, h, n, d = q.shape
    _check_cuda_inputs(WINDOW_ATTENTION_V1, (q, k, v), h, h * d, n)
    _check_v1_bias(WINDOW_ATTENTION_V1, bias, q)
    lib = build.load_library()
    _check_smem(WINDOW_ATTENTION_V1, _fwd_smem(lib, q.dtype, n, d, True), n)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    route = attention_fwd_route(q.dtype, n, d)
    q, k, v, bias = _aligned_operands(route, (q, k, v, bias))
    strides = attention_strides(n, d, h)
    _launch_fwd(
        WINDOW_ATTENTION_V1, route, lib.edrl_window_attention_fwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, w, h, n, d, *strides, *strides, 1.0, int(q.dtype == torch.bfloat16),
    )
    return out


def window_attention_v1_bwd_kernel(q, k, v, bias, dout):
    """``(dq, dk, dv, dbias)`` from the v1 backward kernels; CUDA tensors only.

    dq, dk, dv ``[B, W, H, N, D]`` in q's dtype (dq unscaled, dk from the
    pre-scaled q), written in place through :func:`attention_strides`;
    dbias ``[W, H, N, N]`` f32, summed over the batch as B2's is."""
    if q.dim() != 5 or not q.shape == k.shape == v.shape == dout.shape:
        raise ValueError(f"{WINDOW_ATTENTION_V1_BWD}: q, k, v and dout must share a [B, W, H, N, D] shape")
    b, w, h, n, d = q.shape
    _check_cuda_inputs(WINDOW_ATTENTION_V1_BWD, (q, k, v, dout), h, h * d, n)
    _check_v1_bias(WINDOW_ATTENTION_V1_BWD, bias, q)
    _check_bwd_shape(WINDOW_ATTENTION_V1_BWD, n)
    lib = build.load_library()
    _check_smem(WINDOW_ATTENTION_V1_BWD, lib.edrl_attention_bwd_smem_bytes(n, d, 1), n)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    if q.numel() == 0:
        return dq, dk, dv, dbias.zero_()
    route = attention_bwd_route(q.dtype, n, d)
    q, k, v, bias, dout = _aligned_operands(route, (q, k, v, bias, dout))
    stats = torch.empty((3, b * w * h * n), dtype=torch.float32, device=q.device)
    slots = _dq_blocks_per_sm(lib, q.device, q.dtype, n, d) * build.sm_count(q.device)
    per_block, chunks = dbias_chunking(b, w * h * -(-n // _BWD_QUERY_TILE[route]), slots)
    partial = dbias if chunks == 1 else torch.empty((chunks, *bias.shape), dtype=torch.float32, device=q.device)
    strides = attention_strides(n, d, h)
    _launch_bwd(
        WINDOW_ATTENTION_V1_BWD, route, lib.edrl_window_attention_bwd, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), partial.data_ptr(), dbias.data_ptr(), stats.data_ptr(),
        b, w, h, n, d, *strides, *strides, per_block, 1.0, int(q.dtype == torch.bfloat16),
    )
    return dq, dk, dv, dbias


class _WindowAttentionV1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias):
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias)
            return window_attention_reference(q, k, v, bias)
        q, k, v = (t.contiguous() for t in (q, k, v))
        ctx.save_for_backward(q, k, v, bias)
        if any(ctx.needs_input_grad[:4]):
            _check_bwd_shape(WINDOW_ATTENTION_V1_BWD, q.shape[3])
        return window_attention_v1_fwd_kernel(q, k, v, bias)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        dout = _grad_output(dout, q)
        if q.device.type == "cpu":
            return window_attention_bwd_reference(q, k, v, bias, dout)
        return window_attention_v1_bwd_kernel(q, k, v, bias, dout)


def window_attention_fused(q, k, v, bias):
    """softmax(q k^T + bias) v per (batch, window, head), differentiable (v1).

    q, k, v: ``[B, W, H, N, D]``, q pre-scaled by 1/sqrt(D); bias ``[W, H, N,
    N]`` f32, its gradient summed over the batch.  Returns ``[B, W, H, N, D]``
    in q's dtype.  CPU tensors take the plain versions
    (:func:`window_attention_reference` and its backward); CUDA tensors the v1
    kernels, which read and write this layout in place.
    """
    if q.dim() != 5 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share a [B, W, H, N, D] shape, got {q.shape}, {k.shape}, {v.shape}")
    b, w, h, n, d = q.shape
    if tuple(bias.shape) != (w, h, n, n):
        raise ValueError(f"bias must be [W, H, N, N] = {(w, h, n, n)}, got {tuple(bias.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{WINDOW_ATTENTION_V1}: no kernel for device {q.device}")
    if q.device.type == "cuda" and (
        bias.dtype != torch.float32 or bias.device != q.device or not bias.is_contiguous()
    ):
        raise ValueError(f"{WINDOW_ATTENTION_V1}: bias must be a contiguous float32 tensor on {q.device}")
    return _WindowAttentionV1.apply(q, k, v, bias)

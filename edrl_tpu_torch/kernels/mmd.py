"""Fused MK-MMD on the H100 (B3), forward and backward, with their plain versions.

Counterpart of ``edrl_tpu/kernels/mmd_pallas.py`` (``mk_mmd_pallas``): the
MK-MMD scalar of ``ops.mmd.mk_mmd`` over two ``[n, d]`` feature batches in
one forward launch (CUDA source ``csrc/mmd_fwd.cu``), and its gradient in
one backward launch (``csrc/mmd_bwd.cu``) from what the forward saves: the
distances before the clamp, the bandwidth and the sign (one f32 state
buffer beside the output).  The plain versions are ``ops.mmd.mk_mmd`` and
``ops.mmd.mk_mmd_bwd_reference`` (the VJP in closed form, with JAX's ties).
A CPU tensor takes them; a CUDA tensor launches the kernels or raises.

The forward has two routes, chosen in the C entry point from n = n_s + n_t
and mirrored by :func:`mk_mmd_route`: ``"cluster"`` (n <= 64, every
main-path call: one thread-block cluster of 16 CTAs, each taking a share
of the feature columns, the Gram on the tensor cores as 3xTF32, the CTAs'
tiles summed through distributed shared memory) and ``"split"`` (larger
n: Gram partials in device-memory scratch, then one block for the sum and
the tail; two launches).  Each forward launch counts under its route in
:data:`MMD_ROUTES`.  The backward takes n <= 128; a call that needs a
gradient at a larger n raises at the forward.  Any d is taken.
"""

from __future__ import annotations

import torch

from edrl_tpu_torch.kernels import build
from edrl_tpu_torch.ops.mmd import mk_mmd, mk_mmd_bwd_reference

MK_MMD = "mk_mmd_fused"
MK_MMD_BWD = "mk_mmd_fused_bwd"
# Kernel launches since the last reset_launch_counts(), by wrapper name.
LAUNCHES = {MK_MMD: 0, MK_MMD_BWD: 0}
# Forward calls since the last reset, by route.
MMD_ROUTES = {"cluster": 0, "split": 0}
CLUSTER_MAX_ROWS = 64  # csrc/mmd_fwd.cu, kMmdClusterMaxRows
BWD_MAX_ROWS = 128  # csrc/mmd_bwd.cu, kMmdBwdMaxRows
MAX_KERNEL_NUM = 16


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, MMD_ROUTES):
        for name in counts:
            counts[name] = 0


def mk_mmd_route(n: int) -> str:
    """The forward's route at n = n_s + n_t rows: ``"cluster"`` for n <= 64,
    else ``"split"``.  Mirrors ``mmd_route_cluster`` in ``csrc/mmd_fwd.cu``
    (``edrl_mk_mmd_route`` exposes it)."""
    return "cluster" if n <= CLUSTER_MAX_ROWS else "split"


def _features(name: str, source, target):
    """source and target as the kernels take them: f32 (converted only if
    they are not), contiguous, on one CUDA device, ``[n_s, d]`` and ``[n_t, d]``."""
    if source.device.type != "cuda" or target.device != source.device:
        raise ValueError(f"{name}: the kernel takes two CUDA tensors on one device")
    if source.dim() != 2 or target.dim() != 2 or source.shape[1] != target.shape[1]:
        raise ValueError(f"{name}: takes [n_s, d] and [n_t, d], got {tuple(source.shape)}, {tuple(target.shape)}")
    n_s, d = source.shape
    n_t = target.shape[0]
    if n_s < 1 or n_t < 1 or n_s + n_t < 2 or d < 1:
        raise ValueError(f"{name}: needs rows in both batches and features, got {n_s}, {n_t}, {d}")
    return tuple(t.contiguous() if t.dtype == torch.float32 else t.float().contiguous() for t in (source, target))


def _check_kernel_num(name: str, kernel_num: int) -> None:
    if not 1 <= kernel_num <= MAX_KERNEL_NUM:
        raise ValueError(f"{name}: kernel_num must be 1 to {MAX_KERNEL_NUM}, got {kernel_num}")


def mk_mmd_fwd_kernel(source, target, kernel_mul: float = 2.0, kernel_num: int = 5):
    """``(value, state)`` from the B3 forward kernel; CUDA tensors only.

    value: the 0-d f32 MK-MMD; state: f32 ``[n * n + 2]``, the distances
    before the clamp (0 on the diagonal), the bandwidth and the sign of the
    signed sum, which :func:`mk_mmd_bwd_kernel` takes."""
    src, tgt = _features(MK_MMD, source, target)
    _check_kernel_num(MK_MMD, kernel_num)
    n_s, d = src.shape
    n = n_s + tgt.shape[0]
    lib = build.load_library()
    route = mk_mmd_route(n)
    state = torch.empty(n * n + 2, dtype=torch.float32, device=src.device)
    out = torch.empty((), dtype=torch.float32, device=src.device)
    scratch = None if route == "cluster" else torch.empty(
        lib.edrl_mk_mmd_scratch_floats(n, d), dtype=torch.float32, device=src.device)
    build.launch(LAUNCHES, MK_MMD, lib.edrl_mk_mmd_fwd, src.device, src.data_ptr(), tgt.data_ptr(),
                 n_s, n - n_s, d, float(kernel_mul), int(kernel_num),
                 None if scratch is None else scratch.data_ptr(), out.data_ptr(), state.data_ptr())
    MMD_ROUTES[route] += 1
    return out, state


def mk_mmd_kernel(source, target, kernel_mul: float = 2.0, kernel_num: int = 5):
    """The B3 forward kernel's value (a 0-d f32 tensor); CUDA tensors only."""
    return mk_mmd_fwd_kernel(source, target, kernel_mul, kernel_num)[0]


def _check_bwd_rows(n: int) -> None:
    if n > BWD_MAX_ROWS:
        raise ValueError(f"{MK_MMD_BWD}: the backward kernel takes at most {BWD_MAX_ROWS} rows "
                         f"(n_s + n_t), got {n}")


def mk_mmd_bwd_kernel(source, target, state, grad, kernel_mul: float = 2.0, kernel_num: int = 5):
    """``(dsource, dtarget)`` f32 from the B3 backward kernel; CUDA tensors only.

    ``state`` is :func:`mk_mmd_fwd_kernel`'s for these features and
    parameters; ``grad`` the incoming gradient, a 0-d tensor on the card."""
    src, tgt = _features(MK_MMD_BWD, source, target)
    _check_kernel_num(MK_MMD_BWD, kernel_num)
    n_s, d = src.shape
    n = n_s + tgt.shape[0]
    _check_bwd_rows(n)
    if state.dtype != torch.float32 or state.numel() != n * n + 2 or state.device != src.device:
        raise ValueError(f"{MK_MMD_BWD}: state must be the forward's f32 [{n * n + 2}] on {src.device}")
    grad = grad.reshape(()).to(device=src.device, dtype=torch.float32)
    ds, dt = torch.empty_like(src), torch.empty_like(tgt)
    lib = build.load_library()
    build.launch(LAUNCHES, MK_MMD_BWD, lib.edrl_mk_mmd_bwd, src.device, src.data_ptr(), tgt.data_ptr(),
                 state.contiguous().data_ptr(), grad.data_ptr(), ds.data_ptr(), dt.data_ptr(), n_s, n - n_s, d,
                 float(kernel_mul), int(kernel_num))
    return ds, dt


class _MkMmd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, source, target, kernel_mul, kernel_num):
        ctx.kernel_mul, ctx.kernel_num = kernel_mul, kernel_num
        ctx.dtypes = (source.dtype, target.dtype)
        if source.device.type == "cpu":
            ctx.save_for_backward(source, target)
            return mk_mmd(source, target, kernel_mul, kernel_num)
        if any(ctx.needs_input_grad[:2]):
            _check_bwd_rows(source.shape[0] + target.shape[0])
        src, tgt = _features(MK_MMD, source, target)
        value, state = mk_mmd_fwd_kernel(src, tgt, kernel_mul, kernel_num)
        ctx.save_for_backward(src, tgt, state)
        return value

    @staticmethod
    def backward(ctx, grad):
        if ctx.saved_tensors[0].device.type == "cpu":
            source, target = ctx.saved_tensors
            ds, dt = mk_mmd_bwd_reference(source, target, grad, ctx.kernel_mul, ctx.kernel_num)
        else:
            ds, dt = mk_mmd_bwd_kernel(*ctx.saved_tensors, grad, ctx.kernel_mul, ctx.kernel_num)
        return ds.to(ctx.dtypes[0]), dt.to(ctx.dtypes[1]), None, None


def mk_mmd_fused(source, target, kernel_mul: float = 2.0, kernel_num: int = 5):
    """MK-MMD with the fused forward and backward (B3), differentiable.

    CPU tensors take the plain versions (``ops.mmd.mk_mmd`` and
    ``mk_mmd_bwd_reference``); CUDA tensors the kernels."""
    if source.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{MK_MMD}: no kernel for device {source.device}")
    return _MkMmd.apply(source, target, kernel_mul, kernel_num)

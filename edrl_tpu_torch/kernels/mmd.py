"""Fused MK-MMD forward on the H100 (B3), with its plain version.

Counterpart of ``edrl_tpu/kernels/mmd_pallas.py`` (``mk_mmd_pallas``): one
kernel pass computes the MK-MMD scalar of ``ops.mmd.mk_mmd`` over two
``[n, d]`` feature batches (CUDA source ``csrc/mmd_fwd.cu``).  The backward
is the plain path's, by autograd, as the JAX custom VJP takes it from the
XLA path.  A CPU tensor takes the plain version (forward and backward); a
CUDA tensor launches the kernel or raises.  The kernel takes any n and d.
"""

from __future__ import annotations

import torch

from edrl_tpu_torch.kernels import build
from edrl_tpu_torch.ops.mmd import mk_mmd

MK_MMD = "mk_mmd_fused"
# Kernel launches since the last reset_launch_counts().
LAUNCHES = {MK_MMD: 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def mk_mmd_kernel(source, target, kernel_mul: float = 2.0, kernel_num: int = 5):
    """The B3 forward kernel's value (a 0-d f32 tensor); CUDA tensors only."""
    if source.device.type != "cuda" or target.device != source.device:
        raise ValueError(f"{MK_MMD}: the kernel takes two CUDA tensors on one device")
    if source.dim() != 2 or target.dim() != 2 or source.shape[1] != target.shape[1]:
        raise ValueError(f"{MK_MMD}: takes [n_s, d] and [n_t, d], got {tuple(source.shape)}, {tuple(target.shape)}")
    n_s, d = source.shape
    n_t = target.shape[0]
    if n_s < 1 or n_t < 1 or n_s + n_t < 2 or d < 1:
        raise ValueError(f"{MK_MMD}: needs rows in both batches and features, got {n_s}, {n_t}, {d}")
    src = source.float().contiguous()
    tgt = target.float().contiguous()
    lib = build.load_library()
    scratch = torch.empty(lib.edrl_mk_mmd_scratch_floats(n_s + n_t, d), dtype=torch.float32,
                          device=src.device)
    out = torch.empty((), dtype=torch.float32, device=src.device)
    build.launch(LAUNCHES, MK_MMD, lib.edrl_mk_mmd_fwd, src.device, src.data_ptr(), tgt.data_ptr(),
                 n_s, n_t, d, float(kernel_mul), int(kernel_num), scratch.data_ptr(), out.data_ptr())
    return out


class _MkMmd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, source, target, kernel_mul, kernel_num):
        ctx.save_for_backward(source, target)
        ctx.kernel_mul, ctx.kernel_num = kernel_mul, kernel_num
        if source.device.type == "cpu":
            return mk_mmd(source, target, kernel_mul, kernel_num)
        return mk_mmd_kernel(source, target, kernel_mul, kernel_num)

    @staticmethod
    def backward(ctx, grad):
        source, target = ctx.saved_tensors
        with torch.enable_grad():
            s = source.detach().requires_grad_()
            t = target.detach().requires_grad_()
            value = mk_mmd(s, t, ctx.kernel_mul, ctx.kernel_num)
            ds, dt = torch.autograd.grad(value, (s, t), grad)
        return ds, dt, None, None


def mk_mmd_fused(source, target, kernel_mul: float = 2.0, kernel_num: int = 5):
    """MK-MMD with the fused forward (B3) and the plain path's backward."""
    if source.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{MK_MMD}: no kernel for device {source.device}")
    return _MkMmd.apply(source, target, kernel_mul, kernel_num)

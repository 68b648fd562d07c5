"""Multi-kernel Maximum Mean Discrepancy (``edrl_tpu/ops/mmd.py``).

The dual-view step's self-distillation loss between the low- and
high-noise feature batches: a multi-scale RBF kernel over their
concatenation, its bandwidth set from the mean pairwise distance.  All in
f32.  This is the plain path; ``kernels.mmd.mk_mmd_fused`` is the fused
forward (B3) and differentiates through this module.
"""

from __future__ import annotations

import torch


def _pairwise_sq_dists(total: torch.Tensor) -> torch.Tensor:
    """Squared distances by x^2 + y^2 - 2xy, with an exactly zero diagonal."""
    sq = (total * total).sum(dim=1, keepdim=True)
    d2 = sq + sq.T - 2.0 * (total @ total.T)
    d2 = d2 * (1.0 - torch.eye(total.shape[0], dtype=d2.dtype, device=d2.device))
    return d2.clamp_min(0.0)


def gaussian_kernel(source, target, kernel_mul: float = 2.0, kernel_num: int = 5):
    """Summed multi-scale RBF kernel matrix over concat(source, target)."""
    total = torch.cat([source, target], dim=0).float()
    n = total.shape[0]
    d2 = _pairwise_sq_dists(total)
    length_scale = d2.sum() / float(n * n - n)
    length_scale = length_scale / (kernel_mul ** (kernel_num // 2))
    acc = torch.zeros_like(d2)
    for i in range(kernel_num):
        acc = acc + torch.exp(-d2 / (length_scale * (kernel_mul ** i) + 1e-12))
    return acc


def mk_mmd(source, target, kernel_mul: float = 2.0, kernel_num: int = 5):
    """|mean K_XX + mean K_YY - mean K_XY - mean K_YX|, a 0-d f32 tensor."""
    n_s, n_t = source.shape[0], target.shape[0]
    k = gaussian_kernel(source, target, kernel_mul, kernel_num)
    xx = k[:n_s, :n_s].sum() / float(n_s * n_s)
    yy = k[n_s:, n_s:].sum() / float(n_t * n_t)
    xy = k[:n_s, n_s:].sum() / float(n_s * n_t)
    yx = k[n_s:, :n_s].sum() / float(n_s * n_t)
    return torch.abs(xx + yy - xy - yx)

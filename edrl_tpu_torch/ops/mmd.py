"""Multi-kernel Maximum Mean Discrepancy (``edrl_tpu/ops/mmd.py``).

The dual-view step's self-distillation loss between the low- and
high-noise feature batches: a multi-scale RBF kernel over their
concatenation, its bandwidth set from the mean pairwise distance.  All in
f32 (f64 for f64 features).  This is the plain path; ``kernels.mmd.mk_mmd_fused`` runs the fused
forward and backward (B3), whose plain versions are :func:`mk_mmd` and
:func:`mk_mmd_bwd_reference` (the VJP in closed form).
"""

from __future__ import annotations

import torch

from edrl_tpu_torch.ops import at_least_f32


def _pairwise_sq_dists(total: torch.Tensor) -> torch.Tensor:
    """Squared distances by x^2 + y^2 - 2xy, with an exactly zero diagonal."""
    sq = (total * total).sum(dim=1, keepdim=True)
    d2 = sq + sq.T - 2.0 * (total @ total.T)
    d2 = d2 * (1.0 - torch.eye(total.shape[0], dtype=d2.dtype, device=d2.device))
    return d2.clamp_min(0.0)


def gaussian_kernel(source, target, kernel_mul: float = 2.0, kernel_num: int = 5):
    """Summed multi-scale RBF kernel matrix over concat(source, target)."""
    total = at_least_f32(torch.cat([source, target], dim=0))
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


def _block_weights(n_s: int, n_t: int, device) -> torch.Tensor:
    """w ``[n, n]``: the weight of each kernel entry in the signed sum,
    1/n_s^2, 1/n_t^2 on the diagonal blocks, -1/(n_s n_t) off them."""
    w = torch.full((n_s + n_t, n_s + n_t), -1.0 / float(n_s * n_t), device=device)
    w[:n_s, :n_s] = 1.0 / float(n_s * n_s)
    w[n_s:, n_s:] = 1.0 / float(n_t * n_t)
    return w


def mk_mmd_grad_d2(source, target, kernel_mul: float = 2.0, kernel_num: int = 5):
    """``(G, total, direct)``: G = d|S| / d(d2) ``[n, n]`` in closed form, S
    the signed sum whose magnitude :func:`mk_mmd` returns and d2 the
    distances before the clamp; total = concat(source, target) in f32;
    direct, G's part with the bandwidth held fixed (sign * mask * -w sum_m
    e_m / sigma_m).

    With d2 the clamped distances, ls the bandwidth, sigma_m = ls mul^m +
    1e-12, e_m = exp(-d2 / sigma_m) and w the block weights: B = sum w sum_m
    e_m d2 mul^m / sigma_m^2 (dS/dls) and G = sign(S) * mask * (c B - w
    sum_m e_m / sigma_m) with c = 1 / ((n^2 - n) mul^(num/2)).  Ties as
    JAX's VJP takes them: mask is 0 on the diagonal and where d2 < 0, 1/2
    where it is exactly 0 (``jnp.maximum``), 1 elsewhere; sign(0) = +1
    (``jnp.abs``).
    """
    n_s, n_t = source.shape[0], target.shape[0]
    total = at_least_f32(torch.cat([source, target], dim=0))
    n = total.shape[0]
    off_diagonal = 1.0 - torch.eye(n, dtype=total.dtype, device=total.device)
    sq = (total * total).sum(dim=1, keepdim=True)
    raw = (sq + sq.T - 2.0 * (total @ total.T)) * off_diagonal
    d2 = raw.clamp_min(0.0)
    length_scale = d2.sum() / float(n * n - n)
    length_scale = length_scale / (kernel_mul ** (kernel_num // 2))
    w = _block_weights(n_s, n_t, total.device)
    k = torch.zeros_like(d2)
    f = torch.zeros_like(d2)
    t = torch.zeros_like(d2)
    for i in range(kernel_num):
        sigma = length_scale * (kernel_mul ** i) + 1e-12
        e = torch.exp(-d2 / sigma)
        k = k + e
        f = f + e / sigma
        t = t + e * d2 * (kernel_mul ** i) / (sigma * sigma)
    signed = (k[:n_s, :n_s].sum() / float(n_s * n_s) + k[n_s:, n_s:].sum() / float(n_t * n_t)
              - k[:n_s, n_s:].sum() / float(n_s * n_t) - k[n_s:, :n_s].sum() / float(n_s * n_t))
    sign = torch.where(signed >= 0.0, 1.0, -1.0)
    c = 1.0 / (float(n * n - n) * kernel_mul ** (kernel_num // 2))
    mask = torch.where(raw > 0.0, 1.0, torch.where(raw == 0.0, 0.5, 0.0)) * off_diagonal
    return sign * mask * (c * (w * t).sum() - w * f), total, -sign * mask * w * f


def mk_mmd_bwd_reference(source, target, grad, kernel_mul: float = 2.0, kernel_num: int = 5):
    """The VJP of :func:`mk_mmd` in closed form: ``(dsource, dtarget)``, in
    the inputs' dtypes, for the incoming gradient ``grad`` (a 0-d tensor or
    a number): with G from :func:`mk_mmd_grad_d2` and H = G + G^T, dtotal =
    2 grad (diag(rowsum H) - H) total."""
    n_s = source.shape[0]
    g, total, _ = mk_mmd_grad_d2(source, target, kernel_mul, kernel_num)
    h = g + g.T
    dtotal = 2.0 * (h.sum(dim=1, keepdim=True) * total - h @ total)
    dtotal = dtotal * torch.as_tensor(grad, dtype=torch.float32, device=total.device)
    return dtotal[:n_s].to(source.dtype), dtotal[n_s:].to(target.dtype)

"""Barlow-Twins cross-correlation loss of DILR (``edrl_tpu/ops/correlation.py``)."""

from __future__ import annotations

import torch


def cross_correlation(z1, z2, divisor: float):
    """c = z1^T z2 / divisor, in f32."""
    return (z1.float().T @ z2.float()) / divisor


def off_diagonal_sum_sq(c):
    """Sum of squares of the off-diagonal entries of a square matrix."""
    mask = 1.0 - torch.eye(c.shape[0], dtype=c.dtype, device=c.device)
    return torch.sum(c.square() * mask)


def barlow_block_loss(z1, z2, common_dim: int, batch_divisor: float, off_diag_weight: float = 0.0051):
    """DILR loss over the (common, unique) blocks of standardized features.

    Returns ``(loss, loss_common, loss_unique)`` with
    ``loss = (loss_common + loss_unique) / 2``.
    """
    c = cross_correlation(z1, z2, batch_divisor)
    c_c = c[:common_dim, :common_dim]
    c_u = c[common_dim:, common_dim:]
    loss_c = (torch.diagonal(c_c) - 1.0).square().sum() + off_diag_weight * off_diagonal_sum_sq(c_c)
    loss_u = torch.diagonal(c_u).square().sum() + off_diag_weight * off_diagonal_sum_sq(c_u)
    return 0.5 * (loss_c + loss_u), loss_c, loss_u

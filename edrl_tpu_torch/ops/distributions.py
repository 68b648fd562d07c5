"""Gaussian KL and categorical entropy (``edrl_tpu/ops/distributions.py``)."""

from __future__ import annotations

import torch


def kl_between_normals(mu_q, sigma_q, mu_p, sigma_p, axis: int = 1):
    """KL(N(mu_q, diag sigma_q^2) || N(mu_p, diag sigma_p^2)) summed over ``axis``.

    Log terms are clamped at 1e-8, as in the reference.
    """
    mu_q, sigma_q, mu_p, sigma_p = (t.float() for t in (mu_q, sigma_q, mu_p, sigma_p))
    k = mu_q.shape[axis]
    mu_diff_sq = (mu_p - mu_q).square()
    logdet_q = torch.sum(2.0 * torch.log(sigma_q.clamp_min(1e-8)), dim=axis)
    logdet_p = torch.sum(2.0 * torch.log(sigma_p.clamp_min(1e-8)), dim=axis)
    var_p = sigma_p.square()
    fs = torch.sum(sigma_q.square() / var_p, dim=axis) + torch.sum(mu_diff_sq / var_p, dim=axis)
    return 0.5 * (fs - k + logdet_p - logdet_q)


def kl_to_standard_normal(mu, sigma, axis: int = 1):
    """Mean KL(N(mu, sigma) || N(0, I)): the EDRL information-bottleneck term."""
    kl = kl_between_normals(mu, sigma, torch.zeros_like(mu), torch.ones_like(sigma), axis=axis)
    return kl.mean()


def entropy_regularization(logits):
    """Mean entropy of the rows of softmax(logits)."""
    log_p = torch.log_softmax(logits.float(), dim=1)
    return torch.mean(-torch.sum(log_p.exp() * log_p, dim=1))

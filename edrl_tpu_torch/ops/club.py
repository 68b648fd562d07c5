"""CLUB mutual-information upper bound, functional core (``edrl_tpu/ops/club.py``).

A variational MI upper bound with a unit-variance q(y|x) (``CLUBMean``,
``fusion_net.py:501-542``).  The functions take the predicted ``mu``; the
MLP that predicts it is ``models.auxiliary.CLUBMean``.
"""

from __future__ import annotations

import torch


def club_mean_mi(mu: torch.Tensor, y_samples: torch.Tensor) -> torch.Tensor:
    """mean_i sum_d (positive - negative): positive = -(mu_i - y_i)^2 / 2,
    negative = mean_j -(mu_i - y_j)^2 / 2."""
    mu, y = mu.float(), y_samples.float()
    positive = -(mu - y).square() / 2.0  # [n, d]
    negative = -(mu[:, None, :] - y[None, :, :]).square().mean(dim=1) / 2.0  # [n, d]
    return (positive.sum(dim=-1) - negative.sum(dim=-1)).mean()


def club_learning_loss(mu: torch.Tensor, y_samples: torch.Tensor) -> torch.Tensor:
    """The estimator's own loss: the negative unnormalised log-likelihood of q(y|x)."""
    mu, y = mu.float(), y_samples.float()
    return -(-(mu - y).square()).sum(dim=1).mean()

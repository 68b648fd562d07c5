"""Product-of-Experts fusion (``edrl_tpu/models/poe.py``).

Softmax weights ``phi`` over the modalities, precision-weighted mean,
inverse summed precision; the output is deterministically ``mu + var``.
An optional boolean ``modality_mask`` drops absent experts, and
``renormalize_mask`` rescales the surviving weights to sum 1.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class PoE(nn.Module):
    def __init__(self, modality_num: int = 2, *, renormalize_mask: bool = False, device=None):
        super().__init__()
        self.renormalize_mask = renormalize_mask
        self.phi = nn.Parameter(torch.empty((modality_num,), device=device))

    def flax_init_(self, generator):
        self.phi.fill_(1.0)

    def forward(self, mu_list: Sequence[torch.Tensor], var_list: Sequence[torch.Tensor],
                modality_mask: Optional[torch.Tensor] = None, eps: float = 1e-8):
        """mu/var entries ``[B, C, z]``; returns fused features ``[B, C, z]``."""
        alpha = torch.softmax(self.phi, dim=0)
        if modality_mask is not None:
            alpha = alpha * modality_mask.to(alpha.dtype)
            if self.renormalize_mask:
                alpha = alpha / alpha.sum().clamp_min(eps)
        t_sum = 0.0
        mu_t_sum = 0.0
        for idx, (mu, var) in enumerate(zip(mu_list, var_list)):
            t = 1.0 / (var.float() + eps)
            t_sum = t_sum + alpha[idx] * t
            mu_t_sum = mu_t_sum + mu.float() * alpha[idx] * t
        t_sum = t_sum.clamp_min(eps)
        return mu_t_sum / t_sum + 1.0 / t_sum

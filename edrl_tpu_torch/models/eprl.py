"""EPRL, Essence-Point Representation Learning (``edrl_tpu/models/eprl.py``).

Eval mode only in this slice (train mode is ROADMAP item A6): pseudo-labels
are the argmax of the confidence-blended distribution, and the entropy
regularizer is returned.  Normalisation is over the feature axis, and the
token-mean attention divides by the token count, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.models.layers import Dense, xavier_uniform_
from edrl_tpu_torch.ops.distributions import entropy_regularization

EVAL_SEED = 1


def _l2_normalize(x, eps: float = 1e-12):
    return x / torch.sqrt(x.square().sum(dim=-1, keepdim=True)).clamp_min(eps)


def eval_eps(num_classes: int, sample_num: int, z_dim: int, device) -> torch.Tensor:
    """The eval-mode proxy noise ``[C, S, z]``, from a generator seeded with 1.

    Deterministic, but not the JAX package's draw (``jax.random.key(1)``):
    the two generators give different numbers.  Tests inject JAX's draw.
    """
    gen = torch.Generator(device=device).manual_seed(EVAL_SEED)
    return torch.randn((num_classes, sample_num, z_dim), generator=gen, device=device)


class EPRL(nn.Module):
    """Returns ``(mu [B, C, z], sigma [B, C, z], proxy_loss, z, entropy_loss)``."""

    def __init__(self, x_dim: int, num_tokens: int, *, z_dim: int = 256, num_classes: int = 2,
                 sample_num: int = 800, topk: int = 100, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.x_dim, self.num_tokens, self.z_dim = x_dim, num_tokens, z_dim
        self.num_classes, self.sample_num, self.topk = num_classes, sample_num, topk
        self.enc1 = Dense(x_dim, 2 * z_dim, dtype=dtype, device=device)
        self.enc2 = Dense(2 * z_dim, 2 * z_dim, dtype=dtype, device=device)
        self.enc3 = Dense(2 * z_dim, z_dim, dtype=dtype, device=device)
        self.proxies = nn.Parameter(torch.empty((num_classes, 2 * z_dim), device=device))
        self.token_mlp = Dense(num_tokens, num_classes, dtype=torch.float32, device=device)
        self.alpha = nn.Parameter(torch.empty((), device=device))

    def flax_init_(self, generator):
        xavier_uniform_(self.proxies, generator)
        self.alpha.fill_(0.5)

    def forward(self, x, eps: Optional[torch.Tensor] = None):
        """x: tokens ``[B, N, x_dim]``; eps: ``[C, S, z]`` proxy noise, or None
        for :func:`eval_eps`."""
        b, n, _ = x.shape
        c, s, z_dim = self.num_classes, self.sample_num, self.z_dim
        if x.shape[-1] != self.x_dim or n != self.num_tokens:
            raise ValueError(
                f"EPRL configured for [B, {self.num_tokens}, {self.x_dim}] tokens, got {tuple(x.shape)}"
            )
        h = F.relu(self.enc1(x))
        h = F.relu(self.enc2(h))
        z = self.enc3(h)  # [B, N, z]

        mu_proxy = self.proxies[:, :z_dim]
        sigma_proxy = F.softplus(self.proxies[:, z_dim:])
        if eps is None:
            eps = eval_eps(c, s, z_dim, x.device)
        z_proxy = mu_proxy[:, None, :] + sigma_proxy[:, None, :] * eps  # [C, S, z]

        z_norm = _l2_normalize(z.float())
        p_norm = _l2_normalize(z_proxy)
        att = torch.einsum("bnd,csd->bcs", z_norm, p_norm) / float(n)

        feat = torch.softmax(z_norm.mean(dim=2), dim=1)  # over tokens, [B, N]
        feat = F.relu(self.token_mlp(F.relu(feat)))
        combined = self.alpha * torch.softmax(att.mean(dim=2), dim=1) + (1.0 - self.alpha) * feat

        labels = combined.argmax(dim=1)
        entropy_loss = entropy_regularization(combined)

        one_hot = F.one_hot(labels, c).bool()  # [B, C]
        pos = torch.einsum("bcs,bc->bs", att, one_hot.to(att.dtype))
        neg_mask = (~one_hot).repeat_interleave(s, dim=1)  # [B, C*S]
        neg = torch.where(neg_mask, att.reshape(b, c * s), float("-inf"))
        pos_topk = pos.topk(min(self.topk, s), dim=1).values
        neg_topk = neg.topk(min(self.topk, (c - 1) * s), dim=1).values
        proxy_loss = torch.exp(-pos_topk.mean(dim=1) + neg_topk.mean(dim=1)).mean()

        mu_rep = mu_proxy[None].expand(b, c, z_dim)
        sigma_rep = sigma_proxy[None].expand(b, c, z_dim)
        return mu_rep, sigma_rep, proxy_loss, z, entropy_loss

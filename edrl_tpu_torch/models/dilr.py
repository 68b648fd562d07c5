"""DILR, the disentangled-representation fusion head (``edrl_tpu/models/dilr.py``).

Eval mode only in this slice: the affine-free BatchNorms standardise with
their running statistics (training, with batch statistics and running-stat
updates, is ROADMAP item A6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.models.layers import Dense, LayerNorm, MultiHeadAttention
from edrl_tpu_torch.ops.correlation import barlow_block_loss


class AttentionModel(nn.Module):
    """MultiheadAttention + residual on the query + LayerNorm + FFN(3x) + ReLU."""

    def __init__(self, embed_dim: int, num_heads: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.MultiHeadAttention_0 = MultiHeadAttention(embed_dim, num_heads, dtype=dtype, device=device)
        # flax's own nn.LayerNorm (eps 1e-6, fast variance), not FusedLayerNorm.
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype=dtype, fast_variance=True, device=device)
        self.Dense_0 = Dense(embed_dim, 3 * embed_dim, dtype=dtype, device=device)
        self.Dense_1 = Dense(3 * embed_dim, embed_dim, dtype=dtype, device=device)

    def forward(self, q, k, v):
        x = self.LayerNorm_0(q + self.MultiHeadAttention_0(q, k, v))
        return F.relu(x + self.Dense_1(F.relu(self.Dense_0(x))))


class BatchNorm(nn.Module):
    """Affine-free BatchNorm in eval mode: (x - running_mean) * rsqrt(running_var + eps)."""

    def __init__(self, dim: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.empty((dim,), device=device))
        self.register_buffer("running_var", torch.empty((dim,), device=device))

    def flax_init_(self, generator):
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        return (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)


class DILR(nn.Module):
    """Returns ``(combined [B, 3 * feature_dim / 2], barlow_loss)``."""

    def __init__(self, *, fundus_dim: int = 1024, oct_dim: int = 768, feature_dim: int = 2048,
                 guided_in_dim: int = 512, common_ratio: float = 0.5, num_heads: int = 8,
                 off_diag_weight: float = 0.0051, batch_divisor_mult: float = 4.0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        half = feature_dim // 2
        self.feature_dim, self.common_ratio = feature_dim, common_ratio
        self.off_diag_weight, self.batch_divisor_mult = off_diag_weight, batch_divisor_mult
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.projector1 = Dense(fundus_dim, feature_dim, **kw)
        self.projector2 = Dense(oct_dim, feature_dim, **kw)
        self.guided_projector1 = Dense(guided_in_dim, half, **kw)
        self.guided_projector2 = Dense(guided_in_dim, half, **kw)
        self.self_attn1 = AttentionModel(half, num_heads, **kw)
        self.self_attn2 = AttentionModel(half, num_heads, **kw)
        self.shared_projector = Dense(fundus_dim, half, **kw)
        self.cross_attn1 = AttentionModel(half, num_heads, **kw)
        self.cross_attn2 = AttentionModel(half, num_heads, **kw)
        self.bn1 = BatchNorm(feature_dim, device=device)
        self.bn2 = BatchNorm(feature_dim, device=device)

    def forward(self, fundus_tokens, oct_tokens, shared_features, fundus_guided, oct_guided):
        half = self.feature_dim // 2
        b = fundus_tokens.shape[0]
        y1 = self.projector1(fundus_tokens)
        y2 = self.projector2(oct_tokens)
        y1_unique, y1_common = y1[..., :half], y1[..., half:]
        y2_unique, y2_common = y2[..., :half], y2[..., half:]

        fq = self.guided_projector1(fundus_guided)[:, None, :]
        oq = self.guided_projector2(oct_guided)[:, None, :]
        y1_uni = self.self_attn1(fq, y1_unique, y1_unique).mean(dim=1)
        y2_uni = self.self_attn2(oq, y2_unique, y2_unique).mean(dim=1)

        shared = self.shared_projector(shared_features)[:, None, :]
        y1_com = self.cross_attn1(shared, y1_common, y1_common)[:, 0]
        y2_com = self.cross_attn2(shared, y2_common, y2_common)[:, 0]

        z1 = self.bn1(torch.cat([y1_com, y1_uni], dim=1))
        z2 = self.bn2(torch.cat([y2_com, y2_uni], dim=1))
        loss, _, _ = barlow_block_loss(
            z1, z2,
            common_dim=int(self.common_ratio * self.feature_dim),
            batch_divisor=float(b) * self.batch_divisor_mult,
            off_diag_weight=self.off_diag_weight,
        )
        combined = torch.cat([z1[:, half:], (y1_com + y2_com).float(), z2[:, half:]], dim=1)
        return combined, loss

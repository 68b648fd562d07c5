"""Auxiliary reference modules (``edrl_tpu/models/auxiliary.py``): off the
MedFusion path, part of the reference's public surface, usable in ablations.

- ``MIAttentionFusion``: tri-input attention, global queries over the
  concatenated keys and values (``fusion_net.py:288-343``), the reference's
  key order (general, 3d, 2d) against its value order (general, 2d, 3d)
  kept as written;
- ``PID``: per-modality self-attention, then a mean over tokens
  (``fusion_net.py:405-439``);
- ``CLUBMean`` and ``MIEstimator``: the CLUB MI bound across (fundus, oct)
  and their concatenation against the global embedding
  (``fusion_net.py:482-542``), on ``ops.club``;
- ``estimate_v``: the Student-t degrees of freedom from the sample variance
  (``fusion_net.py:121-125``), which ``train.visualize`` uses too.

Dropout (``MIAttentionFusion``, rate ``dropout``) is active with
``deterministic=False``; its two keep masks (the attention's output, then
the module's own) come from ``dropout_masks`` or else from ``generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.models.eprl import dropout
from edrl_tpu_torch.models.layers import Dense, LayerNorm, MultiHeadAttention
from edrl_tpu_torch.ops.club import club_learning_loss, club_mean_mi


def estimate_v(z_proxy, epsilon: float = 1e-8) -> torch.Tensor:
    """Student-t dof ``max(2 var / (var - 1 + eps), 2)``, var over axis 1."""
    var = torch.as_tensor(z_proxy).var(dim=1, correction=0)
    return torch.clamp_min(2.0 * var / (var - 1.0 + epsilon), 2.0)


class MIAttentionFusion(nn.Module):
    def __init__(self, dim_2d: int, dim_3d: int, dim_general: int, *, num_heads: int = 8, out_dim: int = 128,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        d = out_dim
        self.out_dim, self.rate = d, dropout
        kw = dict(dtype=dtype, device=device)
        self.qkv_fundus = Dense(dim_2d, 3 * d, **kw)
        self.qkv_oct = Dense(dim_3d, 3 * d, **kw)
        self.qkv_general = Dense(dim_general, 3 * d, **kw)
        self.attn = MultiHeadAttention(d, num_heads, **kw)
        self.LayerNorm_0 = LayerNorm(d, fast_variance=True, **kw)

    def forward(self, x_2d, x_3d, x_global, *, deterministic: bool = True,
                dropout_masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        q2, k2, v2 = self.qkv_fundus(x_2d).chunk(3, dim=-1)
        q3, k3, v3 = self.qkv_oct(x_3d).chunk(3, dim=-1)
        qg, kg, vg = self.qkv_general(x_global).chunk(3, dim=-1)
        keys = torch.cat([kg, k3, k2], dim=1)
        vals = torch.cat([vg, v2, v3], dim=1)
        out = self.attn(qg, keys, vals)
        masks = list(dropout_masks) if dropout_masks is not None else [None, None]
        if not deterministic and self.rate > 0:
            out = dropout(dropout(out, self.rate, masks[0], generator), self.rate, masks[1], generator)
        return self.LayerNorm_0(out)


class PID(nn.Module):
    """Returns ``(x_2d_vec [B, embed_dim], x_3d_vec [B, embed_dim])``: the 3-D
    stream is lifted ``embed_dim_3d`` -> ``embed_dim`` before the mean."""

    def __init__(self, *, embed_dim: int = 1024, embed_dim_3d: int = 768, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.self_attn_2d = MultiHeadAttention(embed_dim, num_heads, **kw)
        self.self_attn_3d = MultiHeadAttention(embed_dim_3d, num_heads, **kw)
        self.lift = Dense(embed_dim_3d, embed_dim, **kw)

    def forward(self, x_2d, x_3d) -> Tuple[torch.Tensor, torch.Tensor]:
        a2 = self.self_attn_2d(x_2d, x_2d, x_2d)
        a3 = F.relu(self.lift(self.self_attn_3d(x_3d, x_3d, x_3d)))
        return a2.mean(dim=1), a3.mean(dim=1)


class CLUBMean(nn.Module):
    """The CLUB estimator head: an MLP for q(y|x)'s mean, then the bound
    (``mode="mi"``) or the estimator's loss."""

    def __init__(self, x_dim: int, y_dim: int, *, hidden: int = 512, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.p_mu1 = Dense(x_dim, hidden, dtype=dtype, device=device)
        self.p_mu2 = Dense(hidden, y_dim, dtype=dtype, device=device)

    def forward(self, x_samples, y_samples, *, mode: str = "mi"):
        mu = self.p_mu2(F.relu(self.p_mu1(x_samples)))
        return club_mean_mi(mu, y_samples) if mode == "mi" else club_learning_loss(mu, y_samples)


class MIEstimator(nn.Module):
    """The bound of (histology -> pathways) plus that of (their concatenation
    -> the global embedding), each ``dim`` wide; ``histology_dim`` defaults
    to ``dim``."""

    def __init__(self, dim: int = 128, *, histology_dim: Optional[int] = None, device=None):
        super().__init__()
        h = dim if histology_dim is None else histology_dim
        self.mimin = CLUBMean(h, dim, device=device)
        self.mimin_glob = CLUBMean(h + dim, dim, device=device)

    def forward(self, histology, pathways, global_embed, *, mode: str = "mi"):
        mi = self.mimin(histology, pathways, mode=mode)
        return mi + self.mimin_glob(torch.cat([histology, pathways], dim=1), global_embed, mode=mode)

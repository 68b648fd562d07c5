"""3-D Vision Transformer OCT backbone (``edrl_tpu/models/vit3d.py``).

At the shipped config (volume 96, patch 16, 12 blocks of 768 with 6 heads of
128) it maps ``[B, 96, 96, 96, 1]`` to tokens ``[B, 216, 768]``.  With
``use_fused_attention`` each block's attention runs through
``self_attention_fused`` (the CUDA kernel on the card, its plain version on
the CPU); ``use_fused_ln`` and ``use_fused_mlp`` route its LayerNorms and
MLPs through B4 and B5 where the width is a multiple of 128.
"""

from __future__ import annotations

import torch
from torch import nn

from edrl_tpu_torch.models.layers import Dense, LayerNorm, SelfAttentionBlock, trunc_normal_


class ViT3D(nn.Module):
    """Returns ``(tokens [B, N, dim], pooled [B, dim])`` for [B, D, H, W, C] input."""

    def __init__(self, *, volume_size: int = 96, patch_size: int = 16, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 in_channels: int = 1, use_fused_attention: bool = False,
                 use_fused_ln: bool = False, use_fused_mlp: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.depth = depth
        self.dtype = dtype
        n = (volume_size // patch_size) ** 3
        self.patch_embed = Dense(patch_size ** 3 * in_channels, dim, dtype=dtype, device=device)
        self.pos_embed = nn.Parameter(torch.empty((1, n, dim), dtype=torch.float32, device=device))
        for i in range(depth):
            setattr(self, f"SelfAttentionBlock_{i}", SelfAttentionBlock(
                dim, num_heads, mlp_ratio=mlp_ratio, use_fused_attention=use_fused_attention,
                use_fused_ln=use_fused_ln, use_fused_mlp=use_fused_mlp, dtype=dtype, device=device,
            ))
        self.final_norm = LayerNorm(dim, dtype=dtype, use_fused=use_fused_ln, device=device)

    def flax_init_(self, generator):
        trunc_normal_(self.pos_embed, 0.02, generator)

    def forward(self, x):
        b, d, h, w, c = x.shape
        p = self.patch_size
        x = x.to(self.dtype)
        # 3-D patchify with the channel folded into the innermost patch axis.
        x = x.reshape(b, d // p, p, h // p, p, w // p, p * c).permute(0, 1, 3, 5, 2, 4, 6)
        x = x.reshape(b, (d // p) * (h // p) * (w // p), p * p * p * c)
        x = self.patch_embed(x) + self.pos_embed.to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"SelfAttentionBlock_{i}")(x)
        x = self.final_norm(x)
        return x, x.mean(dim=1)

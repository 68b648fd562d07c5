"""Swin-Transformer 2-D fundus backbone (``edrl_tpu/models/swin2d.py``).

At the shipped config (image 384, patch 4, embed 128, depths (2, 2, 6, 2),
heads (1, 2, 4, 8), window 12) it maps ``[B, 384, 384, 3]`` to tokens
``[B, 144, 1024]``.  Blocks run in the persistent windowed layout
``[B, nW, N, C]``; shifted blocks re-window once on each side of their
attention.  With ``use_fused_attention`` the window attention reads its
q/k/v in place from the packed qkv projection (``window_attention_fused_v2``:
the CUDA kernel on the card, its plain version on the CPU); with
``use_fused_ln`` and ``use_fused_mlp`` every LayerNorm and MLP of the
backbone whose width routes (a multiple of 128) takes the fused kernels B4
and B5, at the JAX package's sites.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from edrl_tpu_torch.models.layers import Dense, LayerNorm, Mlp, scaled_dot_attention, trunc_normal_


def relative_position_index(window: int) -> np.ndarray:
    """Static [w*w, w*w] index into the (2w-1)^2 relative-bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def rel_bias_from_table(table, index, num_heads: int, dtype: torch.dtype):
    """``[(2w-1)^2, heads]`` table -> ``[heads, n, n]`` f32 additive bias.

    The JAX package looks the table up with a one-hot matmul in the module
    dtype, with f32 accumulation.  Each output of that product is exactly one
    table entry rounded to ``dtype``, so a gather from the f32 table rounded
    to ``dtype`` after gives the same values bit for bit.  Gathering first
    keeps the backward in f32: the ~n^2 / (2w-1)^2 duplicates per slot are
    summed in f32 (as the one-hot product's transpose does), not in bf16.
    """
    n = index.shape[0]
    bias = table[index.reshape(-1)].to(dtype).float().reshape(n, n, num_heads)
    return bias.permute(2, 0, 1)


def shift_attn_mask(grid: int, window: int, shift: int) -> np.ndarray:
    """Static additive mask [num_windows, w*w, w*w] (0 or -1e9, f32)."""
    img = np.zeros((grid, grid), dtype=np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    nw = grid // window
    img = img.reshape(nw, window, nw, window).transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


def window_partition(x, window: int):
    """[B, H, W, C] -> [B, nW, window*window, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // window) * (w // window), window * window, c)


def window_merge(x, window: int, h: int, w: int):
    """[B, nW, window*window, C] -> [B, H, W, C]."""
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // window, w // window, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def shift_windows(xw, window: int, grid: int, shift: int):
    """Re-window [B, nW, N, C] after rolling the feature map by ``shift``."""
    x = torch.roll(window_merge(xw, window, grid, grid), shifts=(shift, shift), dims=(1, 2))
    return window_partition(x, window)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int, *, use_fused: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.window = window
        self.num_heads = num_heads
        self.use_fused = use_fused
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.rel_bias_table = nn.Parameter(
            torch.empty(((2 * window - 1) ** 2, num_heads), dtype=torch.float32, device=device)
        )
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        index = torch.as_tensor(relative_position_index(window), dtype=torch.long, device=device)
        self.register_buffer("rel_index", index, persistent=False)

    def flax_init_(self, generator):
        trunc_normal_(self.rel_bias_table, 0.02, generator)

    def forward(self, x, mask=None):
        """x: [B, nW, N, C]; mask: [nW, N, N] additive f32 or None."""
        b, nw, n, _ = x.shape
        head_dim = self.dim // self.num_heads
        scale = head_dim ** -0.5
        qkv = self.qkv(x)
        bias = rel_bias_from_table(self.rel_bias_table, self.rel_index, self.num_heads, self.dtype)
        if self.use_fused:
            from edrl_tpu_torch.kernels.window_attention import window_attention_fused_v2

            full_bias = bias[None].expand(nw, self.num_heads, n, n)
            if mask is not None:
                full_bias = full_bias + mask[:, None]
            out = window_attention_fused_v2(
                qkv, full_bias.contiguous(), self.num_heads, scale
            )
        else:
            qkv = qkv.reshape(b, nw, n, 3, self.num_heads, head_dim)
            q, k, v = (qkv[..., i, :, :].transpose(2, 3) for i in range(3))  # [B, nW, H, N, D]
            attn_bias = bias[None, None]
            if mask is not None:
                attn_bias = attn_bias + mask[None, :, None]
            out = scaled_dot_attention(q, k, v, scale, bias=attn_bias)
            out = out.transpose(2, 3).reshape(b, nw, n, self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, grid: int, num_heads: int, window: int, shift: int, *,
                 mlp_ratio: float = 4.0, use_fused_attention: bool = False,
                 use_fused_ln: bool = False, use_fused_mlp: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.grid = grid
        self.window = min(window, grid)
        self.shift = shift if self.window < grid else 0
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype, use_fused=use_fused_ln, device=device)
        self.WindowAttention_0 = WindowAttention(
            dim, self.window, num_heads, use_fused=use_fused_attention, dtype=dtype, device=device
        )
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype, use_fused=use_fused_ln, device=device)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype, use_fused=use_fused_mlp,
                         device=device)
        if self.shift > 0:
            mask = torch.as_tensor(shift_attn_mask(grid, self.window, self.shift), device=device)
            self.register_buffer("shift_mask", mask, persistent=False)
        else:
            self.shift_mask = None

    def forward(self, xw):
        """xw: [B, nW, N, C] in the persistent windowed layout."""
        h = self.LayerNorm_0(xw)
        if self.shift > 0:
            h = shift_windows(h, self.window, self.grid, -self.shift)
        h = self.WindowAttention_0(h, mask=self.shift_mask)
        if self.shift > 0:
            h = shift_windows(h, self.window, self.grid, self.shift)
        xw = xw + h
        return xw + self.Mlp_0(self.LayerNorm_1(xw))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32, use_fused_ln: bool = False,
                 device=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(4 * dim, dtype=dtype, use_fused=use_fused_ln, device=device)
        self.Dense_0 = Dense(4 * dim, 2 * dim, use_bias=False, dtype=dtype, device=device)

    def forward(self, x):
        # Channel order (sh, sw, c), as the JAX strided-slice concat.
        x = torch.cat([x[:, i::2, j::2, :] for i in (0, 1) for j in (0, 1)], dim=-1)
        return self.Dense_0(self.LayerNorm_0(x))


class SwinTransformer2D(nn.Module):
    """Returns ``(tokens [B, N, C_final], pooled [B, C_final])``."""

    def __init__(self, *, img_size: int = 384, patch_size: int = 4, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (4, 8, 16, 32),
                 window: int = 12, mlp_ratio: float = 4.0, use_fused_attention: bool = False,
                 use_fused_ln: bool = False, use_fused_mlp: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.depths = tuple(depths)
        self.window = window
        ln = dict(dtype=dtype, use_fused=use_fused_ln, device=device)
        self.patch_embed = Dense(patch_size * patch_size * 3, embed_dim, dtype=dtype, device=device)
        self.LayerNorm_0 = LayerNorm(embed_dim, **ln)
        grid, dim, block = img_size // patch_size, embed_dim, 0
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            for i in range(depth):
                setattr(self, f"SwinBlock_{block}", SwinBlock(
                    dim, grid, heads, window, 0 if i % 2 == 0 else window // 2,
                    mlp_ratio=mlp_ratio, use_fused_attention=use_fused_attention,
                    use_fused_ln=use_fused_ln, use_fused_mlp=use_fused_mlp, dtype=dtype, device=device,
                ))
                block += 1
            if stage != len(depths) - 1:
                setattr(self, f"PatchMerging_{stage}", PatchMerging(
                    dim, dtype=dtype, use_fused_ln=use_fused_ln, device=device))
                dim *= 2
                grid //= 2
        self.final_norm = LayerNorm(dim, **ln)

    def forward(self, x):
        """x: [B, H, W, 3] (NHWC, values in [0, 1])."""
        b, h, w, c = x.shape
        p = self.patch_size
        x = x.to(self.dtype)
        # Patchify with the channel folded into the innermost patch axis.
        x = x.reshape(b, h // p, p, w // p, p * c).permute(0, 1, 3, 2, 4)
        x = x.reshape(b, h // p, w // p, p * p * c)
        x = self.LayerNorm_0(self.patch_embed(x))
        grid, block = h // p, 0
        for stage, depth in enumerate(self.depths):
            window = min(self.window, grid)
            xw = window_partition(x, window)
            for _ in range(depth):
                xw = getattr(self, f"SwinBlock_{block}")(xw)
                block += 1
            x = window_merge(xw, window, grid, grid)
            if stage != len(self.depths) - 1:
                x = getattr(self, f"PatchMerging_{stage}")(x)
                grid //= 2
        x = self.final_norm(x)
        tokens = x.reshape(b, grid * grid, x.shape[-1])
        return tokens, tokens.mean(dim=1)

"""Shared building blocks (``edrl_tpu/models/layers.py``).

Conventions carried over from the JAX package:

- parameters are float32; each module computes in its ``dtype`` (bfloat16
  on the main path), and softmax and normalisation statistics stay float32;
- module and parameter names are flax's (``Dense_0``, ``LayerNorm_0``,
  ``qkv``, ``proj``...), so that ``edrl_tpu_torch.convert`` maps a flax tree
  onto a module by name alone; a flax Dense ``kernel [in, out]`` is a
  :class:`Dense` ``weight [out, in]``;
- ``nn.gelu`` is the tanh form, and LayerNorm's eps is 1e-6.

Every module takes an explicit ``device``.  Parameters are allocated empty;
:func:`init_parameters` fills them from a ``torch.Generator`` with the
distributions of the flax initialisers, and ``convert.load_flax_variables``
fills them from a flax tree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.kernels.fused_mlp import fused_mlp
from edrl_tpu_torch.kernels.layer_norm import fused_layer_norm, layer_norm_reference

# ---------------------------------------------------------------------------
# Flax initialisers, drawn from an explicit generator.
# ---------------------------------------------------------------------------

# Std of a unit normal truncated to [-2, 2] (flax variance_scaling's constant).
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Normal(0, std) truncated to +-2 std (flax ``truncated_normal(std)``)."""
    nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator, fan_in_dim: int = 1) -> None:
    """Flax ``lecun_normal``; fan_in is ``weight.shape[fan_in_dim]`` (1 for a
    torch ``[out, in]`` weight, 0 for a flax-layout ``[in, out]`` one)."""
    trunc_normal_(weight, math.sqrt(1.0 / weight.shape[fan_in_dim]) / _TRUNC_STD, generator)


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> None:
    """Flax ``xavier_uniform``: U(+-sqrt(6 / (fan_in + fan_out)))."""
    limit = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    nn.init.uniform_(t, -limit, limit, generator=generator)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of ``model`` with its flax-style init."""
    for module in model.modules():
        init = getattr(module, "flax_init_", None)
        if init is not None:
            init(generator)
    return model


@torch.no_grad()
def cast_dense_weights_(model: nn.Module) -> nn.Module:
    """Store every :class:`Dense`'s weight and bias in its compute dtype, and
    a fused :class:`Mlp`'s ``w1`` and ``w2`` in bf16.

    For serving.  A Dense casts both to its ``dtype`` on every call, and the
    fused MLP rounds its weights to bf16 in either dtype, so storing them cast
    gives the same products, bit for bit, without a cast kernel per tensor
    and call (about 460 launches per bf16 forward at full width).  The fused
    MLP's ``b1`` and ``b2`` stay f32: it adds them in f32.  The model's
    float32 master weights are gone afterwards.
    """
    for module in model.modules():
        if isinstance(module, Dense):
            module.weight.data = module.weight.data.to(module.dtype)
            if module.bias is not None:
                module.bias.data = module.bias.data.to(module.dtype)
        elif isinstance(module, Mlp) and module.fused:
            module.w1.data = module.w1.data.to(torch.bfloat16)
            module.w2.data = module.w2.data.to(torch.bfloat16)
    return model


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """flax ``nn.Dense``: inputs, weight and bias are cast to ``dtype``."""

    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param((out_features, in_features), device)
        self.bias = _param((out_features,), device) if use_bias else None

    def flax_init_(self, generator):
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with f32 statistics, eps 1e-6.

    The default matches ``edrl_tpu.models.layers.FusedLayerNorm``: cast x to
    ``dtype``, then ``layer_norm_reference``, or, with ``use_fused`` and a
    width that is a multiple of 128 (flax's rule), ``fused_layer_norm`` over
    the rows (B4: the CUDA kernels on the card, their plain versions on the
    CPU).  ``fast_variance=True`` matches flax's own ``nn.LayerNorm`` (used
    by DILR's ``AttentionModel``): var = E[x^2] - E[x]^2 clipped at 0, and
    (x - mean) * (rsqrt(var + eps) * scale) + bias.
    """

    def __init__(self, dim: int, *, dtype: torch.dtype = torch.float32, eps: float = 1e-6,
                 fast_variance: bool = False, use_fused: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.fast_variance = fast_variance
        self.fused = use_fused and dim % 128 == 0
        self.weight = _param((dim,), device)
        self.bias = _param((dim,), device)

    def flax_init_(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        if self.fused:
            x = x.to(self.dtype)
            y = fused_layer_norm(x.reshape(-1, x.shape[-1]), self.weight, self.bias, self.eps)
            return y.reshape(x.shape)
        if not self.fast_variance:
            return layer_norm_reference(x.to(self.dtype), self.weight, self.bias, self.eps)
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mu.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mu) * mul + self.bias).to(self.dtype)


class Mlp(nn.Module):
    """Dense -> tanh-GELU -> Dense (the backbones' dropout is 0).

    With ``use_fused``, ``in_dim == out_dim`` and both widths multiples of
    128 (flax's ``fusable`` rule), the MLP runs through ``fused_mlp`` (B5: the
    CUDA kernels on the card, their plain versions on the CPU) and owns
    ``w1 [in, hidden]``, ``b1``, ``w2 [hidden, out]`` and ``b2`` in flax's
    layout, under flax's names; otherwise it has ``Dense_0`` and ``Dense_1``.
    """

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, *,
                 dtype: torch.dtype = torch.float32, use_fused: bool = False, device=None):
        super().__init__()
        self.dtype = dtype
        self.fused = (use_fused and in_dim == out_dim and in_dim % 128 == 0
                      and hidden_dim % 128 == 0)
        if self.fused:
            self.w1 = _param((in_dim, hidden_dim), device)
            self.b1 = _param((hidden_dim,), device)
            self.w2 = _param((hidden_dim, out_dim), device)
            self.b2 = _param((out_dim,), device)
        else:
            self.Dense_0 = Dense(in_dim, hidden_dim, dtype=dtype, device=device)
            self.Dense_1 = Dense(hidden_dim, out_dim, dtype=dtype, device=device)

    def flax_init_(self, generator):
        if self.fused:
            lecun_normal_(self.w1, generator, fan_in_dim=0)
            lecun_normal_(self.w2, generator, fan_in_dim=0)
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, x):
        if self.fused:
            c = x.shape[-1]
            y = fused_mlp(x.to(self.dtype).reshape(-1, c), self.w1, self.b1, self.w2, self.b2)
            return y.reshape(x.shape)
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


def scaled_dot_attention(q, k, v, scale: float, bias: Optional[torch.Tensor] = None):
    """Attention core, ``[..., heads, tokens, head_dim]``.

    Scores and softmax in f32 (products of the inputs accumulated in f32),
    probabilities cast to the input dtype before the value product, output
    in the input dtype: the casts of ``edrl_tpu.models.layers``.
    """
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        attn = attn + bias
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)


class MultiHeadAttention(nn.Module):
    """Q/KV multi-head attention with separate query and key/value inputs.

    ``use_fused`` routes equal, 8-aligned query/key token counts through the
    fused self-attention (the CUDA kernel on the card, its plain version on
    the CPU).
    """

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = True,
                 use_fused: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.use_fused = use_fused
        for name in ("q", "k", "v"):
            setattr(self, name, Dense(dim, dim, use_bias=qkv_bias, dtype=dtype, device=device))
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, q_in, k_in, v_in):
        head_dim = self.dim // self.num_heads
        scale = head_dim ** -0.5
        q, k, v = self.q(q_in), self.k(k_in), self.v(v_in)  # [B, N, C]
        if self.use_fused and q.shape[1] == k.shape[1] and q.shape[1] % 8 == 0:
            from edrl_tpu_torch.kernels.window_attention import self_attention_fused

            out = self_attention_fused(q, k, v, self.num_heads, scale)
        else:
            def split(y):
                return y.reshape(y.shape[0], y.shape[1], self.num_heads, head_dim).transpose(1, 2)

            out = scaled_dot_attention(split(q), split(k), split(v), scale)
            out = out.transpose(1, 2).reshape(out.shape[0], -1, self.dim)
        return self.proj(out)


class SelfAttentionBlock(nn.Module):
    """Pre-LN transformer encoder block (attention + MLP with residuals)."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 use_fused_attention: bool = False, use_fused_ln: bool = False,
                 use_fused_mlp: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype=dtype, use_fused=use_fused_ln, device=device)
        self.MultiHeadAttention_0 = MultiHeadAttention(
            dim, num_heads, use_fused=use_fused_attention, dtype=dtype, device=device
        )
        self.LayerNorm_1 = LayerNorm(dim, dtype=dtype, use_fused=use_fused_ln, device=device)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype, use_fused=use_fused_mlp,
                         device=device)

    def forward(self, x):
        h = self.LayerNorm_0(x)
        x = x + self.MultiHeadAttention_0(h, h, h)
        return x + self.Mlp_0(self.LayerNorm_1(x))

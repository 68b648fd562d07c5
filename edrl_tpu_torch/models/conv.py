"""The convolutional building blocks of the baseline zoo's backbones, as flax has them.

The JAX backbones are channel-last (NHWC, NDHWC); so are these modules at
their boundaries, which keeps ``jnp.split`` along channels, the
concatenations and the pooled features in flax's channel order.  Inside, a
contiguous channel-last tensor is handed to cuDNN as the ``channels_last``
(``channels_last_3d``) view ``permute(0, -1, 1, ..)``, with no copy.

- :func:`same_padding`: flax's ``"SAME"``, ``total = max((ceil(n / s) - 1)
  * s + k - n, 0)``, ``total // 2`` low and the rest high.  At stride 2 it is
  asymmetric (a 3x3 on 384: (0, 1); a 7^3 on 96: (2, 3)), where torch's
  ``padding=`` is symmetric: an asymmetric pad is made with ``F.pad`` and
  the convolution or pool runs with ``padding=0``.
- :class:`Conv`: flax ``nn.Conv`` (``kernel [k.., in, out]`` there, ``weight
  [out, in, k..]`` here; ``lecun_normal`` over ``in * prod(k)``; optional
  bias), computing in its ``dtype``.
- :func:`max_pool` pads with -inf; :func:`avg_pool` counts the padding
  (flax's ``count_include_pad=True``): zeros, and a divisor of ``prod(k)``.
- :class:`BatchNorm`: flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` with
  its scale and bias, in its parameters' dtype (f32), over every axis but
  the last.  Train mode
  normalises with the batch mean and the *biased* variance E[x^2] - E[x]^2
  (flax's fast variance, clipped at 0), and moves the running statistics
  toward them by 0.1 (torch's momentum); ``F.batch_norm`` would move the
  running variance toward the unbiased one.  The statistics are computed
  once, and one autograd node saves only the input.

Under a data axis (``parallel.use_mesh``) train mode's statistics are the
global batch's: the forward sums the per-channel sums and sums of squares
over the ranks (one all-reduce), the backward its two sums (one more); the
node still saves only the input.

``model.double()`` makes a CNN baseline its own f64 reference: Conv, Dense
and BatchNorm then compute in f64 (``layers.compute_dtype``).  Train-mode
BatchNorm at random init amplifies f32 rounding by 1e4-1e5 in a deep stack
(f32 against f64, 1e-2 of a gradient's largest magnitude at the median), so
the f32 train step's gradients are held against that reference.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.models.layers import _TRUNC_STD, _param, compute_dtype, trunc_normal_
from edrl_tpu_torch.parallel.mesh import all_reduce_sum, current_axis, global_rows, sum_over


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``"SAME"`` padding ``(low, high)`` of one spatial axis."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]):
    """The ``(low, high)`` pad of each spatial axis of channel-last ``x``."""
    return [same_padding(n, k, s) for n, k, s in zip(x.shape[1:-1], kernel, stride)]


def _pad_channel_last(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    """``F.pad`` of the spatial axes of a channel-last tensor (its output is
    contiguous channel-last again)."""
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    """``[B, *S, C]`` -> the ``[B, C, *S]`` view (``channels_last`` memory)."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, *range(2, x.dim()), 1)


def _window_op(x, kernel, stride, pad_value, op):
    """``op(x_channels_first, padding)`` with flax's SAME padding: a symmetric
    pad through ``padding=``, an asymmetric one through ``F.pad``."""
    pads = _pads(x, kernel, stride)
    if all(lo == hi for lo, hi in pads):
        return _to_channels_last(op(_to_channels_first(x), tuple(lo for lo, _ in pads)))
    x = _pad_channel_last(x, pads, pad_value)
    return _to_channels_last(op(_to_channels_first(x), 0))


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``padding="SAME"`` over a channel-last input."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Sequence[int], *,
                 stride: int = 1, use_bias: bool = True, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.stride = (stride,) * len(self.kernel)
        self.dtype = dtype
        self.weight = _param((out_channels, in_channels, *self.kernel), device)
        self.bias = _param((out_channels,), device) if use_bias else None
        self._conv = {2: F.conv2d, 3: F.conv3d}[len(self.kernel)]

    def flax_init_(self, generator):
        fan_in = self.weight.shape[1] * math.prod(self.kernel)
        trunc_normal_(self.weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        dtype = compute_dtype(self.dtype, self.weight)
        x, w = x.to(dtype), self.weight.to(dtype)
        b = None if self.bias is None else self.bias.to(dtype)
        return _window_op(x, self.kernel, self.stride, 0.0,
                          lambda y, pad: self._conv(y, w, b, self.stride, pad))


def max_pool(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    """flax ``nn.max_pool(x, kernel, stride, padding="SAME")``, channel-last."""
    pool = {2: F.max_pool2d, 3: F.max_pool3d}[len(kernel)]
    return _window_op(x, kernel, stride, float("-inf"), lambda y, pad: pool(y, kernel, stride, pad))


def avg_pool(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    """flax ``nn.avg_pool(x, kernel, stride, padding="SAME")``, channel-last:
    the padding counts (zeros in the sum, ``prod(kernel)`` in the divisor)."""
    pool = {2: F.avg_pool2d, 3: F.avg_pool3d}[len(kernel)]
    div = math.prod(kernel)
    return _window_op(x, kernel, stride, 0.0,
                      lambda y, pad: pool(y, kernel, stride, pad, count_include_pad=True, divisor_override=div))


class _BatchNormTrain(torch.autograd.Function):
    """``(x - mean) * (invstd * scale) + bias`` with the batch's statistics,
    differentiated through them (the closed-form BatchNorm backward); saves
    ``x`` and the per-channel statistics only.  Under a data ``axis`` the
    statistics are the global batch's: dx takes the two sums over every
    rank's rows (one all-reduce); scale and bias take this rank's, which the
    average of the gradients over the ranks sums."""

    @staticmethod
    def forward(ctx, x, mean, invstd, scale, bias, axis):
        ctx.save_for_backward(x, mean, invstd, scale)
        ctx.axis = axis
        return (x - mean) * (invstd * scale) + bias

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, scale = ctx.saved_tensors
        dims = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1] * (1 if ctx.axis is None else ctx.axis.size)
        dy = dy.float()
        xhat = (x - mean) * invstd
        sums = torch.cat([dy.sum(dim=dims), (dy * xhat).sum(dim=dims)])
        sum_dy, sum_dy_xhat = sums.chunk(2)
        all_dy, all_dy_xhat = sum_over(sums, ctx.axis).chunk(2)
        dx = (invstd * scale) * (dy - all_dy / n - xhat * (all_dy_xhat / n))
        return dx, None, None, sum_dy_xhat, sum_dy, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    the last axis of an N-d channel-last input, with scale and bias,
    computing in its parameters' dtype."""

    momentum = 0.1

    def __init__(self, dim: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param((dim,), device)
        self.bias = _param((dim,), device)
        self.register_buffer("running_mean", torch.empty((dim,), device=device))
        self.register_buffer("running_var", torch.empty((dim,), device=device))

    def flax_init_(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x, train: bool = False):
        x = x.to(self.weight.dtype)
        if not train:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean) * mul + self.bias
        dims = tuple(range(x.dim() - 1))
        with torch.no_grad():
            sums = all_reduce_sum(torch.cat([x.sum(dim=dims), x.square().sum(dim=dims)]))
            mean, mean_sq = (sums / global_rows(x.numel() // x.shape[-1])).chunk(2)
            var = (mean_sq - mean.square()).clamp_min(0.0)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            invstd = torch.rsqrt(var + self.eps)
        return _BatchNormTrain.apply(x, mean, invstd, self.weight, self.bias, current_axis())

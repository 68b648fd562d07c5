"""Res2Net 2-D CNN backbone of the baseline zoo (``edrl_tpu/models/resnet2d.py``).

A bottleneck ResNet whose 3x3 stage is the Res2Net multi-scale hierarchy:
the width is split into ``scales`` groups, and each group's 3x3 conv takes
the previous group's output added in.  Channel-last (NHWC) at the module
boundaries; convolutions on cuDNN through ``models.conv``.  The BatchNorms
run in f32 whatever the compute ``dtype``, so the map and the pooled vector
are f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.models.conv import BatchNorm, Conv, avg_pool, max_pool


class Res2NetBottleneck(nn.Module):
    def __init__(self, in_channels: int, width: int, out_channels: int, *, scales: int = 4, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        mid = width * scales
        self.width, self.scales, self.stride = width, scales, stride
        kw = dict(use_bias=False, dtype=dtype, device=device)
        self.conv1 = Conv(in_channels, mid, (1, 1), **kw)
        self.bn1 = BatchNorm(mid, device=device)
        # Split 0 never goes through a conv: identity in ordinary blocks,
        # avg-pooled in stage (stride > 1) blocks.
        for i in range(1, scales):
            setattr(self, f"conv3x3_{i}", Conv(width, width, (3, 3), stride=stride, **kw))
            setattr(self, f"bn3x3_{i}", BatchNorm(width, device=device))
        self.conv3 = Conv(mid, out_channels, (1, 1), **kw)
        self.bn3 = BatchNorm(out_channels, device=device)
        self.has_downsample = in_channels != out_channels or stride != 1
        if self.has_downsample:
            self.downsample = Conv(in_channels, out_channels, (1, 1), stride=stride, **kw)
            self.bn_down = BatchNorm(out_channels, device=device)

    def forward(self, x, train: bool = False):
        h = F.relu(self.bn1(self.conv1(x), train))
        splits = torch.split(h, self.width, dim=-1)
        s = (self.stride, self.stride)
        outs = [splits[0] if self.stride == 1 else avg_pool(splits[0], (3, 3), s)]
        prev = None
        for i in range(1, self.scales):
            inp = splits[i] if prev is None else splits[i] + prev
            o = F.relu(getattr(self, f"bn3x3_{i}")(getattr(self, f"conv3x3_{i}")(inp), train))
            outs.append(o)
            # Stage blocks have no hierarchical residual chain.
            prev = o if self.stride == 1 else None
        h = self.bn3(self.conv3(torch.cat(outs, dim=-1)), train)
        if self.has_downsample:
            x = self.bn_down(self.downsample(x), train)
        return F.relu(x + h)


class Res2Net2D(nn.Module):
    """Returns ``(feature_map [B, H/32, W/32, C], pooled [B, C])`` for an
    ``[B, H, W, 3]`` input.  The default is res2net50_v1b_26w_4s (v1b deep
    stem, base width 26, 4 scales, stages (3, 4, 6, 3), 2048 channels);
    ``base_width=14, scales=8`` is the 14w8s variant."""

    def __init__(self, *, base_width: int = 26, scales: int = 4, blocks: Sequence[int] = (3, 4, 6, 3),
                 stem_channels: int = 64, in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.blocks = tuple(blocks)
        kw = dict(use_bias=False, dtype=dtype, device=device)
        # v1b deep stem: three 3x3 convs, flax's automatic names.
        self.Conv_0 = Conv(in_channels, 32, (3, 3), stride=2, **kw)
        self.bn_stem1 = BatchNorm(32, device=device)
        self.Conv_1 = Conv(32, 32, (3, 3), **kw)
        self.bn_stem2 = BatchNorm(32, device=device)
        self.Conv_2 = Conv(32, stem_channels, (3, 3), **kw)
        self.bn_stem3 = BatchNorm(stem_channels, device=device)
        channels, in_ch = 256, stem_channels
        for stage, depth in enumerate(self.blocks):
            width = base_width * 2 ** stage
            for i in range(depth):
                setattr(self, f"stage{stage}_block{i}", Res2NetBottleneck(
                    in_ch, width, channels, scales=scales, stride=2 if (i == 0 and stage > 0) else 1,
                    dtype=dtype, device=device))
                in_ch = channels
            channels *= 2
        self.out_channels = in_ch

    def forward(self, x, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        h = F.relu(self.bn_stem1(self.Conv_0(x), train))
        h = F.relu(self.bn_stem2(self.Conv_1(h), train))
        h = F.relu(self.bn_stem3(self.Conv_2(h), train))
        h = max_pool(h, (3, 3), (2, 2))
        for stage, depth in enumerate(self.blocks):
            for i in range(depth):
                h = getattr(self, f"stage{stage}_block{i}")(h, train)
        return h, h.mean(dim=(1, 2))

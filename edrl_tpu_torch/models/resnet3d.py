"""3-D ResNet OCT backbone of the baseline zoo (``edrl_tpu/models/resnet3d.py``).

Basic-block 3-D ResNet-10 / ResNet-18 (Med3D's variants) over the OCT
volume.  Channel-last (NDHWC) at the module boundaries; convolutions on
cuDNN through ``models.conv``; the BatchNorms in f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edrl_tpu_torch.models.conv import BatchNorm, Conv, max_pool


class BasicBlock3D(nn.Module):
    def __init__(self, in_channels: int, channels: int, *, stride: int = 1, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, device=device)
        # flax's automatic names: Conv_0, Conv_1, then the named downsample.
        self.Conv_0 = Conv(in_channels, channels, (3, 3, 3), stride=stride, **kw)
        self.bn1 = BatchNorm(channels, device=device)
        self.Conv_1 = Conv(channels, channels, (3, 3, 3), **kw)
        self.bn2 = BatchNorm(channels, device=device)
        self.has_downsample = in_channels != channels or stride != 1
        if self.has_downsample:
            self.downsample = Conv(in_channels, channels, (1, 1, 1), stride=stride, **kw)
            self.bn_down = BatchNorm(channels, device=device)

    def forward(self, x, train: bool = False):
        h = F.relu(self.bn1(self.Conv_0(x), train))
        h = self.bn2(self.Conv_1(h), train)
        if self.has_downsample:
            x = self.bn_down(self.downsample(x), train)
        return F.relu(x + h)


class ResNet3D(nn.Module):
    """Returns ``(feature_map, pooled [B, C])`` for an ``[B, D, H, W, 1]``
    input; blocks (1, 1, 1, 1) is ResNet-10, (2, 2, 2, 2) ResNet-18."""

    def __init__(self, *, blocks: Sequence[int] = (1, 1, 1, 1), base_channels: int = 64, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.blocks = tuple(blocks)
        self.stem = Conv(in_channels, base_channels, (7, 7, 7), stride=2, use_bias=False, dtype=dtype,
                         device=device)
        self.bn_stem = BatchNorm(base_channels, device=device)
        ch = in_ch = base_channels
        for stage, depth in enumerate(self.blocks):
            for i in range(depth):
                setattr(self, f"stage{stage}_block{i}", BasicBlock3D(
                    in_ch, ch, stride=2 if (i == 0 and stage > 0) else 1, dtype=dtype, device=device))
                in_ch = ch
            if stage < len(self.blocks) - 1:
                ch *= 2
        self.out_channels = in_ch

    def forward(self, x, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        h = F.relu(self.bn_stem(self.stem(x), train))
        h = max_pool(h, (3, 3, 3), (2, 2, 2))
        for stage, depth in enumerate(self.blocks):
            for i in range(depth):
                h = getattr(self, f"stage{stage}_block{i}")(h, train)
        return h, h.mean(dim=(1, 2, 3))

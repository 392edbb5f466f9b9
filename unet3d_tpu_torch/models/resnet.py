"""3D ResNet / ResNeXt classifiers (counterpart of ``unet3d_tpu/models/resnet.py``):
torchvision's ResNet in 3D.

- Stem: ``conv1`` 7-cubed stride 2 with pads (3, 3), ``bn1``, relu, a
  3-cubed max-pool, stride 2, pads (1, 1) of -inf (not XLA's SAME);
- four stages of ``BasicBlock`` (expansion 1) or ``Bottleneck`` (expansion
  4; its 3-cubed conv grouped ``groups`` ways at width ``int(planes *
  base_width / 64) * groups``: ResNeXt), planes 64 to 512, the first block
  of stages 2-4 at stride 2, a projection (``downsample_conv`` +
  ``downsample_bn``) where the stride or the width changes;
- the global average pool and ``fc``; ``features_only`` returns the pooled
  features (the hybrid nets of ``models/custom.py``).

Every conv is Flax's ``nn.Conv`` (XLA's in the JAX package), so here it is
``layers.Conv`` on cuDNN, grouped where the block says so. BatchNorm is
Flax's at momentum 0.9, eps 1e-5. ``n_features`` is the input width (Flax
infers it; the JAX field is kept for config parity). ``block`` is the block
class (this module's), as in JAX.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import BatchNorm, Conv, Dense, max_pool


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, momentum=0.9, eps=1e-5)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64, has_downsample: bool = False):
        super().__init__()
        self.conv1 = Conv(in_channels, planes, 3, stride, 1, use_bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, use_bias=False)
        self.bn2 = _bn(planes)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = Conv(in_channels, planes, 1, stride, use_bias=False)
            self.downsample_bn = _bn(planes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        identity = (self.downsample_bn(self.downsample_conv(x), train)
                    if self.has_downsample else x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64, has_downsample: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * self.expansion
        self.conv1 = Conv(in_channels, width, 1, use_bias=False)
        self.bn1 = _bn(width)
        self.conv2 = Conv(width, width, 3, stride, 1, use_bias=False, groups=groups)
        self.bn2 = _bn(width)
        self.conv3 = Conv(width, out, 1, use_bias=False)
        self.bn3 = _bn(out)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = Conv(in_channels, out, 1, stride, use_bias=False)
            self.downsample_bn = _bn(out)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = torch.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = (self.downsample_bn(self.downsample_conv(x), train)
                    if self.has_downsample else x)
        return torch.relu(out + identity)


class ResNet(nn.Module):

    def __init__(self, block=BasicBlock, layers: Sequence[int] = (2, 2, 2, 2),
                 n_outputs: int = 1000, groups: int = 1, width_per_group: int = 64,
                 n_features: int = 3, features_only: bool = False):
        super().__init__()
        self.features_only = features_only
        self.conv1 = Conv(n_features, 64, 7, 2, 3, use_bias=False)
        self.bn1 = _bn(64)
        self.blocks = []
        in_planes = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                has_down = b == 0 and (s != 1 or in_planes != planes * block.expansion)
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, block(in_planes, planes, s, groups, width_per_group,
                                            has_down))
                self.blocks.append(name)
                in_planes = planes * block.expansion
        self.out_channels = in_planes
        if not features_only:
            self.fc = Dense(in_planes, n_outputs)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x), train))
        x = max_pool(x, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = x.mean(dim=(1, 2, 3))  # AdaptiveAvgPool3d(1) + flatten
        return x if self.features_only else self.fc(x)


def resnet_18(**kwargs) -> ResNet:
    return ResNet(block=BasicBlock, layers=(2, 2, 2, 2), **kwargs)


def resnet_34(**kwargs) -> ResNet:
    return ResNet(block=BasicBlock, layers=(3, 4, 6, 3), **kwargs)


def resnet_50(**kwargs) -> ResNet:
    return ResNet(block=Bottleneck, layers=(3, 4, 6, 3), **kwargs)


def resnet_101(**kwargs) -> ResNet:
    return ResNet(block=Bottleneck, layers=(3, 4, 23, 3), **kwargs)


def resnet_152(**kwargs) -> ResNet:
    return ResNet(block=Bottleneck, layers=(3, 8, 36, 3), **kwargs)


def resnext_50_32x4d(**kwargs) -> ResNet:
    return ResNet(block=Bottleneck, layers=(3, 4, 6, 3), groups=32, width_per_group=4,
                  **kwargs)


def resnext_101_32x8d(**kwargs) -> ResNet:
    return ResNet(block=Bottleneck, layers=(3, 4, 23, 3), groups=32, width_per_group=8,
                  **kwargs)

"""HighResNet (counterpart of ``unet3d_tpu/models/highresnet.py``): Li et
al. 2017's dilated residual net, MONAI's default 3D layer plan.

- ``conv_0``: a 3-cubed conv to 16 (no bias), ``bn_0``, relu;
- ``res_{1,2,3}_{0,1,2}``: three ``HighResBlock``s each at 16 / 32 / 64
  features, dilation 1 / 2 / 4: twice BatchNorm -> relu -> dilated 3-cubed
  conv (pre-activation), plus the identity, zero-padded on channel growth
  (``channel_matching="pad"``: ``total // 2`` channels before, the rest
  after);
- ``conv_1``: a 1-cubed conv to 80 (no bias), ``bn_1``, relu, whole-channel
  dropout (MONAI's Dropout3d) at ``dropout_prob`` from the forward's ``rng``;
- ``conv_2``: a 1-cubed conv to ``out_channels`` with its bias.

No downsampling: every conv is at full resolution. Every conv is Flax's
``nn.Conv`` with SAME padding (``d`` voxels a side at dilation ``d``; XLA's
in the JAX package, no Pallas), so here it is ``layers.Conv`` on cuDNN,
``conv_0`` included.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet3d_tpu_torch.models.layers import BatchNorm, Conv, channel_dropout

PLAN = ((16, 1), (32, 2), (64, 4))


class HighResBlock(nn.Module):
    """Two pre-activation dilated convs plus the channel-padded identity."""

    def __init__(self, in_channels: int, features: int, dilation: int = 1):
        super().__init__()
        self.features = features
        for i, c in enumerate((in_channels, features)):
            self.add_module(f"bn{i}", BatchNorm(c))
            self.add_module(f"conv{i}", Conv(c, features, 3, 1, "SAME", dilation,
                                             use_bias=False))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = x
        for i in range(2):
            y = torch.relu(getattr(self, f"bn{i}")(y, train))
            y = getattr(self, f"conv{i}")(y)
        total = self.features - x.shape[-1]
        if total:
            x = F.pad(x, (total // 2, total - total // 2))
        return y + x


class HighResNet(nn.Module):
    """MONAI HighResNet config surface (3D)."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1, out_channels: int = 1,
                 dropout_prob: float = 0.0):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch HighResNet is 3D")
        self.dropout_prob = dropout_prob
        self.conv_0 = Conv(in_channels, 16, 3, 1, "SAME", use_bias=False)
        self.bn_0 = BatchNorm(16)
        c_in = 16
        for li, (features, dilation) in enumerate(PLAN):
            for r in range(3):
                self.add_module(f"res_{li + 1}_{r}", HighResBlock(c_in, features, dilation))
                c_in = features
        self.conv_1 = Conv(c_in, 80, 1, use_bias=False)
        self.bn_1 = BatchNorm(80)
        self.conv_2 = Conv(80, out_channels, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.bn_0(self.conv_0(x), train))
        for li in range(len(PLAN)):
            for r in range(3):
                x = getattr(self, f"res_{li + 1}_{r}")(x, train)
        x = torch.relu(self.bn_1(self.conv_1(x), train))
        x = channel_dropout(x, self.dropout_prob, train, rng)
        return self.conv_2(x)

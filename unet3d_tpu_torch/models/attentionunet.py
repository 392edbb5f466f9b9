"""AttentionUnet (counterpart of ``unet3d_tpu/models/attentionunet.py``).

MONAI's AttentionUnet (Oktay et al. 2018) on NDHWC, with the JAX package's
module names:

- encoder: a ``ConvBlock`` per level (conv3 -> BatchNorm -> ReLU, twice,
  elementwise dropout between), strided by ``strides`` between levels;
- decoder, deepest first: ``UpConv`` (the overlapping transposed conv,
  ``output_padding = stride - 1``, -> BatchNorm -> ReLU), an additive
  attention gate on the same level's encoder features (``x *
  sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x)))))``, ``psi``'s BatchNorm of
  one channel), the gated features and the upsampled ones concatenated and
  merged by one MONAI ``Convolution`` (conv3 -> instance norm -> dropout ->
  PReLU);
- a pointwise head to ``out_channels``.

The BatchNorms keep their running statistics in buffers (``batch_stats``);
the dropout masks come from the forward's ``rng``.

On the space axis (``parallel/``; x a slab of the volume's D planes) each
level is D-sharded where its depth divides by the axis, else run whole on
every rank (``distributed.level_layout``): a strided ``ConvBlock`` and an
``UpConv`` (the transposed conv's halo form, ``layers.ConvTranspose``) run
between two levels (``between_levels``), the attention gate (1-cubed convs,
BatchNorms over the slabs, a sigmoid and a product, each local to its
planes) and the merge in their level's layout. The elementwise dropout on a
slab draws the slab's own mask: another draw than one device's, as on the
data axis.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import BatchNorm, FastConv, conv1, dropout, transposed_conv
from unet3d_tpu_torch.models.monai_unet import Convolution
from unet3d_tpu_torch.parallel.distributed import (at_level, between_levels, level_layout,
                                                   space_size)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.conv0 = FastConv(in_channels, features, (3, 3, 3), (strides,) * 3)
        self.bn0 = BatchNorm(features)
        self.conv1 = FastConv(features, features, (3, 3, 3))
        self.bn1 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.bn0(self.conv0(x), train))
        x = dropout(x, self.dropout, train, rng)
        return torch.relu(self.bn1(self.conv1(x), train))


class AttentionBlock(nn.Module):
    """Additive attention gate on ``x`` driven by ``g``."""

    def __init__(self, g_channels: int, x_channels: int, f_int: int):
        super().__init__()
        self.W_g = conv1(g_channels, f_int)
        self.bn_g = BatchNorm(f_int)
        self.W_x = conv1(x_channels, f_int)
        self.bn_x = BatchNorm(f_int)
        self.psi = conv1(f_int, 1)
        self.bn_psi = BatchNorm(1)

    def forward(self, g: torch.Tensor, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        a = self.bn_g(self.W_g(g), train) + self.bn_x(self.W_x(x), train)
        psi = self.bn_psi(self.psi(torch.relu(a)), train)
        return x * torch.sigmoid(psi)


class UpConv(nn.Module):
    def __init__(self, in_channels: int, features: int, strides: int = 2,
                 kernel_size: int = 3):
        super().__init__()
        self.up = transposed_conv(in_channels, features, kernel_size, strides,
                                  output_padding=strides - 1)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.bn(self.up(x), train))


class AttentionUnet(nn.Module):
    """MONAI AttentionUnet config surface (3D). ``kernel_size`` is taken
    and, as in the JAX model, unused: the blocks' convs are 3-cubed."""

    SPACE_AXIS = True  # runs on D slabs of the space mesh axis

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1, out_channels: int = 2,
                 channels: Sequence[int] = (16, 32, 64, 128),
                 strides: Sequence[int] = (2, 2, 2), kernel_size: int = 3,
                 up_kernel_size: int = 3, dropout: float = 0.0):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch AttentionUnet is 3D")
        self.n_levels = len(channels)
        self.strides = tuple(int(s) for s in strides)
        ch = tuple(channels)
        self.conv0 = ConvBlock(in_channels, ch[0], dropout=dropout)
        for i in range(1, len(ch)):
            self.add_module(f"down{i}", ConvBlock(ch[i - 1], ch[i], strides[i - 1], dropout))
        for i in range(len(ch) - 2, -1, -1):
            self.add_module(f"upconv{i}", UpConv(ch[i + 1], ch[i], strides[i], up_kernel_size))
            self.add_module(f"att{i}", AttentionBlock(ch[i], ch[i], max(ch[i] // 2, 1)))
            # MONAI AttentionLayer.merge: one default Convolution
            self.add_module(f"merge{i}", Convolution(2 * ch[i], ch[i], dropout=dropout))
        self.head = conv1(ch[0], out_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        depths = [x.shape[1] * space_size()]
        for i in range(1, self.n_levels):
            depths.append(-(-depths[-1] // self.strides[i - 1]))
        levels = level_layout(depths) or [None] * self.n_levels
        feats = [self.conv0(x, train, rng)]
        for i in range(1, self.n_levels):
            feats.append(between_levels(getattr(self, f"down{i}"), feats[-1], levels[i - 1],
                                        levels[i], train, rng))
        y = feats[-1]
        for i in range(self.n_levels - 2, -1, -1):
            up = between_levels(getattr(self, f"upconv{i}"), y, levels[i + 1], levels[i],
                                train)
            y = at_level(levels[i], self._gate, i, up, feats[i], train, rng)
        return self.head(y)

    def _gate(self, i: int, up: torch.Tensor, feat: torch.Tensor, train: bool,
              rng: Optional[torch.Generator]) -> torch.Tensor:
        """Level ``i``'s attention gate and merge."""
        att = getattr(self, f"att{i}")(up, feat, train)
        return getattr(self, f"merge{i}")(torch.cat([att, up], dim=-1), train, rng)

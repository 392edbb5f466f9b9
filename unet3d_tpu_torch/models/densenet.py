"""DenseNet 3D classifiers (counterpart of ``unet3d_tpu/models/densenet.py``):
MONAI's ``DenseNet`` and its 121 / 169 / 201 / 264 factories.

- Stem: ``conv0`` 7-cubed stride 2 (a ``FastConv``: symmetric pads of 3,
  cuDNN), ``norm0``, relu, a 3-cubed max-pool, stride 2, pads (1, 1) of
  -inf;
- dense blocks: each ``DenseLayer`` is BN, relu, ``conv1`` (1-cubed, a
  channel matmul, to ``bn_size * growth_rate``), BN, relu, ``conv2`` (a
  3-cubed stride-1 ``FastConv`` to ``growth_rate``: the hand ``conv``
  kernel on the card, 128 -> 32 channels at the defaults), dropout, and the
  concatenation ``[x, y]``;
- transitions: BN, relu, a 1-cubed conv halving the channels, a 2-cubed
  VALID average pool at stride 2;
- head: ``norm5``, relu, the global average pool and ``class_layers_out``.

BatchNorm is Flax's at momentum 0.9, eps 1e-5. Dropout (``dropout_prob``, 0
by default) draws from the ``rng`` generator in training.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import (BatchNorm, Dense, FastConv, PointwiseConv,
                                            dropout, max_pool)


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, momentum=0.9, eps=1e-5)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.avg_pool`` with window and stride 2, VALID, on NDHWC
    ``x``: an odd last voxel of an axis is dropped."""
    n, d, h, w, c = x.shape
    x = x[:, :d - d % 2, :h - h % 2, :w - w % 2]
    return x.reshape(n, d // 2, 2, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4, 6))


class DenseLayer(nn.Module):

    def __init__(self, in_channels: int, growth_rate: int, bn_size: int, dropout_prob: float):
        super().__init__()
        mid = bn_size * growth_rate
        self.dropout_prob = dropout_prob
        self.norm1 = _bn(in_channels)
        self.conv1 = PointwiseConv(in_channels, mid, use_bias=False)
        self.norm2 = _bn(mid)
        self.conv2 = FastConv(mid, growth_rate, (3, 3, 3), use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.conv1(torch.relu(self.norm1(x, train)))
        y = self.conv2(torch.relu(self.norm2(y, train)))
        y = dropout(y, self.dropout_prob, train, rng)
        return torch.cat([x, y], dim=-1)


class DenseNet(nn.Module):
    """``monai.networks.nets.DenseNet``'s config surface, 3D only."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1, out_channels: int = 2,
                 init_features: int = 64, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16), bn_size: int = 4,
                 dropout_prob: float = 0.0):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu DenseNet is 3D")
        self.conv0 = FastConv(in_channels, init_features, (7, 7, 7), (2, 2, 2), use_bias=False)
        self.norm0 = _bn(init_features)
        self.layers = []
        channels = init_features
        for i, n_layers in enumerate(block_config):
            for j in range(n_layers):
                name = f"block{i}_layer{j}"
                self.add_module(name, DenseLayer(channels + j * growth_rate, growth_rate,
                                                 bn_size, dropout_prob))
                self.layers.append(name)
            channels += n_layers * growth_rate
            if i != len(block_config) - 1:
                self.add_module(f"transition{i}_norm", _bn(channels))
                self.add_module(f"transition{i}_conv",
                                PointwiseConv(channels, channels // 2, use_bias=False))
                self.layers.append(f"transition{i}")
                channels //= 2
        self.norm5 = _bn(channels)
        self.class_layers_out = Dense(channels, out_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.norm0(self.conv0(x), train))
        x = max_pool(x, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        for name in self.layers:
            if name.startswith("transition"):
                x = torch.relu(getattr(self, f"{name}_norm")(x, train))
                x = _avg_pool2(getattr(self, f"{name}_conv")(x))
            else:
                x = getattr(self, name)(x, train, rng)
        x = torch.relu(self.norm5(x, train)).mean(dim=(1, 2, 3))
        return self.class_layers_out(x)


def DenseNet121(**kwargs) -> DenseNet:
    kwargs.setdefault("init_features", 64)
    kwargs.setdefault("growth_rate", 32)
    kwargs.setdefault("block_config", (6, 12, 24, 16))
    return DenseNet(**kwargs)


def DenseNet169(**kwargs) -> DenseNet:
    kwargs.setdefault("init_features", 64)
    kwargs.setdefault("growth_rate", 32)
    kwargs.setdefault("block_config", (6, 12, 32, 32))
    return DenseNet(**kwargs)


def DenseNet201(**kwargs) -> DenseNet:
    kwargs.setdefault("init_features", 64)
    kwargs.setdefault("growth_rate", 32)
    kwargs.setdefault("block_config", (6, 12, 48, 32))
    return DenseNet(**kwargs)


def DenseNet264(**kwargs) -> DenseNet:
    kwargs.setdefault("init_features", 64)
    kwargs.setdefault("growth_rate", 32)
    kwargs.setdefault("block_config", (6, 12, 64, 48))
    return DenseNet(**kwargs)

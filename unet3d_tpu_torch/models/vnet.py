"""VNet (counterpart of ``unet3d_tpu/models/vnet.py``).

MONAI's VNet (Milletari et al. 2016) on NDHWC, with the JAX package's module
names:

- ``in_tr``: a 5-cubed conv ``in -> 16`` + BatchNorm, plus the input
  repeated across 16 channels, then the activation;
- four down transitions: a 2-cubed stride-2 VALID conv doubling the width
  (Flax's ``nn.Conv``, through cuDNN) + BatchNorm + act, whole-channel
  dropout on the two deepest, (1, 2, 3, 2) 5-cubed conv + BatchNorm + act
  stages, the residual added;
- four up transitions: whole-channel dropout on the input (the two deepest)
  and at 0.5 on the skip, a kernel-2 stride-2 transposed conv to half the
  width + BatchNorm + act, the skip concatenated, (2, 2, 1, 1) stages, the
  residual added;
- ``out_tr``: a 5-cubed conv -> ``out_channels`` + BatchNorm + act, then a
  pointwise conv with its bias.

The 5-cubed convs go to cuDNN through ``FastConv`` (XLA convs in the JAX
package too). ``act`` ``elu`` (the default), ``prelu`` (the JAX package's
deterministic stand-in: ``leaky_relu(x, 0.25)``, not torch's PReLU) or any
other name as ReLU. The dropout masks come from the forward's ``rng``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet3d_tpu_torch.models.layers import (BatchNorm, Conv, channel_dropout, conv1, conv3,
                                            leaky_relu, transposed_conv)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name.lower() == "elu":
        return F.elu(x)
    if name.lower() == "prelu":
        return leaky_relu(x, 0.25)
    return torch.relu(x)


class LUConv(nn.Module):
    """5-cubed conv + BatchNorm + act (MONAI vnet.LUConv)."""

    def __init__(self, features: int, act: str = "elu", use_bias: bool = False):
        super().__init__()
        self.act = act
        self.conv = conv3(features, features, 5, 1, use_bias=use_bias)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return _act(self.act, self.bn(self.conv(x), train))


class InputTransition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 16, act: str = "elu",
                 use_bias: bool = False):
        super().__init__()
        self.act, self.out_channels = act, out_channels
        self.conv = conv3(in_channels, out_channels, 5, 1, use_bias=use_bias)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.bn(self.conv(x), train)
        # the input repeated across the channels (MONAI InputTransition)
        return _act(self.act, y + x.repeat(1, 1, 1, 1, self.out_channels // x.shape[-1]))


class DownTransition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_convs: int,
                 dropout: Optional[float] = None, act: str = "elu", use_bias: bool = False):
        super().__init__()
        self.act, self.dropout, self.n_convs = act, dropout, n_convs
        self.down_conv = Conv(in_channels, out_channels, 2, 2, use_bias=use_bias)
        self.bn = BatchNorm(out_channels)
        for i in range(n_convs):
            self.add_module(f"conv{i}", LUConv(out_channels, act, use_bias))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        down = _act(self.act, self.bn(self.down_conv(x), train))
        y = down
        if self.dropout is not None:
            y = channel_dropout(y, self.dropout, train, rng)
        for i in range(self.n_convs):
            y = getattr(self, f"conv{i}")(y, train)
        return _act(self.act, y + down)


class UpTransition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_convs: int,
                 dropout: Optional[float] = None, act: str = "elu", use_bias: bool = False):
        super().__init__()
        self.act, self.dropout, self.n_convs = act, dropout, n_convs
        self.up_conv = transposed_conv(in_channels, out_channels // 2, 2, 2,
                                       use_bias=use_bias)
        self.bn = BatchNorm(out_channels // 2)
        for i in range(n_convs):
            self.add_module(f"conv{i}", LUConv(out_channels, act, use_bias))

    def forward(self, x: torch.Tensor, skip: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.dropout is not None:
            x = channel_dropout(x, self.dropout, train, rng)
        skip = channel_dropout(skip, 0.5, train, rng)
        up = _act(self.act, self.bn(self.up_conv(x), train))
        xcat = torch.cat([up, skip], dim=-1)
        y = xcat
        for i in range(self.n_convs):
            y = getattr(self, f"conv{i}")(y, train)
        return _act(self.act, y + xcat)


class OutputTransition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, act: str = "elu",
                 use_bias: bool = False):
        super().__init__()
        self.act = act
        self.conv = conv3(in_channels, out_channels, 5, 1, use_bias=use_bias)
        self.bn = BatchNorm(out_channels)
        # MONAI's final pointwise conv2 keeps its (default) bias
        self.conv2 = conv1(out_channels, out_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv2(_act(self.act, self.bn(self.conv(x), train)))


class VNet(nn.Module):
    """MONAI VNet config surface (3D); ``in_channels`` must divide 16."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1, out_channels: int = 1,
                 act: str = "elu", dropout_prob: Optional[float] = 0.5, bias: bool = False):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch VNet is 3D")
        if 16 % in_channels != 0:
            raise ValueError(f"VNet requires in_channels dividing 16, got {in_channels}")
        p, b = dropout_prob, bias
        self.in_tr = InputTransition(in_channels, 16, act, b)
        self.down_tr32 = DownTransition(16, 32, 1, act=act, use_bias=b)
        self.down_tr64 = DownTransition(32, 64, 2, act=act, use_bias=b)
        self.down_tr128 = DownTransition(64, 128, 3, dropout=p, act=act, use_bias=b)
        self.down_tr256 = DownTransition(128, 256, 2, dropout=p, act=act, use_bias=b)
        self.up_tr256 = UpTransition(256, 256, 2, dropout=p, act=act, use_bias=b)
        self.up_tr128 = UpTransition(256, 128, 2, dropout=p, act=act, use_bias=b)
        self.up_tr64 = UpTransition(128, 64, 1, act=act, use_bias=b)
        self.up_tr32 = UpTransition(64, 32, 1, act=act, use_bias=b)
        self.out_tr = OutputTransition(32, out_channels, act, b)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x16 = self.in_tr(x, train)
        d32 = self.down_tr32(x16, train, rng)
        d64 = self.down_tr64(d32, train, rng)
        d128 = self.down_tr128(d64, train, rng)
        d256 = self.down_tr256(d128, train, rng)
        u256 = self.up_tr256(d256, d128, train, rng)
        u128 = self.up_tr128(u256, d64, train, rng)
        u64 = self.up_tr64(u128, d32, train, rng)
        u32 = self.up_tr32(u64, x16, train, rng)
        return self.out_tr(u32, train)

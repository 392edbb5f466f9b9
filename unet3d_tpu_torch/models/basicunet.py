"""MONAI's BasicUNet (counterpart of ``unet3d_tpu/models/basicunet.py``).

The plain two-conv U-Net on NDHWC, with the JAX package's module names:

- ``TwoConv``: two (3-cubed ``FastConv`` with its bias -> instance norm ->
  dropout -> leaky ReLU 0.1) stages, MONAI's "NDA" order; the instance norm
  is Flax's ``GroupNorm`` with one group per channel, eps 1e-5;
- ``conv_0`` at full resolution, four ``down_i``: a 2-cubed VALID max-pool
  (odd sizes floored) then a ``TwoConv``;
- four ``upcat_i``: the kernel = stride = 2 transposed conv (the subpixel
  form, taps flipped), its output padded at the high side of each axis with
  edge values where a size was odd on the way down, ``[skip, up]``
  concatenated (skip first), a ``TwoConv``; the up conv halves the width,
  except the top block's, which keeps ``features[1]``;
- ``final_conv``: a pointwise conv to ``out_channels``.

The 3-cubed convs run the hand ``conv`` kernel through ``FastConv`` (the
JAX package's Pallas path), the concat materialised as in JAX. The dropout
masks come from the forward's ``rng``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet3d_tpu_torch.models.layers import (FastConv, GroupNorm, conv1, dropout, leaky_relu,
                                            transposed_conv)


class _ConvNormAct(nn.Module):
    """3-cubed conv (bias) -> instance norm (affine) -> dropout -> leaky
    ReLU 0.1 (the JAX ``_ConvNormAct``)."""

    def __init__(self, in_channels: int, features: int, dropout: float = 0.0,
                 negative_slope: float = 0.1):
        super().__init__()
        self.dropout, self.negative_slope = dropout, negative_slope
        self.conv = FastConv(in_channels, features, (3, 3, 3))
        self.norm = GroupNorm(features, features)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm(self.conv(x))
        x = dropout(x, self.dropout, train, rng)
        return leaky_relu(x, self.negative_slope)


class TwoConv(nn.Module):
    def __init__(self, in_channels: int, features: int, dropout: float = 0.0):
        super().__init__()
        self.conv_0 = _ConvNormAct(in_channels, features, dropout)
        self.conv_1 = _ConvNormAct(features, features, dropout)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.conv_1(self.conv_0(x, train, rng), train, rng)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2-cubed VALID max-pool of NDHWC ``x`` (odd sizes floored); the
    gradient goes to each window's first maximum, as XLA's does."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _pad_to_match(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` padded at the high side of each spatial axis to ``ref``'s size
    with its edge values (``jnp.pad(mode="edge")``, torch's "replicate")."""
    for axis in (1, 2, 3):
        n, want = x.shape[axis], ref.shape[axis]
        if want > n:
            index = torch.clamp(torch.arange(want, device=x.device), max=n - 1)
            x = torch.index_select(x, axis, index)
    return x


class UpCat(nn.Module):
    """Upsample (kernel = stride = 2, to ``up_features``), pad to the skip,
    ``[skip, up]`` concatenated, ``TwoConv`` to ``out_features``."""

    def __init__(self, in_channels: int, skip_channels: int, up_features: int,
                 out_features: int, dropout: float = 0.0):
        super().__init__()
        self.upsample = transposed_conv(in_channels, up_features, 2, 2)
        self.convs = TwoConv(skip_channels + up_features, out_features, dropout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _pad_to_match(self.upsample(x), skip)
        return self.convs(torch.cat([skip, x], dim=-1), train, rng)


class BasicUNet(nn.Module):
    """MONAI BasicUNet config surface (3D). ``upsample`` is accepted and,
    as in JAX, not read: the up path is always the transposed conv."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1, out_channels: int = 2,
                 features: Sequence[int] = (32, 32, 64, 128, 256, 32), dropout: float = 0.0,
                 upsample: str = "deconv"):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch BasicUNet is 3D")
        fea, dr = tuple(features), dropout
        self.conv_0 = TwoConv(in_channels, fea[0], dr)
        self.down_1 = TwoConv(fea[0], fea[1], dr)
        self.down_2 = TwoConv(fea[1], fea[2], dr)
        self.down_3 = TwoConv(fea[2], fea[3], dr)
        self.down_4 = TwoConv(fea[3], fea[4], dr)
        self.upcat_4 = UpCat(fea[4], fea[3], fea[4] // 2, fea[3], dr)
        self.upcat_3 = UpCat(fea[3], fea[2], fea[3] // 2, fea[2], dr)
        self.upcat_2 = UpCat(fea[2], fea[1], fea[2] // 2, fea[1], dr)
        self.upcat_1 = UpCat(fea[1], fea[0], fea[1], fea[5], dr)
        self.final_conv = conv1(fea[5], out_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x0 = self.conv_0(x, train, rng)
        x1 = self.down_1(_max_pool2(x0), train, rng)
        x2 = self.down_2(_max_pool2(x1), train, rng)
        x3 = self.down_3(_max_pool2(x2), train, rng)
        x4 = self.down_4(_max_pool2(x3), train, rng)
        u4 = self.upcat_4(x4, x3, train, rng)
        u3 = self.upcat_3(u4, x2, train, rng)
        u2 = self.upcat_2(u3, x1, train, rng)
        u1 = self.upcat_1(u2, x0, train, rng)
        return self.final_conv(u1)

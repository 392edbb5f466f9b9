"""EfficientNet-BN 3D classifiers (counterpart of
``unet3d_tpu/models/efficientnet.py``): MONAI's ``EfficientNetBN``,
``efficientnet-b0`` to ``-b7``.

- Stem: ``stem_conv`` 3-cubed stride 2 with TF's "same" pads (the odd pad
  at the high side: ``layers.Conv``'s "SAME"), ``stem_bn``, swish;
- seven MBConv stages (the b0 table, widths rounded to multiples of 8 by
  ``_round_filters``, repeats scaled by ``_round_repeats``): a 1-cubed
  ``expand_conv`` (where the expansion is not 1), BN, swish; the depthwise
  ``depthwise_conv`` (one group per channel, cuDNN, "same" pads), BN,
  swish; squeeze-and-excitation reduced from the block's *input* width,
  ``max(1, int(in_ch * se_ratio))``, through biased 1-cubed convs; the
  1-cubed ``project_conv``, BN; on the identity blocks drop-connect (one
  draw per item at a rate ramped by block index over the total) and the
  residual add;
- head: ``head_conv`` to ``_round_filters(1280)``, BN, swish, the global
  average pool, dropout (the variant's rate unless ``dropout_rate`` is
  given) and ``fc``.

BatchNorm is Flax's at MONAI's momentum 0.99 (torch's 0.01) and eps 1e-3;
swish is ``x * sigmoid(x)``. The 1-cubed convs are channel matmuls, the
stem and depthwise convs ``layers.Conv`` (XLA's in the JAX package). The
noise (drop-connect, dropout) draws from the ``rng`` generator in training.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import BatchNorm, Conv, Dense, PointwiseConv, dropout

# (num_repeat, kernel, stride, expand_ratio, in_ch, out_ch, se_ratio): the
# efficientnet-b0 block arguments
_B0_BLOCKS = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)

# model_name -> (width_coefficient, depth_coefficient, image_size, dropout)
_PARAMS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
}


def _round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def _round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def _bn(channels: int) -> BatchNorm:
    return BatchNorm(channels, momentum=0.99, eps=1e-3)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class MBConvBlock(nn.Module):

    def __init__(self, in_channels: int, kernel: int, stride: int, expand_ratio: int,
                 out_channels: int, se_ratio: float, drop_connect: float):
        super().__init__()
        mid = in_channels * expand_ratio
        self.expand = expand_ratio != 1
        self.se = se_ratio > 0
        self.drop_connect = drop_connect
        self.skip = stride == 1 and in_channels == out_channels
        if self.expand:
            self.expand_conv = PointwiseConv(in_channels, mid, use_bias=False)
            self.bn0 = _bn(mid)
        self.depthwise_conv = Conv(mid, mid, kernel, stride, "SAME", use_bias=False, groups=mid)
        self.bn1 = _bn(mid)
        if self.se:
            se_ch = max(1, int(in_channels * se_ratio))
            self.se_reduce = PointwiseConv(mid, se_ch)
            self.se_expand = PointwiseConv(se_ch, mid)
        self.project_conv = PointwiseConv(mid, out_channels, use_bias=False)
        self.bn2 = _bn(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = _swish(self.bn0(self.expand_conv(x), train)) if self.expand else x
        y = _swish(self.bn1(self.depthwise_conv(y), train))
        if self.se:
            s = y.mean(dim=(1, 2, 3), keepdim=True)
            s = self.se_expand(_swish(self.se_reduce(s)))
            y = y * torch.sigmoid(s)
        y = self.bn2(self.project_conv(y), train)
        if not self.skip:
            return y
        if self.drop_connect > 0 and train:
            if rng is None:
                raise ValueError("drop-connect in training needs a torch.Generator (rng)")
            keep = 1.0 - self.drop_connect
            mask = torch.rand((y.shape[0], 1, 1, 1, 1), generator=rng, device=y.device) < keep
            y = y * mask.to(y.dtype) / keep
        return y + x


class EfficientNetBN(nn.Module):
    """``monai.networks.nets.EfficientNetBN``'s config surface, 3D only."""

    def __init__(self, model_name: str = "efficientnet-b0", spatial_dims: int = 3,
                 in_channels: int = 1, num_classes: int = 2,
                 dropout_rate: Optional[float] = None, drop_connect_rate: float = 0.2):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu EfficientNetBN is 3D")
        if model_name not in _PARAMS:
            raise ValueError(f"unknown EfficientNet variant {model_name}; "
                             f"supported: {sorted(_PARAMS)}")
        width, depth, _, default_drop = _PARAMS[model_name]
        self.dropout = default_drop if dropout_rate is None else dropout_rate
        stem = _round_filters(32, width)
        self.stem_conv = Conv(in_channels, stem, 3, 2, "SAME", use_bias=False)
        self.stem_bn = _bn(stem)
        total = sum(_round_repeats(r, depth) for r, *_ in _B0_BLOCKS)
        self.blocks = []
        channels, index = stem, 0
        for si, (r, k, s, e, _, co, se) in enumerate(_B0_BLOCKS):
            out_ch = _round_filters(co, width)
            for j in range(_round_repeats(r, depth)):
                name = f"block{si}_{j}"
                self.add_module(name, MBConvBlock(channels, k, s if j == 0 else 1, e, out_ch,
                                                  se, drop_connect_rate * index / total))
                self.blocks.append(name)
                channels, index = out_ch, index + 1
        head = _round_filters(1280, width)
        self.head_conv = PointwiseConv(channels, head, use_bias=False)
        self.head_bn = _bn(head)
        self.fc = Dense(head, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = _swish(self.stem_bn(self.stem_conv(x), train))
        for name in self.blocks:
            y = getattr(self, name)(y, train, rng)
        y = _swish(self.head_bn(self.head_conv(y), train)).mean(dim=(1, 2, 3))
        return self.fc(dropout(y, self.dropout, train, rng))

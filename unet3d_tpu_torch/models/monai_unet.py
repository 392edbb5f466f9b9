"""MONAI's ``UNet`` and its blocks (counterpart of ``unet3d_tpu/models/monai_unet.py``).

- ``Convolution``: a conv (``FastConv``; the transposed conv with
  ``output_padding = stride - 1``; Flax's ``nn.Conv`` through cuDNN when
  dilated), then Norm -> Dropout -> Act (ADN "NDA"): instance norm (no
  affine) or ``BatchNorm``, elementwise dropout, ``PReLU`` (one shared
  slope), leaky ReLU (0.01) or ReLU.
- ``ResidualUnit``: ``subunits`` such convs (the first strided) plus the
  identity, projected by a 1-cubed conv where the stride or width changes.
- ``UNet``: the recursive skip U-Net (down, the inner block or the bottom,
  the skip concatenated, up), with MONAI's ``len(strides) == len(channels) -
  1`` check.

The norm and activation of stage ``i`` are the parent's ``norm{i}`` /
``act{i}`` (the JAX ``_norm_act`` names them on its caller), so the modules
keep the Flax tree. The dropout masks come from the forward's ``rng``.

On the space axis (``parallel/``; x a slab of the volume's D planes) each of
``UNet``'s levels is D-sharded where its depth divides by the axis, else run
whole on every rank (``distributed.level_layout``): a ``down_{d}`` block and
an ``up_{d}_t`` (the transposed conv's halo form, ``layers.ConvTranspose``)
run between two levels (``between_levels``), the bottom and the residual
units in their level's layout; a ``ResidualUnit``'s strided 1-cubed
residual and PReLU are local to their planes. A dilated conv
(``layers.Conv``) raises on the axis. The elementwise dropout on a slab
draws the slab's own mask: another draw than one device's, as on the data
axis.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import (BatchNorm, Conv, FastConv, GroupNorm,
                                            apply_norm, dropout, leaky_relu,
                                            transposed_conv)
from unet3d_tpu_torch.parallel.distributed import (at_level, between_levels, level_layout,
                                                   space_size)


class PReLU(nn.Module):
    """One learnable slope ``alpha`` (0.25 at init) shared by every channel
    (torch's PReLU default): ``where(x >= 0, x, alpha * x)`` in x's dtype."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


def _add_norm_act(parent: nn.Module, channels: int, norm: str, act: str, idx: int) -> None:
    """``parent.norm{idx}`` (instance or batch; none for another name, as in
    JAX) and ``parent.act{idx}`` for a PReLU."""
    norm = (norm or "instance").lower()
    if norm == "instance":
        parent.add_module(f"norm{idx}", GroupNorm(channels, channels, affine=False))
    elif norm == "batch":
        parent.add_module(f"norm{idx}", BatchNorm(channels))
    if (act or "prelu").lower() == "prelu":
        parent.add_module(f"act{idx}", PReLU())


def _norm_act(parent: nn.Module, x: torch.Tensor, idx: int, act: str, rate: float,
              train: bool, rng: Optional[torch.Generator]) -> torch.Tensor:
    norm = getattr(parent, f"norm{idx}", None)
    if norm is not None:
        x = apply_norm(norm, x, train)
    x = dropout(x, rate, train, rng)
    act = (act or "prelu").lower()
    if act == "prelu":
        return getattr(parent, f"act{idx}")(x)
    if act == "leakyrelu":
        return leaky_relu(x, 0.01)
    return torch.relu(x)


def _conv(in_channels: int, features: int, kernel_size: int, strides: int,
          dilation: int) -> nn.Module:
    """The conv of a stage: ``FastConv``, or Flax's ``nn.Conv`` with pads
    (k - 1) // 2 * dilation when dilated."""
    k = (kernel_size,) * 3
    if dilation != 1:
        return Conv(in_channels, features, k, strides, (kernel_size - 1) // 2 * dilation,
                    dilation)
    return FastConv(in_channels, features, k, (strides,) * 3)


class Convolution(nn.Module):
    """conv or transposed conv + Norm-Dropout-Act
    (``monai.networks.blocks.Convolution``)."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 kernel_size: int = 3, act: str = "prelu", norm: str = "instance",
                 dropout: float = 0.0, is_transposed: bool = False,
                 conv_only: bool = False, dilation: int = 1):
        super().__init__()
        self.act, self.dropout, self.conv_only = act, dropout, conv_only
        if is_transposed:
            self.conv = transposed_conv(in_channels, features, kernel_size, strides,
                                        output_padding=strides - 1)
        else:
            self.conv = _conv(in_channels, features, kernel_size, strides, dilation)
        if not conv_only:
            _add_norm_act(self, features, norm, act, 0)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv(x)
        if self.conv_only:
            return x
        return _norm_act(self, x, 0, self.act, self.dropout, train, rng)


class ResidualUnit(nn.Module):
    """``subunits`` conv + ADN stages with a residual add; the identity is
    strided and projected by a 1-cubed conv when the shape changes."""

    def __init__(self, in_channels: int, features: int, strides: int = 1,
                 kernel_size: int = 3, subunits: int = 2, act: str = "prelu",
                 norm: str = "instance", dropout: float = 0.0,
                 last_conv_only: bool = False, dilation: int = 1):
        super().__init__()
        self.act, self.dropout = act, dropout
        self.n_units = max(1, subunits)
        self.normed = [not (last_conv_only and i == subunits - 1)
                       for i in range(self.n_units)]
        for i in range(self.n_units):
            self.add_module(f"conv{i}", _conv(in_channels if i == 0 else features, features,
                                              kernel_size, strides if i == 0 else 1,
                                              dilation))
            if self.normed[i]:
                _add_norm_act(self, features, norm, act, i)
        self.project = strides != 1 or in_channels != features
        if self.project:
            self.residual = FastConv(in_channels, features, (1, 1, 1), (strides,) * 3)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = x
        for i in range(self.n_units):
            y = getattr(self, f"conv{i}")(y)
            if self.normed[i]:
                y = _norm_act(self, y, i, self.act, self.dropout, train, rng)
        return y + (self.residual(x) if self.project else x)


class UNet(nn.Module):
    """MONAI UNet config surface (3D). Modules ``down_{d}`` (and
    ``bottom_{d}`` at the deepest level), ``up_{d}_t`` and, with residual
    units, ``up_{d}_ru``, as in the Flax tree."""

    SPACE_AXIS = True  # runs on D slabs of the space mesh axis

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1, out_channels: int = 2,
                 channels: Sequence[int] = (16, 32, 64, 128, 256),
                 strides: Sequence[int] = (2, 2, 2, 2), kernel_size: int = 3,
                 up_kernel_size: int = 3, num_res_units: int = 0, act: str = "prelu",
                 norm: str = "instance", dropout: float = 0.0):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch UNet is 3D")
        if len(strides) != len(channels) - 1:
            raise ValueError("len(strides) must be len(channels) - 1")
        self.depth = len(channels) - 2
        self.res = num_res_units
        self.strides = tuple(int(s) for s in strides)
        stage = dict(act=act, norm=norm, dropout=dropout)

        def down(in_c, features, stride):
            if num_res_units > 0:
                return ResidualUnit(in_c, features, stride, kernel_size, num_res_units,
                                    **stage)
            return Convolution(in_c, features, stride, kernel_size, **stage)

        # MONAI UNet._create_block: down in -> channels[0], the inner block
        # (which comes back with channels[0]) or the bottom, the skip
        # concatenated, up -> out
        in_c, out_c = in_channels, out_channels
        for d, (c, s) in enumerate(zip(channels, strides)):
            is_top = d == 0
            self.add_module(f"down_{d}", down(in_c, c, s))
            inner = channels[d + 1] if d == self.depth else c
            if d == self.depth:
                self.add_module(f"bottom_{d + 1}", down(c, inner, 1))
            self.add_module(f"up_{d}_t", Convolution(
                c + inner, out_c, s, up_kernel_size, is_transposed=True,
                conv_only=is_top and num_res_units == 0, **stage))
            if num_res_units > 0:
                self.add_module(f"up_{d}_ru", ResidualUnit(
                    out_c, out_c, 1, kernel_size, 1, last_conv_only=is_top, **stage))
            in_c, out_c = c, c

    def _block(self, x: torch.Tensor, d: int, train: bool,
               rng: Optional[torch.Generator], levels) -> torch.Tensor:
        """Level ``d``'s block: x in level d's layout, h and the inner block
        in level d + 1's (``levels``, the input's level first)."""
        h = between_levels(getattr(self, f"down_{d}"), x, levels[d], levels[d + 1], train,
                           rng)
        if d < self.depth:
            inner = self._block(h, d + 1, train, rng, levels)
        else:
            inner = at_level(levels[d + 1], getattr(self, f"bottom_{d + 1}"), h, train, rng)
        y = between_levels(getattr(self, f"up_{d}_t"), torch.cat([h, inner], dim=-1),
                           levels[d + 1], levels[d], train, rng)
        if self.res > 0:
            y = at_level(levels[d], getattr(self, f"up_{d}_ru"), y, train, rng)
        return y

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        depths = [x.shape[1] * space_size()]
        for s in self.strides:
            depths.append(-(-depths[-1] // s))
        levels = level_layout(depths) or [None] * len(depths)
        return self._block(x, 0, train, rng, levels)

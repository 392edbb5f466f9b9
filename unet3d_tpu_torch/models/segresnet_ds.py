"""SegResNetDS (counterpart of ``unet3d_tpu/models/segresnet_ds.py``).

MONAI's deep-supervision SegResNet on NDHWC, with the JAX package's module
names: a 3-cubed ``conv_init`` (no bias); per level ``blocks_down[i]``
pre-activation blocks (norm -> act -> conv3, twice, plus the identity), then
a stride-2 conv3 doubling the width (the downsample comes after the blocks);
per up level a kernel-2 stride-2 transposed conv halving the width, the skip
added, ``blocks_up[i]`` blocks; 1-cubed heads on the last ``dsdepth`` up
levels. ``norm`` is batch (the default, ``layers.BatchNorm``), instance or
group (8 groups, fewer for fewer channels); ``act`` relu or leakyrelu.

With ``dsdepth`` above 1 training returns the heads stacked on axis 1, full
resolution first, the lower ones trilinearly resized to it (the JAX
package's convention for the criterion's deep-supervision weighting); eval,
and ``dsdepth`` 1, return the full-resolution head. ``resolution`` and
upsample modes other than ``deconv`` raise, as in JAX.

On the space axis (``parallel/``; x a slab of the volume's D planes) each
level is D-sharded where its depth divides by the axis, else run whole on
every rank (``distributed.level_layout``): the blocks in their level's
layout (BatchNorm's statistics summed over the slabs, ``layers.BatchNorm``),
the stride-2 convs and the kernel-2 transposed convs (local to their
planes) between two levels (``between_levels``), each head in its level's
layout and resized to the full-resolution head's slab (a replicated
level's head resized whole and cut to the slab).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import (BatchNorm, GroupNorm, PointwiseConv,
                                            _result_type, apply_norm, conv3, leaky_relu,
                                            transposed_conv)
from unet3d_tpu_torch.ops.interpolate import resize_ndhwc
from unet3d_tpu_torch.parallel.distributed import (at_level, between_levels, level_layout,
                                                   space_size)

ACTIVATIONS = ("relu", "leakyrelu")


def _norm(kind: str, channels: int) -> nn.Module:
    kind = (kind or "batch").lower()
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "instance":
        return GroupNorm(channels, channels, affine=False)
    if kind == "group":
        return GroupNorm(channels, min(8, channels))
    raise NotImplementedError(f"SegResNetDS norm={kind!r} not supported")


class SegResBlock(nn.Module):
    """norm -> act -> conv3, twice, plus the identity (MONAI SegResBlock)."""

    def __init__(self, channels: int, norm: str = "batch", act: str = "relu"):
        super().__init__()
        self.act = (act or "relu").lower()
        if self.act not in ACTIVATIONS:
            raise NotImplementedError(f"SegResNetDS act={act!r} not supported")
        self.norm1 = _norm(norm, channels)
        self.conv1 = conv3(channels, channels, 3, 1, use_bias=False)
        self.norm2 = _norm(norm, channels)
        self.conv2 = conv3(channels, channels, 3, 1, use_bias=False)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x) if self.act == "relu" else leaky_relu(x, 0.01)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv1(self._act(apply_norm(self.norm1, x, train)))
        y = self.conv2(self._act(apply_norm(self.norm2, y, train)))
        return y + x


class SegResNetDS(nn.Module):
    """MONAI SegResNetDS config surface (3D)."""

    SPACE_AXIS = True  # runs on D slabs of the space mesh axis

    def __init__(self, spatial_dims: int = 3, init_filters: int = 32, in_channels: int = 1,
                 out_channels: int = 2, act: str = "relu", norm: str = "batch",
                 blocks_down: Sequence[int] = (1, 2, 2, 4),
                 blocks_up: Optional[Sequence[int]] = None, dsdepth: int = 1,
                 upsample_mode: str = "deconv",
                 resolution: Optional[Sequence[float]] = None):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch SegResNetDS is 3D")
        if resolution is not None:
            raise NotImplementedError(
                "SegResNetDS anisotropic `resolution` kernels are not "
                "implemented; resample to isotropic spacing instead")
        if upsample_mode != "deconv":
            raise NotImplementedError(
                f"SegResNetDS upsample_mode={upsample_mode!r} not supported (deconv only)")
        self.blocks_down = tuple(blocks_down)
        n_levels = len(self.blocks_down)
        self.blocks_up = tuple(blocks_up or (1,) * (n_levels - 1))
        if len(self.blocks_up) != n_levels - 1:
            raise ValueError("len(blocks_up) must equal len(blocks_down) - 1")
        self.dsdepth = dsdepth
        self.conv_init = conv3(in_channels, init_filters, 3, 1, use_bias=False)
        filters = init_filters
        for i, n_blocks in enumerate(self.blocks_down):
            for b in range(n_blocks):
                self.add_module(f"down{i}_block{b}", SegResBlock(filters, norm, act))
            if i < n_levels - 1:
                self.add_module(f"down{i}_downsample",
                                conv3(filters, 2 * filters, 3, 2, use_bias=False))
                filters *= 2
        for i, n_blocks in enumerate(self.blocks_up):
            filters //= 2
            self.add_module(f"up{i}_upsample", transposed_conv(2 * filters, filters, 2, 2))
            for b in range(n_blocks):
                self.add_module(f"up{i}_block{b}", SegResBlock(filters, norm, act))
            if len(self.blocks_up) - i <= dsdepth:
                self.add_module(f"up{i}_head", PointwiseConv(filters, out_channels))

    def _blocks(self, x: torch.Tensor, prefix: str, n_blocks: int,
                train: bool) -> torch.Tensor:
        for b in range(n_blocks):
            x = getattr(self, f"{prefix}_block{b}")(x, train)
        return x

    def forward(self, x: torch.Tensor, train: bool = False):
        depths = [x.shape[1] * space_size()]
        for _ in self.blocks_down[1:]:
            depths.append(-(-depths[-1] // 2))
        levels = level_layout(depths) or [None] * len(depths)
        x = self.conv_init(x)
        skips = []
        for i, n_blocks in enumerate(self.blocks_down):
            x = at_level(levels[i], self._blocks, x, f"down{i}", n_blocks, train)
            skips.append(x)
            if i < len(self.blocks_down) - 1:
                x = between_levels(getattr(self, f"down{i}_downsample"), x, levels[i],
                                   levels[i + 1])
        up_skips = skips[:-1][::-1]
        top = len(self.blocks_down) - 1
        heads = []
        for i, n_blocks in enumerate(self.blocks_up):
            here, there = levels[top - i], levels[top - i - 1]
            x = between_levels(getattr(self, f"up{i}_upsample"), x, here, there) + up_skips[i]
            x = at_level(there, self._blocks, x, f"up{i}", n_blocks, train)
            if len(self.blocks_up) - i <= self.dsdepth:
                heads.append((getattr(self, f"up{i}_head")(x), there))
        heads.reverse()  # the full-resolution head first
        if len(heads) == 1 or not train:
            return heads[0][0]
        full = tuple(heads[0][0].shape[1:4])
        whole = (depths[0], *full[1:])  # the full-resolution head's whole volume
        stacked = [heads[0][0]] + [
            between_levels(resize_ndhwc, h, sharded, levels[0],
                           whole if sharded is False else full, mode="trilinear")
            for h, sharded in heads[1:]]
        dtype = _result_type(*stacked)
        return torch.stack([h.to(dtype) for h in stacked], dim=1)

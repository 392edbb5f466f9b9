"""Decoders: mirrored, skip-concat U-Net and Myronenko (counterparts of
``unet3d_tpu/models/decoder.py``).

Upsampling is a 1-cubed conv plus an interpolation (``pre{i}``; trilinear by
default, which returns f32 under AMP, ``ops/interpolate``) or a transposed
conv (``up{i}``; kernel 3, stride 2, torch padding 1: out = 2 * in - 1). The
U-Net decoder center-pads or crops the upsampled map to its skip and
concatenates the two, in their common dtype. Each decoder takes the channels
of its input (and the U-Net decoder those of its skips), which Flax infers.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet3d_tpu_torch.models.layers import (MyronenkoLayer, SubpixelConvTranspose, conv1,
                                            transposed_conv)
from unet3d_tpu_torch.ops.interpolate import upsample_ndhwc
from unet3d_tpu_torch.parallel import distributed


def _center_pad_to(x: torch.Tensor, target_spatial: Sequence[int]) -> torch.Tensor:
    """Center pad-or-crop NDHWC spatial dims to ``target_spatial``, as
    ``F.pad`` with torch's split of the difference ((d // 2, d - d // 2)):
    a negative difference crops, the larger crop off the start."""
    slices = [slice(None)]
    pads: List[Tuple[int, int]] = []
    for s, t in zip(x.shape[1:4], target_spatial):
        diff = int(t) - s
        if diff < 0:
            lo = -(diff // 2)
            slices.append(slice(lo, lo + int(t)))
            pads.append((0, 0))
        else:
            slices.append(slice(None))
            pads.append((diff // 2, diff - diff // 2))
    x = x[tuple(slices)]
    if any(p != (0, 0) for p in pads):
        # F.pad lists the last axis first: C, then W, H, D
        flat = [0, 0] + [v for p in reversed(pads) for v in p]
        x = F.pad(x, flat)
    return x


def _upsample(module: nn.Module, x: torch.Tensor, transposed: bool, scale: int,
              mode: str, align_corners: bool) -> torch.Tensor:
    x = module(x)
    return x if transposed else upsample_ndhwc(x, scale, mode, align_corners)


class MirroredDecoder(nn.Module):
    """The decoder mirroring the Myronenko encoder level by level; with
    ``skip_connections`` the U-Net decoder (concatenated skips, doubled
    input widths). ``skip_channels`` are the skips' channels in the order
    they join (deepest first); by default each mirrors the level's output
    width."""

    def __init__(self, in_channels: int, base_width: int = 32,
                 layer_blocks: Sequence[int] = (1, 1, 1, 1), upsampling_scale: int = 2,
                 feature_reduction_scale: int = 2, upsampling_mode: str = "trilinear",
                 align_corners: bool = False, layer_widths: Optional[Sequence[int]] = None,
                 use_transposed_convolutions: bool = False, kernel_size: int = 3,
                 skip_connections: bool = False,
                 skip_channels: Optional[Sequence[int]] = None):
        super().__init__()
        self.base_width = base_width
        self.layer_blocks = tuple(layer_blocks)
        self.feature_reduction_scale = feature_reduction_scale
        self.layer_widths = layer_widths
        self.skip_connections = skip_connections
        self.upsampling_scale, self.upsampling_mode = upsampling_scale, upsampling_mode
        self.align_corners = align_corners
        self.transposed = use_transposed_convolutions
        n = len(self.layer_blocks)
        channels = in_channels
        for i, n_blocks in enumerate(self.layer_blocks):
            depth = n - (i + 1)
            in_width, out_width = self.calculate_layer_widths(depth)
            if depth != 0:
                self.add_module(f"layer{i}", MyronenkoLayer(
                    n_blocks, channels, in_width, kernel_size=kernel_size))
                if self.transposed:
                    self.add_module(f"up{i}", transposed_conv(
                        in_width, out_width, kernel_size, upsampling_scale))
                else:
                    self.add_module(f"pre{i}", conv1(in_width, out_width, use_bias=False))
                channels = out_width
                if skip_connections:
                    channels += (int(skip_channels[i]) if skip_channels is not None
                                 else out_width)
            else:
                self.add_module(f"layer{i}", MyronenkoLayer(
                    n_blocks, channels, out_width, kernel_size=kernel_size))
                self.out_channels = out_width

    def calculate_layer_widths(self, depth: int) -> Tuple[int, int]:
        """(in_width, out_width) at ``depth``; the input width doubled for the
        skip concat except at the deepest level."""
        if self.layer_widths is not None:
            out_width = int(self.layer_widths[depth])
            in_width = int(self.layer_widths[depth + 1])
        elif depth > 0:
            out_width = int(self.base_width * (self.feature_reduction_scale ** (depth - 1)))
            in_width = out_width * self.feature_reduction_scale
        else:
            out_width = in_width = self.base_width
        if self.skip_connections and depth != len(self.layer_blocks) - 1:
            in_width *= 2
        return in_width, out_width

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None,
                levels: Optional[Sequence[bool]] = None) -> torch.Tensor:
        """``levels``: whether the level of each of the layers, deepest
        first, is D-sharded on the space axis (``distributed.level_layout``):
        an upsample between two sharded levels runs on the slabs (the
        trilinear one with its halo), any other whole, its result centred
        on the skip's whole shape and cut to the slab where the next level
        is sharded."""
        inputs = None
        if self.skip_connections:
            inputs = list(x)
            x = inputs[0]
        n = len(self.layer_blocks)
        size = distributed.space_size()
        for i in range(n):
            here = levels[i] if levels else None
            x = distributed.at_level(here, getattr(self, f"layer{i}"), x, train=train, rng=rng)
            if n - (i + 1) == 0:
                break
            module = getattr(self, f"up{i}" if self.transposed else f"pre{i}")
            there = levels[i + 1] if levels else None
            skip = inputs[i + 1] if inputs is not None else None
            if here is None or (here and there):
                if here and self.transposed:
                    raise NotImplementedError(
                        "transposed-conv upsampling has no form for the 'space' mesh axis "
                        "yet (see ROADMAP.md)")
                x = _upsample(module, x, self.transposed, self.upsampling_scale,
                              self.upsampling_mode, self.align_corners)
                if skip is not None:
                    x = _center_pad_to(x, skip.shape[1:4])
            else:
                if here:
                    x = distributed.gather_d(x)
                with distributed.replicated():
                    x = _upsample(module, x, self.transposed, self.upsampling_scale,
                                  self.upsampling_mode, self.align_corners)
                if skip is not None:
                    whole = (skip.shape[1] * (size if there else 1), *skip.shape[2:4])
                    x = _center_pad_to(x, whole)
                if there:
                    x = distributed.slice_d(x)
            if inputs is not None:
                dtype = torch.promote_types(x.dtype, skip.dtype)
                x = torch.cat([x.to(dtype), skip.to(dtype)], dim=-1)
        return x


class UNetDecoder(MirroredDecoder):
    """The skip-concat decoder."""

    def __init__(self, *args, skip_connections: bool = True, **kwargs):
        super().__init__(*args, skip_connections=skip_connections, **kwargs)


class MyronenkoDecoder(nn.Module):
    """The non-mirrored decoder: per level, upsample first, then the blocks."""

    def __init__(self, in_channels: int, base_width: int = 32,
                 layer_blocks: Sequence[int] = (1, 1, 1), upsampling_scale: int = 2,
                 feature_reduction_scale: int = 2, upsampling_mode: str = "trilinear",
                 align_corners: bool = False, layer_widths: Optional[Sequence[int]] = None,
                 use_transposed_convolutions: bool = False, kernel_size: int = 3):
        super().__init__()
        self.layer_blocks = tuple(layer_blocks)
        self.upsampling_scale, self.upsampling_mode = upsampling_scale, upsampling_mode
        self.align_corners = align_corners
        self.transposed = use_transposed_convolutions
        n = len(self.layer_blocks)
        channels = in_channels
        for i, n_blocks in enumerate(self.layer_blocks):
            depth = n - (i + 1)
            out_width = (int(layer_widths[depth]) if layer_widths is not None
                         else int(base_width * (feature_reduction_scale ** depth)))
            if self.transposed:
                self.add_module(f"up{i}", transposed_conv(
                    channels, out_width, kernel_size, upsampling_scale))
            else:
                self.add_module(f"pre{i}", conv1(channels, out_width, use_bias=False))
            self.add_module(f"layer{i}", MyronenkoLayer(
                n_blocks, out_width, out_width, kernel_size=kernel_size))
            channels = out_width
        self.out_channels = channels

    def level_depths(self, depth: int) -> List[int]:
        """The depths of the input's level and of each layer's for an input
        of ``depth`` planes."""
        depths = [depth]
        for i in range(len(self.layer_blocks)):
            d = depths[-1]
            if not self.transposed:
                depths.append(int(d * self.upsampling_scale))
                continue
            up = getattr(self, f"up{i}")
            if isinstance(up, SubpixelConvTranspose):
                depths.append(d * up.kernel_size[0])
            else:
                depths.append((d - 1) * up.stride[0] + up.kernel_size[0] - 2 * up.padding[0]
                              + up.output_padding[0])
        return depths

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None,
                levels: Optional[Sequence[bool]] = None) -> torch.Tensor:
        """``levels``: whether the input's level and each layer's level are
        D-sharded on the space axis (``distributed.level_layout``, one more
        entry than the layers): an upsample between two sharded levels runs
        on the slabs, any other whole, cut to the slab where the next level
        is sharded."""
        for i in range(len(self.layer_blocks)):
            module = getattr(self, f"up{i}" if self.transposed else f"pre{i}")
            here, there = (levels[i], levels[i + 1]) if levels else (None, None)
            if here and there and self.transposed:
                raise NotImplementedError(
                    "transposed-conv upsampling has no form for the 'space' mesh axis "
                    "yet (see ROADMAP.md)")
            x = distributed.between_levels(
                lambda v: _upsample(module, v, self.transposed, self.upsampling_scale,
                                    self.upsampling_mode, self.align_corners),
                x, here, there)
            x = distributed.at_level(there, getattr(self, f"layer{i}"), x, train=train,
                                     rng=rng)
        return x

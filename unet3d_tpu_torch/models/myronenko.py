"""Myronenko encoders (counterpart of ``unet3d_tpu/models/myronenko.py``).

Per level ``layer_blocks[i]`` residual blocks at width ``base_width *
feature_dilation ** i`` (or ``layer_widths[i]``), the whole-channel dropout
(0.2 by default) after level 0's first block, and a stride-2 conv keeping the
width between levels; the next level's first block projects to its width.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import MyronenkoLayer, conv3
from unet3d_tpu_torch.parallel.distributed import at_level, between_levels


class MyronenkoEncoder(nn.Module):
    """``n_features`` input channels (Flax infers them; torch needs them)."""

    def __init__(self, n_features: int, base_width: int = 32,
                 layer_blocks: Sequence[int] = (1, 2, 2, 4), feature_dilation: int = 2,
                 downsampling_stride: int = 2, dropout: Optional[float] = 0.2,
                 layer_widths: Optional[Sequence[int]] = None, kernel_size: int = 3,
                 collect_skips: bool = False):
        super().__init__()
        self.base_width, self.feature_dilation = base_width, feature_dilation
        self.layer_widths = layer_widths
        self.layer_blocks = tuple(layer_blocks)
        self.collect_skips = collect_skips
        in_width = n_features
        n_levels = len(self.layer_blocks)
        for i, n_blocks in enumerate(self.layer_blocks):
            out_width = self.level_width(i)
            layer_dropout = dropout if (dropout and i == 0) else None
            self.add_module(f"layer{i}", MyronenkoLayer(
                n_blocks, in_width, out_width, kernel_size=kernel_size,
                dropout=layer_dropout))
            if i != n_levels - 1:
                self.add_module(f"down{i}", conv3(out_width, out_width, kernel_size,
                                                  downsampling_stride, use_bias=False))
            in_width = out_width

    def level_width(self, i: int) -> int:
        if self.layer_widths is not None:
            return int(self.layer_widths[i])
        return int(self.base_width * (self.feature_dilation ** i))

    def level_depths(self, depth: int) -> List[int]:
        """Each level's depth for an input of ``depth`` planes (a stride-s
        SAME conv gives ceil(depth / s))."""
        depths = [depth]
        for i in range(len(self.layer_blocks) - 1):
            depths.append(-(-depths[-1] // getattr(self, f"down{i}").strides[0]))
        return depths

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None,
                levels: Optional[Sequence[bool]] = None):
        """The last level's output; with ``collect_skips`` every level's
        output, deepest first. ``levels``: whether each level is D-sharded on
        the space axis (``distributed.level_layout``; x a slab when the
        first is)."""
        skips: List[torch.Tensor] = []
        n_levels = len(self.layer_blocks)
        for i in range(n_levels):
            here = levels[i] if levels else None
            x = at_level(here, getattr(self, f"layer{i}"), x, train=train, rng=rng)
            if i != n_levels - 1:
                if self.collect_skips:
                    skips.insert(0, x)
                x = between_levels(getattr(self, f"down{i}"), x, here,
                                   levels[i + 1] if levels else None)
        if self.collect_skips:
            skips.insert(0, x)
            return skips
        return x


class UNetEncoder(MyronenkoEncoder):
    """The encoder returning every level's output, deepest first."""

    def __init__(self, *args, collect_skips: bool = True, **kwargs):
        super().__init__(*args, collect_skips=collect_skips, **kwargs)

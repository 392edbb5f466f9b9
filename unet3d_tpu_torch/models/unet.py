"""Skip-connected U-Nets of the Myronenko encoder and decoder (counterpart
of ``unet3d_tpu/models/unet.py``): UNet3D, AutocastUNet (an alias: the
train step's AMP sets the precision) and AutoImplantUNet (returns y - x, or
the raw y under ``test``).

On the space axis (``parallel/``; x a slab of the volume's D planes) each
level is D-sharded where its depth divides by the axis, else run whole on
every rank (``distributed.level_layout``), through the encoder and decoder;
their convs, GroupNorms and trilinear upsamples read across the slabs
(``ops/conv3d``, ``models/layers.group_norm``, ``ops/interpolate``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.decoder import UNetDecoder
from unet3d_tpu_torch.models.layers import conv1
from unet3d_tpu_torch.models.myronenko import MyronenkoEncoder
from unet3d_tpu_torch.models.variational import activation_fn
from unet3d_tpu_torch.parallel.distributed import level_layout, space_size


class UNet3D(nn.Module):
    SPACE_AXIS = True  # runs on D slabs of the space mesh axis

    def __init__(self, n_features: int = 1, base_width: int = 32,
                 encoder_blocks: Sequence[int] = (1, 2, 2, 4),
                 decoder_blocks: Optional[Sequence[int]] = None, feature_dilation: int = 2,
                 downsampling_stride: int = 2, interpolation_mode: str = "trilinear",
                 n_outputs: int = 1, layer_widths: Optional[Sequence[int]] = None,
                 activation: Optional[str] = None,
                 use_transposed_convolutions: bool = False, kernel_size: int = 3):
        super().__init__()
        self.activation = activation_fn(activation)
        self.encoder = MyronenkoEncoder(
            n_features, base_width, encoder_blocks, feature_dilation, downsampling_stride,
            layer_widths=layer_widths, kernel_size=kernel_size, collect_skips=True)
        widths = [self.encoder.level_width(i) for i in range(len(encoder_blocks))]
        self.decoder = UNetDecoder(
            widths[-1], base_width=base_width,
            layer_blocks=decoder_blocks or [1] * len(encoder_blocks),
            upsampling_scale=downsampling_stride, feature_reduction_scale=feature_dilation,
            upsampling_mode=interpolation_mode, layer_widths=layer_widths,
            use_transposed_convolutions=use_transposed_convolutions,
            kernel_size=kernel_size, skip_channels=widths[:-1][::-1])
        self.final_convolution = conv1(self.decoder.out_channels, n_outputs,
                                       use_bias=False)

    def _forward(self, x: torch.Tensor, train: bool,
                 rng: Optional[torch.Generator]) -> torch.Tensor:
        levels = level_layout(self.encoder.level_depths(x.shape[1] * space_size()))
        skips = self.encoder(x, train=train, rng=rng, levels=levels)
        y = self.final_convolution(self.decoder(
            skips, train=train, rng=rng, levels=levels[::-1] if levels else None))
        return self.activation(y) if self.activation else y

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._forward(x, train, rng)


class AutocastUNet(UNet3D):
    """UNet3D under the reference's other name."""


class AutoImplantUNet(UNet3D):
    """Residual output: y - x; ``test`` returns the raw y."""

    def forward(self, x: torch.Tensor, train: bool = False, test: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self._forward(x, train, rng)
        return y if test else y - x

"""The autoencoder family (counterpart of ``unet3d_tpu/models/variational.py``):
ConvolutionalAutoEncoder, VariationalAutoEncoder, LabeledVariationalAutoEncoder.

A Myronenko encoder, a decoder (``MyronenkoDecoder``, or ``MirroredDecoder``
with ``decoder_mirrors_encoder``), a 1-cubed conv head and an optional
sigmoid / softmax. The VAE puts a variational layer between them: a strided
pre-activation conv, flatten, a dense layer to (mu, logvar), the
reparameterised sample (or mu when not sampling), a dense layer back, reshape,
a 1-cubed conv and an upsample; it returns ``(out, mu, logvar)``. The normal
draws come from the ``rng`` generator.

On the space axis (``parallel/``; x a slab of the volume's D planes) each
level of the encoder and the decoder is D-sharded where its depth divides
by the axis, else run whole on every rank (``distributed.level_layout``).
The variational layer runs on the whole bottleneck, gathered, on every rank
alike (its strided conv, the flatten, the dense layers, the latent's draw
and the upsample), and hands its output to the decoder's first level in
that level's layout; ``mu`` and ``logvar`` are the same on every rank.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.decoder import MirroredDecoder, MyronenkoDecoder
from unet3d_tpu_torch.models.layers import Dense, MyronenkoConvBlock, conv1
from unet3d_tpu_torch.models.myronenko import MyronenkoEncoder
from unet3d_tpu_torch.ops.interpolate import upsample_ndhwc
from unet3d_tpu_torch.parallel.distributed import (level_layout, on_whole, slice_d,
                                                   space_size)


def activation_fn(name: Optional[str]):
    """The models' output activation: sigmoid, softmax over the channel
    (last) axis, or None."""
    if name == "sigmoid":
        return torch.sigmoid
    if name == "softmax":
        return lambda x: torch.softmax(x, dim=-1)
    if name is None:
        return None
    raise ValueError(f"Unsupported activation {name}")


class ConvolutionalAutoEncoder(nn.Module):
    """``n_outputs`` defaults to ``n_features`` (reconstruction)."""

    SPACE_AXIS = True  # runs on D slabs of the space mesh axis

    def __init__(self, n_features: int = 1, base_width: int = 32,
                 encoder_blocks: Sequence[int] = (1, 2, 2, 4),
                 decoder_blocks: Optional[Sequence[int]] = None, feature_dilation: int = 2,
                 downsampling_stride: int = 2, interpolation_mode: str = "trilinear",
                 n_outputs: Optional[int] = None,
                 layer_widths: Optional[Sequence[int]] = None,
                 decoder_mirrors_encoder: bool = False, activation: Optional[str] = None,
                 use_transposed_convolutions: bool = False, kernel_size: int = 3):
        super().__init__()
        self.activation = activation_fn(activation)
        self.encoder = MyronenkoEncoder(
            n_features, base_width, encoder_blocks, feature_dilation, downsampling_stride,
            layer_widths=layer_widths, kernel_size=kernel_size)
        common = dict(base_width=base_width, upsampling_scale=downsampling_stride,
                      feature_reduction_scale=feature_dilation,
                      upsampling_mode=interpolation_mode, layer_widths=layer_widths,
                      use_transposed_convolutions=use_transposed_convolutions,
                      kernel_size=kernel_size)
        depth = len(encoder_blocks) - 1
        latent = self.encoder.level_width(depth)
        if decoder_mirrors_encoder:
            self.decoder = MirroredDecoder(latent, layer_blocks=encoder_blocks, **common)
        else:
            blocks = decoder_blocks or [1] * len(encoder_blocks)
            self.decoder = MyronenkoDecoder(latent, layer_blocks=blocks, **common)
        self.mirrored = decoder_mirrors_encoder
        n_out = n_outputs if n_outputs is not None else n_features
        self.final_convolution = conv1(self.decoder.out_channels, n_out, use_bias=False)

    def _levels(self, x: torch.Tensor):
        """The encoder's level layout on the space axis (None off it)."""
        return level_layout(self.encoder.level_depths(x.shape[1] * space_size()))

    def _decoder_levels(self, levels, depth: int):
        """The decoder's level layout for an input of ``depth`` planes: the
        encoder's mirrored, or the Myronenko decoder's own."""
        if levels is None:
            return None
        if self.mirrored:
            return levels[::-1]
        return level_layout(self.decoder.level_depths(depth))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_convolution(x)
        return self.activation(x) if self.activation else x

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        levels = self._levels(x)
        x = self.encoder(x, train=train, rng=rng, levels=levels)
        depth = x.shape[1] * (space_size() if levels and levels[-1] else 1)
        return self._head(self.decoder(x, train=train, rng=rng,
                                       levels=self._decoder_levels(levels, depth)))


class VariationalBlock(nn.Module):
    """dense -> (mu, logvar) -> sample (or mu) -> dense."""

    def __init__(self, in_features: int, n_features: int, out_size: int):
        super().__init__()
        self.dense1 = Dense(in_features, 2 * n_features)
        self.dense2 = Dense(n_features, out_size)

    def forward(self, x: torch.Tensor, sample: bool = True,
                rng: Optional[torch.Generator] = None):
        mu, logvar = torch.chunk(self.dense1(x), 2, dim=1)
        if sample:
            if rng is None:
                raise ValueError("sampling the latent needs a torch.Generator (rng)")
            std = torch.exp(0.5 * logvar)
            eps = torch.randn(std.shape, generator=rng, device=std.device).to(std.dtype)
            z = mu + eps * std
        else:
            z = mu  # the deterministic decode of mu
        return self.dense2(z), mu, logvar


class MyronenkoVariationalLayer(nn.Module):
    """Strided pre-activation conv -> flatten -> VariationalBlock -> reshape
    -> 1-cubed conv -> upsample. ``input_shape`` is the spatial shape of the
    incoming feature map; the stride-s conv makes it ceil(size / s)."""

    def __init__(self, in_features: int, input_shape: Sequence[int],
                 reduced_features: int = 16, latent_features: int = 128,
                 conv_stride: int = 2, upsampling_mode: str = "trilinear",
                 align_corners_upsampling: bool = False):
        super().__init__()
        self.reduced_shape = tuple(-(-int(s) // conv_stride) for s in input_shape)
        self.reduced_features, self.conv_stride = reduced_features, conv_stride
        self.upsampling_mode = upsampling_mode
        self.align_corners = align_corners_upsampling
        in_size = math.prod(self.reduced_shape) * reduced_features
        self.in_conv = MyronenkoConvBlock(in_features, reduced_features, stride=conv_stride)
        self.var_block = VariationalBlock(in_size, latent_features, in_size)
        self.out_conv = conv1(reduced_features, in_features, use_bias=False)

    def out_depth(self, depth: int) -> int:
        """The output's depth for an input of ``depth`` planes."""
        return -(-depth // self.conv_stride) * self.conv_stride

    def forward(self, x: torch.Tensor, sample: bool = True,
                rng: Optional[torch.Generator] = None, return_reduced: bool = False,
                levels=None):
        """``(x, mu, logvar)``; with ``return_reduced`` also the flattened
        output of the strided conv (RegularizedResNet's classifier reads
        it). ``levels``: whether x's level and the output's are D-sharded on
        the space axis (None off it): the layer runs on the whole volume,
        the output cut to this rank's slab where its level is sharded."""
        here, there = levels or (None, None)
        out = on_whole(self._whole, x, here, sample, rng, return_reduced)
        return (slice_d(out[0]), *out[1:]) if there else out

    def _whole(self, x: torch.Tensor, sample: bool, rng: Optional[torch.Generator],
               return_reduced: bool):
        reduced = self.in_conv(x)
        reduced = reduced.reshape(reduced.shape[0], -1)
        x, mu, logvar = self.var_block(reduced, sample, rng)
        x = torch.relu(x).reshape((-1,) + self.reduced_shape + (self.reduced_features,))
        x = upsample_ndhwc(self.out_conv(x), self.conv_stride, self.upsampling_mode,
                           self.align_corners)
        if return_reduced:
            return x, mu, logvar, reduced
        return x, mu, logvar


class VariationalAutoEncoder(ConvolutionalAutoEncoder):
    """Returns ``(out, mu, logvar)``; samples the latent when ``sample``
    (default: ``train``), else decodes mu. ``input_shape`` (the input's
    spatial shape) sets the dense widths."""

    def __init__(self, n_features: int = 1, base_width: int = 32,
                 encoder_blocks: Sequence[int] = (1, 2, 2, 4),
                 decoder_blocks: Optional[Sequence[int]] = None, feature_dilation: int = 2,
                 downsampling_stride: int = 2, interpolation_mode: str = "trilinear",
                 n_outputs: Optional[int] = None,
                 layer_widths: Optional[Sequence[int]] = None,
                 decoder_mirrors_encoder: bool = False, activation: Optional[str] = None,
                 use_transposed_convolutions: bool = False, kernel_size: int = 3,
                 input_shape: Optional[Sequence[int]] = None,
                 n_reduced_latent_feature_maps: int = 16, vae_features: int = 128,
                 var_layer_stride: int = 2):
        if input_shape is None:
            raise ValueError(f"{type(self).__name__} requires input_shape")
        super().__init__(n_features, base_width, encoder_blocks, decoder_blocks,
                         feature_dilation, downsampling_stride, interpolation_mode,
                         n_outputs, layer_widths, decoder_mirrors_encoder, activation,
                         use_transposed_convolutions, kernel_size)
        depth = len(encoder_blocks) - 1
        self.var_layer = MyronenkoVariationalLayer(
            self.encoder.level_width(depth),
            tuple(int(s) // (downsampling_stride ** depth) for s in input_shape),
            reduced_features=n_reduced_latent_feature_maps,
            latent_features=vae_features, conv_stride=var_layer_stride,
            upsampling_mode=interpolation_mode)

    def forward(self, x: torch.Tensor, train: bool = False,
                sample: Optional[bool] = None, rng: Optional[torch.Generator] = None):
        if sample is None:
            sample = train
        levels = self._levels(x)
        x = self.encoder(x, train=train, rng=rng, levels=levels)
        depth = x.shape[1] * (space_size() if levels and levels[-1] else 1)
        decoder_levels = self._decoder_levels(levels, self.var_layer.out_depth(depth))
        x, mu, logvar = self.var_layer(x, sample=sample, rng=rng, levels=(
            (levels[-1], decoder_levels[0]) if levels else None))
        return (self._head(self.decoder(x, train=train, rng=rng, levels=decoder_levels)),
                mu, logvar)


class LabeledVariationalAutoEncoder(VariationalAutoEncoder):
    """The VAE with an ``n_outputs`` segmentation head."""

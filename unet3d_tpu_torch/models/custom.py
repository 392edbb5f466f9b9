"""The hybrid classifiers (counterpart of ``unet3d_tpu/models/custom.py``):
a classification head beside a reconstruction or 1-D signal decoder.

- ``RegularizedResNet``: the Myronenko encoder, the variational layer (its
  flattened reduced latent also feeds ``fc``), the Myronenko decoder and a
  1-cubed ``final_convolution``; returns ``(out, reconstruction, mu,
  logvar)``, the latent sampled when ``sample`` (default: ``train``).
- ``RegularizedBasicResNet``: ``ResNet(features_only)`` of basic blocks,
  ``fc`` on the pooled latent, the latent reshaped to 1-cubed and decoded
  by ``BasicDecoder`` (per level a 1-cubed conv halving the planes, a
  trilinear upsample with ``align_corners`` False, basic blocks); returns
  ``(out, reconstruction)``.
- ``ResNetWithDecoder1D``: a ResNet's ``n_fc_outputs`` logits as a length-1
  signal, nearest-upsampled to ``initial_upsample``, ``Decoder1D`` (per
  level a linear upsample, a 1-wide conv and ``BasicBlock1D``s) until the
  length reaches ``n_outputs``, a VALID ``out_conv`` of width 3 and a last
  resample to ``n_outputs``; returns ``(N, n_outputs, 1)``.

Signals are ``(N, L, C)``; their convs are 1-D ``layers.Conv`` (cuDNN), the
3-D ones those of ``models/resnet.py`` and the Myronenko family's.
``BasicBlock1D``'s BatchNorms are Flax's defaults (momentum 0.99, eps 1e-5),
not the ResNets' 0.9. The resamples take their source coordinates from
numpy, as the JAX module does; the linear ones multiply by f32 weights, so
a bf16 signal comes out f32. Flax infers each input width; here
``ResNetWithDecoder1D`` takes it as ``input_channels`` (the config factory
passes the model's input channels).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from unet3d_tpu_torch.models.decoder import MyronenkoDecoder
from unet3d_tpu_torch.models.layers import BatchNorm, Conv, Dense, conv1
from unet3d_tpu_torch.models.myronenko import MyronenkoEncoder
from unet3d_tpu_torch.models.resnet import BasicBlock, ResNet
from unet3d_tpu_torch.models.variational import MyronenkoVariationalLayer
from unet3d_tpu_torch.ops.interpolate import axis_coords, upsample_ndhwc


class BasicDecoder(nn.Module):
    """``in_channels`` is the latent's width, ``in_planes`` the width the
    first level halves."""

    def __init__(self, in_channels: int, layers: Sequence[int], in_planes: int,
                 plane_dilation: int = 2, upsampling_mode: str = "trilinear",
                 upsampling_scale: int = 2):
        super().__init__()
        self.layers = tuple(layers)
        self.upsampling_mode, self.upsampling_scale = upsampling_mode, upsampling_scale
        channels, planes = in_channels, in_planes
        for li, n_blocks in enumerate(self.layers):
            planes = int(planes / plane_dilation)
            self.add_module(f"conv1_{li}", conv1(channels, planes, use_bias=False))
            for bi in range(n_blocks):
                self.add_module(f"layer{li}_block{bi}", BasicBlock(planes, planes))
            channels = planes
        self.out_channels = channels

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for li, n_blocks in enumerate(self.layers):
            x = getattr(self, f"conv1_{li}")(x)
            x = upsample_ndhwc(x, self.upsampling_scale, self.upsampling_mode,
                               align_corners=False)
            for bi in range(n_blocks):
                x = getattr(self, f"layer{li}_block{bi}")(x, train)
        return x


def _bn1d(channels: int) -> BatchNorm:
    return BatchNorm(channels, momentum=0.99, eps=1e-5)


class BasicBlock1D(nn.Module):
    """conv, BN, relu, conv, BN, the identity, relu; SAME pads."""

    def __init__(self, channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = Conv(channels, channels, (kernel_size,), padding="SAME", use_bias=False)
        self.bn1 = _bn1d(channels)
        self.conv2 = Conv(channels, channels, (kernel_size,), padding="SAME", use_bias=False)
        self.bn2 = _bn1d(channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        return torch.relu(out + x)


def interp_1d(x: torch.Tensor, size: int, mode: str = "linear",
              align_corners: bool = True) -> torch.Tensor:
    """``torch.nn.functional.interpolate`` of ``(N, L, C)`` along L to
    ``size``: "nearest" takes one index a sample (the dtype kept), any other
    mode is linear, two indices and f32 weights."""
    l_in = x.shape[1]

    def take(index: np.ndarray) -> torch.Tensor:
        return torch.index_select(x, 1, torch.from_numpy(index.astype(np.int64)).to(x.device))

    if mode == "nearest":
        return take(axis_coords(l_in, size, "nearest", False))
    coords = axis_coords(l_in, size, "linear", align_corners)
    lo = np.floor(coords)
    frac = torch.from_numpy((coords - lo).astype(np.float32)).to(x.device)[None, :, None]
    return take(lo) * (1 - frac) + take(np.minimum(lo + 1, l_in - 1)) * frac


class Decoder1D(nn.Module):

    def __init__(self, in_channels: int, layer_blocks: Sequence[int],
                 layer_channels: Sequence[int], kernel_size: int = 3, upsample_factor: int = 2,
                 interpolation_mode: str = "linear", interpolation_align_corners: bool = True):
        super().__init__()
        self.layer_blocks = tuple(layer_blocks)
        self.upsample_factor = upsample_factor
        self.mode, self.align_corners = interpolation_mode, interpolation_align_corners
        channels = in_channels
        for li, (n_blocks, out_channels) in enumerate(zip(self.layer_blocks, layer_channels)):
            self.add_module(f"conv1_{li}", Conv(channels, out_channels, (1,), use_bias=False))
            for bi in range(n_blocks):
                self.add_module(f"layer{li}_block{bi}", BasicBlock1D(out_channels, kernel_size))
            channels = out_channels
        self.out_channels = channels

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for li, n_blocks in enumerate(self.layer_blocks):
            x = interp_1d(x, x.shape[1] * self.upsample_factor, self.mode, self.align_corners)
            x = getattr(self, f"conv1_{li}")(x)
            for bi in range(n_blocks):
                x = getattr(self, f"layer{li}_block{bi}")(x, train)
        return x


class RegularizedResNet(nn.Module):
    """``input_shape`` (the input's spatial shape) sizes the variational
    layer, ``n_features`` is the input's and the reconstruction's width."""

    def __init__(self, n_outputs: int, input_shape: Sequence[int], n_features: int = 1,
                 base_width: int = 32, encoder_blocks: Sequence[int] = (1, 2, 2, 4),
                 decoder_blocks: Optional[Sequence[int]] = None, feature_dilation: int = 2,
                 downsampling_stride: int = 2, interpolation_mode: str = "trilinear",
                 vae_features: int = 128, n_reduced_latent_feature_maps: int = 16,
                 var_layer_stride: int = 2):
        super().__init__()
        depth = len(encoder_blocks) - 1
        latent_width = int(base_width * feature_dilation ** depth)
        self.encoder = MyronenkoEncoder(n_features, base_width, encoder_blocks,
                                        feature_dilation, downsampling_stride)
        self.var_layer = MyronenkoVariationalLayer(
            latent_width, tuple(int(s // downsampling_stride ** depth) for s in input_shape),
            reduced_features=n_reduced_latent_feature_maps, latent_features=vae_features,
            conv_stride=var_layer_stride, upsampling_mode=interpolation_mode)
        reduced = (n_reduced_latent_feature_maps
                   * int(np.prod(self.var_layer.reduced_shape)))
        self.fc = Dense(reduced, n_outputs)
        self.decoder = MyronenkoDecoder(
            latent_width, base_width, decoder_blocks or [1] * len(encoder_blocks),
            upsampling_scale=downsampling_stride, feature_reduction_scale=feature_dilation,
            upsampling_mode=interpolation_mode)
        self.final_convolution = conv1(self.decoder.out_channels, n_features, use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False, sample: Optional[bool] = None,
                rng: Optional[torch.Generator] = None):
        if sample is None:
            sample = train
        x = self.encoder(x, train=train, rng=rng)
        y, mu, logvar, reduced = self.var_layer(x, sample=sample, rng=rng, return_reduced=True)
        out = self.fc(reduced)
        y = self.decoder(y, train=train, rng=rng)
        return out, self.final_convolution(y), mu, logvar


class RegularizedBasicResNet(nn.Module):

    def __init__(self, n_features: int, n_outputs: int = 1000,
                 layers: Sequence[int] = (2, 2, 2, 2),
                 decoding_layers: Sequence[int] = (1, 1, 1, 1, 1, 1, 1),
                 latent_planes: int = 512, plane_dilation: int = 2,
                 upsampling_mode: str = "trilinear", upsampling_scale: int = 2):
        super().__init__()
        self.encoder = ResNet(block=BasicBlock, layers=layers, n_features=n_features,
                              features_only=True)
        latent = self.encoder.out_channels
        self.fc = Dense(latent, n_outputs)
        self.decoder = BasicDecoder(latent, decoding_layers, latent_planes, plane_dilation,
                                    upsampling_mode, upsampling_scale)
        self.final_convolution = conv1(self.decoder.out_channels, n_features, use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False):
        latent = self.encoder(x, train)
        out = self.fc(latent)
        y = self.decoder(latent.reshape(latent.shape[0], 1, 1, 1, latent.shape[-1]), train)
        return out, self.final_convolution(y)


class ResNetWithDecoder1D(nn.Module):
    """``input_channels``: the input's width (the JAX module infers it)."""

    def __init__(self, n_fc_outputs: int, n_outputs: int, initial_upsample: int = 1024,
                 blocks_per_layer: int = 1, channel_decay: int = 2, upsample_factor: int = 2,
                 layers: Sequence[int] = (2, 2, 2, 2), interpolation_mode: str = "linear",
                 interpolation_align_corners: bool = True, input_channels: int = 3):
        super().__init__()
        self.n_outputs, self.initial_upsample = n_outputs, initial_upsample
        self.mode, self.align_corners = interpolation_mode, interpolation_align_corners
        self.encoder = ResNet(block=BasicBlock, layers=layers, n_outputs=n_fc_outputs,
                              n_features=input_channels)
        layer_blocks, layer_channels = [], []
        size, channels = initial_upsample, n_fc_outputs
        while size < n_outputs:
            size = int(size * upsample_factor)
            channels = int(channels / channel_decay)
            layer_blocks.append(blocks_per_layer)
            layer_channels.append(channels)
        self.decoder = Decoder1D(n_fc_outputs, layer_blocks, layer_channels,
                                 upsample_factor=upsample_factor,
                                 interpolation_mode=interpolation_mode,
                                 interpolation_align_corners=interpolation_align_corners)
        self.out_conv = Conv(self.decoder.out_channels, 1, (3,), use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.encoder(x, train)[:, None, :]
        y = interp_1d(y, self.initial_upsample, mode="nearest")
        y = self.out_conv(self.decoder(y, train))
        return interp_1d(y, self.n_outputs, self.mode, self.align_corners)

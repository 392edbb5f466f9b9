"""MONAI's ``AutoEncoder`` and ``VarAutoEncoder`` (counterpart of
``unet3d_tpu/models/monai_autoencoder.py``).

Stacks of ``models/monai_unet``'s ``Convolution`` / ``ResidualUnit``:

- ``encode_{i}``: per (channels, strides) a Convolution, or a ResidualUnit
  of ``num_res_units`` subunits;
- ``inter_{i}``: per (``inter_channels``, ``inter_dilations``) a stride-1
  Convolution or ResidualUnit of ``num_inter_units`` subunits; a dilated one
  is Flax's ``nn.Conv`` (cuDNN), a dilation-1 one a ``FastConv``;
- ``decode_{i}``: per reversed stride a transposed Convolution (kernel
  ``up_kernel_size``, ``output_padding`` stride - 1: the overlapping form,
  stride 1 included) to the mirrored width, ``out_channels`` last, then,
  with residual units, a one-subunit ``decode_{i}_ru``; the last stage is
  conv only (no norm, no activation): the transposed conv when there are no
  residual units, else the unit's conv.

``VarAutoEncoder`` flattens the encoding over NDHWC (so a JAX checkpoint's
``mu``, ``logvar`` and ``decodeL`` kernels line up), ``mu`` / ``logvar``
Dense layers, in training ``z = mu + eps * exp(logvar / 2)`` with ``eps``
drawn from the forward's ``rng`` (in eval ``z = mu``), ``decodeL`` + relu
back to the NDHWC grid, the decoder, a sigmoid with ``use_sigmoid``; it
returns ``(reconstruction, mu, logvar, z)``. Its input width is
``in_shape[0]`` and its Dense sizes follow ``in_shape``'s grid, as the JAX
module's follow its first input. Dropout masks come from the forward's
``rng``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import Dense
from unet3d_tpu_torch.models.monai_unet import Convolution, ResidualUnit


class _Coder(nn.Module):
    """The encode, intermediate and decode stages both nets share."""

    def _build(self, in_channels: int, out_channels: int, channels: Sequence[int],
               strides: Sequence[int], kernel_size: int, up_kernel_size: int,
               num_res_units: int, inter_channels: Optional[Sequence[int]],
               inter_dilations: Optional[Sequence[int]], num_inter_units: int, act: str,
               norm: str, dropout: float) -> int:
        """Add the encode and intermediate stages; return the latent width
        (the decode stages follow in ``_build_decode``)."""
        self.stage = dict(act=act, norm=norm, dropout=dropout)
        self.num_res_units = num_res_units
        c_in = in_channels
        self.n_encode = 0
        for i, (c, s) in enumerate(zip(channels, strides)):
            if num_res_units > 0:
                m = ResidualUnit(c_in, c, s, kernel_size, num_res_units, **self.stage)
            else:
                m = Convolution(c_in, c, s, kernel_size, **self.stage)
            self.add_module(f"encode_{i}", m)
            c_in, self.n_encode = c, i + 1
        inter_channels = tuple(inter_channels or ())
        dilations = tuple(inter_dilations or (1,) * len(inter_channels))
        self.n_inter = 0
        for i, (c, d) in enumerate(zip(inter_channels, dilations)):
            if num_inter_units > 0:
                m = ResidualUnit(c_in, c, 1, kernel_size, num_inter_units, dilation=d,
                                 **self.stage)
            else:
                m = Convolution(c_in, c, 1, kernel_size, dilation=d, **self.stage)
            self.add_module(f"inter_{i}", m)
            c_in, self.n_inter = c, i + 1
        self._decode_plan = (tuple(channels[-2::-1]) + (out_channels,), tuple(strides[::-1]),
                             up_kernel_size)
        return c_in

    def _build_decode(self, c_in: int) -> None:
        channels, strides, up_kernel_size = self._decode_plan
        plan = list(zip(channels, strides))
        for i, (c, s) in enumerate(plan):
            is_last = i == len(channels) - 1
            self.add_module(f"decode_{i}", Convolution(
                c_in, c, s, up_kernel_size, is_transposed=True,
                conv_only=is_last and self.num_res_units == 0, **self.stage))
            if self.num_res_units > 0:
                self.add_module(f"decode_{i}_ru", ResidualUnit(
                    c, c, 1, up_kernel_size, 1, last_conv_only=is_last, **self.stage))
            c_in = c
        self.n_decode = len(plan)

    def _encode(self, x: torch.Tensor, train: bool,
                rng: Optional[torch.Generator]) -> torch.Tensor:
        for i in range(self.n_encode):
            x = getattr(self, f"encode_{i}")(x, train, rng)
        for i in range(self.n_inter):
            x = getattr(self, f"inter_{i}")(x, train, rng)
        return x

    def _decode(self, x: torch.Tensor, train: bool,
                rng: Optional[torch.Generator]) -> torch.Tensor:
        for i in range(self.n_decode):
            x = getattr(self, f"decode_{i}")(x, train, rng)
            if self.num_res_units > 0:
                x = getattr(self, f"decode_{i}_ru")(x, train, rng)
        return x


class AutoEncoder(_Coder):
    """monai.networks.nets.AutoEncoder config surface (3D)."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1, out_channels: int = 1,
                 channels: Sequence[int] = (4, 8, 16), strides: Sequence[int] = (2, 2, 2),
                 kernel_size: int = 3, up_kernel_size: int = 3, num_res_units: int = 0,
                 inter_channels: Optional[Sequence[int]] = None,
                 inter_dilations: Optional[Sequence[int]] = None, num_inter_units: int = 2,
                 act: str = "prelu", norm: str = "instance", dropout: float = 0.0):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch AutoEncoder is 3D")
        latent = self._build(in_channels, out_channels, channels, strides, kernel_size,
                             up_kernel_size, num_res_units, inter_channels, inter_dilations,
                             num_inter_units, act, norm, dropout)
        self._build_decode(latent)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._decode(self._encode(x, train, rng), train, rng)


class VarAutoEncoder(_Coder):
    """monai.networks.nets.VarAutoEncoder: ``(recon, mu, logvar, z)``."""

    def __init__(self, spatial_dims: int = 3, in_shape: Sequence[int] = (1, 32, 32, 32),
                 out_channels: int = 1, latent_size: int = 16,
                 channels: Sequence[int] = (4, 8, 16), strides: Sequence[int] = (2, 2, 2),
                 kernel_size: int = 3, up_kernel_size: int = 3, num_res_units: int = 0,
                 inter_channels: Optional[Sequence[int]] = None,
                 inter_dilations: Optional[Sequence[int]] = None, num_inter_units: int = 2,
                 act: str = "prelu", norm: str = "instance", dropout: float = 0.0,
                 use_sigmoid: bool = True):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch VarAutoEncoder is 3D")
        self.use_sigmoid = use_sigmoid
        latent = self._build(int(in_shape[0]), out_channels, channels, strides, kernel_size,
                             up_kernel_size, num_res_units, inter_channels, inter_dilations,
                             num_inter_units, act, norm, dropout)
        # the encoding's grid: each SAME conv of stride s takes n to ceil(n / s)
        grid = [int(d) for d in in_shape[1:]]
        for s in list(strides)[:self.n_encode]:
            grid = [-(-d // s) for d in grid]
        flat = latent * grid[0] * grid[1] * grid[2]
        self.mu = Dense(flat, latent_size)
        self.logvar = Dense(flat, latent_size)
        self.decodeL = Dense(latent_size, flat)
        self._build_decode(latent)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None):
        x = self._encode(x, train, rng)
        grid = x.shape[1:]
        flat = x.reshape(x.shape[0], -1)
        mu, logvar = self.mu(flat), self.logvar(flat)
        if train:
            if rng is None:
                raise ValueError("sampling the latent needs a torch.Generator (rng)")
            eps = torch.randn(mu.shape, generator=rng, device=mu.device).to(mu.dtype)
            z = mu + eps * torch.exp(0.5 * logvar)
        else:
            z = mu
        y = torch.relu(self.decodeL(z)).reshape((x.shape[0],) + tuple(grid))
        y = self._decode(y, train, rng)
        if self.use_sigmoid:
            y = torch.sigmoid(y)
        return y, mu, logvar, z

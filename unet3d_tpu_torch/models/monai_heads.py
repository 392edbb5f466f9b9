"""MONAI's small conv-stack heads (counterpart of
``unet3d_tpu/models/monai_heads.py``): ``Regressor``, ``Classifier``,
``Discriminator``, ``Critic`` and ``Generator``, from ``models/monai_unet``'s
``Convolution`` / ``ResidualUnit``.

- ``Regressor``: per (channels, strides) ``layer_{i}``, a ResidualUnit of
  ``num_res_units`` subunits (a Convolution without them); the last stage
  is conv only (no norm, no activation). Then the flatten over NDHWC, the
  Dense ``final`` to ``prod(out_shape)``, the optional ``last_act``
  (sigmoid, softmax over the last axis, tanh or relu) and the reshape to
  ``(N,) + out_shape``. Its input width is ``in_shape[0]`` and ``final``'s
  size follows ``in_shape``'s grid, as the JAX module's follows its input.
- ``Classifier``: ``out_shape = (classes,)``; ``Discriminator``: one unit,
  sigmoid, dropout 0.25; ``Critic``: one unit, no activation, dropout 0.25.
- ``Generator``: the flattened latent, the Dense ``linear`` to
  ``prod(start_shape)``, reshaped channel-first ``(N, C, D, H, W)`` and
  moved to NDHWC, then per stage a transposed Convolution ``conv_{i}``
  (``output_padding`` stride - 1) and, with residual units, a stride-1
  ``resunit_{i}``; the last stage is conv only.

Dropout masks come from the forward's ``rng``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import Dense
from unet3d_tpu_torch.models.monai_unet import Convolution, ResidualUnit

LAST_ACTS = {"sigmoid": torch.sigmoid, "softmax": lambda x: torch.softmax(x, dim=-1),
             "tanh": torch.tanh, "relu": torch.relu}


def _stage(in_channels: int, features: int, strides: int, kernel_size: int,
           num_res_units: int, act: str, norm: str, dropout: float,
           is_last: bool) -> nn.Module:
    if num_res_units > 0:
        return ResidualUnit(in_channels, features, strides, kernel_size, num_res_units, act,
                            norm, dropout, last_conv_only=is_last)
    return Convolution(in_channels, features, strides, kernel_size, act, norm, dropout,
                       conv_only=is_last)


class Regressor(nn.Module):
    """monai.networks.nets.Regressor config surface (3D)."""

    def __init__(self, in_shape: Sequence[int] = (1, 32, 32, 32),
                 out_shape: Sequence[int] = (1,), channels: Sequence[int] = (8, 16, 32),
                 strides: Sequence[int] = (2, 2, 2), kernel_size: int = 3,
                 num_res_units: int = 2, act: str = "prelu", norm: str = "instance",
                 dropout: float = 0.0, last_act: Optional[str] = None):
        super().__init__()
        self.out_shape = tuple(int(s) for s in out_shape)
        self.last_act = last_act.lower() if last_act else None
        if self.last_act is not None and self.last_act not in LAST_ACTS:
            raise KeyError(last_act)
        c_in, grid = int(in_shape[0]), [int(d) for d in in_shape[1:]]
        plan = list(zip(channels, strides))
        for i, (c, s) in enumerate(plan):
            self.add_module(f"layer_{i}", _stage(c_in, c, s, kernel_size, num_res_units, act,
                                                 norm, dropout, i == len(channels) - 1))
            # a conv of kernel k with k // 2 pads at stride s
            grid = [(d + 2 * (kernel_size // 2) - kernel_size) // s + 1 for d in grid]
            c_in = c
        self.n_layers = len(plan)
        self.final = Dense(c_in * math.prod(grid), math.prod(self.out_shape))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, train, rng)
        x = self.final(x.reshape(x.shape[0], -1))
        if self.last_act is not None:
            x = LAST_ACTS[self.last_act](x)
        return x.reshape((x.shape[0],) + self.out_shape)


class Classifier(Regressor):
    """Regressor with ``out_shape = (classes,)`` (any ``out_shape`` given is
    replaced, as in the JAX module)."""

    def __init__(self, in_shape: Sequence[int] = (1, 32, 32, 32), classes: int = 2,
                 channels: Sequence[int] = (8, 16, 32), strides: Sequence[int] = (2, 2, 2),
                 kernel_size: int = 3, num_res_units: int = 2, act: str = "prelu",
                 norm: str = "instance", dropout: float = 0.0,
                 last_act: Optional[str] = None, out_shape: Optional[Sequence[int]] = None):
        super().__init__(in_shape, (classes,), channels, strides, kernel_size, num_res_units,
                         act, norm, dropout, last_act)


class Discriminator(Classifier):
    """One sigmoid output unit; dropout 0.25 by default (MONAI's)."""

    def __init__(self, in_shape: Sequence[int] = (1, 32, 32, 32), classes: int = 1,
                 channels: Sequence[int] = (8, 16, 32), strides: Sequence[int] = (2, 2, 2),
                 kernel_size: int = 3, num_res_units: int = 2, act: str = "prelu",
                 norm: str = "instance", dropout: float = 0.25,
                 last_act: Optional[str] = "sigmoid", out_shape: Optional[Sequence[int]] = None):
        super().__init__(in_shape, classes, channels, strides, kernel_size, num_res_units, act,
                         norm, dropout, last_act)


class Critic(Classifier):
    """WGAN critic: one linear output unit, dropout 0.25 by default."""

    def __init__(self, in_shape: Sequence[int] = (1, 32, 32, 32), classes: int = 1,
                 channels: Sequence[int] = (8, 16, 32), strides: Sequence[int] = (2, 2, 2),
                 kernel_size: int = 3, num_res_units: int = 2, act: str = "prelu",
                 norm: str = "instance", dropout: float = 0.25,
                 last_act: Optional[str] = None, out_shape: Optional[Sequence[int]] = None):
        super().__init__(in_shape, classes, channels, strides, kernel_size, num_res_units, act,
                         norm, dropout, last_act)


class Generator(nn.Module):
    """monai.networks.nets.Generator: latent ``(N,) + latent_shape`` ->
    conv-transpose stack from ``start_shape`` (C, D, H, W)."""

    def __init__(self, latent_shape: Sequence[int] = (64,),
                 start_shape: Sequence[int] = (8, 4, 4, 4), channels: Sequence[int] = (8, 4, 1),
                 strides: Sequence[int] = (2, 2, 2), kernel_size: int = 3,
                 num_res_units: int = 2, act: str = "prelu", norm: str = "instance",
                 dropout: float = 0.0):
        super().__init__()
        self.start_shape = tuple(int(s) for s in start_shape)
        self.num_res_units = num_res_units
        stage = dict(act=act, norm=norm, dropout=dropout)
        self.linear = Dense(math.prod(int(s) for s in latent_shape), math.prod(self.start_shape))
        c_in = self.start_shape[0]
        plan = list(zip(channels, strides))
        for i, (c, s) in enumerate(plan):
            is_last = i == len(channels) - 1
            self.add_module(f"conv_{i}", Convolution(
                c_in, c, s, kernel_size, is_transposed=True,
                conv_only=is_last and num_res_units == 0, **stage))
            if num_res_units > 0:
                self.add_module(f"resunit_{i}", ResidualUnit(
                    c, c, 1, kernel_size, num_res_units, last_conv_only=is_last, **stage))
            c_in = c
        self.n_stages = len(plan)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.linear(x.reshape(x.shape[0], -1))
        # channel-first reshape, then NDHWC
        x = x.reshape((x.shape[0],) + self.start_shape).permute(0, 2, 3, 4, 1).contiguous()
        for i in range(self.n_stages):
            x = getattr(self, f"conv_{i}")(x, train, rng)
            if self.num_res_units > 0:
                x = getattr(self, f"resunit_{i}")(x, train, rng)
        return x

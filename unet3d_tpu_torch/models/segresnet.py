"""SegResNet and SegResNetVAE (counterparts of ``unet3d_tpu/models/segresnet.py``).

MONAI's SegResNet topology on NDHWC, with the JAX package's module names:
a 3-cubed ``convInit``, the whole-channel dropout after it, per level a
stride-2 conv (after the first) and ``blocks_down`` Myronenko residual
blocks, width doubling; then per up level a 1-cubed conv halving the width,
a 2x upsample (``nontrainable``: trilinear; ``deconv``: a kernel-2 stride-2
transposed conv), the skip added, ``blocks_up`` residual blocks; and
GroupNorm -> ReLU -> 1-cubed conv head.

Under AMP the trilinear upsample returns f32 (``ops/interpolate``), the bf16
skip is added to it, and every decoder block after it runs in f32 on the
bf16 parameters, as the JAX model does: its 3-cubed convs take the f32 form
of the conv kernel.

SegResNetVAE adds Myronenko's VAE branch, in training only: from the
bottleneck it strides down to ``smallest_filters`` channels, flattens into a
``vae_nz`` latent (the mean plus ``vae_default_std`` times a normal draw, or
a learned std), projects back up and replays the shared decoder without
skips to reconstruct the input; training returns ``(seg, mse + reg)``, eval
``seg``. The draws come from the ``rng`` generator.

On the space axis (``parallel/``; x a slab of the volume's D planes) each
level is D-sharded where its depth divides by the axis, else run whole on
every rank (``distributed.level_layout``): the blocks in their level's
layout, the stride-2 convs and the upsamples between two levels
(``between_levels``), each skip added in its own level's layout. The
channel dropout draws one value per (item, channel), the same on every rank
of a space line (they share the seed and the draw order). The VAE branch
runs on the whole bottleneck, gathered, on every rank alike (the strided
conv, the flatten, the dense layers and the latent's draw), its
reconstruction handed to the decoder in the bottleneck level's layout; the
reconstruction's squared error is summed over the slabs
(``sum_over_space``), so every rank returns the same scalar.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet3d_tpu_torch.models.layers import (Dense, GroupNorm, MyronenkoResidualBlock,
                                            channel_dropout, conv1, conv3,
                                            group_norm_groups, transposed_conv)
from unet3d_tpu_torch.ops.interpolate import resize_ndhwc
from unet3d_tpu_torch.parallel.distributed import (at_level, between_levels, level_layout,
                                                   on_whole, slice_d, space_size,
                                                   sum_over_space)

UPSAMPLE_MODES = ("nontrainable", "trilinear", "nearest", "deconv")


def _check_upsample_mode(mode: str) -> None:
    if mode not in UPSAMPLE_MODES:
        raise NotImplementedError(
            f"SegResNet upsample_mode={mode!r} is not supported here "
            "(supported: nontrainable, deconv)")


def _upsample2x(x: torch.Tensor, mode: str, deconv: Optional[nn.Module]) -> torch.Tensor:
    """MONAI UpSample: the transposed conv under ``deconv``, else an
    interpolation (nearest for ``nearest``, trilinear otherwise)."""
    if deconv is not None:
        return deconv(x)
    return resize_ndhwc(x, tuple(2 * s for s in x.shape[1:4]),
                        mode="nearest" if mode == "nearest" else "trilinear")


class SegResNet(nn.Module):
    """MONAI SegResNet config surface (3D)."""

    SPACE_AXIS = True  # runs on D slabs of the space mesh axis

    def __init__(self, spatial_dims: int = 3, init_filters: int = 8,
                 in_channels: int = 1, out_channels: int = 2,
                 dropout_prob: Optional[float] = None, norm_groups: int = 8,
                 blocks_down: Sequence[int] = (1, 2, 2, 4),
                 blocks_up: Sequence[int] = (1, 1, 1),
                 upsample_mode: str = "nontrainable", use_conv_final: bool = True):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError(f"{type(self).__name__} is 3D")
        _check_upsample_mode(upsample_mode)
        self.dropout_prob, self.upsample_mode = dropout_prob, upsample_mode
        self.blocks_down, self.blocks_up = tuple(blocks_down), tuple(blocks_up)
        self.use_conv_final = use_conv_final
        self.convInit = conv3(in_channels, init_filters, 3, 1, use_bias=False)
        for i, n_blocks in enumerate(self.blocks_down):
            width = init_filters * 2 ** i
            if i > 0:
                self.add_module(f"down{i}", conv3(width // 2, width, 3, 2, use_bias=False))
            for b in range(n_blocks):
                self.add_module(f"layer{i}_block{b}", MyronenkoResidualBlock(
                    width, width, norm_groups=norm_groups))
        width = init_filters * 2 ** (len(self.blocks_down) - 1)
        for i, n_blocks in enumerate(self.blocks_up):
            width //= 2
            self.add_module(f"up{i}_conv", conv1(2 * width, width, use_bias=False))
            if upsample_mode == "deconv":
                self.add_module(f"up{i}_deconv", transposed_conv(width, width, 2, 2))
            for b in range(n_blocks):
                self.add_module(f"up{i}_block{b}", MyronenkoResidualBlock(
                    width, width, norm_groups=norm_groups))
        if use_conv_final:
            self.final_norm = GroupNorm(width, group_norm_groups(width, norm_groups))
            self.conv_final = conv1(width, out_channels)

    def _levels(self, x: torch.Tensor) -> list:
        """Whether each level (the input's first) is D-sharded on the space
        axis; Nones off it. Each stride-2 SAME conv gives ceil(depth / 2)."""
        depths = [x.shape[1] * space_size()]
        for _ in self.blocks_down[1:]:
            depths.append(-(-depths[-1] // 2))
        return level_layout(depths) or [None] * len(depths)

    def _level_blocks(self, x: torch.Tensor, prefix: str, n_blocks: int) -> torch.Tensor:
        for b in range(n_blocks):
            x = getattr(self, f"{prefix}_block{b}")(x)
        return x

    def _encode(self, x: torch.Tensor, train: bool, rng: Optional[torch.Generator],
                levels: Sequence[Optional[bool]]):
        """convInit, its dropout and the down levels: (bottleneck, skips),
        each in its level's layout ``levels``."""
        x = self.convInit(x)
        if self.dropout_prob is not None:
            x = channel_dropout(x, self.dropout_prob, train, rng)
        skips = []
        for i, n_blocks in enumerate(self.blocks_down):
            if i > 0:
                x = between_levels(getattr(self, f"down{i}"), x, levels[i - 1], levels[i])
            x = at_level(levels[i], self._level_blocks, x, f"layer{i}", n_blocks)
            skips.append(x)
        return x, skips

    def _up(self, x: torch.Tensor, i: int) -> torch.Tensor:
        x = getattr(self, f"up{i}_conv")(x)
        return _upsample2x(x, self.upsample_mode, getattr(self, f"up{i}_deconv", None))

    def _decode(self, x: torch.Tensor, skips: Optional[Sequence[torch.Tensor]],
                levels: Sequence[Optional[bool]]):
        """The up levels; each adds the skip of its level when ``skips`` is
        given (deepest-first, the bottleneck excluded). ``levels``: the
        encoder's layout, the input's level first."""
        top = len(self.blocks_down) - 1
        for i, n_blocks in enumerate(self.blocks_up):
            here, there = levels[top - i], levels[top - i - 1]
            x = between_levels(self._up, x, here, there, i)
            if skips is not None:
                x = x + skips[i]
            x = at_level(there, self._level_blocks, x, f"up{i}", n_blocks)
        return x

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_conv_final:
            return x
        return self.conv_final(torch.relu(self.final_norm(x)))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        levels = self._levels(x)
        x, skips = self._encode(x, train, rng, levels)
        return self._head(self._decode(x, skips[:-1][::-1], levels))


class SegResNetVAE(SegResNet):
    """SegResNet with the VAE regularisation branch (MONAI SegResNetVAE).

    ``input_image_size`` sets the latent's spatial size (the Dense widths),
    as in the JAX model. Needs ``len(blocks_up) == len(blocks_down) - 1`` so
    the reconstruction comes back at the input's resolution."""

    def __init__(self, input_image_size: Sequence[int], spatial_dims: int = 3,
                 init_filters: int = 8, in_channels: int = 1, out_channels: int = 2,
                 dropout_prob: Optional[float] = None, norm_groups: int = 8,
                 blocks_down: Sequence[int] = (1, 2, 2, 4),
                 blocks_up: Sequence[int] = (1, 1, 1),
                 upsample_mode: str = "nontrainable", vae_estimate_std: bool = False,
                 vae_default_std: float = 0.3, vae_nz: int = 256,
                 smallest_filters: int = 16):
        if len(blocks_up) != len(blocks_down) - 1:
            raise ValueError(
                "SegResNetVAE needs len(blocks_up) == len(blocks_down) - 1 so "
                "the VAE branch reconstructs at the input resolution; got "
                f"blocks_up={tuple(blocks_up)} for blocks_down={tuple(blocks_down)}")
        super().__init__(spatial_dims, init_filters, in_channels, out_channels,
                         dropout_prob, norm_groups, blocks_down, blocks_up,
                         upsample_mode, use_conv_final=True)
        self.vae_estimate_std, self.vae_default_std = vae_estimate_std, vae_default_std
        self.smallest_filters = smallest_filters
        zoom = 2 ** (len(self.blocks_down) - 1)
        self.fc_insize = tuple(int(s) // (2 * zoom) for s in input_image_size)
        total = smallest_filters * math.prod(self.fc_insize)
        # the flattened latent: each stride-2 conv gives ceil(size / 2)
        reduced = []
        for s in input_image_size:
            s = int(s)
            for _ in range(len(self.blocks_down)):
                s = -(-s // 2)
            reduced.append(s)
        bottom = init_filters * zoom
        self.vae_down_norm = GroupNorm(bottom, group_norm_groups(bottom, norm_groups))
        self.vae_down_conv = conv3(bottom, smallest_filters, 3, 2, use_bias=False)
        self.vae_fc1 = Dense(smallest_filters * math.prod(reduced), vae_nz)
        if vae_estimate_std:
            self.vae_fc2 = Dense(smallest_filters * math.prod(reduced), vae_nz)
        self.vae_fc3 = Dense(vae_nz, total)
        self.vae_fc_up_conv = conv1(smallest_filters, bottom, use_bias=False)
        if upsample_mode == "deconv":
            self.vae_fc_upsample = transposed_conv(bottom, bottom, 2, 2)
        self.vae_conv_final = conv1(init_filters, in_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None):
        net_input = x
        levels = self._levels(x)
        x, skips = self._encode(x, train, rng, levels)
        seg = self._head(self._decode(x, skips[:-1][::-1], levels))
        if not train:
            return seg
        if rng is None:
            raise ValueError("SegResNetVAE's training forward draws its latent "
                             "noise from a torch.Generator (rng)")
        r, reg = on_whole(self._vae_latent, x, levels[-1], rng)
        if levels[-1]:  # the reconstruction's first level is the bottleneck's
            r = slice_d(r)
        recon = self.vae_conv_final(self._decode(r, None, levels))
        err = (recon.float() - net_input.float()) ** 2
        if space_size() == 1:
            mse = torch.mean(err)
        else:  # the whole volume's mean: the slabs' sums summed over the axis
            mse = sum_over_space(err.sum()) / (err.numel() * space_size())
        return seg, mse + reg

    def _vae_latent(self, x: torch.Tensor, rng: torch.Generator):
        """The VAE branch from the bottleneck ``x`` to the reconstruction's
        first level: (its input, the latent's regulariser)."""
        v = self.vae_down_conv(torch.relu(self.vae_down_norm(x)))
        v = v.reshape(v.shape[0], -1)
        z_mean = self.vae_fc1(v)
        noise = torch.randn(z_mean.shape, generator=rng, device=z_mean.device)
        noise = noise.to(z_mean.dtype)
        if self.vae_estimate_std:
            z_sigma = F.softplus(self.vae_fc2(v))
            m, s = z_mean.float(), z_sigma.float()
            reg = 0.5 * torch.mean(m ** 2 + s ** 2 - torch.log(1e-8 + s ** 2) - 1.0)
            z = z_mean + z_sigma * noise
        else:
            reg = torch.mean(z_mean.float() ** 2)
            z = z_mean + self.vae_default_std * noise
        r = torch.relu(self.vae_fc3(z))
        r = r.reshape((r.shape[0],) + self.fc_insize + (self.smallest_filters,))
        r = _upsample2x(self.vae_fc_up_conv(r), self.upsample_mode,
                        getattr(self, "vae_fc_upsample", None))
        return r, reg

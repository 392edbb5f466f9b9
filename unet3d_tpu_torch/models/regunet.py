"""The registration nets RegUNet, GlobalNet and LocalNet, and ``warp_image``
(counterpart of ``unet3d_tpu/models/regunet.py``; MONAI's DeepReg-derived
``monai.networks.nets.regunet``).

- ``ConvBNReLU``: a k-cubed ``FastConv`` without bias, BatchNorm, relu;
  ``ResidualConvBlock``: two such convs + BatchNorm, the first with its
  relu, the skip added before the last relu; ``EncodeBlock``: the one then
  the other.
- ``RegUNet``: ``depth`` encode levels of ``num_channel_initial * 2^d``
  channels, each followed by a 2-cubed max-pool or, without ``pooling``, a
  3-cubed stride-2 ``FastConv`` (``pool_conv_{d}``); the ``bottom`` block;
  a decoder from ``depth - 1`` down to ``min(extract_levels)`` (by default
  ``extract_levels`` is ``(depth,)``, so it runs no level): the overlapping
  transposed conv (k 3, s 2, output_padding 1, no bias), BatchNorm, relu,
  the skip added (or concatenated after it with ``concat_skip``) and a
  kernel-3 ``EncodeBlock``; then per extracted level a biased 3-cubed head
  to ``out_channels``, resized trilinearly (torch's ``interpolate``) to the
  input's size unless it is at that size already, the heads summed in
  level order and divided by their count. Under AMP the resized heads are
  f32 and an unresized one bf16, so the mean is f32, as in JAX.
- ``LocalNet``: RegUNet with the kernel-7 first encode block (7, 3, 3, ...
  whatever ``encode_kernel_sizes`` says) and every level extracted when
  ``extract_levels`` is not given.
- ``GlobalNet``: the encoder, the bottom block, the ``AffineHead`` (a Dense
  on the NDHWC-flattened features to 12 affine parameters: zero kernel,
  identity bias, its own initialiser) and the dense displacement field
  ``theta @ [grid, 1] - grid`` as a broadcast multiply and a sum over the
  last axis with the grid in f32 (zero at init). The Dense's size follows
  the input's grid, which the JAX module reads from its first input: here
  ``image_size`` gives it (the CLIs pass the dataset's ``desired_shape``).
- ``warp_image``: ``out(p) = image(p + ddf(p))`` per item through
  ``ops/resample.sample_at_coords``, zeros outside.

The 3-cubed convs are ``FastConv``s: the hand ``conv`` kernel at stride 1,
cuDNN with the ``s2_wgrad`` weight gradient at stride 2; LocalNet's kernel-7
convs go to cuDNN (``ops/conv3d.conv3d_torch``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.basicunet import _max_pool2
from unet3d_tpu_torch.models.layers import BatchNorm, Dense, FastConv, transposed_conv
from unet3d_tpu_torch.ops.interpolate import resize_ndhwc
from unet3d_tpu_torch.ops.resample import sample_at_coords


def _conv(in_channels: int, features: int, k: int, stride: int = 1,
          use_bias: bool = False) -> FastConv:
    return FastConv(in_channels, features, (k, k, k), (stride,) * 3, use_bias=use_bias)


class ConvBNReLU(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.conv = _conv(in_channels, features, kernel_size)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x), train))


class ResidualConvBlock(nn.Module):
    """monai RegistrationResidualConvBlock: the skip added before the last
    relu; the last BatchNorm has no relu of its own."""

    def __init__(self, features: int, kernel_size: int = 3, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"conv{i}", _conv(features, features, kernel_size))
            self.add_module(f"bn{i}", BatchNorm(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        skip = x
        for i in range(self.num_layers):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return torch.relu(x + skip)


class EncodeBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size: int = 3):
        super().__init__()
        self.conv = ConvBNReLU(in_channels, features, kernel_size)
        self.residual = ResidualConvBlock(features, kernel_size)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.residual(self.conv(x, train), train)


def _kernel_size(sizes: Union[int, Sequence[int]], d: int) -> int:
    return sizes[d] if isinstance(sizes, (tuple, list)) else sizes


class _Encoder(nn.Module):
    """The encode levels, their pools and the bottom block (RegUNet's and
    GlobalNet's)."""

    def _build_encoder(self, in_channels: int, num_channel_initial: int, depth: int,
                       pooling: bool, encode_kernel_sizes, bottom_kernel_size: int) -> None:
        self.depth, self.pooling = depth, pooling
        self.widths = [num_channel_initial * 2 ** d for d in range(depth + 1)]
        c_in = in_channels
        for d in range(depth):
            self.add_module(f"encode_{d}", EncodeBlock(c_in, self.widths[d],
                                                       _kernel_size(encode_kernel_sizes, d)))
            if not pooling:
                self.add_module(f"pool_conv_{d}", _conv(self.widths[d], self.widths[d], 3, 2))
            c_in = self.widths[d]
        self.bottom = EncodeBlock(c_in, self.widths[depth], bottom_kernel_size)

    def _encode(self, x: torch.Tensor, train: bool):
        skips = []
        for d in range(self.depth):
            x = getattr(self, f"encode_{d}")(x, train)
            skips.append(x)
            x = _max_pool2(x) if self.pooling else getattr(self, f"pool_conv_{d}")(x)
        return self.bottom(x, train), skips


class RegUNet(_Encoder):
    """monai.networks.nets.RegUNet config surface (3D)."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 2,
                 num_channel_initial: int = 16, depth: int = 3, out_channels: int = 3,
                 extract_levels: Optional[Sequence[int]] = None, pooling: bool = True,
                 concat_skip: bool = False,
                 encode_kernel_sizes: Union[int, Sequence[int]] = 3):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch RegUNet is 3D")
        self.levels = tuple(extract_levels or (depth,))
        if max(self.levels) > depth:
            raise ValueError(f"extract_levels {self.levels} reach past depth {depth}")
        self.concat_skip = concat_skip
        self._build_encoder(in_channels, num_channel_initial, depth, pooling,
                            encode_kernel_sizes, _kernel_size(encode_kernel_sizes, depth))
        w = self.widths
        self.decode_levels = list(range(depth - 1, min(self.levels) - 1, -1))
        c_in = w[depth]
        for d in self.decode_levels:
            self.add_module(f"deconv_{d}", transposed_conv(c_in, w[d], 3, 2, use_bias=False,
                                                           output_padding=1))
            self.add_module(f"deconv_bn_{d}", BatchNorm(w[d]))
            self.add_module(f"decode_{d}", EncodeBlock(w[d] * (2 if concat_skip else 1), w[d]))
            c_in = w[d]
        for level in self.levels:
            self.add_module(f"extract_{level}", _conv(w[level], out_channels, 3, use_bias=True))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        image_size = tuple(x.shape[1:4])
        x, skips = self._encode(x, train)
        outs = {self.depth: x}
        for d in self.decode_levels:
            x = torch.relu(getattr(self, f"deconv_bn_{d}")(getattr(self, f"deconv_{d}")(x),
                                                             train))
            x = torch.cat([x, skips[d]], dim=-1) if self.concat_skip else x + skips[d]
            x = getattr(self, f"decode_{d}")(x, train)
            outs[d] = x
        # RegistrationExtractionBlock: per-level head -> resize -> mean
        heads = []
        for level in self.levels:
            h = getattr(self, f"extract_{level}")(outs[level])
            if tuple(h.shape[1:4]) != image_size:
                h = resize_ndhwc(h, image_size, "trilinear")
            heads.append(h)
        return sum(heads) / len(heads)


class LocalNet(RegUNet):
    """monai.networks.nets.LocalNet: kernel 7 at level 0, 3 elsewhere
    (overriding ``encode_kernel_sizes``), every level extracted unless
    ``extract_levels`` is given."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 2,
                 num_channel_initial: int = 16, depth: int = 3, out_channels: int = 3,
                 extract_levels: Optional[Sequence[int]] = None, pooling: bool = True,
                 concat_skip: bool = False,
                 encode_kernel_sizes: Union[int, Sequence[int]] = 3):
        super().__init__(spatial_dims, in_channels, num_channel_initial, depth, out_channels,
                         extract_levels if extract_levels is not None else range(depth + 1),
                         pooling, concat_skip, (7,) + (3,) * depth)


class AffineHead(nn.Module):
    """Dense to the 12 affine parameters, as (N, 3, 4): zero kernel and
    identity bias at init (``init_own_parameters``), so the first prediction
    is the identity transform."""

    IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)

    def __init__(self, in_features: int):
        super().__init__()
        self.fc = Dense(in_features, 12)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.fc.kernel.zero_()
            self.fc.bias.copy_(torch.tensor(self.IDENTITY))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        if flat.shape[1] != self.fc.kernel.shape[0]:
            raise ValueError(f"GlobalNet: the features flatten to {flat.shape[1]} values, the "
                             f"affine head was built for {self.fc.kernel.shape[0]} (image_size)")
        return self.fc(flat).reshape(-1, 3, 4)


class GlobalNet(_Encoder):
    """monai.networks.nets.GlobalNet: encoder + affine head -> the DDF
    ``(N, D, H, W, 3)`` in voxels (zero at init); apply it with
    ``warp_image``. ``image_size`` (D, H, W) sizes the head."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 2,
                 num_channel_initial: int = 16, depth: int = 3, pooling: bool = True,
                 encode_kernel_sizes: Union[int, Sequence[int]] = 3,
                 image_size: Optional[Sequence[int]] = None):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch GlobalNet is 3D")
        if image_size is None:
            raise ValueError("GlobalNet needs image_size, the input's spatial size: its affine "
                             "head's size follows it")
        # GlobalNet's bottom block is kernel 3 whatever encode_kernel_sizes says
        self._build_encoder(in_channels, num_channel_initial, depth, pooling,
                            encode_kernel_sizes, 3)
        grid = [int(d) // 2 ** depth for d in image_size]
        self.affine_head = AffineHead(self.widths[depth] * math.prod(grid))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        image_size = tuple(x.shape[1:4])
        if any(d % 2 ** self.depth for d in image_size):
            raise ValueError(f"GlobalNet requires spatial dims divisible by 2^depth="
                             f"{2 ** self.depth}, got {image_size}")
        x, _ = self._encode(x, train)
        theta = self.affine_head(x)  # (N, 3, 4)
        axes = [torch.arange(s, dtype=torch.float32, device=x.device) for s in image_size]
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        gh = torch.cat([grid, torch.ones(image_size + (1,), device=x.device)], dim=-1)
        warped = (theta[:, None, None, None, :, :] * gh[None, :, :, :, None, :]).sum(dim=-1)
        return warped - grid[None]


def warp_image(image: torch.Tensor, ddf: torch.Tensor, mode: str = "trilinear") -> torch.Tensor:
    """Warp NDHWC ``image`` by the voxel-unit displacement field ``ddf (N, D,
    H, W, 3)``: ``out(p) = image(p + ddf(p))``, zeros outside the volume
    (monai.networks.blocks.Warp)."""
    spatial = image.shape[1:4]
    axes = [torch.arange(s, dtype=torch.float32, device=image.device) for s in spatial]
    base = torch.stack(torch.meshgrid(*axes, indexing="ij"))  # (3, D, H, W)
    out = []
    for n in range(image.shape[0]):
        coords = base + ddf[n].permute(3, 0, 1, 2)
        vol = image[n].permute(3, 0, 1, 2)
        out.append(sample_at_coords(vol, coords, mode=mode).permute(1, 2, 3, 0))
    return torch.stack(out)

"""AHNet (counterpart of ``unet3d_tpu/models/ahnet.py``): Liu et al. 2018's
anisotropic hybrid network, MONAI's config surface in 3D.

The anisotropic (through-plane) axis is the last spatial one, W of NDHWC,
and so also the last of the NCDHW view cuDNN gets.

- Stem: ``conv1`` (7, 7, 3) stride (2, 2, 1) with symmetric pads (3, 3, 1),
  ``bn0``, relu, a 3-cubed max-pool, stride 2, pad 1;
- four stages of ``Bottleneck3x3x1`` blocks (``layers`` of them, planes 64
  to 512, expansion 4): 1-cubed conv, BN, relu, (3, 3, 1) conv at stride
  (s, s, 1) with pads (1, 1, 0), plus a (1, 1, 3) max-pool of its own
  output (stride 1, pad 1), BN, relu, 1-cubed conv, BN, the projection
  (``down_conv`` + ``down_bn``) on every stage's first block, the residual
  add and relu; the first block of stages 2-4 strides 2 in-plane;
- the FCN decoder: every stage projected to 64 (``proj{1..4}``), the deeper
  sum up-sampled (2, 2, 1) and added;
- four ``Pseudo3DLayer`` dense layers (growth 16): BN-relu-1x1,
  BN-relu-(3, 3, 1), BN-relu-(1, 1, 3), the two anisotropic paths summed,
  BN-relu-1x1 back to the growth width, concatenated;
- ``PSP``: ``psp_block_num`` in-plane max-pools by 2^(i+1) (clamped to the
  feature extent), a biased 1-cubed conv to one channel and the up-sample
  back; its maps concatenated before the dense features, then
  ``final_conv`` and the (4, 4, 2) up-sample to the input's size.

Every conv is Flax's ``nn.Conv`` (XLA's in the JAX package, no Pallas), so
here it is ``layers.Conv`` on cuDNN. Max-pools pad with -inf and send their
gradient to each window's first maximum (XLA's and torch's rule).
``upsample_mode`` "transpose" is Flax's ``nn.ConvTranspose`` with kernel =
stride and SAME padding: ``layers.SubpixelConvTranspose`` (its taps
flipped), with a bias; "trilinear" is ``jax.image.resize``'s trilinear and
any other mode its nearest (``ops/interpolate.image_resize``), as in JAX.

The PSP up-sample kernels' shapes depend on the feature extent, which the
JAX module reads from its first input: here ``image_size`` (the input's
spatial size, the CLIs pass the dataset's ``desired_shape``) sizes them;
without it they take the unclamped 2^(i+1), and in "transpose" mode an
input whose extent would clamp them raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import BatchNorm, Conv, SubpixelConvTranspose, max_pool
from unet3d_tpu_torch.ops.interpolate import image_resize

PLANES = (64, 128, 256, 512)


def _half(n: int) -> int:
    return -(-n // 2)


def _upsampler(mode: str, channels: int, scale: Tuple[int, int, int]) -> Optional[nn.Module]:
    """The parameters of an up-sample: the subpixel transposed conv in
    "transpose" mode, none for a resize."""
    return SubpixelConvTranspose(channels, channels, scale) if mode == "transpose" else None


def _upsample(module: Optional[nn.Module], x: torch.Tensor, scale: Sequence[int],
              mode: str) -> torch.Tensor:
    if mode == "transpose":
        return module(x)
    return image_resize(x, scale, "trilinear" if mode == "trilinear" else "nearest")


class Bottleneck3x3x1(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        s = (stride, stride, 1)
        self.downsample = downsample
        self.conv1 = Conv(in_channels, planes, 1, use_bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, (3, 3, 1), s, (1, 1, 0), use_bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, planes * 4, 1, use_bias=False)
        self.bn3 = BatchNorm(planes * 4)
        if downsample:
            self.down_conv = Conv(in_channels, planes * 4, 1, s, use_bias=False)
            self.down_bn = BatchNorm(planes * 4)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = self.conv2(out)
        # through-plane context: the (1, 1, 3) max-pool added in
        out = out + max_pool(out, (1, 1, 3), (1, 1, 1), (0, 0, 1))
        out = torch.relu(self.bn2(out, train))
        out = self.bn3(self.conv3(out), train)
        residual = self.down_bn(self.down_conv(x), train) if self.downsample else x
        return torch.relu(out + residual)


class Pseudo3DLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int = 16, bn_size: int = 4):
        super().__init__()
        inter = bn_size * growth_rate
        self.bn1 = BatchNorm(in_channels)
        self.conv1 = Conv(in_channels, inter, 1, use_bias=False)
        self.bn2 = BatchNorm(inter)
        self.conv2d = Conv(inter, inter, (3, 3, 1), 1, "SAME", use_bias=False)
        self.bn3 = BatchNorm(inter)
        self.conv1d = Conv(inter, inter, (1, 1, 3), 1, "SAME", use_bias=False)
        self.bn4 = BatchNorm(inter)
        self.conv_out = Conv(inter, growth_rate, 1, use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv1(torch.relu(self.bn1(x, train)))
        y = torch.relu(self.bn2(y, train))
        y2d = self.conv2d(y)
        z1d = self.conv1d(torch.relu(self.bn3(y2d, train)))
        y = torch.relu(self.bn4(y2d + z1d, train))  # the P3D-B sum of the two paths
        return torch.cat([x, self.conv_out(y)], dim=-1)


class PSP(nn.Module):
    """Anisotropic pyramid pooling: in-plane pools of 2, 4, 8 and 16 (each
    clamped to the feature extent ``extent``, when given)."""

    def __init__(self, in_channels: int, psp_block_num: int, upsample_mode: str = "transpose",
                 extent: Optional[Sequence[int]] = None):
        super().__init__()
        self.psp_block_num, self.upsample_mode = psp_block_num, upsample_mode
        self.windows = []
        for i in range(psp_block_num):
            k = 2 ** (i + 1)
            window = (min(k, extent[0]), min(k, extent[1]), 1) if extent else (k, k, 1)
            self.windows.append(window)
            self.add_module(f"proj{i}", Conv(in_channels, 1, 1))
            up = _upsampler(upsample_mode, 1, window)
            if up is not None:
                self.add_module(f"up{i}", up)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        outs = []
        for i, built in enumerate(self.windows):
            k = 2 ** (i + 1)
            window = (min(k, x.shape[1]), min(k, x.shape[2]), 1)
            if self.upsample_mode == "transpose" and window != built:
                raise ValueError(
                    f"AHNet PSP level {i}: the features' in-plane extent {tuple(x.shape[1:3])} "
                    f"pools by {window[:2]}, but its up-sample was built for {built[:2]}; build "
                    "the model with image_size set to the input's spatial size")
            p = getattr(self, f"proj{i}")(max_pool(x, window, window, (0, 0, 0)))
            outs.append(_upsample(getattr(self, f"up{i}", None), p, window,
                                  self.upsample_mode))
        return torch.cat(outs, dim=-1)


class AHNet(nn.Module):
    """MONAI ``AHNet`` config surface (3D; ``pretrained`` raises)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), spatial_dims: int = 3,
                 in_channels: int = 1, out_channels: int = 1, psp_block_num: int = 4,
                 upsample_mode: str = "transpose", pretrained: bool = False,
                 progress: bool = True, image_size: Optional[Sequence[int]] = None):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("AHNet here is 3D; use a 2D net for spatial_dims=2")
        if pretrained:
            raise NotImplementedError(
                "AHNet(pretrained=True) transfers torch MRI weights; the port has no such "
                "checkpoint")
        if not 0 <= psp_block_num <= 4:
            raise ValueError("psp_block_num must be in 0..4")
        self.layers, self.psp_block_num = tuple(layers), psp_block_num
        self.upsample_mode = upsample_mode
        self.conv1 = Conv(in_channels, 64, (7, 7, 3), (2, 2, 1), (3, 3, 1), use_bias=False)
        self.bn0 = BatchNorm(64)
        c_in = 64
        for li, (n_blocks, planes) in enumerate(zip(self.layers, PLANES)):
            for b in range(n_blocks):
                stride = 2 if (li > 0 and b == 0) else 1
                self.add_module(f"layer{li + 1}_{b}",
                                Bottleneck3x3x1(c_in, planes, stride, b == 0))
                c_in = planes * 4
        self.proj4 = Conv(c_in, 64, 1)
        for li in (2, 1, 0):
            up = _upsampler(upsample_mode, 64, (2, 2, 1))
            if up is not None:
                self.add_module(f"up{li + 1}", up)
            self.add_module(f"proj{li + 1}", Conv(PLANES[li] * 4, 64, 1))
        c = 64
        for i in range(4):
            self.add_module(f"dense{i}", Pseudo3DLayer(c))
            c += 16
        if psp_block_num > 0:
            # the features' in-plane extent: the stem conv and pool each
            # take n to ceil(n / 2)
            extent = tuple(_half(_half(int(d))) for d in image_size[:2]) if image_size else None
            self.psp = PSP(c, psp_block_num, upsample_mode, extent)
            c += psp_block_num
        self.final_conv = Conv(c, out_channels, 1)
        up = _upsampler(upsample_mode, out_channels, (4, 4, 2))
        if up is not None:
            self.final_up = up

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i, d in enumerate(x.shape[1:4]):
            need = 2 if i == 2 else 32
            if d % need:
                raise ValueError(f"AHNet: spatial dim {i} = {d} must be divisible by {need}")
        h = torch.relu(self.bn0(self.conv1(x), train))
        h = max_pool(h, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        feats = []
        for li, n_blocks in enumerate(self.layers):
            for b in range(n_blocks):
                h = getattr(self, f"layer{li + 1}_{b}")(h, train)
            feats.append(h)
        mode = self.upsample_mode
        y = self.proj4(feats[3])
        for li in (2, 1, 0):
            y = _upsample(getattr(self, f"up{li + 1}", None), y, (2, 2, 1), mode)
            y = y + getattr(self, f"proj{li + 1}")(feats[li])
        for i in range(4):
            y = getattr(self, f"dense{i}")(y, train)
        if self.psp_block_num > 0:
            y = torch.cat([self.psp(y, train), y], dim=-1)
        y = self.final_conv(y)
        return _upsample(getattr(self, "final_up", None), y, (4, 4, 2), mode)

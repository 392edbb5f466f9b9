"""DynUNet (counterpart of ``unet3d_tpu/models/dynunet.py``).

nnU-Net style U-Net: per-level strides / filters / kernel sizes, conv ->
instance norm -> leaky ReLU blocks, transposed-conv upsampling with a skip
join, and a 1x1x1 output head. NDHWC activations; module and parameter names
follow the Flax tree, so ``convert.load_jax_variables`` maps keys one to one.

In a basic block, conv1 returns its output's statistics, norm1 folds them into
a per-(item, channel) affine, and conv2 applies that affine and the leaky ReLU
to its input as it loads it: ``lrelu(IN1(y1))`` is never materialised. On CUDA
the 3x3x3 stride-1 convs run the hand-written kernels (``ops/conv3d_kernel``)
forward and backward, and the stride-2 convs' weight gradient runs
``ops/s2_wgrad_kernel``. Under ``UNET3D_TPU_CONV=winograd`` the convs that
pass the JAX gate run the Winograd-DH kernels instead, a conv2 site on its
materialised activation (``ops/conv3d``). The gradient of the folded affine
reaches norm1's scale / bias and conv1's statistics through autograd of
``fold_in_affine``: the derived instance-norm gradient the JAX model uses by
default.

``res_block`` builds ``UnetResBlock`` for the down and bottleneck blocks: the
same fused conv1 / conv2 pair, norm2 without its activation, and a projected
identity (1x1x1 conv and a plain instance norm) where the channels or the
stride change. ``remat`` recomputes each down, bottleneck and up block in the
backward pass from its input (the JAX model's per-block ``nn.remat``) through
``models/remat.whole_model_remat``, the remat of every other net, whose
blocks are these: the output and deep-supervision heads, lone convs, run
plainly.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet3d_tpu_torch.models.layers import (FastConv, PointwiseConv, _triple,
                                            transposed_conv)
from unet3d_tpu_torch.models.remat import checkpointed_blocks, whole_model_remat
from unet3d_tpu_torch.ops.conv3d import conv3d_block_with_stats
from unet3d_tpu_torch.ops.conv3d_kernel import instance_stats
from unet3d_tpu_torch.ops.interpolate import resize_ndhwc
from unet3d_tpu_torch.ops.norm import fold_in_affine, instance_norm_from_stats

IntsOrSeq = Union[int, Sequence[int]]

_ALPHA = 0.01  # leaky ReLU slope


class _StatsInstanceNorm(nn.Module):
    """Instance norm from precomputed statistics; Flax GroupNorm parameters."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def fold(self, s1, s2, count: int):
        return fold_in_affine(s1, s2, self.scale, self.bias, count)

    def forward(self, y, s1, s2):
        return instance_norm_from_stats(y, s1, s2, self.scale, self.bias)


class UnetBasicBlock(nn.Module):
    """conv(stride)-IN-lrelu -> conv(1)-IN-lrelu."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntsOrSeq = 3, stride: IntsOrSeq = 1):
        super().__init__()
        k = _triple(kernel_size)
        self.conv1 = FastConv(in_channels, out_channels, k, _triple(stride),
                              use_bias=False, with_stats=True)
        self.norm1 = _StatsInstanceNorm(out_channels)
        # holds conv2's kernel only: forward feeds it to the fused prologue conv
        self.conv2 = FastConv(out_channels, out_channels, k, use_bias=False)
        self.norm2 = _StatsInstanceNorm(out_channels)

    def _conv_pair(self, x: torch.Tensor) -> torch.Tensor:
        """conv1 -> IN1 -> lrelu -> conv2 -> IN2, the first activation applied
        in conv2's prologue."""
        y1, s1, s2 = self.conv1(x)
        inv, shift = self.norm1.fold(s1, s2, y1.shape[1] * y1.shape[2] * y1.shape[3])
        y2, t1, t2 = conv3d_block_with_stats(
            y1, self.conv2.kernel.to(y1.dtype), inv, shift, _ALPHA)
        return self.norm2(y2, t1, t2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self._conv_pair(x), _ALPHA)


class UnetResBlock(UnetBasicBlock):
    """The basic block's conv pair with norm2 left without its activation,
    plus the identity, projected where the channels or the stride change by
    a 1x1x1 conv and an instance norm of its output's plain statistics (the
    JAX block's Flax ``GroupNorm``, one channel per group):
    ``lrelu(IN2(conv2(...)) + identity)``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntsOrSeq = 3, stride: IntsOrSeq = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride)
        stride = _triple(stride)
        self.project = in_channels != out_channels or stride != (1, 1, 1)
        if self.project:
            # a 1x1x1 conv's "SAME" pads are 0: the JAX block's VALID
            self.conv3 = (PointwiseConv(in_channels, out_channels, use_bias=False)
                          if stride == (1, 1, 1) else
                          FastConv(in_channels, out_channels, (1, 1, 1), stride,
                                   use_bias=False))
            self.norm3 = _StatsInstanceNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        if self.project:
            identity = self.conv3(x)
            identity = self.norm3(identity, *instance_stats(identity))
        return F.leaky_relu(self._conv_pair(x) + identity, _ALPHA)


class UnetUpBlock(nn.Module):
    """Transposed-conv upsample -> concat skip -> basic block. The concat is
    written, as in the JAX block, so conv1 takes its statistics in the conv
    kernel's epilogue and accumulates over all input channels at once."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntsOrSeq, upsample_kernel_size: IntsOrSeq):
        super().__init__()
        self.transp_conv = transposed_conv(in_channels, out_channels,
                                           upsample_kernel_size,
                                           upsample_kernel_size, use_bias=False)
        self.conv_block = UnetBasicBlock(2 * out_channels, out_channels,
                                         kernel_size, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class DynUNet(nn.Module):
    """Configurable U-Net with the reference config's model-section schema."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 spatial_dims: int = 3,
                 kernel_size: Sequence = ((3, 3, 3),) * 6,
                 strides: Sequence = ((1, 1, 1),) + ((2, 2, 2),) * 5,
                 upsample_kernel_size: Sequence = ((2, 2, 2),) * 5,
                 filters: Optional[Sequence[int]] = None,
                 deep_supervision: bool = False, deep_supr_num: int = 1,
                 res_block: bool = False, remat: bool = False):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("DynUNet is 3D")
        n = len(strides)
        if filters is None:
            filters = [min(2 ** (5 + i), 320) for i in range(n)]
        filters = [int(f) for f in filters]
        self.n_levels = n
        block = UnetResBlock if res_block else UnetBasicBlock
        self.input_block = block(in_channels, filters[0], kernel_size[0], strides[0])
        for i in range(1, n - 1):
            self.add_module(f"downsample{i - 1}", block(
                filters[i - 1], filters[i], kernel_size[i], strides[i]))
        self.bottleneck = block(filters[n - 2], filters[n - 1],
                                kernel_size[n - 1], strides[n - 1])
        for i in range(n - 2, -1, -1):
            self.add_module(f"upsample{n - 2 - i}", UnetUpBlock(
                filters[i + 1], filters[i], kernel_size[i + 1],
                upsample_kernel_size[i]))
            if deep_supervision and 0 < i <= deep_supr_num:
                self.add_module(f"deep_supervision_head{i}",
                                PointwiseConv(filters[i], out_channels))
        self.output_block = PointwiseConv(filters[0], out_channels)
        self.deep_supervision = deep_supervision
        self.deep_supr_num = deep_supr_num
        self.remat = remat

    @property
    def remat(self) -> bool:
        """Whether the blocks recompute in the backward; set it to turn that
        on or off."""
        return bool(checkpointed_blocks(self))

    @remat.setter
    def remat(self, on: bool) -> None:
        whole_model_remat(self, on)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """NDHWC logits; with deep supervision and ``train``, the output and
        the heads (nearest-upsampled to full size) stacked on axis 1."""
        n = self.n_levels
        skips = [self.input_block(x)]
        for i in range(1, n - 1):
            skips.append(getattr(self, f"downsample{i - 1}")(skips[-1]))
        x = self.bottleneck(skips[-1])
        heads = []
        for i in range(n - 2, -1, -1):
            x = getattr(self, f"upsample{n - 2 - i}")(x, skips[i])
            if self.deep_supervision and train and 0 < i <= self.deep_supr_num:
                heads.append(getattr(self, f"deep_supervision_head{i}")(x))
        out = self.output_block(x)
        if not heads:
            return out
        full = out.shape[1:4]
        ups = [resize_ndhwc(h, full, mode="nearest") for h in reversed(heads)]
        return torch.stack([out] + ups, dim=1)

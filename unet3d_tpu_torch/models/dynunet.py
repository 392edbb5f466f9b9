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

On the space axis (``parallel/``; x a slab of the volume's D planes) each
level is D-sharded where its global depth divides by the axis, else run
whole on every rank (JAX's ``activation_spec``): a block whose input or
output level is replicated gathers its input on D and cuts its output back
to the slab (``distributed.between_levels``); an up block over a replicated
level cuts its transposed conv's output (kernel = stride: per plane, no
halo). The convs exchange their halos, the instance norms count the whole
volume's voxels from the statistics summed over the axis
(``ops/conv3d``, ``ops/norm.voxel_count``), and a deep-supervision head of
a replicated level is upsampled whole and cut to the output's slab.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet3d_tpu_torch.models.layers import (FastConv, PointwiseConv, SubpixelConvTranspose,
                                            _triple, transposed_conv)
from unet3d_tpu_torch.models.remat import checkpointed_blocks, whole_model_remat
from unet3d_tpu_torch.ops.conv3d import conv3d_block_with_stats, global_instance_stats
from unet3d_tpu_torch.ops.interpolate import resize_ndhwc
from unet3d_tpu_torch.ops.norm import fold_in_affine, instance_norm_from_stats, voxel_count
from unet3d_tpu_torch.parallel import distributed

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
        inv, shift = self.norm1.fold(s1, s2, voxel_count(y1))
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
            identity = self.norm3(identity, *global_instance_stats(identity))
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

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                slice_up: bool = False) -> torch.Tensor:
        """``slice_up``: x is the whole of a replicated level and skip a D
        slab; the upsampled x is cut to the slab."""
        if distributed.space_size() > 1 and not isinstance(self.transp_conv,
                                                           SubpixelConvTranspose):
            raise NotImplementedError(
                "an up block whose kernel differs from its stride has no form for the "
                "'space' mesh axis yet (see ROADMAP.md)")
        up = self.transp_conv(x)
        if slice_up:
            up = distributed.slice_d(up)
        return self.conv_block(torch.cat([up, skip], dim=-1))


class DynUNet(nn.Module):
    """Configurable U-Net with the reference config's model-section schema."""

    SPACE_AXIS = True  # runs on D slabs of the space mesh axis

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
        self.depth_strides = [_triple(s)[0] for s in strides]
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
        depth = x.shape[1] * distributed.space_size()
        depths = []
        for s in self.depth_strides:
            depth = -(-depth // s)
            depths.append(depth)
        levels = distributed.level_layout(depths) or [None] * n
        x_layout = None if levels[0] is None else True  # on the axis x is a slab
        blocks = ([self.input_block]
                  + [getattr(self, f"downsample{i - 1}") for i in range(1, n - 1)]
                  + [self.bottleneck])
        skips = []
        for i, block in enumerate(blocks):
            skips.append(distributed.between_levels(
                block, skips[-1] if skips else x, levels[i - 1] if i else x_layout,
                levels[i]))
        x = skips.pop()
        heads = []
        for i in range(n - 2, -1, -1):
            up = getattr(self, f"upsample{n - 2 - i}")
            x = distributed.at_level(levels[i], up, x, skips[i],
                                     slice_up=bool(levels[i] and not levels[i + 1]))
            if self.deep_supervision and train and 0 < i <= self.deep_supr_num:
                heads.append((getattr(self, f"deep_supervision_head{i}")(x), levels[i]))
        out = self.output_block(x)
        if not heads:
            return out
        full = out.shape[1:4]
        ups = []
        for h, sharded in reversed(heads):
            if sharded is False and levels[0]:  # a replicated level's head, a slab out
                h = distributed.between_levels(resize_ndhwc, h, False, True,
                                               (depths[0], *full[1:]), mode="nearest")
            ups.append(resize_ndhwc(h, full, mode="nearest"))
        return torch.stack([out] + ups, dim=1)

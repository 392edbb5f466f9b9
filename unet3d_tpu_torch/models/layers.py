"""Conv, norm and dense building blocks (NDHWC activations).

Counterparts of ``unet3d_tpu/models/layers.py``. ``FastConv`` trains through
the autograd Functions of ``ops/conv3d``; ``PointwiseConv`` and
``SubpixelConvTranspose`` are matmuls and reshapes (the JAX subpixel VJP is a
layout device for XLA, not a kernel), ``ConvTranspose`` is the overlapping
transposed conv (cuDNN), and so is ``Dense`` a matmul, each through
``ops/conv3d``'s ``channel_matmul`` / ``cudnn_conv`` (f32 in full f32, TF32
off); ``GroupNorm`` trains through torch autograd. Parameters keep the Flax names and layouts (``kernel``
DHWIO or (in, out), ``scale`` / ``bias``), so a JAX checkpoint loads by key
alone (``convert.py``). Parameters are created empty; ``init_parameters``
fills a whole model from a ``torch.Generator``.

Flax infers a module's input channels from its first input; torch needs them
when the module is built, so every module here takes them. The Myronenko
blocks (GroupNorm -> ReLU -> conv, twice, plus the identity) follow Flax's
dtype rules: ``GroupNorm`` returns the result type of its input and its
parameters and a conv casts its kernel to its input's dtype, so a block fed
an f32 activation runs in f32 even on bf16 parameters, as the JAX block does.
Noise (the channel dropout) is drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from unet3d_tpu_torch.ops.conv3d import channel_matmul, conv3d, conv3d_with_stats, cudnn_conv
from unet3d_tpu_torch.ops.conv3d_kernel import instance_stats

Ints3 = Union[int, Sequence[int]]


def _triple(v: Ints3) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    return tuple(int(x) for x in v)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's initialisers, drawn from ``generator`` in parameter order:
    ``kernel`` lecun-normal (truncated at two standard deviations, fan-in all
    axes but the last: a conv's or transposed conv's DHWIO, a Dense's (in,
    out)), ``scale`` ones, ``bias`` zeros."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                fan_in = math.prod(p.shape[:-1])
                # flax's truncated normal: stddev of the truncated draw is
                # sqrt(1 / fan_in); .8796 is the stddev of N(0,1) cut at +-2
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                raise ValueError(f"no initialiser for parameter {name}")


class FastConv(nn.Module):
    """Conv with Flax ``nn.Conv`` parameters and SAME padding (symmetric k//2
    pads, torch Conv3d semantics), routed through ``ops/conv3d``.

    ``x`` may be a tuple of tensors to convolve as if channel-concatenated:
    each part is convolved with its slice of the kernel and the parts are
    summed, so the concat is never materialised. ``with_stats`` returns
    ``(y, sum, sum_sq)`` per (item, channel)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int, int],
                 strides: Tuple[int, int, int] = (1, 1, 1),
                 use_bias: bool = True, with_stats: bool = False):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.strides = _triple(strides)
        self.with_stats = with_stats
        self.kernel = nn.Parameter(
            torch.empty(self.kernel_size + (in_channels, features)))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x):
        xs = x if isinstance(x, (list, tuple)) else (x,)
        if self.with_stats and len(xs) == 1 and self.bias is None:
            return conv3d_with_stats(xs[0], self.kernel.to(xs[0].dtype),
                                     self.strides)
        y = None
        offset = 0
        for v in xs:
            c = v.shape[-1]
            part = conv3d(v, self.kernel[..., offset:offset + c, :].to(v.dtype),
                          self.strides)
            y = part if y is None else y + part
            offset += c
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.with_stats:
            return (y, *instance_stats(y))
        return y


class PointwiseConv(nn.Module):
    """1x1x1 conv as one channel matmul; Flax ``nn.Conv`` parameters."""

    def __init__(self, in_channels: int, features: int, use_bias: bool = True):
        super().__init__()
        self.features = features
        self.kernel = nn.Parameter(torch.empty(1, 1, 1, in_channels, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.reshape(x.shape[-1], self.features).to(x.dtype)
        y = channel_matmul(x, w)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class SubpixelConvTranspose(nn.Module):
    """Transposed conv with kernel == stride: ``out[s*i + a] = x[i] @ w[flip(a)]``,
    one matmul plus the depth-to-space interleave. Flax applies a
    ConvTranspose kernel tap-reversed, hence the flip."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int, int], use_bias: bool = True):
        super().__init__()
        self.features = features
        self.kernel_size = _triple(kernel_size)
        self.kernel = nn.Parameter(
            torch.empty(self.kernel_size + (in_channels, features)))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k0, k1, k2 = self.kernel_size
        n, d, h, w, c = x.shape
        co = self.features
        wf = torch.flip(self.kernel, dims=(0, 1, 2)).to(x.dtype)
        wm = wf.permute(3, 0, 1, 2, 4).reshape(c, k0 * k1 * k2 * co)
        y = channel_matmul(x, wm).reshape(n, d, h, w, k0, k1, k2 * co)
        y = y.permute(0, 1, 4, 2, 5, 3, 6).reshape(n, d * k0, h * k1, w * k2, co)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ConvTranspose(nn.Module):
    """Flax ``nn.ConvTranspose`` with explicit pads: the stride-dilated input,
    padded by ``pads`` per axis, correlated with the kernel as stored (Flax
    does not flip it). Computed by a cuDNN transposed conv on the flipped
    kernel (torch's transposed conv flips), in the result type of the input
    and the parameters."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int, int], stride: Tuple[int, int, int],
                 pads: Tuple[Tuple[int, int], ...], use_bias: bool = True):
        super().__init__()
        self.kernel_size, self.stride = _triple(kernel_size), _triple(stride)
        # pads (k-1-p, k-1-p+op) are torch's padding p and output_padding op
        self.padding = tuple(k - 1 - lo for k, (lo, _) in zip(self.kernel_size, pads))
        self.output_padding = tuple(hi - lo for lo, hi in pads)
        self.kernel = nn.Parameter(
            torch.empty(self.kernel_size + (in_channels, features)))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = [self.kernel] + ([self.bias] if self.bias is not None else [])
        dtype = _result_type(x, *params)
        w = torch.flip(self.kernel, dims=(0, 1, 2)).to(dtype).permute(3, 4, 0, 1, 2)
        y = cudnn_conv(x.to(dtype).permute(0, 4, 1, 2, 3), w, self.stride, self.padding,
                       transposed=True, output_padding=self.output_padding)
        y = y.permute(0, 2, 3, 4, 1).contiguous()
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


def transposed_conv(in_channels: int, features: int, kernel_size: Ints3,
                    stride: Ints3, use_bias: bool = True,
                    output_padding: Ints3 = 0) -> nn.Module:
    """Transposed conv with torch padding semantics: padding (k - s + 1) // 2
    each side when k > s, else none, and ``output_padding`` on the high side
    (out = (in - 1) * s + k - 2p + op). Kernel == stride takes the subpixel
    matmul (the same parameters and outputs); any other kernel the Flax
    ``nn.ConvTranspose`` with pads (k-1-p, k-1-p+op)."""
    k, s, op = _triple(kernel_size), _triple(stride), _triple(output_padding)
    if k == s and op == (0, 0, 0):
        return SubpixelConvTranspose(in_channels, features, k, use_bias)
    pads = []
    for ki, si, opi in zip(k, s, op):
        torch_p = max((ki - si + 1) // 2, 0)
        pads.append((ki - 1 - torch_p, ki - 1 - torch_p + opi))
    return ConvTranspose(in_channels, features, k, s, tuple(pads), use_bias)


def conv3(in_channels: int, features: int, kernel_size: Ints3 = 3,
          stride: Ints3 = 1, use_bias: bool = True) -> FastConv:
    """k-cubed convolution, symmetric k//2 pads."""
    return FastConv(in_channels, features, _triple(kernel_size), _triple(stride),
                    use_bias=use_bias)


def conv1(in_channels: int, features: int, stride: Ints3 = 1,
          use_bias: bool = True) -> nn.Module:
    """1-cubed convolution: a channel matmul at stride 1, else a strided conv
    without pads (the JAX ``nn.Conv`` with VALID)."""
    if _triple(stride) == (1, 1, 1):
        return PointwiseConv(in_channels, features, use_bias=use_bias)
    return FastConv(in_channels, features, (1, 1, 1), _triple(stride),
                    use_bias=use_bias)


def _result_type(*tensors: torch.Tensor) -> torch.dtype:
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


class Dense(nn.Module):
    """Flax ``nn.Dense``: ``kernel`` (in, out), ``bias``; computed in the
    result type of the input and the parameters."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = [self.kernel] + ([self.bias] if self.bias is not None else [])
        dtype = _result_type(x, *params)
        y = channel_matmul(x.to(dtype), self.kernel.to(dtype))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


def group_norm_groups(channels: int, norm_groups: int = 8) -> int:
    """GroupNorm's group count, with the reference's fallback to one group
    per channel when ``channels`` is smaller than or not divisible by
    ``norm_groups``."""
    if channels < norm_groups or channels % norm_groups != 0:
        return channels
    return norm_groups


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Flax's GroupNorm on NDHWC ``x``: per (item, group) mean and variance
    over the spatial axes and the group's channels in f32 (f64 for an f64
    x), the variance as E[x^2] - E[x]^2 clamped at 0; ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in that type; the result in the
    result type of x, scale and bias.
    (``F.group_norm`` takes the variance another way and refuses parameters
    of another dtype than its input.)"""
    n, c = x.shape[0], x.shape[-1]
    compute = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(compute)
    xg = xf.reshape(n, -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3))
    var = torch.clamp((xg * xg).mean(dim=(1, 3)) - mean * mean, min=0.0)
    size = c // num_groups
    mean = mean.repeat_interleave(size, dim=-1)[:, None, None, None, :]
    var = var.repeat_interleave(size, dim=-1)[:, None, None, None, :]
    mul = torch.rsqrt(var + eps) * scale.to(compute)
    y = (xf - mean) * mul + bias.to(compute)
    return y.to(_result_type(x, scale, bias))


class GroupNorm(nn.Module):
    """``group_norm`` with Flax ``nn.GroupNorm`` parameters (``scale``,
    ``bias``), eps 1e-5."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {channels} channels")
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.scale, self.bias, self.eps)


def channel_dropout(x: torch.Tensor, rate: float, train: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout(rate, broadcast_dims=(1, 2, 3))`` on NDHWC ``x``:
    in training each (item, channel) is kept with probability 1 - rate (one
    uniform draw from ``generator`` each, on x's device) and scaled by
    1 / (1 - rate); otherwise x as it is. Training with a rate in (0, 1)
    needs the generator."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator (rng)")
    keep = 1.0 - rate
    shape = (x.shape[0], 1, 1, 1, x.shape[-1])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class MyronenkoConvBlock(nn.Module):
    """Pre-activation block: GroupNorm -> ReLU -> conv."""

    def __init__(self, in_channels: int, planes: int, stride: Ints3 = 1,
                 norm_groups: int = 8, kernel_size: Ints3 = 3):
        super().__init__()
        self.norm = GroupNorm(in_channels, group_norm_groups(in_channels, norm_groups))
        self.conv = conv3(in_channels, planes, kernel_size, stride, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.relu(self.norm(x)))


class MyronenkoResidualBlock(nn.Module):
    """Two pre-activation conv blocks plus the identity, projected by a
    1-cubed conv (``sample``) where the width changes."""

    def __init__(self, in_channels: int, planes: int, stride: Ints3 = 1,
                 norm_groups: int = 8, kernel_size: Ints3 = 3):
        super().__init__()
        self.conv1 = MyronenkoConvBlock(in_channels, planes, stride, norm_groups,
                                        kernel_size)
        self.conv2 = MyronenkoConvBlock(planes, planes, stride, norm_groups, kernel_size)
        self.project = in_channels != planes
        if self.project:
            self.sample = conv1(in_channels, planes, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + (self.sample(x) if self.project else x)


class MyronenkoLayer(nn.Module):
    """``n_blocks`` residual blocks, the whole-channel dropout after the
    first when ``dropout`` is set (Dropout3d)."""

    def __init__(self, n_blocks: int, in_channels: int, planes: int,
                 norm_groups: int = 8, kernel_size: Ints3 = 3,
                 dropout: Optional[float] = None):
        super().__init__()
        self.n_blocks, self.dropout = n_blocks, dropout
        for i in range(n_blocks):
            self.add_module(f"block{i}", MyronenkoResidualBlock(
                in_channels if i == 0 else planes, planes, norm_groups=norm_groups,
                kernel_size=kernel_size))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
            if i == 0 and self.dropout is not None:
                x = channel_dropout(x, self.dropout, train, rng)
        return x

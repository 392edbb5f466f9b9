"""Conv building blocks (NDHWC activations).

Counterparts of ``unet3d_tpu/models/layers.py``. ``FastConv`` trains through
the autograd Functions of ``ops/conv3d``; ``PointwiseConv`` and
``SubpixelConvTranspose`` are matmuls and reshapes that train through torch
autograd (the JAX subpixel VJP is a layout device for XLA, not a kernel).
Parameters keep the Flax
names and layouts (``kernel`` DHWIO, ``bias``), so a JAX checkpoint loads by
key alone (``convert.py``). Parameters are created empty; ``init_parameters``
fills a whole model from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn

from unet3d_tpu_torch.ops.conv3d import conv3d, conv3d_with_stats
from unet3d_tpu_torch.ops.conv3d_kernel import instance_stats

Ints3 = Union[int, Sequence[int]]


def _triple(v: Ints3) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    return tuple(int(x) for x in v)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's initialisers, drawn from ``generator`` in parameter order:
    ``kernel`` lecun-normal (truncated at two standard deviations, fan-in all
    axes but the last), ``scale`` ones, ``bias`` zeros."""
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
        y = torch.matmul(x, w)
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
        y = torch.matmul(x, wm).reshape(n, d, h, w, k0, k1, k2 * co)
        y = y.permute(0, 1, 4, 2, 5, 3, 6).reshape(n, d * k0, h * k1, w * k2, co)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


def transposed_conv(in_channels: int, features: int, kernel_size: Ints3,
                    stride: Ints3, use_bias: bool = True,
                    output_padding: Ints3 = 0) -> nn.Module:
    """Transposed conv with torch padding semantics; only kernel == stride is
    ported (the DynUNet upsample)."""
    k, s, op = _triple(kernel_size), _triple(stride), _triple(output_padding)
    if k == s and op == (0, 0, 0):
        return SubpixelConvTranspose(in_channels, features, k, use_bias)
    raise NotImplementedError(
        f"transposed_conv kernel={k} stride={s} output_padding={op}: only "
        "kernel == stride is ported so far (see ROADMAP.md)")

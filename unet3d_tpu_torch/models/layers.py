"""Conv, norm and dense building blocks (NDHWC activations).

Counterparts of ``unet3d_tpu/models/layers.py``. ``FastConv`` trains through
the autograd Functions of ``ops/conv3d``; ``PointwiseConv`` and
``SubpixelConvTranspose`` are matmuls and reshapes (the JAX subpixel VJP is a
layout device for XLA, not a kernel), ``ConvTranspose`` is the overlapping
transposed conv (cuDNN), and so is ``Dense`` a matmul, each through
``ops/conv3d``'s ``channel_matmul`` / ``cudnn_conv`` (f32 in full f32, TF32
off); ``Conv`` is Flax's ``nn.Conv`` with explicit pads and dilation
(cuDNN, as the JAX package leaves it to XLA), and ``PatchConv`` its
kernel = stride, VALID form as a patchify and one channel matmul;
``GroupNorm``, ``LayerNorm`` and ``BatchNorm`` train through torch autograd. Parameters keep the Flax names
and layouts (``kernel`` DHWIO or (in, out), ``scale`` / ``bias``), and a
BatchNorm's running statistics are buffers named as Flax's ``batch_stats``
(``mean`` / ``var``), so a JAX checkpoint loads by key alone
(``convert.py``). Parameters are created empty; ``init_parameters`` fills a
whole model from a ``torch.Generator``.

Flax infers a module's input channels from its first input; torch needs them
when the module is built, so every module here takes them. The Myronenko
blocks (GroupNorm -> ReLU -> conv, twice, plus the identity) follow Flax's
dtype rules: ``GroupNorm`` returns the result type of its input and its
parameters and a conv casts its kernel to its input's dtype, so a block fed
an f32 activation runs in f32 even on bf16 parameters, as the JAX block does.
Noise (the dropout masks) is drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from unet3d_tpu_torch.ops.conv3d import (channel_matmul, conv3d, conv3d_with_stats, cudnn_conv,
                                         global_instance_stats, pad_d)
from unet3d_tpu_torch.parallel.distributed import (data_size, mean_over_data, space_size,
                                                   sum_over_space)
from unet3d_tpu_torch.parallel.halo import exchange_halo

Ints3 = Union[int, Sequence[int]]


def _triple(v: Ints3) -> Tuple[int, int, int]:
    return _ntuple(v, 3)


def _ntuple(v: Ints3, n: int) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's initialisers, drawn from ``generator`` in parameter order:
    ``kernel`` lecun-normal (truncated at two standard deviations, fan-in all
    axes but the last: a conv's or transposed conv's DHWIO, a Dense's (in,
    out)), ``scale`` ones, ``bias`` zeros, a PReLU's ``alpha`` 0.25; the
    transformers' ``pos_embedding`` normal(0.02), ``cls_token`` zeros and
    ``relative_position_bias_table`` Flax's ``truncated_normal(0.02)`` (a
    standard normal cut at +-2, times 0.02: not rescaled to a 0.02 standard
    deviation, as the kernels' draw is); DiNTS's architecture logits
    ``log_alpha_a`` zeros and ``log_alpha_c`` normal(1e-3); the BatchNorm buffers
    (``batch_stats``) ``mean`` zeros, ``var`` ones. A submodule with an
    ``init_own_parameters(generator)`` method (GlobalNet's affine head: zero
    kernel, identity bias; the graph layers' uniform draws; VQVAE's
    quantizers, whose codebook buffers it fills) sets its own parameters and
    buffers instead."""
    owners = [(prefix, m) for prefix, m in module.named_modules()
              if hasattr(m, "init_own_parameters")]
    owned = {f"{prefix}.{name}" if prefix else name
             for prefix, m in owners
             for name, _ in [*m.named_parameters(), *m.named_buffers()]}
    for _, m in owners:
        m.init_own_parameters(generator)
    with torch.no_grad():
        for name, b in module.named_buffers():
            if name in owned:
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in ("mean", "var"):
                raise ValueError(f"no initialiser for buffer {name}")
            b.fill_(0.0 if leaf == "mean" else 1.0)
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in owned:
                continue
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
            elif leaf == "alpha":
                p.fill_(0.25)
            elif leaf == "pos_embedding":
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "cls_token":
                p.zero_()
            elif leaf == "relative_position_bias_table":
                nn.init.trunc_normal_(p, 0.0, 0.02, -0.04, 0.04, generator=generator)
            elif leaf == "log_alpha_a":
                p.zero_()
            elif leaf == "log_alpha_c":
                p.normal_(0.0, 1e-3, generator=generator)
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
            return (y, *global_instance_stats(y))
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
    ConvTranspose kernel tap-reversed, hence the flip. Each output plane
    reads one input plane, so on the space axis a D slab gives the slab of
    the whole volume's output as it is."""

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
    and the parameters.

    On the space axis (x a D slab) the kernel-3 stride-2 form with D pads
    (1, 2) (torch's ``output_padding`` 1: out = 2 in; MONAI's up-convs)
    reads one plane past the slab's top: the slab takes the plane above it
    (``parallel/halo.exchange_halo``; a zero plane at the volume's top, as
    the pad there), is transposed-convolved whole and cut to its own 2 D
    output planes. Any other form raises on the axis."""

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
        depth, on_axis = x.shape[1], space_size() > 1
        if on_axis:
            if (self.kernel_size[0], self.stride[0], self.padding[0],
                    self.output_padding[0]) != (3, 2, 1, 1):
                raise NotImplementedError(
                    f"a transposed conv of kernel {self.kernel_size}, stride {self.stride}, "
                    f"padding {self.padding} and output padding {self.output_padding} has "
                    "no form for the 'space' mesh axis (see ROADMAP.md)")
            x, (_, pad_hi) = exchange_halo(x, 0, 1)
            x = pad_d(x, (0, pad_hi))
        w = torch.flip(self.kernel, dims=(0, 1, 2)).to(dtype).permute(3, 4, 0, 1, 2)
        y = cudnn_conv(x.to(dtype).permute(0, 4, 1, 2, 3), w, self.stride, self.padding,
                       transposed=True, output_padding=self.output_padding)
        y = y.permute(0, 2, 3, 4, 1)
        y = (y[:, :2 * depth] if on_axis else y).contiguous()
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


class Conv(nn.Module):
    """Flax ``nn.Conv`` with ``padding`` and ``dilation``, computed by cuDNN
    in the result type of the input and the parameters (f32 in full f32):
    the VALID 2-cubed stride-2 conv of VNet's down transitions, the dilated
    convs of MONAI's ``Convolution``, DiNTS's convs and QuickNAT's 2-D ones.
    A ``kernel_size`` tuple sets the number of spatial axes (2 on NHWC
    slices; an int means 3). ``padding`` is symmetric per axis, or "SAME",
    XLA's: ``max((ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)`` in all on
    an axis of size n, the odd one at the high side. ``groups`` is Flax's
    ``feature_group_count``: the kernel is ``(*k, Cin / groups, Cout)``.
    On the space axis only a form local to its D planes runs (kernel 1,
    stride 1, no pad on D); any other raises: a slab convolved with zero
    pads for its neighbours' planes is not the volume's slab."""

    def __init__(self, in_channels: int, features: int, kernel_size: Ints3,
                 strides: Ints3 = 1, padding: Union[str, Ints3] = 0, dilation: Ints3 = 1,
                 use_bias: bool = True, groups: int = 1):
        super().__init__()
        if in_channels % groups or features % groups:
            raise ValueError(f"{groups} groups do not divide {in_channels} -> {features} "
                             "channels")
        nd = 3 if isinstance(kernel_size, int) else len(kernel_size)
        self.kernel_size, self.strides = _ntuple(kernel_size, nd), _ntuple(strides, nd)
        self.padding = padding if padding == "SAME" else _ntuple(padding, nd)
        self.dilation, self.groups = _ntuple(dilation, nd), groups
        self.kernel = nn.Parameter(
            torch.empty(self.kernel_size + (in_channels // groups, features)))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def _pads(self, spatial: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
        if self.padding != "SAME":
            return tuple((p, p) for p in self.padding)
        pads = []
        for n, k, s, d in zip(spatial, self.kernel_size, self.strides, self.dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = [self.kernel] + ([self.bias] if self.bias is not None else [])
        dtype = _result_type(x, *params)
        nd = len(self.kernel_size)
        pads = self._pads(x.shape[1:-1])
        if space_size() > 1 and (self.kernel_size[0], self.strides[0], pads[0]) != (
                1, 1, (0, 0)):
            raise NotImplementedError(
                f"a conv of kernel {self.kernel_size}, strides {self.strides} and pads "
                f"{pads} has no form for the 'space' mesh axis (see ROADMAP.md)")
        x = x.to(dtype).movedim(-1, 1)
        if any(lo != hi for lo, hi in pads):
            x = torch.nn.functional.pad(x, [p for pair in reversed(pads) for p in pair])
            pads = ((0, 0),) * nd
        w = self.kernel.to(dtype).permute(nd + 1, nd, *range(nd))
        y = cudnn_conv(x, w, self.strides, tuple(lo for lo, _ in pads),
                       dilation=self.dilation, groups=self.groups)
        y = y.movedim(1, -1).contiguous()
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


def max_pool(x: torch.Tensor, window: Sequence[int], strides: Sequence[int],
             padding: Sequence[int]) -> torch.Tensor:
    """Flax's ``nn.max_pool`` of NDHWC ``x`` with symmetric ``padding`` per
    axis: the pads are -inf, and the gradient goes to each window's first
    maximum (XLA's and torch's rule)."""
    y = torch.nn.functional.max_pool3d(x.permute(0, 4, 1, 2, 3), tuple(window),
                                       tuple(strides), tuple(padding))
    return y.permute(0, 2, 3, 4, 1).contiguous()


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


class PatchConv(nn.Module):
    """Flax ``nn.Conv`` with kernel = stride and VALID padding (the
    transformers' patch embeddings): each patch flattened in (d, h, w, c)
    order, one channel matmul with the DHWIO kernel reshaped to (patch * C,
    features); in the result type of the input and the parameters."""

    def __init__(self, in_channels: int, features: int, patch_size: Ints3,
                 use_bias: bool = True):
        super().__init__()
        self.patch_size = _triple(patch_size)
        self.kernel = nn.Parameter(torch.empty(self.patch_size + (in_channels, features)))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = [self.kernel] + ([self.bias] if self.bias is not None else [])
        dtype = _result_type(x, *params)
        (p0, p1, p2), (n, d, h, w, c) = self.patch_size, x.shape
        if d % p0 or h % p1 or w % p2:
            raise ValueError(f"spatial dims {(d, h, w)} are not multiples of the patch "
                             f"{self.patch_size}")
        x = x.to(dtype).reshape(n, d // p0, p0, h // p1, p1, w // p2, p2, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(n, d // p0, h // p1, w // p2, -1)
        y = channel_matmul(x, self.kernel.to(dtype).reshape(x.shape[-1], -1))
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """Flax's LayerNorm over the last axis: mean and variance in f32 (f64
    for an f64 x), the variance as E[x^2] - E[x]^2 clamped at 0; ``(x -
    mean) * (rsqrt(var + eps) * scale) + bias`` in that type (without the
    scale or bias that is None); the result in the result type of x, scale
    and bias. (``F.layer_norm`` takes the variance in two passes and keeps
    its input's dtype.)"""
    compute = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(compute)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale.to(compute)
    y = (xf - mean) * mul
    if bias is not None:
        y = y + bias.to(compute)
    return y.to(_result_type(x, *(p for p in (scale, bias) if p is not None)))


class LayerNorm(nn.Module):
    """``layer_norm`` with Flax ``nn.LayerNorm`` parameters (``scale``,
    ``bias``). ``eps`` has no default: Flax's is 1e-6, the nets pass 1e-5."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


def group_norm_groups(channels: int, norm_groups: int = 8) -> int:
    """GroupNorm's group count, with the reference's fallback to one group
    per channel when ``channels`` is smaller than or not divisible by
    ``norm_groups``."""
    if channels < norm_groups or channels % norm_groups != 0:
        return channels
    return norm_groups


def group_norm(x: torch.Tensor, num_groups: int, scale: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """Flax's GroupNorm on channels-last ``x`` of any rank (NDHWC, NHWC for
    the 2-D nets, (B, V, C) for the graph blocks): per (item, group) mean
    and variance over the other axes and the group's channels in f32 (f64 for an f64
    x), the variance as E[x^2] - E[x]^2 clamped at 0; ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in that type (without the scale or
    bias that is None); the result in the result type of x, scale and bias.
    (``F.group_norm`` takes the variance another way and refuses parameters
    of another dtype than its input.) On the space axis (x an NDHWC D slab)
    the moments are the whole volume's: the slabs' sums summed over the
    axis, over the global voxel count."""
    n, c = x.shape[0], x.shape[-1]
    compute = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(compute)
    xg = xf.reshape(n, -1, num_groups, c // num_groups)
    if x.dim() == 5 and space_size() > 1:
        count = xg.shape[1] * xg.shape[3] * space_size()
        sums = sum_over_space(torch.stack([xg.sum(dim=(1, 3)), (xg * xg).sum(dim=(1, 3))]))
        mean, mean_sq = sums[0] / count, sums[1] / count
    else:
        mean, mean_sq = xg.mean(dim=(1, 3)), (xg * xg).mean(dim=(1, 3))
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    size = c // num_groups
    stat_shape = (n,) + (1,) * (x.dim() - 2) + (c,)
    mean = mean.repeat_interleave(size, dim=-1).reshape(stat_shape)
    var = var.repeat_interleave(size, dim=-1).reshape(stat_shape)
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale.to(compute)
    y = (xf - mean) * mul
    if bias is not None:
        y = y + bias.to(compute)
    return y.to(_result_type(x, *(p for p in (scale, bias) if p is not None)))


class GroupNorm(nn.Module):
    """``group_norm`` with Flax ``nn.GroupNorm`` parameters (``scale``,
    ``bias``; none when not ``affine``, Flax's ``use_scale=False,
    use_bias=False``), eps 1e-5. One group per channel is an instance norm."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {channels} channels")
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.empty(channels)) if affine else None
        self.bias = nn.Parameter(torch.empty(channels)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.scale, self.bias, self.eps)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` on channels-last ``x``, as the nets build it:
    ``momentum`` the weight of the old running value (0.9), eps 1e-5.
    Parameters ``scale`` / ``bias``; buffers ``mean`` / ``var``, the
    ``batch_stats`` collection (zeros / ones at init).

    With ``train`` the statistics are the batch's, over every axis but the
    last, in f32 (f64 for an f64 x), the variance E[x^2] - E[x]^2 clamped at
    0 (the biased one); in a data-parallel step E[x] and E[x^2] are the
    global batch's, averaged over the data axis, and on the space axis (x
    a D slab; not in a replicated level) over the slabs too (SyncBN over
    (data, space): Flax under SPMD), so every rank normalises and updates
    alike; each call updates the
    running averages in place, once, ``ra = momentum * ra + (1 - momentum) *
    batch``, in the buffers' dtype (f32 under the AMP train step, which
    casts only parameters). Otherwise the running averages as they are (bf16 under the inference
    AMP cast). Then ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in
    the promoted type of its operands, the result in the result type of x,
    scale and bias. The mode is the ``train`` argument, not
    ``Module.training``. (``torch.nn.BatchNorm3d`` weights its momentum the
    other way and stores the unbiased variance.)"""

    BUFFER_COLLECTION = "batch_stats"

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            dims = tuple(range(x.dim() - 1))
            moments = torch.stack([xf.mean(dim=dims), (xf * xf).mean(dim=dims)])
            if space_size() > 1:  # every slab of a level has as many planes
                moments = sum_over_space(moments) / space_size()
            if data_size() > 1:
                moments = mean_over_data(moments)
            mean, mean_sq = moments.unbind(0)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(_result_type(x, self.scale, self.bias))


def apply_norm(norm: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
    """``norm(x)``, with the mode for a ``BatchNorm`` (the other norms have
    none)."""
    return norm(x, train) if isinstance(norm, BatchNorm) else norm(x)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """JAX's ``leaky_relu``: ``where(x >= 0, x, slope * x)``, derivative 1 at
    0 (torch's ``F.leaky_relu`` takes the slope there)."""
    return torch.where(x >= 0, x, slope * x)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator],
            broadcast_dims: Sequence[int] = ()) -> torch.Tensor:
    """Flax ``nn.Dropout(rate, broadcast_dims)``: in training each element
    (one mask value shared along ``broadcast_dims``) is kept with
    probability 1 - rate (one uniform draw from ``generator`` each, on x's
    device) and scaled by 1 / (1 - rate); otherwise x as it is. Training
    with a rate in (0, 1) needs the generator."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator (rng)")
    keep = 1.0 - rate
    shape = tuple(1 if i in broadcast_dims else s for i, s in enumerate(x.shape))
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def channel_dropout(x: torch.Tensor, rate: float, train: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout(rate, broadcast_dims=(1, 2, 3))`` on NDHWC ``x``:
    one draw per (item, channel), MONAI's Dropout3d."""
    return dropout(x, rate, train, generator, broadcast_dims=(1, 2, 3))


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

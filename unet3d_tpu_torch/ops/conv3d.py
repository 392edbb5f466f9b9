"""3D convolution entry points (NDHWC activations, DHWIO weights), with gradients.

The 3x3x3 stride-1 SAME conv goes to the hand-written kernels of
``ops/conv3d_kernel.py`` (their plain versions for a CPU tensor), forward and
backward: the input gradient is the ``conv`` kernel on the cotangent with the
weight flipped on its three spatial axes and in/out transposed, the weight
gradient is cuDNN's (the JAX package leaves it to XLA). The 3x3x3 stride-2
conv runs forward and input gradient in cuDNN and its weight gradient in the
kernel of ``ops/s2_wgrad_kernel.py``. Every other conv (1x1x1, other kernel
sizes) goes to ``F.conv3d`` with explicit pads and torch autograd, as the JAX
package leaves them to XLA; statistics outside a kernel are a plain
reduction. Padding "SAME" means symmetric k//2 pads (torch Conv3d
semantics), not XLA's strided SAME.

``UNET3D_TPU_CONV=winograd`` (the JAX package's strategy variable, read at
each dispatch) sends every 3x3x3 stride-1 conv that passes the JAX gate
(``ops/winograd_kernel.winograd_applies``) to the Winograd-DH kernels, forward
and input gradient, as the JAX package does; at a fused block site the
activation is then materialised first. Unset keeps the routing above; any
other value raises (the JAX package's other strategies are TPU bisect
handles the port does not carry).

On the space axis (``parallel/``: inside ``space_parallel``, x a slab of
the volume's D planes) a 3x3x3 stride-1 conv exchanges one plane with each
neighbour (``parallel/halo.exchange_halo``) and runs the kernels' D-halo
mode, forward and input gradient (``ops/conv3d_kernel``: the pads of a
rank at the volume's edge stand for its missing neighbour); its weight
gradient runs on the halo'd input padded on D, VALID on D, each rank's
partial sum left to the gradients' mean over the mesh. A 3x3x3 stride-2
conv takes the plane below (a slab of an even number of planes starts at
an even plane, so no plane above is in reach): cuDNN's forward and input
gradient on the input padded on D by (pad_lo, 1), VALID on D, and
``s2_wgrad``'s halo mode for the weight gradient. A 1x1x1 conv is local to
each plane. The statistics of ``conv3d_with_stats`` and
``conv3d_block_with_stats`` are summed over the axis
(``distributed.sum_over_space``). Other kernel sizes raise on the axis (see
ROADMAP.md). Under ``UNET3D_TPU_CONV=winograd`` the gate is judged on the
whole volume (the slab's D times the axis), as the JAX package's sharded
step judges it, and a site that passes runs the Winograd-DH kernels' D-halo
mode, forward and input gradient; at a fused block site the neighbours'
raw planes are exchanged, the halo'd slab activated with the slab's
scale and shift, and the Winograd halo mode's zero pad planes stand for the
missing neighbours after the activation, as JAX pads the materialised
activation.

f32 on the card is full f32: every cuDNN conv here (forward and gradients)
and the channel matmuls (the attention products too) run under
``utils/device.full_f32``, TF32 off
whatever the process's flags say, and the f32 3x3x3 kernel form is 3xTF32
(``ops/conv3d_kernel``), f32-accurate.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from unet3d_tpu_torch.ops.conv3d_kernel import (SAME, affine_lrelu, conv3x3x3,
                                                conv3x3x3_block_with_stats,
                                                conv3x3x3_with_stats,
                                                instance_stats)
from unet3d_tpu_torch.parallel import distributed
from unet3d_tpu_torch.parallel.halo import exchange_halo
from unet3d_tpu_torch.ops.s2_wgrad_kernel import s2_wgrad
from unet3d_tpu_torch.ops.winograd_kernel import (winograd3x3x3,
                                                  winograd3x3x3_with_stats,
                                                  winograd_applies,
                                                  winograd_profitable)
from unet3d_tpu_torch.utils.device import full_f32

Pads = Tuple[Tuple[int, int], ...]


def _pads(padding, kernel: Sequence[int]) -> Pads:
    if padding == "SAME":
        return tuple((k // 2, k // 2) for k in kernel)
    pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    if any(lo != hi for lo, hi in pads):
        raise ValueError(f"asymmetric conv padding {pads} is not supported")
    return pads


def conv_strategy() -> Optional[str]:
    """``UNET3D_TPU_CONV`` as the port honours it: None (unset) or "winograd"."""
    strategy = os.environ.get("UNET3D_TPU_CONV") or None
    if strategy not in (None, "winograd"):
        raise ValueError(
            f"UNET3D_TPU_CONV={strategy!r}: the port honours only 'winograd' "
            "(or unset); the JAX package's other conv strategies are TPU "
            "bisect handles it does not carry")
    return strategy


def whole_volume(shape, space: int) -> Tuple[int, ...]:
    """The NDHWC shape of the volume of which ``shape`` is one of ``space``
    D slabs."""
    return (shape[0], shape[1] * space, *shape[2:])


def _winograd_site(x: torch.Tensor, w: torch.Tensor, stride, pads) -> bool:
    """Whether the strategy and the JAX gate, judged on the whole volume
    (x's on one device, a slab's times the space axis), send this 3x3x3
    conv to Winograd-DH."""
    return (conv_strategy() == "winograd"
            and winograd_applies(whole_volume(x.shape, distributed.space_size()),
                                 tuple(w.shape), stride, pads))


def _is_3x3x3(w: torch.Tensor, stride: Tuple[int, ...], pads: Pads, s: int) -> bool:
    return (tuple(w.shape[:3]) == (3, 3, 3) and stride == (s, s, s)
            and pads == ((1, 1),) * 3)


class _FullF32Conv(torch.autograd.Function):
    """An f32 cuDNN conv or transposed conv (channels-first operands, any
    number of spatial axes, ``groups``) with its forward and both gradients
    under ``full_f32``: torch autograd would run the gradients outside any
    scope the forward set."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed, output_padding, dilation, groups):
        ctx.conf = (stride, padding, dilation, transposed, output_padding, groups)
        ctx.save_for_backward(x, w)
        with full_f32(x):
            return torch.ops.aten.convolution(x, w, None, *ctx.conf)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with full_f32(gy):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, *ctx.conf, (*ctx.needs_input_grad[:2], False))
        return dx, dw, None, None, None, None, None, None


def cudnn_conv(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
               padding: Sequence[int], transposed: bool = False,
               output_padding: Optional[Sequence[int]] = None,
               dilation: Optional[Sequence[int]] = None, groups: int = 1) -> torch.Tensor:
    """``F.conv{1,2,3}d`` (``F.conv_transpose*d`` when ``transposed``) of
    channels-first ``x`` with torch's weight layout, ``(Cout, Cin / groups,
    ...)`` for a grouped conv (the outputs ordered by group, as Flax's
    ``feature_group_count`` orders them); f32 in full f32, forward and
    gradients."""
    stride, padding = tuple(stride), tuple(padding)
    output_padding = tuple(output_padding or (0,) * len(stride))
    dilation = tuple(dilation or (1,) * len(stride))
    if x.dtype == torch.float32:
        return _FullF32Conv.apply(x, w, stride, padding, transposed, output_padding,
                                  dilation, groups)
    return torch.ops.aten.convolution(x, w, None, stride, padding, dilation,
                                      transposed, output_padding, groups)


class _FullF32Matmul(torch.autograd.Function):
    """``x @ w`` in f32, for (..., Cin) ``x`` and a (Cin, Cout) ``w`` or for
    (..., m, k) and (..., k, n) operands of the same batch shape, its
    forward and both gradients under ``full_f32``."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with full_f32(x):
            return torch.matmul(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx = dw = None
        with full_f32(gy):
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(gy, w.transpose(-1, -2))
            if ctx.needs_input_grad[1]:
                dw = (torch.matmul(x.reshape(-1, x.shape[-1]).t(), gy.reshape(-1, gy.shape[-1]))
                      if w.dim() == 2 else torch.matmul(x.transpose(-1, -2), gy))
        return dx, dw


def channel_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(x, w)`` over the channel axis of ``x`` with a (Cin,
    Cout) ``w``, or of two operands with the same batch axes (the attention
    products); f32 in full f32, forward and gradients."""
    if x.dtype == torch.float32:
        return _FullF32Matmul.apply(x, w)
    return torch.matmul(x, w)


def conv3d_torch(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, ...],
                 pads: Pads) -> torch.Tensor:
    """``F.conv3d`` on an NDHWC tensor with symmetric ``pads`` (f32 in full
    f32). The NCDHW view of a contiguous NDHWC tensor is already
    channels_last_3d, so the permutes copy nothing."""
    y = cudnn_conv(x.permute(0, 4, 1, 2, 3), w.to(x.dtype).permute(4, 3, 0, 1, 2),
                   stride, tuple(lo for lo, _ in pads))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """The 3x3x3 weight of the input gradient: taps reversed, in/out swapped."""
    return torch.flip(w, dims=(0, 1, 2)).transpose(3, 4).contiguous()


def pad_d(x: torch.Tensor, pads) -> torch.Tensor:
    """NDHWC ``x`` with (lo, hi) zero planes on D."""
    return F.pad(x, (0, 0, 0, 0, 0, 0, *pads))


def weight_grad(x: torch.Tensor, g: torch.Tensor, w_shape, stride: int,
                pad) -> torch.Tensor:
    """cuDNN's weight gradient (f32 accumulation, full f32 for f32 operands)
    of ``conv3d(x, w)`` for the cotangent ``g``, DHWIO, in g's dtype, with
    ``pad`` (an int, or one per axis) symmetric pads. A CPU tensor computes
    in f32."""
    dtype = g.dtype
    if x.device.type == "cpu":
        x, g = x.float(), g.float()
    with full_f32(g):
        dw = torch.nn.grad.conv3d_weight(
            x.permute(0, 4, 1, 2, 3), (w_shape[4], w_shape[3], *w_shape[:3]),
            g.permute(0, 4, 1, 2, 3), stride=stride, padding=pad)
    return dw.permute(2, 3, 4, 1, 0).to(dtype)


def fold_stats_cotangent(gy, gs1, gs2, y) -> torch.Tensor:
    """The cotangent of y from those of (y, sum y, sum y^2) per (item,
    channel), folded in f32 and rounded to y's dtype, contiguous."""
    g = (gy.float() + gs1[:, None, None, None, :]
         + 2.0 * y.float() * gs2[:, None, None, None, :])
    return g.to(y.dtype).contiguous()


class _Conv3x3x3(torch.autograd.Function):
    """3x3x3 stride-1 SAME conv, with or without the output statistics,
    through the direct kernels or (``winograd``) the Winograd-DH ones. The
    input gradient of a Winograd site is Winograd again when the cotangent
    passes the profitability gate, else the direct ``conv`` kernel (the JAX
    ``_dgrad``)."""

    @staticmethod
    def forward(ctx, x, w, with_stats: bool, winograd: bool = False, pads=SAME):
        ctx.with_stats, ctx.winograd, ctx.pads = with_stats, winograd, tuple(pads)
        ctx.space = distributed.space_size()
        if with_stats:
            y, s1, s2 = (winograd3x3x3_with_stats(x, w, pads) if winograd
                         else conv3x3x3_with_stats(x, w, pads))
            ctx.save_for_backward(x, w, y)
            return y, s1, s2
        y = winograd3x3x3(x, w, pads) if winograd else conv3x3x3(x, w, pads)
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gs1=None, gs2=None):
        if ctx.with_stats:
            x, w, y = ctx.saved_tensors
            g = fold_stats_cotangent(gy, gs1, gs2, y)
        else:
            x, w = ctx.saved_tensors
            g = gy.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx_pads = input_grad_pads(ctx.pads)
            # the JAX _dgrad's gate, on the whole volume's cotangent
            if ctx.winograd and winograd_profitable(whole_volume(g.shape, ctx.space)):
                dx = winograd3x3x3(g, flip_io(w), dx_pads)
            else:
                dx = conv3x3x3(g, flip_io(w), dx_pads)
        dw = None
        if ctx.needs_input_grad[1]:
            dw = halo_weight_grad(x, g, w.shape, ctx.pads).to(w.dtype)
        return dx, dw, None, None, None


def input_grad_pads(pads) -> Tuple[int, int]:
    """The D pads of the input gradient's conv of a conv with D ``pads``:
    it gives every plane of the conv's input (SAME's own for SAME)."""
    return 2 - pads[0], 2 - pads[1]


def halo_weight_grad(x: torch.Tensor, g: torch.Tensor, w_shape, pads) -> torch.Tensor:
    """The stride-1 3x3x3 weight gradient for x with D ``pads``: SAME's, or
    on x padded on D, VALID on D."""
    if tuple(pads) == SAME:
        return weight_grad(x, g, w_shape, 1, 1)
    return weight_grad(pad_d(x, pads), g, w_shape, 1, (0, 1, 1))


class _BlockConv3x3x3(torch.autograd.Function):
    """``conv(lrelu(y * inv + shift), w)`` plus the output statistics, the
    activation zero-padded (a neighbour plane of the D-halo mode is
    activated). Backward recomputes the activation: the kernel's forward
    never writes it."""

    @staticmethod
    def forward(ctx, y, w, inv, shift, alpha: float, pads=SAME):
        out, t1, t2 = conv3x3x3_block_with_stats(y, w, inv, shift, alpha, pads)
        ctx.alpha, ctx.pads = alpha, tuple(pads)
        ctx.save_for_backward(y, inv, shift, w, out)
        return out, t1, t2

    @staticmethod
    @once_differentiable
    def backward(ctx, gout, gt1, gt2):
        y, inv, shift, w, out = ctx.saved_tensors
        g = fold_stats_cotangent(gout, gt1, gt2, out)
        dw = None
        if ctx.needs_input_grad[1]:
            z = affine_lrelu(y, inv, shift, ctx.alpha)
            dw = halo_weight_grad(z, g, w.shape, ctx.pads).to(w.dtype)
            del z
        dy = dinv = dshift = None
        if any(ctx.needs_input_grad[i] for i in (0, 2, 3)):
            dz = conv3x3x3(g, flip_io(w), input_grad_pads(ctx.pads)).float()
            inv5, shift5 = inv[:, None, None, None, :], shift[:, None, None, None, :]
            yf = y.float()
            dz = torch.where(yf * inv5 + shift5 >= 0, dz, dz * ctx.alpha)
            dy = (dz * inv5).to(y.dtype)
            dinv = (dz * yf).sum(dim=(1, 2, 3))
            dshift = dz.sum(dim=(1, 2, 3))
        return dy, dw, dinv, dshift, None, None


class _Conv3x3x3Stride2(torch.autograd.Function):
    """3x3x3 stride-2 conv with pads of 1: forward and input gradient in
    cuDNN (full f32 for f32), weight gradient in the s2_wgrad kernel. With
    ``pad_lo`` 0 (the D-halo mode: x's first plane is the slab's neighbour
    below) x is padded on D by (0, 1) and the conv is VALID on D."""

    @staticmethod
    def forward(ctx, x, w, pad_lo: int = 1):
        ctx.pad_lo = pad_lo
        ctx.save_for_backward(x, w)
        if pad_lo == 1:
            return conv3d_torch(x, w, (2, 2, 2), ((1, 1),) * 3)
        return conv3d_torch(pad_d(x, (0, 1)), w, (2, 2, 2), ((0, 0), (1, 1), (1, 1)))

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            depth, padding = (x.shape[1], 1) if ctx.pad_lo == 1 else (x.shape[1] + 1, (0, 1, 1))
            with full_f32(g):
                dx = torch.nn.grad.conv3d_input(
                    (x.shape[0], x.shape[4], depth, *x.shape[2:4]),
                    w.to(x.dtype).permute(4, 3, 0, 1, 2),
                    g.permute(0, 4, 1, 2, 3), stride=2, padding=padding)
            dx = dx.permute(0, 2, 3, 4, 1)[:, :x.shape[1]].contiguous()
        if ctx.needs_input_grad[1]:
            dw = s2_wgrad(x, g, ctx.pad_lo).to(w.dtype)
        return dx, dw, None


def _space_conv3d(x: torch.Tensor, w: torch.Tensor, stride, pads, with_stats: bool):
    """``conv3d`` (``conv3d_with_stats``: the slab's statistics) of a D slab
    on the space axis."""
    if _is_3x3x3(w, stride, pads, 1):
        winograd = _winograd_site(x, w, stride, pads)
        xh, halo_pads = exchange_halo(x, 1, 1)
        return _Conv3x3x3.apply(xh, w.contiguous(), with_stats, winograd, halo_pads)
    if _is_3x3x3(w, stride, pads, 2) and x.shape[1] % 2 == 0:
        xh, halo_pads = exchange_halo(x, 1, 0)
        y = _Conv3x3x3Stride2.apply(xh, w.contiguous(), halo_pads[0])
    elif w.shape[0] == 1 and pads[0] == (0, 0) and x.shape[1] % stride[0] == 0:
        y = conv3d_torch(x, w, stride, pads)  # each output plane reads one plane
    else:
        raise NotImplementedError(
            f"a {tuple(w.shape[:3])} conv with strides {stride} has no form for the "
            f"'space' mesh axis on a slab of {x.shape[1]} planes (see ROADMAP.md)")
    return (y, *instance_stats(y)) if with_stats else y


def space_stats(s1: torch.Tensor, s2: torch.Tensor):
    """Per-(item, channel) statistics of a D slab summed over the space axis
    (the slab's own off the axis)."""
    if distributed.space_size() == 1:
        return s1, s2
    return tuple(distributed.sum_over_space(torch.stack([s1, s2])).unbind(0))


def global_instance_stats(y: torch.Tensor):
    """``instance_stats`` of the whole volume of which ``y`` is a D slab."""
    return space_stats(*instance_stats(y))


def conv3d(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] = (1, 1, 1),
           padding="SAME") -> torch.Tensor:
    conv_strategy()  # an unknown strategy raises at every conv, as a typo should
    stride = tuple(int(s) for s in stride)
    pads = _pads(padding, w.shape[:3])
    if distributed.space_size() > 1:
        return _space_conv3d(x, w, stride, pads, False)
    if _is_3x3x3(w, stride, pads, 1):
        return _Conv3x3x3.apply(x, w.contiguous(), False,
                                _winograd_site(x, w, stride, pads))
    if _is_3x3x3(w, stride, pads, 2):
        return _Conv3x3x3Stride2.apply(x, w.contiguous())
    return conv3d_torch(x, w, stride, pads)


def conv3d_with_stats(x: torch.Tensor, w: torch.Tensor,
                      stride: Sequence[int] = (1, 1, 1), padding="SAME"):
    """Conv plus per-(item, channel) f32 (sum, sum_sq) of the output as rounded
    to its dtype: the instance-norm statistics (the whole volume's on the
    space axis)."""
    stride = tuple(int(s) for s in stride)
    pads = _pads(padding, w.shape[:3])
    if distributed.space_size() > 1:
        conv_strategy()
        y, s1, s2 = _space_conv3d(x, w, stride, pads, True)
        return (y, *space_stats(s1, s2))
    if _is_3x3x3(w, stride, pads, 1):
        return _Conv3x3x3.apply(x, w.contiguous(), True,
                                _winograd_site(x, w, stride, pads))
    y = conv3d(x, w, stride, padding)
    return (y, *instance_stats(y))


def conv3d_block_with_stats(y: torch.Tensor, w: torch.Tensor,
                            scale: torch.Tensor, shift: torch.Tensor,
                            alpha: float = 0.01):
    """Stride-1 SAME ``conv3d(lrelu(y * scale + shift, alpha), w)`` plus the
    output statistics. ``scale`` / ``shift`` are f32 (N, C): the previous
    instance norm folded with its statistics (``ops/norm.fold_in_affine``).
    The activation is zero-padded, as if it had been materialised; at a
    Winograd site it is materialised, as the JAX model does. On the space
    axis the neighbours' planes of y are exchanged first and activated with
    the slab's own (at a Winograd site the halo'd slab is activated, then
    convolved in the Winograd halo mode)."""
    if tuple(w.shape[:3]) != (3, 3, 3):
        return conv3d_with_stats(affine_lrelu(y, scale, shift, alpha), w)
    winograd = _winograd_site(y, w, (1, 1, 1), ((1, 1),) * 3)
    if distributed.space_size() > 1:
        yh, halo_pads = exchange_halo(y, 1, 1)
        if winograd:
            out, t1, t2 = _Conv3x3x3.apply(affine_lrelu(yh, scale, shift, alpha),
                                           w.contiguous(), True, True, halo_pads)
        else:
            out, t1, t2 = _BlockConv3x3x3.apply(yh, w.contiguous(), scale, shift, alpha,
                                                halo_pads)
        return (out, *space_stats(t1, t2))
    if not winograd:
        return _BlockConv3x3x3.apply(y, w.contiguous(), scale, shift, alpha)
    return conv3d_with_stats(affine_lrelu(y, scale, shift, alpha), w)

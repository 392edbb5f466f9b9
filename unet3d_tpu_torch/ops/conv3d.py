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
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from unet3d_tpu_torch.ops.conv3d_kernel import (affine_lrelu, conv3x3x3,
                                                conv3x3x3_block_with_stats,
                                                conv3x3x3_with_stats,
                                                instance_stats)
from unet3d_tpu_torch.ops.s2_wgrad_kernel import s2_wgrad
from unet3d_tpu_torch.ops.winograd_kernel import (winograd3x3x3,
                                                  winograd3x3x3_with_stats,
                                                  winograd_applies,
                                                  winograd_profitable)

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


def _winograd_site(x: torch.Tensor, w: torch.Tensor, stride, pads) -> bool:
    return (conv_strategy() == "winograd"
            and winograd_applies(tuple(x.shape), tuple(w.shape), stride, pads))


def _is_3x3x3(w: torch.Tensor, stride: Tuple[int, ...], pads: Pads, s: int) -> bool:
    return (tuple(w.shape[:3]) == (3, 3, 3) and stride == (s, s, s)
            and pads == ((1, 1),) * 3)


def conv3d_torch(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, ...],
                 pads: Pads) -> torch.Tensor:
    """``F.conv3d`` on an NDHWC tensor with symmetric ``pads``. The NCDHW view
    of a contiguous NDHWC tensor is already channels_last_3d, so the permutes
    copy nothing."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype).permute(4, 3, 0, 1, 2),
                 stride=tuple(stride), padding=tuple(lo for lo, _ in pads))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """The 3x3x3 weight of the input gradient: taps reversed, in/out swapped."""
    return torch.flip(w, dims=(0, 1, 2)).transpose(3, 4).contiguous()


def weight_grad(x: torch.Tensor, g: torch.Tensor, w_shape, stride: int,
                pad: int) -> torch.Tensor:
    """cuDNN's weight gradient (f32 accumulation) of ``conv3d(x, w)`` for the
    cotangent ``g``, DHWIO, in g's dtype. A CPU tensor computes in f32."""
    dtype = g.dtype
    if x.device.type == "cpu":
        x, g = x.float(), g.float()
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
    def forward(ctx, x, w, with_stats: bool, winograd: bool = False):
        ctx.with_stats, ctx.winograd = with_stats, winograd
        if with_stats:
            op = winograd3x3x3_with_stats if winograd else conv3x3x3_with_stats
            y, s1, s2 = op(x, w)
            ctx.save_for_backward(x, w, y)
            return y, s1, s2
        y = (winograd3x3x3 if winograd else conv3x3x3)(x, w)
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
            dgrad = (winograd3x3x3 if ctx.winograd and winograd_profitable(g.shape)
                     else conv3x3x3)
            dx = dgrad(g, flip_io(w))
        dw = None
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x, g, w.shape, 1, 1).to(w.dtype)
        return dx, dw, None, None


class _BlockConv3x3x3(torch.autograd.Function):
    """``conv(lrelu(y * inv + shift), w)`` plus the output statistics, the
    activation zero-padded. Backward recomputes the activation: the kernel's
    forward never writes it."""

    @staticmethod
    def forward(ctx, y, w, inv, shift, alpha: float):
        out, t1, t2 = conv3x3x3_block_with_stats(y, w, inv, shift, alpha)
        ctx.alpha = alpha
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
            dw = weight_grad(z, g, w.shape, 1, 1).to(w.dtype)
            del z
        dy = dinv = dshift = None
        if any(ctx.needs_input_grad[i] for i in (0, 2, 3)):
            dz = conv3x3x3(g, flip_io(w)).float()
            inv5, shift5 = inv[:, None, None, None, :], shift[:, None, None, None, :]
            yf = y.float()
            dz = torch.where(yf * inv5 + shift5 >= 0, dz, dz * ctx.alpha)
            dy = (dz * inv5).to(y.dtype)
            dinv = (dz * yf).sum(dim=(1, 2, 3))
            dshift = dz.sum(dim=(1, 2, 3))
        return dy, dw, dinv, dshift, None


class _Conv3x3x3Stride2(torch.autograd.Function):
    """3x3x3 stride-2 conv with pads of 1: forward and input gradient in
    cuDNN, weight gradient in the s2_wgrad kernel."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d_torch(x, w, (2, 2, 2), ((1, 1),) * 3)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(
                (x.shape[0], x.shape[4], *x.shape[1:4]),
                w.to(x.dtype).permute(4, 3, 0, 1, 2),
                g.permute(0, 4, 1, 2, 3), stride=2, padding=1)
            dx = dx.permute(0, 2, 3, 4, 1).contiguous()
        if ctx.needs_input_grad[1]:
            dw = s2_wgrad(x, g).to(w.dtype)
        return dx, dw


def conv3d(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] = (1, 1, 1),
           padding="SAME") -> torch.Tensor:
    conv_strategy()  # an unknown strategy raises at every conv, as a typo should
    stride = tuple(int(s) for s in stride)
    pads = _pads(padding, w.shape[:3])
    if _is_3x3x3(w, stride, pads, 1):
        return _Conv3x3x3.apply(x, w.contiguous(), False,
                                _winograd_site(x, w, stride, pads))
    if _is_3x3x3(w, stride, pads, 2):
        return _Conv3x3x3Stride2.apply(x, w.contiguous())
    return conv3d_torch(x, w, stride, pads)


def conv3d_with_stats(x: torch.Tensor, w: torch.Tensor,
                      stride: Sequence[int] = (1, 1, 1), padding="SAME"):
    """Conv plus per-(item, channel) f32 (sum, sum_sq) of the output as rounded
    to its dtype: the instance-norm statistics."""
    stride = tuple(int(s) for s in stride)
    pads = _pads(padding, w.shape[:3])
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
    Winograd site it is materialised, as the JAX model does."""
    if (tuple(w.shape[:3]) == (3, 3, 3)
            and not _winograd_site(y, w, (1, 1, 1), ((1, 1),) * 3)):
        return _BlockConv3x3x3.apply(y, w.contiguous(), scale, shift, alpha)
    return conv3d_with_stats(affine_lrelu(y, scale, shift, alpha), w)

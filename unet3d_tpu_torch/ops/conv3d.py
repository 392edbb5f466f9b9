"""3D convolution entry points (NDHWC activations, DHWIO weights).

The 3x3x3 stride-1 SAME conv goes to the hand-written kernels of
``ops/conv3d_kernel.py`` (their plain versions for a CPU tensor). Every other
conv (stride 2, 1x1x1, other kernel sizes) goes to ``F.conv3d`` with explicit
pads, as the JAX package leaves them to XLA; its statistics are a plain
reduction. Padding "SAME" means symmetric k//2 pads (torch Conv3d semantics),
not XLA's strided SAME.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from unet3d_tpu_torch.ops.conv3d_kernel import (affine_lrelu, conv3x3x3,
                                                conv3x3x3_block_with_stats,
                                                conv3x3x3_with_stats,
                                                instance_stats)

Pads = Tuple[Tuple[int, int], ...]


def _pads(padding, kernel: Sequence[int]) -> Pads:
    if padding == "SAME":
        return tuple((k // 2, k // 2) for k in kernel)
    pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    if any(lo != hi for lo, hi in pads):
        raise ValueError(f"asymmetric conv padding {pads} is not supported")
    return pads


def _uses_kernel(w: torch.Tensor, stride: Tuple[int, ...], pads: Pads) -> bool:
    return (tuple(w.shape[:3]) == (3, 3, 3) and stride == (1, 1, 1)
            and pads == ((1, 1),) * 3)


def conv3d_torch(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, ...],
                 pads: Pads) -> torch.Tensor:
    """``F.conv3d`` on an NDHWC tensor with symmetric ``pads``. The NCDHW view
    of a contiguous NDHWC tensor is already channels_last_3d, so the permutes
    copy nothing."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype).permute(4, 3, 0, 1, 2),
                 stride=tuple(stride), padding=tuple(lo for lo, _ in pads))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv3d(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] = (1, 1, 1),
           padding="SAME") -> torch.Tensor:
    stride = tuple(int(s) for s in stride)
    pads = _pads(padding, w.shape[:3])
    if _uses_kernel(w, stride, pads):
        return conv3x3x3(x, w.contiguous())
    return conv3d_torch(x, w, stride, pads)


def conv3d_with_stats(x: torch.Tensor, w: torch.Tensor,
                      stride: Sequence[int] = (1, 1, 1), padding="SAME"):
    """Conv plus per-(item, channel) f32 (sum, sum_sq) of the output as rounded
    to its dtype: the instance-norm statistics."""
    stride = tuple(int(s) for s in stride)
    pads = _pads(padding, w.shape[:3])
    if _uses_kernel(w, stride, pads):
        return conv3x3x3_with_stats(x, w.contiguous())
    y = conv3d_torch(x, w, stride, pads)
    return (y, *instance_stats(y))


def conv3d_block_with_stats(y: torch.Tensor, w: torch.Tensor,
                            scale: torch.Tensor, shift: torch.Tensor,
                            alpha: float = 0.01):
    """Stride-1 SAME ``conv3d(lrelu(y * scale + shift, alpha), w)`` plus the
    output statistics. ``scale`` / ``shift`` are f32 (N, C): the previous
    instance norm folded with its statistics (``ops/norm.fold_in_affine``).
    The activation is zero-padded, as if it had been materialised."""
    if tuple(w.shape[:3]) == (3, 3, 3):
        return conv3x3x3_block_with_stats(y, w.contiguous(), scale, shift, alpha)
    return conv3d_with_stats(affine_lrelu(y, scale, shift, alpha), w)

"""Instance norm applied from precomputed (sum, sum_sq) statistics, forward only.

The two-moment form of ``_StatsInstanceNorm`` (``unet3d_tpu/models/dynunet.py``)
and ``unet3d_tpu/ops/norm.py``: f32 statistics, variance E[y^2] - E[y]^2
clamped at 0, eps 1e-5, the result rounded to y's dtype. On the space axis
the statistics are the whole volume's (summed over the axis by the caller)
and so is the voxel count (``voxel_count``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from unet3d_tpu_torch.parallel.distributed import space_size


def voxel_count(y: torch.Tensor) -> int:
    """The voxels of one item of NDHWC ``y``, the whole volume's on the
    space axis (y a D slab)."""
    return y.shape[1] * y.shape[2] * y.shape[3] * space_size()


def fold_in_affine(s1: torch.Tensor, s2: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, count: int,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inv, shift), each f32 (N, C), with IN(y) = y * inv + shift, from the
    per-(item, channel) sums over ``count`` voxels."""
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps) * scale.float()
    return inv, bias.float() - mean * inv


def instance_norm_from_stats(y: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor,
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float = 1e-5) -> torch.Tensor:
    """Normalise NDHWC ``y`` with its precomputed statistics and the affine."""
    inv, shift = fold_in_affine(s1, s2, scale, bias, voxel_count(y), eps)
    out = y.float() * inv[:, None, None, None, :] + shift[:, None, None, None, :]
    return out.to(y.dtype)

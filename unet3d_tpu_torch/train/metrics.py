"""Evaluation metrics: per-channel Dice and a surface-disagreement proxy
(counterpart of ``unet3d_tpu/train/metrics.py``), on channel-last tensors
``(..., C)`` in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from unet3d_tpu_torch.ops.one_hot import estimate_binary_contour
from unet3d_tpu_torch.utils.device import as_tensor


def dice_score(pred, target, threshold: Optional[float] = 0.5,
               smooth: float = 1e-5, axis=None) -> torch.Tensor:
    """Per-channel Dice; ``threshold`` binarises the prediction (None keeps
    the soft Dice); sums over every axis but the channels unless ``axis``
    says otherwise."""
    pred = as_tensor(pred).float()
    target = as_tensor(target).float()
    if threshold is not None:
        pred = (pred > threshold).float()
    if axis is None:
        axis = tuple(range(pred.dim() - 1))
    intersection = torch.sum(pred * target, dim=axis)
    denom = torch.sum(pred, dim=axis) + torch.sum(target, dim=axis)
    return (2.0 * intersection + smooth) / (denom + smooth)


def mean_dice(pred, target, **kwargs) -> torch.Tensor:
    return torch.mean(dice_score(pred, target, **kwargs))


def hausdorff_like_surface_error(pred, target, threshold: float = 0.5) -> torch.Tensor:
    """The share of boundary voxels present in exactly one of the two masks
    (the boundaries of the thresholded masks over their last three axes)."""
    cp = estimate_binary_contour(as_tensor(pred) > threshold)
    ct = estimate_binary_contour(as_tensor(target) > threshold)
    disagree = torch.logical_xor(cp, ct).sum()
    total = torch.clamp(cp.sum() + ct.sum(), min=1)
    return disagree / total

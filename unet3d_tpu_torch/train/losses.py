"""Losses (counterpart of ``unet3d_tpu/train/losses.py``): DiceLoss so far.

Channel-last ``(N, ..., C)`` layout, one-hot targets. Under bf16 AMP the train
step hands the loss the raw bf16 output, and the Dice family keeps its
elementwise products in that dtype and accumulates every reduction in f32, as
the JAX package does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _sum32(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.sum(x, dim=dims, dtype=torch.float32)


class DiceLoss:
    """MONAI DiceLoss semantics: 1 - (2|X∩Y| + nr) / (|X| + |Y| + dr), reduced
    over spatial dims (and batch when ``batch=True``), then averaged."""

    def __init__(self, include_background: bool = True, sigmoid: bool = False,
                 softmax: bool = False, squared_pred: bool = False,
                 jaccard: bool = False, batch: bool = False,
                 smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 reduction: str = "mean"):
        self.include_background = include_background
        self.sigmoid = sigmoid
        self.softmax = softmax
        self.squared_pred = squared_pred
        self.jaccard = jaccard
        self.batch = batch
        self.smooth_nr = smooth_nr
        self.smooth_dr = smooth_dr
        self.reduction = reduction

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.sigmoid:
            pred = torch.sigmoid(pred)
        elif self.softmax:
            pred = torch.softmax(pred, dim=-1)
        if not self.include_background and pred.shape[-1] > 1:
            # channel 0 is background by MONAI convention
            pred, target = pred[..., 1:], target[..., 1:]
        target = target.to(pred.dtype)
        spatial = tuple(range(1, pred.dim() - 1))
        dims = ((0,) + spatial) if self.batch else spatial
        intersection = _sum32(target * pred, dims)
        if self.squared_pred:
            ground, prediction = _sum32(target * target, dims), _sum32(pred * pred, dims)
        else:
            ground, prediction = _sum32(target, dims), _sum32(pred, dims)
        denominator = ground + prediction
        if self.jaccard:
            denominator = 2.0 * (denominator - intersection)
        loss = 1.0 - (2.0 * intersection + self.smooth_nr) / (denominator + self.smooth_dr)
        if self.reduction == "none":
            return loss
        if self.reduction == "sum":
            return loss.sum()
        return loss.mean()


LOSS_REGISTRY = {"DiceLoss": DiceLoss}


def load_criterion(criterion_name: str, loss_kwargs: Optional[dict] = None) -> Callable:
    """Name -> loss instance."""
    if criterion_name not in LOSS_REGISTRY:
        raise ValueError(f"Loss {criterion_name} is not ported yet; ported: "
                         f"{', '.join(LOSS_REGISTRY)} (see ROADMAP.md)")
    return LOSS_REGISTRY[criterion_name](**(loss_kwargs or {}))

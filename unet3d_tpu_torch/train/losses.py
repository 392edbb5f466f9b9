"""Losses (counterpart of ``unet3d_tpu/train/losses.py``): the JAX package's
whole registry, the MONAI and torch names, with its semantics.

Channel-last ``(N, ..., C)`` layout, one-hot targets (continuous ones for the
regression losses). Under bf16 AMP the train step hands the loss the raw bf16
output: the Dice family keeps its elementwise products in that dtype and
accumulates every reduction in f32; the losses with transcendentals (focal,
cross-entropy, BCE) and the regression losses upcast to f32 at entry, as the
JAX package does. The semantics are the JAX package's where they differ from
torch's: CrossEntropyLoss and NLLLoss take one-hot (or probability) targets
on the last axis, a weighted mean divides by the sum of the weights, and
FocalLoss handles ``alpha`` as MONAI does.

In a data-parallel step (``parallel/mesh.py``) each rank sees its share of
the global batch, and a loss that couples items takes the global batch's
sums: ``batch=True`` on the Dice family and Tversky, and a class-weighted
mean, sum their batch sums over the data axis before the ratio; a
``reduction="sum"`` over items scales the share's sum by the axis's size,
so that the mean over ranks is the global loss. Outside such a step both
are the identity.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unet3d_tpu_torch.ops.conv3d import cudnn_conv
from unet3d_tpu_torch.parallel.distributed import data_size, sum_over_data


def _sum32(x: torch.Tensor, dims) -> torch.Tensor:
    return torch.sum(x, dim=dims, dtype=torch.float32)


def _f32(pred: torch.Tensor) -> torch.Tensor:
    return pred.float()


def _apply_activation(pred: torch.Tensor, sigmoid: bool = False,
                      softmax: bool = False) -> torch.Tensor:
    if sigmoid:
        return torch.sigmoid(pred)
    if softmax:
        return torch.softmax(pred, dim=-1)
    return pred


def _drop_background(pred, target, include_background: bool):
    if not include_background and pred.shape[-1] > 1:
        # channel 0 is background by MONAI convention
        return pred[..., 1:], target[..., 1:]
    return pred, target


def _reduce(loss: torch.Tensor, reduction: str, over_items: bool = True) -> torch.Tensor:
    """``loss`` reduced; a sum over items (``over_items``: the loss keeps
    the batch axis) scaled by the data axis's size in a data-parallel step."""
    if reduction == "none":
        return loss
    if reduction == "sum":
        total = loss.sum()
        return total * data_size() if over_items and data_size() > 1 else total
    return loss.mean()


def _global_sums(*sums: torch.Tensor):
    """Batch sums of this rank's share summed over the data axis (one
    all-reduce) in a data-parallel step; as they are otherwise."""
    if data_size() == 1:
        return sums
    return tuple(sum_over_data(torch.stack(sums)).unbind(0))


def _reduce_dims(pred: torch.Tensor, batch: bool):
    spatial = tuple(range(1, pred.dim() - 1))
    return ((0,) + spatial) if batch else spatial


def _bce_with_logits(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return F.softplus(-pred) * target + F.softplus(pred) * (1.0 - target)


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
        pred = _apply_activation(pred, self.sigmoid, self.softmax)
        pred, target = _drop_background(pred, target, self.include_background)
        target = target.to(pred.dtype)
        dims = _reduce_dims(pred, self.batch)
        intersection = _sum32(target * pred, dims)
        if self.squared_pred:
            ground, prediction = _sum32(target * target, dims), _sum32(pred * pred, dims)
        else:
            ground, prediction = _sum32(target, dims), _sum32(pred, dims)
        if self.batch:
            intersection, ground, prediction = _global_sums(intersection, ground, prediction)
        denominator = ground + prediction
        if self.jaccard:
            denominator = 2.0 * (denominator - intersection)
        loss = 1.0 - (2.0 * intersection + self.smooth_nr) / (denominator + self.smooth_dr)
        return _reduce(loss, self.reduction, over_items=not self.batch)


class GeneralizedDiceLoss:
    """MONAI GeneralizedDiceLoss, ``w_type`` square (default), simple or
    uniform; an empty class's infinite weight becomes the sample's largest
    finite weight."""

    def __init__(self, include_background: bool = True, sigmoid: bool = False,
                 softmax: bool = False, w_type: str = "square", batch: bool = False,
                 smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 reduction: str = "mean"):
        self.include_background = include_background
        self.sigmoid = sigmoid
        self.softmax = softmax
        self.w_type = w_type
        self.batch = batch
        self.smooth_nr = smooth_nr
        self.smooth_dr = smooth_dr
        self.reduction = reduction

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        pred = _apply_activation(pred, self.sigmoid, self.softmax)
        pred, target = _drop_background(pred, target, self.include_background)
        target = target.to(pred.dtype)
        dims = _reduce_dims(pred, self.batch)
        intersection = _sum32(target * pred, dims)
        ground = _sum32(target, dims)
        prediction = _sum32(pred, dims)
        if self.batch:  # the weights too come from the global sums
            intersection, ground, prediction = _global_sums(intersection, ground, prediction)
        if self.w_type == "simple":
            w = torch.reciprocal(ground)
        elif self.w_type == "uniform":
            w = torch.ones_like(ground)
        else:  # square
            w = torch.reciprocal(ground * ground)
        infinite = torch.isinf(w)
        finite = torch.where(infinite, torch.zeros_like(w), w)
        w = torch.where(infinite, finite.amax(dim=-1, keepdim=True), w)
        numer = 2.0 * torch.sum(intersection * w, dim=-1) + self.smooth_nr
        denom = torch.sum((ground + prediction) * w, dim=-1) + self.smooth_dr
        return _reduce(1.0 - numer / denom, self.reduction, over_items=not self.batch)


class FocalLoss:
    """MONAI FocalLoss, gamma 2: the sigmoid (BCE-with-logits) form, or the
    softmax form with ``use_softmax``. Under softmax ``alpha`` weights the
    background channel by 1 - alpha and the others by alpha, and is dropped,
    with a warning, when the background is excluded."""

    def __init__(self, include_background: bool = True, gamma: float = 2.0,
                 alpha: Optional[float] = None, weight=None, reduction: str = "mean",
                 use_softmax: bool = False):
        self.include_background = include_background
        self.gamma = gamma
        self.alpha = alpha
        self.weight = weight
        self.reduction = reduction
        self.use_softmax = use_softmax

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        pred = _f32(pred)
        pred, target = _drop_background(pred, target, self.include_background)
        target = target.to(pred.dtype)
        alpha = self.alpha
        if self.use_softmax:
            if not self.include_background and alpha is not None:
                warnings.warn("FocalLoss: `include_background=False`, `alpha` "
                              "ignored when using softmax (MONAI semantics).")
                alpha = None
            logp = torch.log_softmax(pred, dim=-1)
            p = torch.exp(logp)
            loss = -target * ((1 - p) ** self.gamma) * logp
            if alpha is not None:
                n = pred.shape[-1]
                alpha_fac = torch.tensor([1 - alpha] + [alpha] * (n - 1),
                                         dtype=pred.dtype, device=pred.device)
                loss = alpha_fac * loss
        else:
            p = torch.sigmoid(pred)
            ce = _bce_with_logits(pred, target)
            p_t = p * target + (1 - p) * (1 - target)
            loss = ce * ((1.0 - p_t) ** self.gamma)
            if self.alpha is not None:
                alpha_t = self.alpha * target + (1 - self.alpha) * (1 - target)
                loss = alpha_t * loss
        if self.weight is not None:
            w = torch.atleast_1d(torch.as_tensor(self.weight, dtype=pred.dtype,
                                                 device=pred.device))
            if w.dim() != 1 or (w.shape[0] not in (1, pred.shape[-1])):
                raise ValueError(
                    f"FocalLoss weight has {w.shape[0]} entries for "
                    f"{pred.shape[-1]} classes (include_background="
                    f"{self.include_background})")
            loss = w * loss
        return _reduce(loss, self.reduction)


class DiceCELoss:
    """MONAI DiceCELoss: lambda_dice * DiceLoss + lambda_ce * cross-entropy,
    the CE leg BCE-with-logits for one channel (MONAI routes on the channel
    count alone)."""

    def __init__(self, include_background: bool = True, sigmoid: bool = False,
                 softmax: bool = False, squared_pred: bool = False, batch: bool = False,
                 smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 lambda_dice: float = 1.0, lambda_ce: float = 1.0):
        self.dice = DiceLoss(include_background=include_background, sigmoid=sigmoid,
                             softmax=softmax, squared_pred=squared_pred, batch=batch,
                             smooth_nr=smooth_nr, smooth_dr=smooth_dr)
        self.sigmoid = sigmoid
        self.lambda_dice = lambda_dice
        self.lambda_ce = lambda_ce

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        dice = self.dice(pred, target)
        pred = _f32(pred)
        target_f = target.to(pred.dtype)
        if pred.shape[-1] == 1:
            ce = torch.mean(_bce_with_logits(pred, target_f))
        else:
            ce = -torch.mean(torch.sum(target_f * torch.log_softmax(pred, dim=-1), dim=-1))
        return self.lambda_dice * dice + self.lambda_ce * ce


class DiceFocalLoss:
    """MONAI DiceFocalLoss: lambda_dice * DiceLoss + lambda_focal * FocalLoss."""

    def __init__(self, include_background: bool = True, sigmoid: bool = False,
                 softmax: bool = False, gamma: float = 2.0, batch: bool = False,
                 lambda_dice: float = 1.0, lambda_focal: float = 1.0):
        self.dice = DiceLoss(include_background=include_background, sigmoid=sigmoid,
                             softmax=softmax, batch=batch)
        self.focal = FocalLoss(include_background=include_background, gamma=gamma,
                               use_softmax=softmax)
        self.lambda_dice = lambda_dice
        self.lambda_focal = lambda_focal

    def __call__(self, pred, target):
        return (self.lambda_dice * self.dice(pred, target)
                + self.lambda_focal * self.focal(pred, target))


class GeneralizedDiceFocalLoss:
    """MONAI GeneralizedDiceFocalLoss: lambda_gdl * GDL + lambda_focal * FocalLoss."""

    def __init__(self, include_background: bool = True, sigmoid: bool = False,
                 softmax: bool = False, w_type: str = "square",
                 gamma: float = 2.0, batch: bool = False,
                 smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 lambda_gdl: float = 1.0, lambda_focal: float = 1.0):
        self.gdl = GeneralizedDiceLoss(
            include_background=include_background, sigmoid=sigmoid,
            softmax=softmax, w_type=w_type, batch=batch,
            smooth_nr=smooth_nr, smooth_dr=smooth_dr)
        self.focal = FocalLoss(include_background=include_background,
                               gamma=gamma, use_softmax=softmax)
        self.lambda_gdl = lambda_gdl
        self.lambda_focal = lambda_focal

    def __call__(self, pred, target):
        return (self.lambda_gdl * self.gdl(pred, target)
                + self.lambda_focal * self.focal(pred, target))


class SSIMLoss:
    """MONAI SSIMLoss (3D): 1 - mean SSIM over a gaussian (or uniform)
    window, the window means separable VALID convolutions per channel in
    f32."""

    def __init__(self, spatial_dims: int = 3, data_range: float = 1.0,
                 kernel_type: str = "gaussian", win_size: int = 11,
                 kernel_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
                 reduction: str = "mean"):
        if spatial_dims != 3:
            raise NotImplementedError("SSIMLoss is 3D")
        self.data_range = float(data_range)
        self.k1, self.k2 = float(k1), float(k2)
        self.reduction = reduction
        if kernel_type == "gaussian":
            half = (win_size - 1) / 2.0
            x = np.arange(win_size, dtype=np.float64) - half
            k = np.exp(-0.5 * (x / kernel_sigma) ** 2)
        elif kernel_type == "uniform":
            k = np.ones(win_size, dtype=np.float64)
        else:
            raise ValueError(f"SSIMLoss kernel_type {kernel_type!r}")
        self._kernel = torch.from_numpy((k / k.sum()).astype(np.float32))

    def _window_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Separable VALID window mean over the three spatial axes of
        (N, D, H, W, C)."""
        n, c = x.shape[0], x.shape[-1]
        y = x.permute(0, 4, 1, 2, 3).reshape(n * c, *x.shape[1:4])
        k = self._kernel.to(x.device)[None, None, :]
        for axis in (1, 2, 3):
            y = y.movedim(axis, -1)
            shape = y.shape[:-1]
            y = cudnn_conv(y.reshape(-1, 1, y.shape[-1]), k, (1,), (0,)).reshape(*shape, -1)
            y = y.movedim(-1, axis)
        return y.reshape(n, c, *y.shape[1:]).permute(0, 2, 3, 4, 1)

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        win = int(self._kernel.shape[0])
        if any(s < win for s in pred.shape[1:4]):
            raise ValueError(
                f"SSIMLoss win_size={win} exceeds spatial dims "
                f"{tuple(pred.shape[1:4])}; pass a smaller win_size")
        x = _f32(pred)
        y = target.to(x.dtype)
        c1 = (self.k1 * self.data_range) ** 2
        c2 = (self.k2 * self.data_range) ** 2
        mu_x = self._window_mean(x)
        mu_y = self._window_mean(y)
        sxx = self._window_mean(x * x) - mu_x * mu_x
        syy = self._window_mean(y * y) - mu_y * mu_y
        sxy = self._window_mean(x * y) - mu_x * mu_y
        ssim = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / (
            (mu_x * mu_x + mu_y * mu_y + c1) * (sxx + syy + c2))
        return _reduce(1.0 - ssim, self.reduction)


def _class_weighted(loss, target, weight, reduction):
    """A per-class weight taken at each voxel's one-hot class; the mean is
    divided by the weights' sum, as torch does."""
    if weight is None:
        return _reduce(loss, reduction)
    w = torch.sum(target * torch.as_tensor(weight, dtype=target.dtype,
                                           device=target.device), dim=-1)
    if reduction == "mean":
        numer, denom = _global_sums(torch.sum(loss * w), torch.sum(w))
        return numer / denom
    return _reduce(loss * w, reduction)


class CrossEntropyLoss:
    """torch.nn.CrossEntropyLoss over one-hot or probability targets on the
    last axis, with class weights and label smoothing."""

    def __init__(self, weight=None, reduction: str = "mean",
                 label_smoothing: float = 0.0):
        self.weight = weight
        self.reduction = reduction
        self.label_smoothing = label_smoothing

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        pred = _f32(pred)
        target = target.to(pred.dtype)
        if self.label_smoothing:
            n = target.shape[-1]
            target = target * (1 - self.label_smoothing) + self.label_smoothing / n
        loss = -torch.sum(target * torch.log_softmax(pred, dim=-1), dim=-1)
        return _class_weighted(loss, target, self.weight, self.reduction)


class BCEWithLogitsLoss:
    def __init__(self, reduction: str = "mean", pos_weight=None):
        self.reduction = reduction
        self.pos_weight = pos_weight

    def __call__(self, pred, target):
        pred = _f32(pred)
        target = target.to(pred.dtype)
        pos = F.softplus(-pred) * target
        if self.pos_weight is not None:
            pos = pos * torch.as_tensor(self.pos_weight, dtype=pred.dtype,
                                        device=pred.device)
        return _reduce(pos + F.softplus(pred) * (1.0 - target), self.reduction)


class MSELoss:
    def __init__(self, reduction: str = "mean"):
        self.reduction = reduction

    def __call__(self, pred, target):
        pred = _f32(pred)
        return _reduce((pred - target.to(pred.dtype)) ** 2, self.reduction)


class L1Loss:
    def __init__(self, reduction: str = "mean"):
        self.reduction = reduction

    def __call__(self, pred, target):
        pred = _f32(pred)
        return _reduce(torch.abs(pred - target.to(pred.dtype)), self.reduction)


class SmoothL1Loss:
    def __init__(self, reduction: str = "mean", beta: float = 1.0):
        self.reduction = reduction
        self.beta = beta

    def __call__(self, pred, target):
        pred = _f32(pred)
        diff = torch.abs(pred - target.to(pred.dtype))
        loss = torch.where(diff < self.beta, 0.5 * diff ** 2 / self.beta,
                           diff - 0.5 * self.beta)
        return _reduce(loss, self.reduction)


class TverskyLoss:
    """MONAI TverskyLoss: 1 - (TP + nr) / (TP + alpha FP + beta FN + dr)."""

    def __init__(self, include_background: bool = True, sigmoid: bool = False,
                 softmax: bool = False, alpha: float = 0.5, beta: float = 0.5,
                 batch: bool = False, smooth_nr: float = 1e-5,
                 smooth_dr: float = 1e-5, reduction: str = "mean"):
        self.include_background = include_background
        self.sigmoid = sigmoid
        self.softmax = softmax
        self.alpha = alpha
        self.beta = beta
        self.batch = batch
        self.smooth_nr = smooth_nr
        self.smooth_dr = smooth_dr
        self.reduction = reduction

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        pred = _apply_activation(pred, self.sigmoid, self.softmax)
        pred, target = _drop_background(pred, target, self.include_background)
        target = target.to(pred.dtype)
        dims = _reduce_dims(pred, self.batch)
        tp = _sum32(pred * target, dims)
        fp = self.alpha * _sum32(pred * (1.0 - target), dims)
        fn = self.beta * _sum32((1.0 - pred) * target, dims)
        if self.batch:
            tp, fp, fn = _global_sums(tp, fp, fn)
        score = (tp + self.smooth_nr) / (tp + fp + fn + self.smooth_dr)
        return _reduce(1.0 - score, self.reduction, over_items=not self.batch)


class MaskedDiceLoss(DiceLoss):
    """MONAI MaskedDiceLoss: DiceLoss over ``pred * mask`` and ``target *
    mask``; without a mask, DiceLoss."""

    def __call__(self, pred, target, mask=None):
        if mask is not None:
            mask = mask.to(pred.dtype)
            pred = pred * mask
            target = target.to(pred.dtype) * mask
        return super().__call__(pred, target)


class NLLLoss:
    """torch.nn.NLLLoss over log-probabilities on the last axis, with one-hot
    or probability targets (CrossEntropyLoss's convention)."""

    def __init__(self, weight=None, reduction: str = "mean"):
        self.weight = weight
        self.reduction = reduction

    def __call__(self, pred, target):
        pred = _f32(pred)
        target = target.to(pred.dtype)
        loss = -torch.sum(target * pred, dim=-1)
        return _class_weighted(loss, target, self.weight, self.reduction)


class HuberLoss:
    """torch.nn.HuberLoss: 0.5 d^2 for |d| < delta, else delta (|d| - delta / 2)."""

    def __init__(self, reduction: str = "mean", delta: float = 1.0):
        self.reduction = reduction
        self.delta = delta

    def __call__(self, pred, target):
        pred = _f32(pred)
        diff = torch.abs(pred - target.to(pred.dtype))
        loss = torch.where(diff < self.delta, 0.5 * diff ** 2,
                           self.delta * (diff - 0.5 * self.delta))
        return _reduce(loss, self.reduction)


class VAELoss:
    """Reconstruction + beta * KL for the VAE family; ``wants_extras``: the
    train step passes the model's ``mu`` / ``logvar``."""

    def __init__(self, reconstruction: str = "MSELoss", beta: float = 1.0):
        self.recon = load_criterion(reconstruction)
        self.beta = beta
        self.wants_extras = True

    def __call__(self, pred, target, mu=None, logvar=None):
        loss = self.recon(pred, target)
        if mu is not None:
            mu, logvar = _f32(mu), _f32(logvar)
            kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
            loss = loss + self.beta * kl
        return loss


LOSS_REGISTRY = {
    "DiceLoss": DiceLoss,
    "GeneralizedDiceLoss": GeneralizedDiceLoss,
    "FocalLoss": FocalLoss,
    "DiceCELoss": DiceCELoss,
    "DiceFocalLoss": DiceFocalLoss,
    "GeneralizedDiceFocalLoss": GeneralizedDiceFocalLoss,
    "SSIMLoss": SSIMLoss,
    "CrossEntropyLoss": CrossEntropyLoss,
    "BCEWithLogitsLoss": BCEWithLogitsLoss,
    "MSELoss": MSELoss,
    "L1Loss": L1Loss,
    "SmoothL1Loss": SmoothL1Loss,
    "TverskyLoss": TverskyLoss,
    "MaskedDiceLoss": MaskedDiceLoss,
    "NLLLoss": NLLLoss,
    "HuberLoss": HuberLoss,
    "VAELoss": VAELoss,
}


def load_criterion(criterion_name: str, loss_kwargs: Optional[dict] = None) -> Callable:
    """Name -> loss instance."""
    if criterion_name not in LOSS_REGISTRY:
        raise ValueError(f"Loss {criterion_name} is not supported")
    return LOSS_REGISTRY[criterion_name](**(loss_kwargs or {}))

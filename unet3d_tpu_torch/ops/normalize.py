"""The intensity normalisers the dataset's alias table names (counterparts of
``unet3d_tpu/ops/normalize.py`` in torch): MONAI ``NormalizeIntensity``,
``ScaleIntensity``, ``ScaleIntensityRange``, ``ScaleIntensityRangePercentiles``,
``ThresholdIntensity`` and ``ShiftIntensity``. Each takes a channel-first
``(C, D, H, W)`` array or tensor and returns an f32 tensor. Standard
deviations are population ones (ddof 0), as MONAI's and jnp's.
"""
from __future__ import annotations

import torch

from unet3d_tpu_torch.utils.device import as_tensor


def _f32(data) -> torch.Tensor:
    return as_tensor(data).float()


def normalize_intensity(data, subtrahend=None, divisor=None, nonzero: bool = False,
                        channel_wise: bool = False) -> torch.Tensor:
    """z-score over the whole array or per channel; with ``nonzero`` the
    statistics and the update are restricted to nonzero voxels."""
    data = _f32(data)
    dims = tuple(range(1, data.dim())) if channel_wise else tuple(range(data.dim()))
    where = (data != 0) if nonzero else None
    if where is not None:
        cnt = torch.clamp(where.sum(dim=dims, keepdim=True), min=1)
        masked_mean = torch.where(where, data, 0.0).sum(dim=dims, keepdim=True) / cnt
    if subtrahend is None:
        sub = data.mean(dim=dims, keepdim=True) if where is None else masked_mean
    else:
        sub = torch.as_tensor(subtrahend, dtype=torch.float32)
        if channel_wise and sub.dim() == 1:
            sub = sub.reshape((-1,) + (1,) * (data.dim() - 1))
    if divisor is None:
        if where is None:
            div = data.std(dim=dims, keepdim=True, correction=0)
        else:
            div = torch.sqrt(torch.where(where, (data - masked_mean) ** 2, 0.0)
                             .sum(dim=dims, keepdim=True) / cnt)
    else:
        div = torch.as_tensor(divisor, dtype=torch.float32)
        if channel_wise and div.dim() == 1:
            div = div.reshape((-1,) + (1,) * (data.dim() - 1))
    div = torch.where(div == 0, torch.ones_like(div), div)
    normed = (data - sub) / div
    if nonzero:
        return torch.where(where, normed, data)
    return normed


def _rescale_array(arr: torch.Tensor, minv, maxv) -> torch.Tensor:
    """MONAI ``rescale_array``: min -> minv, max -> maxv; the bare 0-1 norm
    when either bound is None; a constant array gives ``arr * minv`` (or
    ``arr`` when minv is None)."""
    mina, maxa = arr.min(), arr.max()
    degenerate = arr if minv is None else arr * float(minv)
    norm = (arr - mina) / torch.where(maxa == mina, torch.ones_like(maxa), maxa - mina)
    if minv is None or maxv is None:
        scaled = norm
    else:
        scaled = norm * (float(maxv) - float(minv)) + float(minv)
    return torch.where(maxa == mina, degenerate, scaled)


def scale_intensity(data, minv=0.0, maxv=1.0, factor=None,
                    channel_wise: bool = False) -> torch.Tensor:
    """Rescale to [minv, maxv], or multiply by ``1 + factor`` when both bounds
    are None."""
    data = _f32(data)
    if minv is not None or maxv is not None:
        if channel_wise:
            return torch.stack([_rescale_array(data[c], minv, maxv)
                                for c in range(data.shape[0])])
        return _rescale_array(data, minv, maxv)
    if factor is None:
        raise ValueError("scale_intensity: incompatible values: "
                         "minv=None, maxv=None and factor=None")
    return data * (1.0 + float(factor))


def scale_intensity_range(data, a_min: float, a_max: float, b_min=None, b_max=None,
                          clip: bool = False) -> torch.Tensor:
    """Map [a_min, a_max] linearly to [b_min, b_max]; a degenerate input range
    shifts by ``-a_min (+ b_min)``."""
    data = _f32(data)
    if float(a_max) - float(a_min) == 0.0:
        out = data - a_min
        if b_min is not None:
            out = out + b_min
    else:
        out = (data - a_min) / (float(a_max) - float(a_min))
        if b_min is not None and b_max is not None:
            out = out * (float(b_max) - float(b_min)) + b_min
    if clip:
        out = torch.clamp(out, b_min, b_max)
    return out


def scale_intensity_range_percentiles(data, lower: float, upper: float, b_min, b_max,
                                      clip: bool = False, relative: bool = False,
                                      channel_wise: bool = False) -> torch.Tensor:
    """``scale_intensity_range`` with a_min / a_max at the lower / upper
    intensity percentiles (linear interpolation); ``relative`` scales the
    output window to the percentile span first."""
    if not 0.0 <= lower <= 100.0 or not 0.0 <= upper <= 100.0:
        raise ValueError("Percentiles must be in the range [0, 100]")
    data = _f32(data)

    def one(img):
        q = torch.quantile(img.reshape(-1), torch.tensor([lower / 100.0, upper / 100.0],
                                                         device=img.device))
        a_min, a_max = q[0], q[1]
        lo, hi = b_min, b_max
        if relative:
            if b_min is None or b_max is None:
                raise ValueError("If it is relative, b_min and b_max "
                                 "should not be None.")
            lo = (b_max - b_min) * (lower / 100.0) + b_min
            hi = (b_max - b_min) * (upper / 100.0) + b_min
        rng = a_max - a_min
        out = (img - a_min) / torch.where(rng == 0, torch.ones_like(rng), rng)
        if lo is not None and hi is not None:
            out = out * (float(hi) - float(lo)) + lo
        degenerate = img - a_min + (lo if lo is not None else 0.0)
        out = torch.where(rng == 0, degenerate, out)
        if clip:
            out = torch.clamp(out, lo, hi)
        return out

    if channel_wise:
        return torch.stack([one(data[c]) for c in range(data.shape[0])])
    return one(data)


def threshold_intensity(data, threshold: float, above: bool = True,
                        cval: float = 0.0) -> torch.Tensor:
    """Keep voxels strictly above (or below) ``threshold``, set the rest to
    ``cval``."""
    data = _f32(data)
    mask = data > threshold if above else data < threshold
    return torch.where(mask, data, torch.full_like(data, cval))


def shift_intensity(data, offset: float) -> torch.Tensor:
    """Add a fixed offset."""
    return _f32(data) + float(offset)

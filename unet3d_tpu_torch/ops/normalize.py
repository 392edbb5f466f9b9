"""The intensity normalisers the dataset resolves by name (counterparts of
``unet3d_tpu/ops/normalize.py`` in torch): MONAI ``NormalizeIntensity``,
``ScaleIntensity``, ``ScaleIntensityRange``, ``ScaleIntensityRangePercentiles``,
``ThresholdIntensity`` and ``ShiftIntensity``, and the reference's own menu
(``percentile_window``, ``foreground_zero_mean_normalize_image_data``,
``window_data``, ``radiology_style_windowing``, ``static_windows``,
``zero_floor_normalize_image_data``, ``zero_one_window``, ``hist_match``).
Each takes a channel-first ``(C, D, H, W)`` array or tensor and returns an
f32 tensor. MONAI's standard deviations are population ones (ddof 0); the
reference's menu uses torch's unbiased ``std`` (ddof 1). Percentiles
interpolate linearly between order statistics, as ``jnp.percentile`` does.
"""
from __future__ import annotations

import numpy as np
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


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` on an ascending ``xp``: linear between the points,
    ``fp[0]`` / ``fp[-1]`` outside them, ``fp[i - 1]`` across a zero-width
    step."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _percentile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile along the last axis, linear between order
    statistics (the position q/100 * (n - 1) in f32, as ``jnp.percentile``)."""
    s = flat.sort(dim=-1).values
    pos = torch.tensor(q, dtype=torch.float32) / 100.0 * (s.shape[-1] - 1)
    lo, hi = int(torch.floor(pos)), int(torch.ceil(pos))
    w = pos - lo
    return s[..., lo] * (1.0 - w) + s[..., hi] * w


def _channel_percentile(data: torch.Tensor, q: float) -> torch.Tensor:
    return _percentile(data.reshape(data.shape[0], -1), q).reshape(-1, 1, 1, 1)


def percentile_window(data, floor_percentile: float = 5,
                      ceiling_percentile: float = 95) -> torch.Tensor:
    """Clamp each channel to its [floor, ceiling] percentile window."""
    data = _f32(data)
    return torch.minimum(torch.maximum(data, _channel_percentile(data, floor_percentile)),
                         _channel_percentile(data, ceiling_percentile))


def foreground_zero_mean_normalize_image_data(data, background_value: float = 0,
                                              tolerance: float = 1e-5) -> torch.Tensor:
    """Per-channel z-score (unbiased std) over the voxels with
    |x| > background + tolerance; the background stays as it is."""
    data = _f32(data)
    dims = tuple(range(1, data.dim()))
    fg = data.abs() > (background_value + tolerance)
    cnt = torch.clamp(fg.sum(dim=dims, keepdim=True), min=1)
    mean = torch.where(fg, data, 0.0).sum(dim=dims, keepdim=True) / cnt
    var = torch.where(fg, (data - mean) ** 2, 0.0).sum(dim=dims, keepdim=True) / cnt
    std = torch.sqrt(var * (cnt / torch.clamp(cnt - 1, min=1)))
    return torch.where(fg, (data - mean) / std, data)


def window_data(data, floor_threshold, ceiling_threshold, floor: float = 0,
                ceiling: float = 1) -> torch.Tensor:
    """Map [floor_threshold, ceiling_threshold] linearly to [0, 1], then
    clamp to [floor, ceiling]."""
    data = (_f32(data) - floor_threshold) / (ceiling_threshold - floor_threshold)
    return torch.clamp(data, floor, ceiling)


def radiology_style_windowing(data, l: float, w: float, floor: float = 0,
                              ceiling: float = 1) -> torch.Tensor:
    """Level / width CT windowing."""
    return window_data(data, l - w / 2, l + w / 2, floor=floor, ceiling=ceiling)


def static_windows(data, windows, floor: float = 0, ceiling: float = 1) -> torch.Tensor:
    """Several fixed CT windows of a one-channel volume, stacked as channels."""
    data = _f32(data)
    squeezed = data[0] if (data.dim() == 4 and data.shape[0] == 1) else data
    return torch.stack([radiology_style_windowing(squeezed, l, w, floor, ceiling)
                        for (l, w) in windows])


def zero_floor_normalize_image_data(data, floor_percentile: float = 1,
                                    floor: float = 0) -> torch.Tensor:
    """Voxels at or below each channel's floor percentile become ``floor``,
    the rest are shifted down by it; then divided by the channel's unbiased
    std."""
    data = _f32(data)
    floor_threshold = _channel_percentile(data, floor_percentile)
    data = torch.where(data <= floor_threshold, floor, data - floor_threshold)
    n = data[0].numel()
    var = data.var(dim=(1, 2, 3), keepdim=True, correction=0)
    return data / torch.sqrt(var * (n / max(n - 1, 1)))


def zero_one_window(data, ceiling_percentile: float = 99, floor_percentile: float = 1,
                    floor: float = 0, ceiling: float = 1) -> torch.Tensor:
    """Per channel, ``window_data`` from the image's floor percentile to the
    ceiling percentile of the voxels above it (the channel maximum when none
    is)."""
    data = _f32(data)
    floor_threshold = _channel_percentile(data, floor_percentile)
    out = []
    for c in range(data.shape[0]):
        chan = data[c]
        mask = chan > floor_threshold[c]
        vals = torch.where(mask, chan, torch.inf).reshape(-1).sort().values
        pos = (ceiling_percentile / 100.0) * torch.clamp(mask.sum() - 1, min=0).float()
        lo = torch.clamp(torch.floor(pos).long(), 0, vals.numel() - 1)
        hi = torch.clamp(lo + 1, 0, vals.numel() - 1)
        frac = pos - lo
        ceiling_threshold = torch.where(frac > 0, vals[lo] * (1 - frac) + vals[hi] * frac,
                                        vals[lo])
        ceiling_threshold = torch.where(torch.isfinite(ceiling_threshold),
                                        ceiling_threshold, chan.max())
        out.append(window_data(chan, floor_threshold[c, 0, 0, 0], ceiling_threshold,
                               floor=floor, ceiling=ceiling))
    return torch.stack(out)


def hist_match(source, template) -> torch.Tensor:
    """Histogram matching by empirical CDFs: each source voxel takes the
    template value at its quantile; tied source voxels share one quantile
    (the count of values <= it)."""
    source, template = _f32(source), _f32(template)
    src = source.reshape(-1)
    tmpl = template.reshape(-1).sort().values
    s_quantiles = torch.searchsorted(src.sort().values, src, right=True).float() / src.numel()
    t_quantiles = torch.arange(1, tmpl.numel() + 1, dtype=torch.float32) / tmpl.numel()
    return interp(s_quantiles, t_quantiles, tmpl).reshape(source.shape)

"""Foreground cropping and pad-or-crop (a copy of the parts of
``unet3d_tpu/ops/crop.py`` the dataset runs; numpy on the host).

Bounding-box discovery gives data-dependent shapes, so it runs on the host
before the volume is resized to its fixed shape.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from unet3d_tpu_torch.ops import affine as affine_ops


def foreground_slices(data, rtol: float = 1e-8, percentile: Optional[float] = None,
                      pad: int = 1) -> Optional[Tuple[slice, slice, slice]]:
    """Spatial bbox slices of the foreground of a channel-first ``(C, D, H, W)``
    array: a per-channel percentile threshold when ``percentile`` is given,
    else |x| > rtol * max|x|; expanded by ``pad`` voxels and clipped. None
    when there is no foreground."""
    arr = np.asarray(data)
    if percentile is not None:
        cutoffs = np.percentile(arr, percentile, axis=tuple(range(1, arr.ndim)))
        passes = arr > cutoffs.reshape((-1,) + (1,) * (arr.ndim - 1))
    else:
        infinity_norm = max(-float(arr.min()), float(arr.max()))
        passes = (arr < -rtol * infinity_norm) | (arr > rtol * infinity_norm)
    if passes.ndim == 4:
        passes = np.any(passes, axis=0)
    if not passes.any():
        return None
    coords = np.stack(np.where(passes))
    start = coords.min(axis=1)
    end = coords.max(axis=1) + 1
    if pad > 0:
        start = np.maximum(start - pad, 0)
        end = np.minimum(end + pad, passes.shape)
    return tuple(slice(int(s), int(e)) for s, e in zip(start, end))


def _percentile_threshold_np(image: np.ndarray, percentile: float) -> np.ndarray:
    """Voxels above the per-channel ``percentile`` quantile in any channel."""
    flat = image.reshape(image.shape[:-3] + (-1,))
    cutoffs = np.percentile(flat.astype(np.float32), percentile * 100.0, axis=-1)
    mask = image > cutoffs[..., None, None, None].astype(image.dtype)
    return np.any(mask, axis=-4, keepdims=True)


def crop_foreground(image, affine: np.ndarray, label=None,
                    foreground_percentile: float = 0.1, margin: int = 1):
    """MONAI ``CropForegroundD``: the bbox of the percentile-threshold mask with
    ``margin``, applied to image (and label). Returns (image, affine, label,
    slices)."""
    mask = _percentile_threshold_np(np.asarray(image), foreground_percentile)
    slices = foreground_slices(mask.astype(np.uint8), rtol=0.5, pad=margin)
    if slices is None:
        return image, np.asarray(affine), label, tuple(slice(0, s) for s in image.shape[-3:])
    image = np.asarray(image)[(slice(None),) + slices]
    if label is not None:
        label = np.asarray(label)[(slice(None),) + slices]
    new_affine = affine_ops.crop_affine(affine, [s.start for s in slices])
    return image, new_affine, label, slices


def pad_or_crop(data, target_shape: Sequence[int], affine: Optional[np.ndarray] = None,
                mode: str = "constant", value: float = 0.0):
    """Center pad-or-crop a channel-first array to ``target_shape`` (MONAI
    ``ResizeWithPadOrCropD``: the crop starts at s//2 - t//2, the extra pad
    voxel goes at the end); the affine's origin follows the offset."""
    arr = np.asarray(data)
    spatial = arr.shape[-3:]
    target = tuple(int(t) for t in target_shape)
    crop_start = [max(s // 2 - t // 2, 0) for s, t in zip(spatial, target)]
    slices = tuple(slice(cs, cs + min(s, t))
                   for cs, s, t in zip(crop_start, spatial, target))
    arr = arr[(slice(None),) * (arr.ndim - 3) + slices]
    pad_before = [max((t - s) // 2, 0) for s, t in zip(spatial, target)]
    pad_after = [t - s2 - pb for t, s2, pb in
                 zip(target, arr.shape[-3:], pad_before)]
    pad_width = [(0, 0)] * (arr.ndim - 3) + [(pb, pa) for pb, pa in zip(pad_before, pad_after)]
    if any(pb or pa for pb, pa in pad_width):
        arr = np.pad(arr, pad_width, mode=mode,
                     constant_values=value if mode == "constant" else 0)
    if affine is None:
        return arr
    offset = [cs - pb for cs, pb in zip(crop_start, pad_before)]
    return arr, affine_ops.crop_affine(affine, offset)

"""Random augmentations with MONAI-compatible names and kwargs (counterpart of
``unet3d_tpu/data/transforms.py``).

Each config-listed name maps to a transform whose random parameters are drawn
on the host from a per-sample ``np.random.RandomState``, with the JAX
package's calls, arguments and shapes in its order, so one seed gives the same
augmentation in both packages. The voxel math is plain torch on the tensor's
device (the CPU for the dataset's numpy samples).

Transforms take channel-first ``(C, D, H, W)`` arrays or tensors and return
tensors (crops return a slice of what they were given). Spatial transforms
apply the same distortion to image and label (MONAI dict-transform behaviour
with keys=("image", "label")); intensity transforms touch the image only.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from unet3d_tpu_torch.ops.normalize import interp
from unet3d_tpu_torch.ops.resample import resample_transform, resize, sample_at_coords
from unet3d_tpu_torch.utils.device import as_tensor

_SPATIAL_DIMS = (-3, -2, -1)


class Transform:
    """Base: ``__call__(rng, image, label) -> (image, label)``.

    ``num_samples > 1`` marks a multi-sample transform (e.g.
    RandSpatialCropSamplesD): its ``samples()`` returns a LIST of
    (image, label) pairs and the dataset maps the remaining pipeline over
    them, stacking to a (S, C, D, H, W) sample that ``collate_flatten``
    later folds into the batch dimension."""
    spatial = False
    num_samples = 1

    def __call__(self, rng: np.random.RandomState, image, label):
        raise NotImplementedError


def _intensity_range(value, name: str) -> Tuple[float, float]:
    """MONAI intensity-range semantics: scalar r -> U(-r, r); a sequence must
    be a (min, max) pair."""
    if isinstance(value, (int, float)):
        return (-float(value), float(value))
    vals = tuple(float(v) for v in value)
    if len(vals) != 2:
        raise ValueError(f"{name} must be a number or a (min, max) pair, "
                         f"got {value!r}")
    return vals


def _range_pair(value) -> Tuple[float, float]:
    """MONAI range semantics for one parameter: scalar r -> U(-r, r);
    pair (a, b) -> U(a, b)."""
    if value is None:
        return (0.0, 0.0)
    if isinstance(value, (int, float)):
        return (-float(value), float(value))
    vals = [float(v) for v in value]
    if len(vals) == 1:
        return (-vals[0], vals[0])
    return (vals[0], vals[1])


def _param_ranges(value, n: int):
    """MONAI RandAffine range semantics: a SCALAR applies to the first
    parameter only (the others stay 0); a sequence maps per parameter, each
    element scalar r -> U(-r, r) or pair (a, b) -> U(a, b)."""
    if value is None:
        value = ()
    if isinstance(value, (int, float)):
        value = (float(value),)
    pairs = [_range_pair(v) for v in tuple(value)[:n]]
    return pairs + [(0.0, 0.0)] * (n - len(pairs))


def _center_transform(matrix: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Lift a 3x3 voxel-space linear map to a 4x4 transform about the volume centre."""
    center = (np.asarray(shape, dtype=np.float64) - 1.0) / 2.0
    t = np.eye(4)
    t[:3, :3] = matrix
    t[:3, 3] = center - matrix @ center
    return t


_PADDING_MODES = ("zeros", "border", "reflection")


def _check_padding_mode(padding_mode: str, name: str) -> str:
    # MONAI grid-sample names; "edge" is RandZoomd's np.pad spelling of border
    mode = {"edge": "border"}.get(padding_mode, padding_mode)
    if mode not in _PADDING_MODES:
        raise ValueError(f"{name}: unsupported padding_mode {padding_mode!r} "
                         f"(supported: {_PADDING_MODES} and 'edge')")
    return mode


def _mode_pair(mode, label_mode, name: str):
    """(mode, label_mode) from either MONAI form (a per-key sequence matched
    to ``keys=("image", "label")``, or a mode and a label_mode), with torch's
    'bilinear' / 'area' read as 'trilinear'."""
    if isinstance(mode, (list, tuple)):
        if label_mode is not None or not 1 <= len(mode) <= 2:
            raise ValueError(f"{name}: per-key mode sequence {mode!r} must "
                             "have one entry per key (image[, label]) and "
                             "excludes label_mode")
        label_mode = mode[1] if len(mode) > 1 else None
        mode = mode[0]
    remap = lambda m: "trilinear" if m in ("bilinear", "area") else m
    mode = remap(mode)
    return mode, remap(label_mode) if label_mode is not None else mode


def _apply_spatial(image, label, transform: np.ndarray, mode: str, label_mode: str,
                   padding_mode: str = "zeros"):
    """dst-voxel -> src-voxel resample of image (+label) with a shared
    transform; ``padding_mode`` "zeros" fills outside the volume with 0,
    "border" clamps source coordinates to the volume, "reflection" mirrors
    them about the border voxel centres."""
    shape = tuple(image.shape[-3:])
    clip = (torch.tensor([s - 1 for s in shape], dtype=torch.float32)
            if padding_mode == "border" else None)
    reflect = padding_mode == "reflection"
    image = resample_transform(image, transform, shape, mode=mode, clip_max=clip,
                               reflect=reflect)
    if label is not None:
        label = resample_transform(as_tensor(label).float(), transform, shape,
                                   mode=label_mode, clip_max=clip, reflect=reflect)
    return image, label


def _stack_pairs(pairs, with_label: bool = True):
    image = torch.stack([as_tensor(p[0]) for p in pairs])
    label = (torch.stack([as_tensor(p[1]) for p in pairs])
             if with_label and pairs[0][1] is not None else None)
    return image, label


class RandFlipD(Transform):
    """MONAI RandFlipd: flip listed spatial axes with probability ``prob``."""
    spatial = True

    def __init__(self, prob: float = 0.1, spatial_axis=None):
        self.prob = prob
        if spatial_axis is None:
            spatial_axis = (0, 1, 2)
        self.axes = (spatial_axis,) if isinstance(spatial_axis, int) else tuple(spatial_axis)

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        dims = tuple(a + 1 for a in self.axes)  # channel-first offset
        image = torch.flip(as_tensor(image), dims)
        if label is not None:
            label = torch.flip(as_tensor(label), dims)
        return image, label


class RandRotate90D(Transform):
    """MONAI RandRotate90d: k in 1..max_k quarter turns in a spatial plane."""
    spatial = True

    def __init__(self, prob: float = 0.1, max_k: int = 3, spatial_axes=(0, 1)):
        self.prob = prob
        self.max_k = max_k
        self.spatial_axes = tuple(spatial_axes)

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        k = rng.randint(1, self.max_k + 1)
        dims = tuple(a + 1 for a in self.spatial_axes)
        image = torch.rot90(as_tensor(image), int(k), dims)
        if label is not None:
            label = torch.rot90(as_tensor(label), int(k), dims)
        return image, label


def _rotation_matrix(angles: Sequence[float]) -> np.ndarray:
    ax, ay, az = angles
    rx = np.array([[1, 0, 0],
                   [0, math.cos(ax), -math.sin(ax)],
                   [0, math.sin(ax), math.cos(ax)]])
    ry = np.array([[math.cos(ay), 0, math.sin(ay)],
                   [0, 1, 0],
                   [-math.sin(ay), 0, math.cos(ay)]])
    rz = np.array([[math.cos(az), -math.sin(az), 0],
                   [math.sin(az), math.cos(az), 0],
                   [0, 0, 1]])
    return rx @ ry @ rz


class RandRotateD(Transform):
    """MONAI RandRotated: per-axis uniform angles, rotate about the centre,
    keep_size, border padding (the MONAI Rotated default)."""
    spatial = True

    def __init__(self, prob: float = 0.1, range_x=0.0, range_y=0.0, range_z=0.0,
                 mode: str = "bilinear", label_mode: Optional[str] = None,
                 keep_size: bool = True, padding_mode: str = "border"):
        self.prob = prob
        self.ranges = (_range_pair(range_x), _range_pair(range_y),
                       _range_pair(range_z))
        self.mode, self.label_mode = _mode_pair(mode, label_mode, "RandRotateD")
        if not keep_size:
            raise NotImplementedError(
                "RandRotateD: keep_size=False (shape-expanding rotate) is not "
                "implemented; the output grid always matches the input")
        self.padding_mode = _check_padding_mode(padding_mode, "RandRotateD")

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        angles = [rng.uniform(lo, hi) if hi > lo else lo
                  for lo, hi in self.ranges]
        # dst -> src mapping is the inverse rotation
        transform = _center_transform(_rotation_matrix(angles).T, image.shape[-3:])
        return _apply_spatial(image, label, transform, self.mode, self.label_mode,
                              padding_mode=self.padding_mode)


class RandZoomD(Transform):
    """MONAI RandZoomd with keep_size: scale about the centre; a zoomed-out
    volume is padded with its edge values (MONAI's default) by clamping the
    source coordinates."""
    spatial = True

    def __init__(self, prob: float = 0.1, min_zoom: float = 0.9, max_zoom: float = 1.1,
                 mode: str = "bilinear", label_mode: Optional[str] = None,
                 keep_size: bool = True, padding_mode: str = "edge"):
        self.prob = prob
        self.min_zoom = min_zoom
        self.max_zoom = max_zoom
        self.mode, self.label_mode = _mode_pair(mode, label_mode, "RandZoomD")
        if not keep_size:
            raise NotImplementedError(
                "RandZoomD: keep_size=False (shape-changing zoom) is not "
                "implemented; the output grid always matches the input")
        self.padding_mode = _check_padding_mode(padding_mode, "RandZoomD")

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        zoom = rng.uniform(self.min_zoom, self.max_zoom)
        transform = _center_transform(np.eye(3) / zoom, image.shape[-3:])
        return _apply_spatial(image, label, transform, self.mode,
                              self.label_mode, padding_mode=self.padding_mode)


class RandAffineD(Transform):
    """MONAI RandAffined: rotation + shear + scale + translation in one
    resample, reflection padding by default."""
    spatial = True

    def __init__(self, prob: float = 0.1, rotate_range=0.0, scale_range=0.0,
                 translate_range=0.0, shear_range=0.0, mode: str = "bilinear",
                 label_mode: Optional[str] = None,
                 padding_mode: str = "reflection"):
        self.prob = prob
        self.rotate_range = _param_ranges(rotate_range, 3)
        self.scale_range = _param_ranges(scale_range, 3)
        self.translate_range = _param_ranges(translate_range, 3)
        self.shear_range = _param_ranges(shear_range, 6)
        self.mode, self.label_mode = _mode_pair(mode, label_mode, "RandAffineD")
        self.padding_mode = _check_padding_mode(padding_mode, "RandAffineD")

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        sample = lambda pairs: [rng.uniform(lo, hi) if hi > lo else lo
                                for lo, hi in pairs]
        angles = sample(self.rotate_range)
        scales = [1.0 + v for v in sample(self.scale_range)]
        trans = sample(self.translate_range)
        sh = sample(self.shear_range)
        # MONAI create_shear (3D): [[1, s0, s1], [s2, 1, s3], [s4, s5, 1]];
        # grid composition order rotate @ shear @ scale (translation separate)
        shear = np.array([[1.0, sh[0], sh[1]],
                          [sh[2], 1.0, sh[3]],
                          [sh[4], sh[5], 1.0]])
        fwd = _rotation_matrix(angles) @ shear @ np.diag(scales)
        transform = _center_transform(np.linalg.inv(fwd), image.shape[-3:])
        transform[:3, 3] -= np.asarray(trans)
        return _apply_spatial(image, label, transform, self.mode, self.label_mode,
                              padding_mode=self.padding_mode)


class RandScaleIntensityD(Transform):
    """MONAI RandScaleIntensityd: x * (1 + U(-factors, factors))."""

    def __init__(self, prob: float = 0.1, factors=0.1):
        self.prob = prob
        self.factors = _intensity_range(factors, "RandScaleIntensityD.factors")

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        factor = rng.uniform(*self.factors)
        return as_tensor(image) * (1.0 + factor), label


class RandShiftIntensityD(Transform):
    """MONAI RandShiftIntensityd: x + U(-offsets, offsets)."""

    def __init__(self, prob: float = 0.1, offsets=0.1):
        self.prob = prob
        self.offsets = _intensity_range(offsets, "RandShiftIntensityD.offsets")

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        offset = rng.uniform(*self.offsets)
        return as_tensor(image) + offset, label


class RandGaussianNoiseD(Transform):
    """MONAI RandGaussianNoised: additive N(mean, std'), std' ~ U(0, std)
    when ``sample_std``."""

    def __init__(self, prob: float = 0.1, mean: float = 0.0, std: float = 0.1,
                 sample_std: bool = True):
        self.prob = prob
        self.mean = mean
        self.std = std
        self.sample_std = sample_std

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        std = rng.uniform(0, self.std) if self.sample_std else self.std
        noise = rng.normal(self.mean, std, size=tuple(image.shape)).astype(np.float32)
        return as_tensor(image) + torch.from_numpy(noise), label


def gaussian_kernel1d(sigma: float, truncated: float = 4.0,
                      approx: str = "scipy") -> np.ndarray:
    """1D gaussian kernel in one of three conventions.

    - "scipy": pdf sampled at integer offsets, normalised to sum 1
      (scipy ``gaussian_filter``);
    - "erf": MONAI ``gaussian_1d(..., approx="erf", normalize=False)``, the
      voxel-integrated gaussian ``0.5*(erf(t(x+.5)) - erf(t(x-.5)))`` with
      ``t = 0.70710678/sigma``, clamped at 0 and not renormalised (what
      ``monai.networks.layers.GaussianFilter`` applies);
    - "sampled": MONAI ``approx="sampled"``: pdf / (2.5066282*sigma).
    """
    if approx == "scipy":
        radius = max(int(truncated * sigma + 0.5), 1)
        x = np.arange(-radius, radius + 1, dtype=np.float64)
        k = np.exp(-0.5 * (x / sigma) ** 2)
        return (k / k.sum()).astype(np.float32)
    # MONAI gaussian_1d tail: int(max(sigma * truncated, 0.5) + 0.5)
    radius = int(max(float(sigma) * truncated, 0.5) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    if approx == "erf":
        t = 0.70710678 / abs(float(sigma))  # MONAI's f32 1/sqrt(2) constant
        k = np.asarray([0.5 * (math.erf(t * (xi + 0.5)) - math.erf(t * (xi - 0.5)))
                        for xi in x])
        return np.clip(k, 0.0, None).astype(np.float32)
    if approx == "sampled":
        k = np.exp(-0.5 * (x / sigma) ** 2) / (2.5066282 * sigma)
        return k.astype(np.float32)
    raise ValueError(f"unknown gaussian kernel approx {approx!r} "
                     "(supported: scipy, erf, sampled)")


def separable_gaussian_blur(image, sigmas: Sequence[float], pad_mode: str = "edge",
                            truncated: float = 4.0, approx: str = "scipy") -> torch.Tensor:
    """Separable gaussian blur of a channel-first volume, in f32.

    ``pad_mode``: "edge" (replicate, scipy ``mode="nearest"``) or "zero"
    (scipy ``mode="constant"``, MONAI ``separable_filtering(mode="zeros")``).
    MONAI's GaussianSmooth / GaussianSharpen are ``pad_mode="zero",
    approx="erf"``; Rand3DElastic's field smoothing also has ``truncated=3.0``.
    """
    out = as_tensor(image).float()
    for axis, sigma in enumerate(sigmas):
        if sigma <= 0:
            continue
        k = gaussian_kernel1d(sigma, truncated=truncated, approx=approx)
        r = (len(k) - 1) // 2
        dim = axis + 1
        n = out.shape[dim]
        if pad_mode == "edge":
            lo, hi = out.narrow(dim, 0, 1), out.narrow(dim, n - 1, 1)
        else:
            lo = hi = torch.zeros_like(out.narrow(dim, 0, 1))
        padded = torch.cat([lo] * r + [out] + [hi] * r, dim=dim)
        acc = torch.zeros_like(out)
        for i in range(len(k)):
            acc = acc + float(k[i]) * padded.narrow(dim, i, n)
        out = acc
    return out


class RandGaussianSmoothD(Transform):
    """MONAI RandGaussianSmoothd: per-axis sigma ~ U(range), applied as
    GaussianFilter does (voxel-integrated erf kernel, zero padding)."""

    def __init__(self, prob: float = 0.1, sigma_x=(0.25, 1.5), sigma_y=(0.25, 1.5),
                 sigma_z=(0.25, 1.5), approx: str = "erf"):
        self.prob = prob
        self.sigmas = (tuple(sigma_x), tuple(sigma_y), tuple(sigma_z))
        self.approx = approx

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        sigmas = [rng.uniform(lo, hi) for lo, hi in self.sigmas]
        return separable_gaussian_blur(image, sigmas, pad_mode="zero",
                                       approx=self.approx), label


def _unbiased_std(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((x - mean) ** 2).sum() / max(x.numel() - 1, 1))


class RandAdjustContrastD(Transform):
    """MONAI RandAdjustContrastd: gamma ~ U(range),
    ``((img - min) / (range + 1e-7)) ** gamma * range + min``, with the
    optional ``invert_image`` (negate before and after) and ``retain_stats``
    (restore the pre-gamma mean and unbiased std)."""

    def __init__(self, prob: float = 0.1, gamma=(0.5, 4.5),
                 invert_image: bool = False, retain_stats: bool = False):
        self.prob = prob
        if isinstance(gamma, (int, float)):
            if gamma <= 0.5:
                raise ValueError(
                    "RandAdjustContrastD: a scalar gamma must be > 0.5 "
                    "(MONAI samples from (0.5, gamma))")
            self.gamma = (0.5, float(gamma))
        else:
            self.gamma = tuple(float(g) for g in gamma)
        self.invert_image = bool(invert_image)
        self.retain_stats = bool(retain_stats)

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        gamma = rng.uniform(*self.gamma)
        img = as_tensor(image).float()
        if self.invert_image:
            img = -img
        if self.retain_stats:
            mean = img.mean()
            std = _unbiased_std(img, mean)
        vmin = img.min()
        vrange = img.max() - vmin
        out = ((img - vmin) / (vrange + 1e-7)) ** gamma * vrange + vmin
        if self.retain_stats:
            out = out - out.mean()
            out = out / (_unbiased_std(out, out.mean()) + 1e-8)
            out = std * out + mean
        if self.invert_image:
            out = -out
        return out, label


class RandSpatialCropD(Transform):
    """MONAI RandSpatialCropd(random_size=False): random fixed-size crop."""
    spatial = True

    def __init__(self, roi_size: Sequence[int], random_size: bool = False):
        if random_size:
            raise NotImplementedError("random_size=True is not supported")
        if isinstance(roi_size, (int, float)):
            roi_size = (roi_size,) * 3
        self.roi_size = tuple(int(s) for s in roi_size)

    def __call__(self, rng, image, label):
        spatial = tuple(image.shape[-3:])
        # MONAI fall_back_tuple: non-positive roi entries keep the full extent
        roi = tuple(r if r > 0 else s for r, s in zip(self.roi_size, spatial))
        starts = [rng.randint(0, max(s - r, 0) + 1)
                  for s, r in zip(spatial, roi)]
        slices = tuple(slice(st, st + min(r, s))
                       for st, r, s in zip(starts, roi, spatial))
        image = image[(slice(None),) + slices]
        if label is not None:
            label = label[(slice(None),) + slices]
        return image, label


class RandSpatialCropSamplesD(Transform):
    """MONAI RandSpatialCropSamplesd: ``num_samples`` independent fixed-size
    random crops per input sample, stacked by the dataset into a
    (S, C, D, H, W) sample that ``collate_flatten`` folds into the batch."""
    spatial = True

    def __init__(self, roi_size: Sequence[int], num_samples: int,
                 random_size: bool = False):
        if random_size:
            raise NotImplementedError("random_size=True is not supported")
        if int(num_samples) < 1:
            raise ValueError("num_samples must be >= 1")
        self.num_samples = int(num_samples)
        self.cropper = RandSpatialCropD(roi_size=roi_size)

    def samples(self, rng, image, label):
        return [self.cropper(rng, image, label)
                for _ in range(self.num_samples)]

    def __call__(self, rng, image, label):
        # direct use (no dataset mapping): stack along a leading sample axis
        return _stack_pairs(self.samples(rng, image, label))


class RandBiasFieldD(Transform):
    """MONAI RandBiasFieldd: multiplicative exponential-polynomial bias field,
    exp(sum_{i+j+k <= degree} c_ijk x^i y^j z^k) over [-1, 1] coordinates,
    coefficients ~ U(coeff_range), one field for all channels."""

    def __init__(self, prob: float = 0.1, degree: int = 3,
                 coeff_range=(0.0, 0.1)):
        if degree < 1:
            raise ValueError("degree must be >= 1")
        self.prob = prob
        self.degree = int(degree)
        self.coeff_range = tuple(coeff_range)
        self.exponents = [(i, j, k)
                          for i in range(self.degree + 1)
                          for j in range(self.degree + 1 - i)
                          for k in range(self.degree + 1 - i - j)]

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        shape = tuple(image.shape[-3:])
        coeffs = rng.uniform(self.coeff_range[0], self.coeff_range[1],
                             size=len(self.exponents))
        coords = [np.linspace(-1.0, 1.0, s, dtype=np.float32) for s in shape]
        log_field = np.zeros(shape, dtype=np.float32)
        for c, (i, j, k) in zip(coeffs, self.exponents):
            log_field += (c * coords[0][:, None, None] ** i
                          * coords[1][None, :, None] ** j
                          * coords[2][None, None, :] ** k)
        field = torch.exp(torch.from_numpy(log_field))[None]
        return as_tensor(image) * field, label


class RandHistogramShiftD(Transform):
    """MONAI RandHistogramShiftd: a random monotone piecewise-linear remap of
    the intensities between ``num_control_points`` control points."""

    def __init__(self, prob: float = 0.1, num_control_points=10):
        self.prob = prob
        if isinstance(num_control_points, (int, float)):
            n = int(num_control_points)
            self.num_control_points = (n, n)
        else:
            lo, hi = (int(v) for v in num_control_points)
            self.num_control_points = (min(lo, hi), max(lo, hi))
        if self.num_control_points[0] < 2:
            raise ValueError("num_control_points must be >= 2")

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        n = rng.randint(self.num_control_points[0],
                        self.num_control_points[1] + 1)
        reference = np.linspace(0.0, 1.0, n)
        floating = reference.copy()
        # each interior point redrawn within (previous floating point, next
        # reference point), which keeps the map monotone
        for i in range(1, n - 1):
            floating[i] = rng.uniform(floating[i - 1], reference[i + 1])
        img = as_tensor(image).float()
        vmin, vmax = img.min(), img.max()
        scale = vmax - vmin
        ref = torch.from_numpy(reference.astype(np.float32)) * scale + vmin
        flt = torch.from_numpy(floating.astype(np.float32)) * scale + vmin
        return interp(img, ref, flt), label


class RandGaussianSharpenD(Transform):
    """MONAI RandGaussianSharpend: unsharp mask with random sigmas and alpha,
    out = b1 + alpha * (b1 - b2), b1 = blur(img, sigma1), b2 = blur(b1,
    sigma2), blurs as GaussianFilter (erf kernel, zero padding). A scalar
    sigma2 component x samples U(x, the sampled sigma1) on its axis."""

    def __init__(self, prob: float = 0.1,
                 sigma1_x=(0.5, 1.0), sigma1_y=(0.5, 1.0), sigma1_z=(0.5, 1.0),
                 sigma2_x=0.5, sigma2_y=0.5, sigma2_z=0.5,
                 alpha=(10.0, 30.0), approx: str = "erf"):
        self.prob = prob
        self.approx = approx

        def rng_range(v):
            return (float(v), float(v)) if isinstance(v, (int, float)) \
                else tuple(float(x) for x in v)

        self.sigma1 = tuple(rng_range(v) for v in (sigma1_x, sigma1_y, sigma1_z))
        self.sigma2 = tuple(rng_range(v) for v in (sigma2_x, sigma2_y, sigma2_z))
        self.sigma2_from_s1 = tuple(isinstance(v, (int, float))
                                    for v in (sigma2_x, sigma2_y, sigma2_z))
        self.alpha = rng_range(alpha)

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        s1 = [rng.uniform(lo, hi) if hi > lo else lo for lo, hi in self.sigma1]
        s2 = [rng.uniform(lo, hi if not scalar else s1_i)
              if (hi if not scalar else s1_i) > lo else lo
              for (lo, hi), scalar, s1_i
              in zip(self.sigma2, self.sigma2_from_s1, s1)]
        alpha = rng.uniform(*self.alpha)
        b1 = separable_gaussian_blur(image, s1, pad_mode="zero", approx=self.approx)
        b2 = separable_gaussian_blur(b1, s2, pad_mode="zero", approx=self.approx)
        return b1 + alpha * (b1 - b2), label


class RandCoarseDropoutD(Transform):
    """MONAI RandCoarseDropoutd: fill random rectangular holes (or everything
    OUTSIDE them when ``dropout_holes=False``).

    ``fill_value``: scalar, (lo, hi) uniform-random per voxel, or None for
    uniform random in [img.min, img.max) (MONAI default).
    """

    def __init__(self, prob: float = 0.1, holes: int = 1, spatial_size=1,
                 dropout_holes: bool = True, fill_value=None,
                 max_holes=None, max_spatial_size=None):
        if holes < 1:
            raise ValueError("holes must be >= 1")
        self.prob = prob
        self.holes = int(holes)
        self.max_holes = None if max_holes is None else int(max_holes)
        self.spatial_size = spatial_size
        self.max_spatial_size = max_spatial_size
        self.dropout_holes = bool(dropout_holes)
        self.fill_value = fill_value

    @staticmethod
    def _size_triple(value, img_shape):
        if value is None:
            return None
        if isinstance(value, (int, float)):
            value = (int(value),) * 3
        # MONAI fall_back_tuple: non-positive entries fall back to the extent
        return tuple(int(v) if int(v) > 0 else int(s)
                     for v, s in zip(value, img_shape))

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        shape = tuple(image.shape[-3:])
        size = self._size_triple(self.spatial_size, shape)
        max_size = self._size_triple(self.max_spatial_size, shape)
        n_holes = self.holes if self.max_holes is None else \
            rng.randint(self.holes, self.max_holes + 1)
        img = np.asarray(image, dtype=np.float32)
        hole_mask = np.zeros(shape, dtype=bool)
        for _ in range(n_holes):
            hsize = [rng.randint(s, m + 1) for s, m in zip(size, max_size)] \
                if max_size is not None else list(size)
            hsize = [min(h, s) for h, s in zip(hsize, shape)]
            # MONAI RandCoarseTransform: the centre is drawn so the hole fits
            slices = []
            for h, s in zip(hsize, shape):
                center = rng.randint(h // 2, s - h + h // 2 + 1)
                start = center - h // 2
                slices.append(slice(start, start + h))
            hole_mask[tuple(slices)] = True
        region = hole_mask if self.dropout_holes else ~hole_mask
        if self.fill_value is None:
            lo, hi = float(img.min()), float(img.max())
        elif isinstance(self.fill_value, (int, float)):
            lo = hi = float(self.fill_value)
        else:
            lo, hi = (float(v) for v in self.fill_value)
        out = img.copy()
        if int(region.sum()):
            reg = np.broadcast_to(region, out.shape)
            if lo == hi:
                out[reg] = lo
            else:
                out[reg] = rng.uniform(lo, hi, size=int(reg.sum())).astype(np.float32)
        return torch.from_numpy(out), label


class RandStdShiftIntensityD(Transform):
    """MONAI RandStdShiftIntensityd: v + factor * std(v), factor ~ U(factors)
    (scalar f -> U(-f, f)), the std unbiased (torch.std) and, with
    ``nonzero``, over and onto the nonzero voxels only; ``channel_wise``
    repeats that per channel with the one drawn factor."""

    def __init__(self, factors=0.1, prob: float = 0.1, nonzero: bool = False,
                 channel_wise: bool = False):
        self.factors = _range_pair(factors)
        self.prob = prob
        self.nonzero = nonzero
        self.channel_wise = channel_wise

    def _shift(self, img, factor):
        mask = (img != 0) if self.nonzero else torch.ones(img.shape, dtype=torch.bool)
        n = mask.sum()
        mean = torch.where(mask, img, 0.0).sum() / torch.clamp(n, min=1)
        var = torch.where(mask, (img - mean) ** 2, 0.0).sum() / torch.clamp(n - 1, min=1)
        offset = factor * torch.sqrt(var)
        # MONAI: img[slices] = img[slices] + offset; no-op on an empty slice
        return torch.where(mask & (n > 0), img + offset, img)

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        factor = rng.uniform(*self.factors)
        img = as_tensor(image)
        if self.channel_wise:
            return torch.stack([self._shift(img[c], factor)
                                for c in range(img.shape[0])]), label
        return self._shift(img, factor), label


class RandRicianNoiseD(Transform):
    """MONAI RandRicianNoised: sqrt((v + n1)^2 + n2^2), n1, n2 ~ N(mean,
    std'), std' ~ U(0, std) when ``sample_std``."""

    def __init__(self, prob: float = 0.1, mean: float = 0.0, std: float = 1.0,
                 sample_std: bool = True, channel_wise: bool = False):
        self.prob = prob
        self.mean = mean
        self.std = std
        self.sample_std = sample_std
        self.channel_wise = channel_wise

    def _noise_pair(self, rng, shape, std):
        n1 = rng.normal(self.mean, std, size=shape).astype(np.float32)
        n2 = rng.normal(self.mean, std, size=shape).astype(np.float32)
        return torch.from_numpy(n1), torch.from_numpy(n2)

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        img = as_tensor(image)
        if self.channel_wise:
            outs = []
            for c in range(img.shape[0]):
                std = rng.uniform(0, self.std) if self.sample_std else self.std
                n1, n2 = self._noise_pair(rng, tuple(img.shape[1:]), std)
                outs.append(torch.sqrt((img[c] + n1) ** 2 + n2 ** 2))
            return torch.stack(outs), label
        std = rng.uniform(0, self.std) if self.sample_std else self.std
        n1, n2 = self._noise_pair(rng, tuple(img.shape), std)
        return torch.sqrt((img + n1) ** 2 + n2 ** 2), label


class RandGibbsNoiseD(Transform):
    """MONAI RandGibbsNoised: Gibbs ringing by a hard low-pass mask in
    shifted k-space, keeping frequencies within radius
    ``(1 - alpha) * max(shape) * sqrt(2) / 2`` of the centre, alpha ~
    U(alpha range) in [0, 1]: 0 keeps everything, 1 truncates all."""

    def __init__(self, prob: float = 0.1, alpha=(0.0, 1.0)):
        self.prob = prob
        a = ((0.0, float(alpha)) if isinstance(alpha, (int, float))
             else tuple(float(v) for v in alpha))
        if not (0.0 <= a[0] <= 1.0 and 0.0 <= a[1] <= 1.0):
            raise ValueError(
                f"RandGibbsNoiseD alpha must lie in [0, 1], got {a}")
        self.alpha = a

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        alpha = rng.uniform(*self.alpha)
        img = as_tensor(image)
        spatial = tuple(img.shape[-3:])
        if alpha <= 0.0:
            return img, label  # the radius covers all of k-space: identity
        center = [(s - 1) / 2.0 for s in spatial]
        radius = (1.0 - alpha) * max(spatial) * np.sqrt(2.0) / 2.0
        grids = [(np.arange(s, dtype=np.float32) - c) ** 2
                 for s, c in zip(spatial, center)]
        dist_sq = (grids[0][:, None, None] + grids[1][None, :, None]
                   + grids[2][None, None, :])
        mask = torch.from_numpy((dist_sq <= radius * radius).astype(np.float32))
        k = torch.fft.fftshift(torch.fft.fftn(img, dim=_SPATIAL_DIMS), dim=_SPATIAL_DIMS)
        out = torch.fft.ifftn(torch.fft.ifftshift(k * mask, dim=_SPATIAL_DIMS),
                              dim=_SPATIAL_DIMS)
        return out.real.to(img.dtype), label


class Rand3DElasticD(Transform):
    """MONAI Rand3DElasticd (elastic core): uniform(-1, 1) offsets per axis,
    gaussian-smoothed with sigma ~ U(sigma_range), scaled by magnitude ~
    U(magnitude_range); the image warps trilinear, the label nearest. The
    affine extras (rotate/scale/translate/shear ranges) belong in a separate
    RandAffineD entry and raise here."""
    spatial = True

    def __init__(self, sigma_range=(5.0, 8.0), magnitude_range=(100.0, 200.0),
                 prob: float = 0.1, mode: str = "bilinear",
                 label_mode: Optional[str] = None, **extras):
        affine_keys = {"rotate_range", "scale_range", "translate_range",
                       "shear_range"}
        bad = affine_keys & set(extras)
        if bad:
            raise NotImplementedError(
                f"Rand3DElasticD here is elastic-only; move {sorted(bad)} "
                "into a RandAffineD stage")
        if extras:
            raise TypeError(f"Unsupported Rand3DElasticD kwargs: {sorted(extras)}")
        self.sigma_range = tuple(float(v) for v in sigma_range)
        self.magnitude_range = tuple(float(v) for v in magnitude_range)
        self.prob = prob
        if isinstance(mode, (list, tuple)):  # MONAI per-key mode sequence
            self.mode, self.label_mode = _mode_pair(mode, label_mode, "Rand3DElasticD")
        else:
            self.mode = "trilinear" if mode == "bilinear" else mode
            self.label_mode = label_mode or "nearest"

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        spatial = tuple(image.shape[-3:])
        sigma = rng.uniform(*self.sigma_range)
        magnitude = rng.uniform(*self.magnitude_range)

        def offsets():
            field = (rng.rand(*spatial).astype(np.float32) * 2.0 - 1.0)
            # MONAI Rand3DElastic: GaussianFilter(3, sigma, truncated=3.0)
            sm = separable_gaussian_blur(field[None], (sigma, sigma, sigma),
                                         pad_mode="zero", truncated=3.0,
                                         approx="erf")[0]
            return sm * magnitude

        dz, dy, dx = offsets(), offsets(), offsets()
        gz, gy, gx = torch.meshgrid(
            *(torch.arange(s, dtype=torch.float32) for s in spatial), indexing="ij")
        coords = torch.stack([gz + dz, gy + dy, gx + dx])
        coords = torch.stack([torch.clamp(coords[i], 0, spatial[i] - 1)
                              for i in range(3)])
        img = sample_at_coords(as_tensor(image), coords, mode=self.mode)
        if label is None:
            return img, None
        return img, sample_at_coords(as_tensor(label), coords, mode=self.label_mode)


class RandSimulateLowResolutionD(Transform):
    """MONAI RandSimulateLowResolutiond (nnU-Net's low-resolution
    simulation): downsample by zoom ~ U(zoom_range) with ``downsample_mode``,
    then resize back with ``upsample_mode``; one zoom for all axes, target
    shape round(shape * zoom); the image only."""

    def __init__(self, prob: float = 0.1, downsample_mode: str = "nearest",
                 upsample_mode: str = "trilinear", zoom_range=(0.5, 1.0),
                 align_corners: bool = False):
        self.prob = prob
        self.downsample_mode = downsample_mode
        self.upsample_mode = ("trilinear" if upsample_mode == "bilinear"
                              else upsample_mode)
        self.zoom_range = tuple(float(v) for v in zoom_range)
        self.align_corners = bool(align_corners)

    def __call__(self, rng, image, label):
        if rng.rand() >= self.prob:
            return image, label
        zoom = rng.uniform(*self.zoom_range)
        spatial = tuple(image.shape[-3:])
        target = tuple(max(int(np.round(s * zoom)), 1) for s in spatial)
        down = resize(as_tensor(image).float(), target, mode=self.downsample_mode)
        return resize(down, spatial, mode=self.upsample_mode,
                      align_corners=self.align_corners), label


def _center_crops(image, label, centers, roi):
    out = []
    for center in centers:
        slices = tuple(slice(c - r // 2, c - r // 2 + r) for c, r in zip(center, roi))
        out.append((image[(slice(None),) + slices], label[(slice(None),) + slices]))
    return out


class RandCropByPosNegLabelD(Transform):
    """MONAI RandCropByPosNegLabeld: pos/neg-ratio-balanced random crops
    centred on label foreground / background voxels.

    - a multi-channel label drops channel 0 (MONAI's one-hot background);
      foreground is any remaining channel nonzero; background is the rest,
      intersected with ``any(image > image_threshold)`` under
      ``image_key="image"``;
    - each sample picks foreground with probability ``pos/(pos+neg)``, then a
      uniform voxel of that class as the crop centre, clamped so the ROI
      fits; an empty class falls back to the other with a warning, both
      empty raises;
    - non-positive spatial_size entries keep the full extent; an ROI larger
      than the volume raises unless ``allow_smaller`` clamps it.

    MONAI has no ``prob`` here: it always applies.
    """
    spatial = True

    def __init__(self, spatial_size: Sequence[int], pos: float = 1.0,
                 neg: float = 1.0, num_samples: int = 1,
                 image_key: Optional[str] = None,
                 image_threshold: float = 0.0, allow_smaller: bool = False):
        if pos < 0 or neg < 0:
            raise ValueError(
                f"pos and neg must be nonnegative, got pos={pos} neg={neg}")
        if pos + neg == 0:
            raise ValueError("Incompatible values: pos=0 and neg=0.")
        if int(num_samples) < 1:
            raise ValueError("num_samples must be >= 1")
        if isinstance(spatial_size, (int, float)):
            spatial_size = (spatial_size,) * 3
        self.spatial_size = tuple(int(s) for s in spatial_size)
        self.pos_ratio = float(pos) / (float(pos) + float(neg))
        self.num_samples = int(num_samples)
        if image_key not in (None, "image"):
            raise ValueError("RandCropByPosNegLabelD: image_key must be "
                             "'image' (the pipeline carries a single image)")
        self.use_image = image_key == "image"
        self.image_threshold = float(image_threshold)
        self.allow_smaller = bool(allow_smaller)

    def _centers(self, rng, image, label):
        if label is None:
            raise ValueError("RandCropByPosNegLabelD requires a label "
                             "(MONAI: 'label must not be None')")
        lbl = np.asarray(label)
        spatial = lbl.shape[-3:]
        fg_src = lbl[1:] if lbl.shape[0] > 1 else lbl
        fg_mask = np.any(fg_src != 0, axis=0)
        fg_indices = np.flatnonzero(fg_mask)
        if self.use_image:
            img_mask = np.any(np.asarray(image) > self.image_threshold, axis=0)
            bg_indices = np.flatnonzero(img_mask & ~fg_mask)
        else:
            bg_indices = np.flatnonzero(~fg_mask)
        pos_ratio = self.pos_ratio
        if len(fg_indices) == 0 and len(bg_indices) == 0:
            raise ValueError("No sampling location available.")
        if len(fg_indices) == 0 or len(bg_indices) == 0:
            warnings.warn(
                f"Num foregrounds {len(fg_indices)}, Num backgrounds "
                f"{len(bg_indices)}, unable to generate class balanced "
                "samples.")
            pos_ratio = 0.0 if len(fg_indices) == 0 else 1.0
        roi = _resolve_roi(self.spatial_size, spatial, self.allow_smaller,
                           "RandCropByPosNegLabelD")
        centers = []
        for _ in range(self.num_samples):
            use = fg_indices if rng.rand() < pos_ratio else bg_indices
            idx = use[rng.randint(len(use))]
            centers.append(_correct_crop_center(np.unravel_index(idx, spatial), roi,
                                                spatial))
        return centers, roi

    def samples(self, rng, image, label):
        return _center_crops(image, label, *self._centers(rng, image, label))

    def __call__(self, rng, image, label):
        pairs = self.samples(rng, image, label)
        return pairs[0] if self.num_samples == 1 else _stack_pairs(pairs)


def _resolve_roi(spatial_size, spatial, allow_smaller: bool, name: str):
    """MONAI fall_back_tuple and the ROI-vs-extent check of
    ``correct_crop_centers``: non-positive entries keep the full extent; an
    ROI larger than the volume raises unless ``allow_smaller`` clamps it."""
    roi = tuple(int(r) if r > 0 else int(s)
                for r, s in zip(spatial_size, spatial))
    if any(s < r for s, r in zip(spatial, roi)):
        if not allow_smaller:
            raise ValueError(
                "The size of the proposed random crop ROI is larger "
                f"than the image size: roi {roi} vs {spatial} ({name})")
        roi = tuple(min(int(s), r) for s, r in zip(spatial, roi))
    return roi


def _correct_crop_center(center, roi, spatial):
    """MONAI ``correct_crop_centers``: shift a voxel centre into the range
    where a ``roi``-sized crop fits inside ``spatial``."""
    valid_start = [r // 2 for r in roi]
    valid_end = [int(s + 1 - r / 2) for s, r in zip(spatial, roi)]
    valid_end = [max(e, vs + 1) for e, vs in zip(valid_end, valid_start)]
    return tuple(int(min(max(c, vs), ve - 1))
                 for c, vs, ve in zip(center, valid_start, valid_end))


class RandCropByLabelClassesD(Transform):
    """MONAI RandCropByLabelClassesd: per-class-ratio-balanced random crops
    centred on voxels of each label class.

    - a multi-channel label is one-hot: class c is ``label[c] != 0`` (channel
      0 is class 0, not dropped); a single-channel label is a label map and
      needs ``num_classes`` (class c is ``label[0] == c``); under
      ``image_key="image"`` every class is intersected with
      ``any(image > image_threshold)``;
    - ``max_samples_per_class`` keeps ``round(linspace(0, n-1, max))`` of a
      class's indices when it has more;
    - one ``choice(n_classes, p=ratios)`` for all samples (an empty class
      gets ratio 0 with a warning; all empty raises), then one ``randint``
      per sample picks the centre, clamped so the ROI fits;
    - ROI rules as RandCropByPosNegLabelD.
    """
    spatial = True

    def __init__(self, spatial_size: Sequence[int], ratios=None,
                 num_classes: Optional[int] = None, num_samples: int = 1,
                 image_key: Optional[str] = None,
                 image_threshold: float = 0.0, allow_smaller: bool = False,
                 warn: bool = True, max_samples_per_class: Optional[int] = None):
        if int(num_samples) < 1:
            raise ValueError("num_samples must be >= 1")
        if isinstance(spatial_size, (int, float)):
            spatial_size = (spatial_size,) * 3
        self.spatial_size = tuple(int(s) for s in spatial_size)
        if ratios is not None:
            ratios = [float(r) for r in ratios]
            if any(r < 0 for r in ratios):
                raise ValueError("ratios should not contain negative numbers")
        self.ratios = ratios
        self.num_classes = None if num_classes is None else int(num_classes)
        self.num_samples = int(num_samples)
        if image_key not in (None, "image"):
            raise ValueError("RandCropByLabelClassesD: image_key must be "
                             "'image' (the pipeline carries a single image)")
        self.use_image = image_key == "image"
        self.image_threshold = float(image_threshold)
        self.allow_smaller = bool(allow_smaller)
        self.warn = bool(warn)
        self.max_samples_per_class = (
            None if max_samples_per_class is None else int(max_samples_per_class))

    def _class_indices(self, image, label):
        """monai.transforms.utils.map_classes_to_indices."""
        lbl = np.asarray(label)
        channels = lbl.shape[0]
        if channels == 1:
            if self.num_classes is None:
                raise ValueError("if not One-Hot format label, must provide "
                                 "the num_classes")
            n_classes = self.num_classes
        else:
            n_classes = channels
        img_mask = None
        if self.use_image:
            img_mask = np.any(np.asarray(image) > self.image_threshold, axis=0).ravel()
        indices = []
        for c in range(n_classes):
            mask = (lbl[c] != 0) if channels > 1 else (lbl[0] == c)
            flat = mask.ravel()
            if img_mask is not None:
                flat = flat & img_mask
            cls_idx = np.flatnonzero(flat)
            m = self.max_samples_per_class
            if m and len(cls_idx) > m and len(cls_idx) > 1:
                sample_id = np.round(np.linspace(0, len(cls_idx) - 1, m)).astype(int)
                cls_idx = cls_idx[sample_id]
            indices.append(cls_idx)
        return indices

    def _centers(self, rng, image, label):
        if label is None:
            raise ValueError("RandCropByLabelClassesD requires a label")
        spatial = np.asarray(label).shape[-3:]
        indices = self._class_indices(image, label)
        ratios = ([1.0] * len(indices) if self.ratios is None
                  else list(self.ratios))
        if len(ratios) != len(indices):
            raise ValueError(
                f"random crop ratios must match the number of indices of "
                f"classes, got {len(ratios)} and {len(indices)}.")
        for i, arr in enumerate(indices):
            if len(arr) == 0 and ratios[i] != 0:
                ratios[i] = 0.0
                if self.warn:
                    warnings.warn(
                        f"no available indices of class {i} to crop, setting "
                        f"the crop ratio of this class to zero.")
        total = float(sum(ratios))
        if total <= 0:
            raise ValueError(
                "No sampling location available: every class is empty or "
                "has ratio zero.")
        roi = _resolve_roi(self.spatial_size, spatial, self.allow_smaller,
                           "RandCropByLabelClassesD")
        classes = rng.choice(len(ratios), size=self.num_samples,
                             p=np.asarray(ratios) / total)
        centers = []
        for i in classes:
            use = indices[int(i)]
            idx = use[rng.randint(len(use))]
            centers.append(_correct_crop_center(np.unravel_index(idx, spatial), roi,
                                                spatial))
        return centers, roi

    def samples(self, rng, image, label):
        return _center_crops(image, label, *self._centers(rng, image, label))

    def __call__(self, rng, image, label):
        pairs = self.samples(rng, image, label)
        return pairs[0] if self.num_samples == 1 else _stack_pairs(pairs)


class RandWeightedCropD(Transform):
    """MONAI RandWeightedCropd: random crops whose centres are drawn with
    probability proportional to a weight map.

    - the weight map is channel 0 of ``w_key`` ("image" or "label": the
      pipeline carries no other keys);
    - window = fall_back_tuple(spatial_size, extent); centres come from the
      'valid' interior ``[win//2, m - win + win//2)`` per axis (axes with
      ``m <= win`` collapse to ``m//2``);
    - negative weights are shifted up by the minimum; the flat CDF is
      inverted with ``searchsorted(cdf, U(0,1)*total, right=True)``, the
      index clamped to the last one (MONAI, and the JAX package, can return
      one past it when the draw rounds to the total: a deliberate
      divergence); a zero or non-finite total samples uniformly;
    - the crop is ``SpatialCrop(center, spatial_size)``: start clamped at 0,
      end clipped by the extent, no padding;
    - one ``rand(num_samples)`` draw (or one ``randint`` in the uniform
      fallback), no per-sample draws.
    """
    spatial = True

    def __init__(self, spatial_size: Sequence[int], w_key: str = "label",
                 num_samples: int = 1):
        if int(num_samples) < 1:
            raise ValueError("num_samples must be >= 1")
        if isinstance(spatial_size, (int, float)):
            spatial_size = (spatial_size,) * 3
        self.spatial_size = tuple(int(s) for s in spatial_size)
        if w_key not in ("image", "label"):
            raise ValueError("RandWeightedCropD: w_key must be 'image' or "
                             "'label' (the pipeline carries no other keys)")
        self.w_key = w_key
        self.num_samples = int(num_samples)

    def _centers(self, rng, image, label):
        w_src = label if self.w_key == "label" else image
        if w_src is None:
            raise ValueError(f"RandWeightedCropD: w_key={self.w_key!r} is "
                             "not present in this sample")
        w = np.asarray(np.asarray(w_src)[0], dtype=np.float64)
        spatial = w.shape
        win = tuple(int(r) if r > 0 else int(m)
                    for r, m in zip(self.spatial_size, spatial))
        s = tuple(slice(r // 2, m - r + r // 2) if m > r
                  else slice(m // 2, m // 2 + 1)
                  for r, m in zip(win, spatial))
        v = w[s]
        v_size = v.shape
        v = v.ravel()
        if (v < 0).any():
            v = v - v.min()
        v = np.cumsum(v)
        if not v[-1] or not np.isfinite(v[-1]) or v[-1] < 0:
            idx = rng.randint(0, len(v), size=self.num_samples)
        else:
            r = rng.random_sample(self.num_samples)
            idx = np.minimum(np.searchsorted(v, r * v[-1], side="right"), len(v) - 1)
        diff = [min(r, m) // 2 for r, m in zip(win, spatial)]
        centers = []
        for flat in np.atleast_1d(idx):
            center = np.unravel_index(int(flat), v_size)
            centers.append(tuple(int(c + d) for c, d in zip(center, diff)))
        return centers, win, spatial

    def samples(self, rng, image, label):
        centers, win, spatial = self._centers(rng, image, label)
        out = []
        for center in centers:
            slices = tuple(
                slice(max(c - r // 2, 0), min(max(c - r // 2, 0) + r, m))
                for c, r, m in zip(center, win, spatial))
            im = image[(slice(None),) + slices]
            lb = None if label is None else label[(slice(None),) + slices]
            out.append((im, lb))
        return out

    def __call__(self, rng, image, label):
        pairs = self.samples(rng, image, label)
        return pairs[0] if self.num_samples == 1 else _stack_pairs(pairs)


class CenterSpatialCropD(Transform):
    """MONAI CenterSpatialCropd: deterministic centre crop to ``roi_size``
    (-1 keeps the full extent of that axis)."""
    spatial = True

    def __init__(self, roi_size=None):
        if roi_size is None:
            raise ValueError("CenterSpatialCropD requires roi_size")
        self.roi_size = ([int(roi_size)] * 3 if isinstance(roi_size, int)
                         else [int(v) for v in roi_size])

    def __call__(self, rng, image, label):
        spatial = tuple(image.shape[-3:])
        slices = [slice(None)]
        for size, extent in zip(self.roi_size, spatial):
            if size < 0 or size >= extent:
                slices.append(slice(None))
            else:
                # MONAI centre convention: start = centre - floor(size/2)
                start = extent // 2 - size // 2
                slices.append(slice(start, start + size))
        slices = tuple(slices)
        image = as_tensor(image)[slices]
        if label is not None:
            label = as_tensor(label)[slices]
        return image, label


TRANSFORM_REGISTRY: Dict[str, type] = {
    "RandFlipD": RandFlipD,
    "RandRotate90D": RandRotate90D,
    "RandRotateD": RandRotateD,
    "RandZoomD": RandZoomD,
    "RandAffineD": RandAffineD,
    "RandScaleIntensityD": RandScaleIntensityD,
    "RandShiftIntensityD": RandShiftIntensityD,
    "RandGaussianNoiseD": RandGaussianNoiseD,
    "RandGaussianSmoothD": RandGaussianSmoothD,
    "RandAdjustContrastD": RandAdjustContrastD,
    "RandSpatialCropD": RandSpatialCropD,
    "RandSpatialCropSamplesD": RandSpatialCropSamplesD,
    "RandCropByPosNegLabelD": RandCropByPosNegLabelD,
    "RandCropByLabelClassesD": RandCropByLabelClassesD,
    "RandWeightedCropD": RandWeightedCropD,
    "RandSimulateLowResolutionD": RandSimulateLowResolutionD,
    "RandBiasFieldD": RandBiasFieldD,
    "RandHistogramShiftD": RandHistogramShiftD,
    "RandGaussianSharpenD": RandGaussianSharpenD,
    "RandCoarseDropoutD": RandCoarseDropoutD,
    "RandStdShiftIntensityD": RandStdShiftIntensityD,
    "RandRicianNoiseD": RandRicianNoiseD,
    "RandGibbsNoiseD": RandGibbsNoiseD,
    "Rand3DElasticD": Rand3DElasticD,
    "CenterSpatialCropD": CenterSpatialCropD,
}
# MONAI accepts both the "...D" and "...d" dictionary-transform spellings.
TRANSFORM_REGISTRY.update({k[:-1] + "d": v for k, v in list(TRANSFORM_REGISTRY.items())})


def build_transform(spec: dict) -> Transform:
    """Config entry ``{"name": ..., **kwargs}`` -> transform instance."""
    name = spec["name"]
    if name not in TRANSFORM_REGISTRY:
        raise ValueError(f"Augmentation {name} is not supported")
    kwargs = {k: v for k, v in spec.items() if k != "name"}
    return TRANSFORM_REGISTRY[name](**kwargs)

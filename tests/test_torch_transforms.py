"""The port's random augmentations against the JAX package's, transform by
transform.

Each transform runs with prob 1 and parameters that reach each of its
branches, on the same seeded (C, D, H, W) = (2, 12, 10, 14) image (with a
zero block, for the nonzero options) and 3-channel one-hot label, each side
drawing from its own ``np.random.RandomState`` of one seed. Checks:

- the RandomState is in the same state after the call (the same draws, in
  the same order and count);
- images within 1e-6 of max|x| for elementwise transforms, and within 1e-4
  for those that resample, filter or transform the volume (f32 sums and
  sampling weights in another order);
- labels identical where they are copied, cropped, flipped or resampled
  nearest, within the image's 1e-4 where they are resampled trilinearly.
"""
import numpy as np
import pytest
import torch

from unet3d_tpu.data import transforms as jax_transforms

from unet3d_tpu_torch.data import transforms

SEED = 11
ELEMENTWISE, RESAMPLING = 1e-6, 1e-4


def _inputs():
    rng = np.random.RandomState(5)
    image = rng.randn(2, 12, 10, 14).astype(np.float32) + 1.0
    image[:, :3, :2] = 0.0
    label_map = rng.randint(0, 3, size=(12, 10, 14))
    label = np.stack([(label_map == c) for c in range(3)]).astype(np.float32)
    return image, label


# (spec, image tolerance, label check: "exact" or "close")
CASES = [
    ({"name": "RandFlipD", "prob": 1.0, "spatial_axis": [0, 2]}, ELEMENTWISE, "exact"),
    ({"name": "RandRotate90D", "prob": 1.0, "max_k": 3, "spatial_axes": [1, 2]},
     ELEMENTWISE, "exact"),
    ({"name": "RandRotateD", "prob": 1.0, "range_x": 0.3, "range_y": [0.1, 0.2],
      "range_z": 0.25}, RESAMPLING, "close"),
    ({"name": "RandRotateD", "prob": 1.0, "range_x": 0.4, "mode": ["bilinear", "nearest"],
      "padding_mode": "zeros"}, RESAMPLING, "exact"),
    ({"name": "RandZoomD", "prob": 1.0, "min_zoom": 0.7, "max_zoom": 1.3}, RESAMPLING,
     "close"),
    ({"name": "RandAffineD", "prob": 1.0, "rotate_range": [0.2, 0.1, 0.3],
      "scale_range": [0.1, [-0.2, 0.1], 0.1], "translate_range": [3, 4, 5],
      "shear_range": [0.05] * 6, "label_mode": "nearest"}, RESAMPLING, "exact"),
    ({"name": "RandAffineD", "prob": 1.0, "rotate_range": 0.3, "padding_mode": "border"},
     RESAMPLING, "close"),
    ({"name": "RandScaleIntensityD", "prob": 1.0, "factors": 0.2}, ELEMENTWISE, "exact"),
    ({"name": "RandShiftIntensityD", "prob": 1.0, "offsets": [0.1, 0.5]}, ELEMENTWISE,
     "exact"),
    ({"name": "RandGaussianNoiseD", "prob": 1.0, "std": 0.2}, ELEMENTWISE, "exact"),
    ({"name": "RandGaussianNoiseD", "prob": 1.0, "mean": 0.1, "std": 0.3,
      "sample_std": False}, ELEMENTWISE, "exact"),
    ({"name": "RandGaussianSmoothD", "prob": 1.0}, RESAMPLING, "exact"),
    ({"name": "RandAdjustContrastD", "prob": 1.0, "gamma": 2.0}, ELEMENTWISE, "exact"),
    ({"name": "RandAdjustContrastD", "prob": 1.0, "gamma": [0.7, 1.5],
      "invert_image": True, "retain_stats": True}, ELEMENTWISE, "exact"),
    ({"name": "RandSpatialCropD", "roi_size": [8, 6, -1]}, ELEMENTWISE, "exact"),
    ({"name": "RandSpatialCropSamplesD", "roi_size": [6, 6, 6], "num_samples": 3},
     ELEMENTWISE, "exact"),
    ({"name": "RandCropByPosNegLabelD", "spatial_size": [6, 6, 6], "pos": 1, "neg": 2,
      "num_samples": 4, "image_key": "image", "image_threshold": 0.5},
     ELEMENTWISE, "exact"),
    ({"name": "RandCropByPosNegLabelD", "spatial_size": [20, 6, -1],
      "allow_smaller": True}, ELEMENTWISE, "exact"),
    ({"name": "RandCropByLabelClassesD", "spatial_size": [6, -1, 6],
      "ratios": [1, 2, 1], "num_samples": 3, "image_key": "image",
      "max_samples_per_class": 50}, ELEMENTWISE, "exact"),
    ({"name": "RandWeightedCropD", "spatial_size": [6, 6, 6], "w_key": "image",
      "num_samples": 3}, ELEMENTWISE, "exact"),
    ({"name": "RandWeightedCropD", "spatial_size": [14, 6, 6]}, ELEMENTWISE, "exact"),
    ({"name": "RandSimulateLowResolutionD", "prob": 1.0, "zoom_range": [0.5, 0.8]},
     RESAMPLING, "exact"),
    ({"name": "RandBiasFieldD", "prob": 1.0, "coeff_range": [0.0, 0.3]}, ELEMENTWISE,
     "exact"),
    ({"name": "RandHistogramShiftD", "prob": 1.0, "num_control_points": [4, 8]},
     ELEMENTWISE, "exact"),
    ({"name": "RandGaussianSharpenD", "prob": 1.0, "sigma2_y": [0.2, 0.4]}, RESAMPLING,
     "exact"),
    ({"name": "RandCoarseDropoutD", "prob": 1.0, "holes": 2, "max_holes": 4,
      "spatial_size": 2, "max_spatial_size": [4, 3, -1], "fill_value": [0.0, 1.0]},
     ELEMENTWISE, "exact"),
    ({"name": "RandCoarseDropoutD", "prob": 1.0, "spatial_size": [3, 3, 3],
      "dropout_holes": False}, ELEMENTWISE, "exact"),
    ({"name": "RandStdShiftIntensityD", "prob": 1.0, "factors": 0.5, "nonzero": True,
      "channel_wise": True}, ELEMENTWISE, "exact"),
    ({"name": "RandStdShiftIntensityD", "prob": 1.0, "factors": [0.1, 0.4]}, ELEMENTWISE,
     "exact"),
    ({"name": "RandRicianNoiseD", "prob": 1.0, "std": 0.5, "channel_wise": True},
     ELEMENTWISE, "exact"),
    ({"name": "RandRicianNoiseD", "prob": 1.0, "std": 0.5, "sample_std": False},
     ELEMENTWISE, "exact"),
    ({"name": "RandGibbsNoiseD", "prob": 1.0, "alpha": [0.3, 0.6]}, RESAMPLING, "exact"),
    ({"name": "Rand3DElasticD", "prob": 1.0, "sigma_range": [1.0, 2.0],
      "magnitude_range": [1.0, 3.0]}, RESAMPLING, "exact"),
    ({"name": "CenterSpatialCropD", "roi_size": [8, -1, 20]}, ELEMENTWISE, "exact"),
]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_state(got_rng, want_rng):
    got, want = got_rng.get_state(), want_rng.get_state()
    assert got[0] == want[0] and got[2:] == want[2:]
    np.testing.assert_array_equal(got[1], want[1])


def _compare(got, want, image, tol, label_check):
    (gi, gl), (wi, wl) = got, want
    scale = float(np.abs(image).max())
    assert _np(gi).shape == np.asarray(wi).shape
    np.testing.assert_allclose(_np(gi), np.asarray(wi), rtol=0, atol=tol * scale)
    if wl is None:
        assert gl is None
    elif label_check == "exact":
        np.testing.assert_array_equal(_np(gl), np.asarray(wl))
    else:
        np.testing.assert_allclose(_np(gl), np.asarray(wl), rtol=0, atol=RESAMPLING)


@pytest.mark.parametrize("spec,tol,label_check", CASES,
                         ids=[f"{i}-{c[0]['name']}" for i, c in enumerate(CASES)])
def test_transform_matches_jax(spec, tol, label_check):
    image, label = _inputs()
    got_rng, want_rng = np.random.RandomState(SEED), np.random.RandomState(SEED)
    port, ref = transforms.build_transform(spec), jax_transforms.build_transform(spec)
    got = port(got_rng, image, label)
    want = ref(want_rng, image, label)
    _assert_same_state(got_rng, want_rng)
    _compare(got, want, image, tol, label_check)
    if getattr(ref, "num_samples", 1) > 1:  # the dataset's fan-out form
        got_pairs = port.samples(got_rng, image, label)
        want_pairs = ref.samples(want_rng, image, label)
        _assert_same_state(got_rng, want_rng)
        assert len(got_pairs) == len(want_pairs) == ref.num_samples
        for g, w in zip(got_pairs, want_pairs):
            _compare(g, w, image, tol, label_check)


@pytest.mark.parametrize("name", ["RandFlipD", "RandScaleIntensityD", "RandRotateD"])
def test_transform_skipped_by_prob_draws_once(name):
    """prob 0: one draw, the sample returned as it is."""
    image, label = _inputs()
    got_rng, want_rng = np.random.RandomState(SEED), np.random.RandomState(SEED)
    got = transforms.build_transform({"name": name, "prob": 0.0})(got_rng, image, label)
    jax_transforms.build_transform({"name": name, "prob": 0.0})(want_rng, image, label)
    _assert_same_state(got_rng, want_rng)
    assert got[0] is image and got[1] is label


def test_build_transform_names_match_jax():
    assert sorted(transforms.TRANSFORM_REGISTRY) == sorted(jax_transforms.TRANSFORM_REGISTRY)
    for name, cls in transforms.TRANSFORM_REGISTRY.items():
        assert cls.__name__ == jax_transforms.TRANSFORM_REGISTRY[name].__name__
    assert type(transforms.build_transform({"name": "RandFlipd"})) is transforms.RandFlipD
    with pytest.raises(ValueError, match="not supported"):
        transforms.build_transform({"name": "RandElastic"})
    with pytest.raises(ValueError, match="padding_mode"):
        transforms.build_transform({"name": "RandZoomD", "padding_mode": "wrap"})
    with pytest.raises(NotImplementedError, match="RandAffineD"):
        transforms.build_transform({"name": "Rand3DElasticD", "rotate_range": 0.1})


@pytest.mark.parametrize("approx,pad_mode,truncated", [
    ("scipy", "edge", 4.0), ("erf", "zero", 4.0), ("erf", "zero", 3.0),
    ("sampled", "edge", 2.0)])
def test_gaussian_blur_matches_jax(approx, pad_mode, truncated):
    image, _ = _inputs()
    sigmas = (0.8, 0.0, 1.7)
    for sigma in sigmas[::2]:
        np.testing.assert_array_equal(
            transforms.gaussian_kernel1d(sigma, truncated, approx),
            jax_transforms.gaussian_kernel1d(sigma, truncated, approx))
    got = transforms.separable_gaussian_blur(image, sigmas, pad_mode, truncated, approx)
    want = jax_transforms.separable_gaussian_blur(image, sigmas, pad_mode, truncated, approx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RESAMPLING * float(np.abs(image).max()))


def test_weighted_crop_clamps_a_draw_that_rounds_to_the_total():
    """MONAI's searchsorted returns one past the last index when the draw
    rounds to the total; the port clamps it (a deliberate divergence)."""
    class Top:
        def random_sample(self, n):
            return np.ones(n)

    image, label = _inputs()
    crop = transforms.RandWeightedCropD(spatial_size=[6, 6, 6], w_key="image")
    (center,), win, spatial = crop._centers(Top(), np.abs(image), label)
    assert all(c < s for c, s in zip(center, spatial))

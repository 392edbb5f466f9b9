"""The port's data path against the JAX package: orientation, IO, affine
algebra, one-hot codec, cropping, normalisation, resampling, the dataset's
deterministic prefix (against the recorded golden too), its disk cache in
both directions, and the loader.

The same numpy inputs go to both sides. Tolerances: host numpy code (affine,
orientation, crop, IO) is exact; torch against XLA f32 arithmetic 1e-5
(reductions and sampling weights in another order); nearest sampling and
one-hot codes exact.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet3d_tpu.data import dataset as jax_dataset
from unet3d_tpu.data import io as jax_io
from unet3d_tpu.data import loader as jax_loader
from unet3d_tpu.data import orientation as jax_orientation
from unet3d_tpu.ops import affine as jax_affine
from unet3d_tpu.ops import crop as jax_crop
from unet3d_tpu.ops import normalize as jax_normalize
from unet3d_tpu.ops import one_hot as jax_one_hot
from unet3d_tpu.ops import resample as jax_resample

from unet3d_tpu_torch.data import dataset, io, loader, nifti, orientation
from unet3d_tpu_torch.data.image import Volume
from unet3d_tpu_torch.ops import affine, crop, normalize, one_hot, resample

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CASE = {"image": [os.path.join(FIXTURES, "case_t1.nii.gz"),
                  os.path.join(FIXTURES, "case_t2.nii.gz")],
        "label": os.path.join(FIXTURES, "case_seg.nii.gz")}
HIERARCHY = [[2, 1, 4], [1, 4], [4]]
GOLDEN_KWARGS = dict(labels=HIERARCHY, desired_shape=[12, 12, 12],
                     normalization="NormalizeIntensityD",
                     normalization_kwargs={"channel_wise": True},
                     crop_foreground=True, resample=True, orientation="RAS")
NON_RAS = np.array([[0.0, -1.5, 0.0, 12.0], [0.0, 0.0, 2.0, -4.0],
                    [-1.2, 0.0, 0.0, 7.0], [0.0, 0.0, 0.0, 1.0]])


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _volume(seed=0, shape=(2, 9, 11, 7)):
    rng = np.random.RandomState(seed)
    data = np.zeros(shape, np.float32)
    data[:, 2:7, 3:9, 1:6] = rng.rand(shape[0], 5, 6, 5) + 0.5
    return data


# --- host metadata ---------------------------------------------------------

def test_volume_spacing_matches_jax_on_a_non_ras_affine():
    from unet3d_tpu.data.image import Volume as JaxVolume
    data = np.zeros((1, 3, 4, 5), np.float32)
    got = Volume(data=data, affine=NON_RAS).spacing
    np.testing.assert_array_equal(got, JaxVolume(data=data, affine=NON_RAS).spacing)
    np.testing.assert_allclose(got, [1.2, 1.5, 2.0])


@pytest.mark.parametrize("axcodes", ["RAS", "LPI", "ASR"])
def test_orientation_matches_jax(axcodes):
    data = _volume(1)
    got = orientation.apply_orientation(data, NON_RAS, axcodes)
    want = jax_orientation.apply_orientation(data, NON_RAS, axcodes)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_affine_helpers_match_jax():
    for fn, args in (("get_spacing_from_affine", (NON_RAS,)),
                     ("adjust_affine_spacing", (NON_RAS, [1.0, 2.0, 0.5])),
                     ("resize_affine", (NON_RAS, (9, 11, 7), (12, 12, 12))),
                     ("get_extent_from_shape", ((2, 9, 11, 7), NON_RAS)),
                     ("crop_affine", (NON_RAS, [2, 3, 1])),
                     ("voxel_to_voxel_transform", (NON_RAS, np.diag([2.0, 1, 1, 1])))):
        np.testing.assert_array_equal(getattr(affine, fn)(*args),
                                      getattr(jax_affine, fn)(*args), err_msg=fn)


@pytest.mark.parametrize("reorder", [False, True])
def test_load_image_matches_jax(reorder):
    got = io.load_image(CASE["image"], reorder=reorder, dtype=np.float32)
    want = jax_io.load_image(CASE["image"], reorder=reorder, dtype=np.float32)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.affine, want.affine)
    np.testing.assert_array_equal(got.spacing, want.spacing)


# --- one-hot codec ----------------------------------------------------------

def test_label_map_to_one_hot_matches_jax():
    rng = np.random.RandomState(2)
    label = rng.choice([0, 1, 2, 4], size=(1, 6, 7, 5)).astype(np.float32)
    label += rng.uniform(-0.2, 0.2, size=label.shape).astype(np.float32)  # rounding
    for labels in (HIERARCHY, [1, 2, 4]):
        got = one_hot.label_map_to_one_hot(label, labels=labels)
        want = jax_one_hot.label_map_to_one_hot(jnp.asarray(label), labels=labels)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kwargs", [
    dict(labels=[2, 1, 4]), dict(labels=[2, 1, 4], sum_then_threshold=True),
    dict(labels=[2, 1, 4], label_hierarchy=True), dict(labels=HIERARCHY, label_hierarchy=True),
    dict(labels=[[2, 1], [4]], threshold=0.3)])
def test_one_hot_to_label_map_matches_jax(kwargs):
    probs = np.random.RandomState(3).rand(3, 6, 7, 5).astype(np.float32)
    got = one_hot.one_hot_to_label_map(probs, **kwargs)
    want = jax_one_hot.one_hot_to_label_map(jnp.asarray(probs), **kwargs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- crop and normalisation -------------------------------------------------

def test_crop_foreground_and_pad_or_crop_match_jax():
    data = _volume(4)
    label = (data[:1] > 1.0).astype(np.float32)
    got = crop.crop_foreground(data, NON_RAS, label=label, foreground_percentile=0.1)
    want = jax_crop.crop_foreground(data, NON_RAS, label=label, foreground_percentile=0.1)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    for target in ((12, 8, 7), (5, 11, 9)):
        g, ga = crop.pad_or_crop(data, target, affine=NON_RAS)
        w, wa = jax_crop.pad_or_crop(data, target, affine=NON_RAS)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(ga, wa)


@pytest.mark.parametrize("name,kwargs", [
    ("normalize_intensity", {}), ("normalize_intensity", dict(channel_wise=True)),
    ("normalize_intensity", dict(channel_wise=True, nonzero=True)),
    ("normalize_intensity", dict(subtrahend=[0.5, 1.0], divisor=[2.0, 0.0],
                                 channel_wise=True)),
    ("scale_intensity", {}), ("scale_intensity", dict(minv=-1.0, maxv=2.0, channel_wise=True)),
    ("scale_intensity", dict(minv=None, maxv=None, factor=0.3)),
    ("scale_intensity_range", dict(a_min=0.2, a_max=1.2, b_min=0.0, b_max=1.0, clip=True)),
    ("scale_intensity_range_percentiles", dict(lower=5, upper=95, b_min=0.0, b_max=1.0)),
    ("scale_intensity_range_percentiles", dict(lower=10, upper=90, b_min=-1.0, b_max=1.0,
                                               relative=True, channel_wise=True, clip=True)),
    ("threshold_intensity", dict(threshold=0.7, cval=-1.0)),
    ("shift_intensity", dict(offset=0.25))])
def test_normalizers_match_jax(name, kwargs):
    data = _volume(5)
    got = getattr(normalize, name)(data, **kwargs)
    want = getattr(jax_normalize, name)(jnp.asarray(data), **kwargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# --- resampling -------------------------------------------------------------

@pytest.mark.parametrize("mode,align", [("trilinear", False), ("trilinear", True),
                                        ("nearest", False), ("nearest-exact", False)])
@pytest.mark.parametrize("out_shape", [(12, 12, 12), (5, 17, 4)])
def test_resize_matches_jax(mode, align, out_shape):
    data = _volume(6)
    got = resample.resize(data, out_shape, mode=mode, align_corners=align)
    want = jax_resample.resize(jnp.asarray(data), out_shape, mode=mode, align_corners=align)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode,align", [("trilinear", False), ("trilinear", True),
                                        ("nearest", False), ("nearest-exact", False)])
def test_resize_bucketed_gives_the_jax_values_without_padding(mode, align):
    """The JAX function pads to 32-voxel buckets to spare XLA recompiles; the
    port samples the unpadded array and gives the same values."""
    data = _volume(7, shape=(3, 37, 21, 40))
    got = resample.resize_bucketed(data, data.shape[-3:], (16, 16, 16), mode=mode,
                                   align_corners=align)
    want = jax_resample.resize_bucketed(data, data.shape[-3:], (16, 16, 16), mode=mode,
                                        align_corners=align)
    if mode == "trilinear":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_resample_to_img_matches_jax(mode):
    """A rotated, anisotropic source grid onto a RAS target grid."""
    data = _volume(8)
    target = np.diag([1.1, 0.9, 1.3, 1.0])
    target[:3, 3] = [-2.0, 1.0, 3.0]
    got = resample.resample_to_img(torch.from_numpy(data), NON_RAS, target, (10, 12, 9),
                                   mode=mode)
    want = jax_resample.resample_to_img(data, NON_RAS, target, (10, 12, 9), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the same affine and shape: the input comes back as it is
    same = torch.from_numpy(data)
    assert resample.resample_to_img(same, NON_RAS, NON_RAS, data.shape[-3:]) is same


def test_resample_image_to_spacing_matches_jax():
    data = _volume(9)
    got, got_affine = resample.resample_image_to_spacing(data, NON_RAS, [1.0, 1.0, 1.0])
    want, want_affine = jax_resample.resample_image_to_spacing(data, NON_RAS, [1.0, 1.0, 1.0])
    np.testing.assert_array_equal(got_affine, want_affine)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


# --- dataset, cache, loader -------------------------------------------------

def test_prefix_matches_the_recorded_golden():
    """The tolerances of tests/test_pipeline_golden.py."""
    golden = np.load(os.path.join(FIXTURES, "pipeline_golden.npz"))
    sample = dataset.SegmentationDataset(filenames=[CASE], **GOLDEN_KWARGS)[0]
    np.testing.assert_allclose(sample["affine"], golden["affine"], atol=1e-10)
    np.testing.assert_allclose(sample["image"], golden["image"], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(sample["label"], golden["label"])
    assert sample["source_filename"] == CASE["image"]


@pytest.mark.parametrize("kwargs", [
    dict(labels=HIERARCHY, desired_shape=[10, 14, 8], crop_foreground=True,
         normalization="NormalizeIntensityD", normalization_kwargs={"channel_wise": True}),
    dict(labels=[1, 2, 4], desired_shape=[20, 12, 16], normalization="zero_mean"),
    dict(labels=[1, 2, 4], normalization=["ScaleIntensityD", "ShiftIntensityD"],
         normalization_kwargs={"ShiftIntensityD": {"offset": 0.5}}, orientation="LPS")])
def test_dataset_sample_matches_jax(kwargs):
    got = dataset.SegmentationDataset(filenames=[CASE], **kwargs)[0]
    want = jax_dataset.SegmentationDataset(filenames=[CASE], **kwargs)[0]
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["affine"], want["affine"])
    np.testing.assert_allclose(got["image"], np.asarray(want["image"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got["label"], np.asarray(want["label"]))


def test_inference_dataset_has_no_label_and_random_stages_raise():
    item = {"image": CASE["image"]}
    sample = dataset.SegmentationDataset(filenames=[item], desired_shape=[8, 8, 8])[0]
    assert "label" not in sample and sample["image"].shape == (2, 8, 8, 8)
    for kwargs in (dict(random_crop=True),
                   dict(spatial_augmentations=[{"name": "RandFlipD", "prob": 0.5}]),
                   dict(intensity_augmentations=[{"name": "RandScaleIntensityD"}])):
        with pytest.raises(NotImplementedError, match="transforms"):
            dataset.SegmentationDataset(filenames=[item], **kwargs)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_entries_interchange(writer, tmp_path, monkeypatch):
    """An entry written by one package is read by the other under the same
    key: the reader's own prefix is made to fail, so the sample must come
    from the cache."""
    kwargs = dict(GOLDEN_KWARGS, cache_dir=str(tmp_path))
    ours = dataset.SegmentationDatasetPersistent(filenames=[CASE], **kwargs)
    theirs = jax_dataset.SegmentationDatasetPersistent(filenames=[CASE], **kwargs)
    assert ours._cache_key(CASE) == theirs._cache_key(CASE)
    first, second = (theirs, ours) if writer == "jax" else (ours, theirs)
    base = (dataset.SegmentationDataset if writer == "jax"
            else jax_dataset.SegmentationDataset)
    want = first[0]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ours._cache_key(CASE) + ext for ext in (".image.npy", ".label.npy", ".meta.json"))

    def no_prefix(self, item):
        raise AssertionError("recomputed instead of reading the cache")
    monkeypatch.setattr(base, "_deterministic_prefix", no_prefix)
    got = second[0]
    np.testing.assert_allclose(np.asarray(got["image"]), np.asarray(want["image"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(got["label"]), np.asarray(want["label"]))
    np.testing.assert_array_equal(got["affine"], want["affine"])
    assert got["source_filename"] == want["source_filename"] == CASE["image"]


@pytest.mark.parametrize("workers", [1, 2])
def test_loader_batches_equal_jax(workers):
    items = [CASE, dict(CASE, image=CASE["image"][::-1])] * 2
    kwargs = dict(labels=HIERARCHY, desired_shape=[8, 8, 8], normalization="zero_mean")
    got = list(loader.build_loader(dataset.SegmentationDataset(filenames=items, **kwargs),
                                   batch_size=3, shuffle=True, num_workers=workers))
    want = list(jax_loader.build_loader(
        jax_dataset.SegmentationDataset(filenames=items, **kwargs), batch_size=3,
        shuffle=True, num_workers=workers))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["image"].shape == w["image"].shape and g["source_filename"] == w["source_filename"]
        np.testing.assert_allclose(g["image"], w["image"], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(g["label"], w["label"])


def test_load_dataset_class_and_validate_filenames(tmp_path):
    cls = dataset.load_dataset_class({"name": "SegmentationDatasetPersistent"},
                                     cache_dir=str(tmp_path))
    assert cls.func is dataset.SegmentationDatasetPersistent
    assert dataset.load_dataset_class({"name": "SegmentationDataset"}) is \
        dataset.SegmentationDataset
    with pytest.raises(ValueError, match="not supported"):
        dataset.load_dataset_class({"name": "Other"})
    missing = {"image": [str(tmp_path / "nope.nii.gz")]}
    with pytest.warns(UserWarning):
        assert dataset.validate_filenames([CASE, missing]) == [CASE]
    with pytest.raises(FileNotFoundError):
        dataset.validate_filenames([missing], raise_on_missing=True)


def test_nifti_written_by_the_port_reads_in_jax(tmp_path):
    from unet3d_tpu.data import nifti as jax_nifti
    data = _volume(10)
    fn = str(tmp_path / "v.nii.gz")
    Volume(data=data, affine=NON_RAS).to_filename(fn)
    got, got_affine, _ = jax_nifti.load(fn)
    np.testing.assert_array_equal(np.moveaxis(got, -1, 0), data)
    np.testing.assert_allclose(got_affine, NON_RAS, atol=1e-6)
    np.testing.assert_array_equal(nifti.load(fn)[0], got)

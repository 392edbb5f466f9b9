"""The port's training data pipeline against the JAX package's: the
normalisers of the reference's menu, the dataset's random stages (the BraTS
augmentation lists and ``random_crop``) at several (epoch, index) seeds, the
augmented config's cache entries, the loader factory's compact bf16 transfer,
the cross-validation folds, the prefetcher on those batches and the step's
batch preparation (the prefetcher's own cases: tests/test_torch_prefetch.py).

Tolerances: normalisers 1e-5 (f32 reductions in another order); dataset
samples 1e-4 of max|x| (they resample), labels the same (RandRotateD
resamples them trilinearly); cross-validation files byte for byte. Every
test that iterates a threaded loader or prefetcher runs under a bounded
wait, so a hang fails that test instead of stalling the run.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet3d_tpu.config import factory as jax_factory
from unet3d_tpu.data import dataset as jax_dataset
from unet3d_tpu.ops import normalize as jax_normalize

from unet3d_tpu_torch.config import factory
from unet3d_tpu_torch.data import dataset
from unet3d_tpu_torch.data.loader import DataLoader, build_loader
from unet3d_tpu_torch.data.prefetch import DevicePrefetcher
from unet3d_tpu_torch.ops import normalize
from unet3d_tpu_torch.train.step import prepare_batch

from test_torch_prefetch import bounded

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BRATS = os.path.join(os.path.dirname(__file__), "..", "examples", "brats2020",
                     "brats2020_config.json")
CASE = {"image": [os.path.join(FIXTURES, "case_t1.nii.gz"),
                  os.path.join(FIXTURES, "case_t2.nii.gz")],
        "label": os.path.join(FIXTURES, "case_seg.nii.gz")}
ITEMS = [CASE, dict(CASE, image=CASE["image"][::-1])]
HIERARCHY = [[2, 1, 4], [1, 4], [4]]


def _volume(seed=0, shape=(2, 9, 11, 7)):
    rng = np.random.RandomState(seed)
    data = np.zeros(shape, np.float32)
    data[:, 2:7, 3:9, 1:6] = rng.rand(shape[0], 5, 6, 5) * 3 + 0.5
    return data


# --- normalisers ------------------------------------------------------------

@pytest.mark.parametrize("name,kwargs,channels", [
    ("percentile_window", {}, 2),
    ("percentile_window", dict(floor_percentile=20, ceiling_percentile=70), 2),
    ("foreground_zero_mean_normalize_image_data", {}, 2),
    ("foreground_zero_mean_normalize_image_data", dict(background_value=1.0), 2),
    ("window_data", dict(floor_threshold=0.5, ceiling_threshold=2.0, floor=-1), 2),
    ("radiology_style_windowing", dict(l=1.5, w=2.0), 2),
    ("static_windows", dict(windows=[[1.0, 2.0], [2.0, 1.0]]), 1),
    ("zero_floor_normalize_image_data", dict(floor_percentile=30), 2),
    ("zero_one_window", {}, 2),
    ("zero_one_window", dict(ceiling_percentile=50, floor_percentile=60, ceiling=2), 2),
    ("hist_match", dict(template=_volume(12)), 2)])
def test_reference_normalizers_match_jax(name, kwargs, channels):
    data = _volume(11, shape=(channels, 9, 11, 7))
    data[:, 0, 0, 0] = 0.25  # a tie with no other voxel
    got = getattr(normalize, name)(data, **kwargs)
    want = getattr(jax_normalize, name)(jnp.asarray(data), **kwargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_zero_one_window_of_a_constant_channel_matches_jax():
    """No voxel above the floor: the ceiling falls back to the maximum."""
    data = _volume(13)
    data[1] = 2.0
    got = normalize.zero_one_window(data)
    want = jax_normalize.zero_one_window(jnp.asarray(data))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_the_dataset_resolves_every_normaliser_of_the_jax_menu():
    for name in ("percentile_window", "zero_one_window", "hist_match", "window_data",
                 "static_windows", "radiology_style_windowing",
                 "zero_floor_normalize_image_data",
                 "foreground_zero_mean_normalize_image_data"):
        assert dataset._resolve_normalization(name) is getattr(normalize, name)


# --- dataset random stages --------------------------------------------------

def _brats_augmentations(prob=None):
    augs = copy.deepcopy(json.load(open(BRATS))["dataset"]["training"])
    if prob is not None:
        for spec in augs["spatial_augmentations"] + augs["intensity_augmentations"]:
            spec["prob"] = prob
    return augs


def _compare_samples(got, want):
    assert set(got) == set(want)
    scale = float(np.abs(np.asarray(want["image"])).max())
    assert got["image"].dtype == np.float32 and got["image"].shape == want["image"].shape
    np.testing.assert_allclose(got["image"], np.asarray(want["image"]), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got["label"], np.asarray(want["label"]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["affine"], want["affine"])
    assert got["source_filename"] == want["source_filename"]


@pytest.mark.parametrize("kwargs", [
    dict(desired_shape=[12, 12, 12], crop_foreground=True, resample=True,
         **_brats_augmentations()),
    dict(desired_shape=[12, 12, 12], crop_foreground=True, resample=True,
         **_brats_augmentations(prob=1.0)),
    dict(desired_shape=[8, 6, 10], random_crop=True, base_seed=3,
         **_brats_augmentations(prob=1.0))],
    ids=["brats", "brats-prob1", "random-crop"])
def test_dataset_random_stages_match_jax(kwargs):
    kwargs = dict(kwargs, labels=HIERARCHY, normalization="NormalizeIntensityD",
                  normalization_kwargs={"channel_wise": True})
    ours = dataset.SegmentationDataset(filenames=ITEMS, **kwargs)
    theirs = jax_dataset.SegmentationDataset(filenames=ITEMS, **kwargs)
    assert not ours.multi_sample
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for index in (0, 1):
            _compare_samples(ours[index], theirs[index])


def test_multi_sample_dataset_fans_out_as_jax():
    spatial = [{"name": "RandSpatialCropSamplesD", "roi_size": [6, 6, 6], "num_samples": 3},
               {"name": "RandFlipD", "prob": 0.5}]
    kwargs = dict(labels=HIERARCHY, desired_shape=[12, 12, 12],
                  spatial_augmentations=spatial,
                  intensity_augmentations=[{"name": "RandShiftIntensityD", "prob": 0.5}])
    ours = dataset.SegmentationDataset(filenames=ITEMS, **kwargs)
    theirs = jax_dataset.SegmentationDataset(filenames=ITEMS, **kwargs)
    assert ours.multi_sample
    got, want = ours[1], theirs[1]
    assert got["image"].shape == (3, 2, 6, 6, 6)
    _compare_samples(got, want)
    batch = bounded(lambda: next(iter(build_loader(ours, batch_size=2))))
    assert batch["image"].shape == (6, 2, 6, 6, 6)  # collate_flatten


def test_augmented_config_reads_the_jax_cache(tmp_path, monkeypatch):
    """The cache key leaves the random stages out: the port's augmented
    dataset reads the entry the JAX package wrote."""
    kwargs = dict(labels=HIERARCHY, desired_shape=[12, 12, 12], crop_foreground=True,
                  resample=True, cache_dir=str(tmp_path), **_brats_augmentations(1.0))
    want = jax_dataset.SegmentationDatasetPersistent(filenames=[CASE], **kwargs)[0]

    def no_prefix(self, item):
        raise AssertionError("recomputed instead of reading the cache")
    monkeypatch.setattr(dataset.SegmentationDataset, "_deterministic_prefix", no_prefix)
    got = dataset.SegmentationDatasetPersistent(filenames=[CASE], **kwargs)[0]
    _compare_samples(got, want)


def test_samples_log_their_stage_seconds(caplog):
    caplog.set_level("DEBUG", logger=dataset.__name__)
    dataset.SegmentationDataset(filenames=[CASE], labels=HIERARCHY, desired_shape=[8, 8, 8],
                                **_brats_augmentations())[0]
    (record,) = [r.sample_seconds for r in caplog.records if hasattr(r, "sample_seconds")]
    assert set(record) == {"index", "preprocess", "augment"} and record["index"] == 0
    assert record["preprocess"] > 0 and record["augment"] > 0


# --- loaders and cross-validation --------------------------------------------

def _config(amp, compact=None):
    config = {"training": {"batch_size": 2, "amp": amp},
              "dataset": {"name": "SegmentationDataset", "labels": HIERARCHY,
                          "desired_shape": [8, 8, 8], "normalization": "zero_mean",
                          "training": _brats_augmentations(1.0)},
              "training_filenames": ITEMS}
    if compact is not None:
        config["training"]["compact_transfer"] = compact
    return config


@pytest.mark.parametrize("amp,compact", [(True, None), (False, True), (True, False)])
def test_loader_factory_ships_bf16_torch_batches_under_amp(amp, compact, tmp_path):
    config = _config(amp, compact)
    with pytest.warns(RuntimeWarning, match="validation_filenames"):
        train, val, metric = factory.build_data_loaders_from_config(
            config, {"n_workers": 2}, str(tmp_path), dataset.SegmentationDataset)
    assert val is None and metric == "loss"
    assert sorted(os.listdir(tmp_path / "data_loader_testing")) == [
        "input_test_case_t1.nii.gz", "target_test_case_t1.nii.gz"]
    plain = DataLoader(train.dataset, batch_size=2, shuffle=True)
    got, want = bounded(lambda: (list(train), list(plain)))
    assert len(got) == len(want) == 1
    for key in ("image", "label"):
        if compact if compact is not None else amp:
            assert isinstance(got[0][key], torch.Tensor)
            assert got[0][key].dtype == torch.bfloat16
            torch.testing.assert_close(got[0][key],
                                       torch.from_numpy(want[0][key]).to(torch.bfloat16),
                                       rtol=0, atol=0)
        else:
            assert got[0][key].dtype == np.float32
            np.testing.assert_array_equal(got[0][key], want[0][key])


def test_loader_refuses_a_numpy_transfer_dtype():
    with pytest.raises(TypeError, match="torch dtype"):
        DataLoader([], transfer_dtype={"image": np.float16})


def test_loader_factories_build_what_jax_builds(tmp_path):
    config = _config(False)
    config["validation_filenames"] = [CASE]
    config["training"]["test_input"] = 0
    ours = factory.build_data_loaders_from_config(
        copy.deepcopy(config), {}, str(tmp_path), dataset.SegmentationDataset)
    theirs = jax_factory.build_data_loaders_from_config(
        copy.deepcopy(config), {}, str(tmp_path), jax_dataset.SegmentationDataset)
    assert ours[2] == theirs[2] == "val_loss"
    for got, want in zip(ours[:2], theirs[:2]):
        assert (len(got), got.batch_size, got.shuffle) == (len(want), want.batch_size,
                                                           want.shuffle)
    assert factory.model_input_shape_from_config(json.load(open(BRATS))) == \
        jax_factory.model_input_shape_from_config(json.load(open(BRATS))) == (128,) * 3 + (4,)


@pytest.mark.parametrize("n_files,n_folds,seed", [(7, 3, 25), (4, 2, 25), (5, 5, 3)])
def test_cross_validation_folds_are_byte_identical(tmp_path, n_files, n_folds, seed):
    config = json.load(open(BRATS))
    config["training_filenames"] = config["training_filenames"][:n_files]
    for name, module in (("port", factory), ("jax", jax_factory)):
        os.makedirs(tmp_path / name)
        folds = module.setup_cross_validation(copy.deepcopy(config), str(tmp_path / name),
                                              n_folds, random_seed=seed)
        assert [os.path.basename(f) for _, f in folds] == [
            f"fold{i + 1}.json" for i in range(n_folds)]
    for i in range(n_folds):
        port = (tmp_path / "port" / f"fold{i + 1}.json").read_bytes()
        assert port == (tmp_path / "jax" / f"fold{i + 1}.json").read_bytes()


# --- the prefetcher on the loader factory's batches ----------------------------

def test_prefetcher_keeps_compact_batches_and_the_loader_order(tmp_path):
    config = _config(True)
    config["training"]["test_input"] = 0
    with pytest.warns(RuntimeWarning):
        train, _, _ = factory.build_data_loaders_from_config(
            config, {}, str(tmp_path), dataset.SegmentationDataset)
    got = bounded(lambda: list(DevicePrefetcher(train, "cpu")))
    want = list(train)
    assert [b["source_filename"] for b in got] == [b["source_filename"] for b in want]
    assert got[0]["image"].dtype == torch.bfloat16
    assert torch.equal(got[0]["image"], want[0]["image"])


# --- the step's batch preparation --------------------------------------------

def test_prepare_batch_takes_a_bf16_batch_as_it_is():
    images = torch.randn(1, 2, 4, 5, 6).to(torch.bfloat16)
    labels = (torch.rand(1, 3, 4, 5, 6) > 0.5).to(torch.bfloat16)
    x, y = prepare_batch(images, labels, torch.device("cpu"), amp=True)
    assert x.dtype == torch.bfloat16 and y.dtype == torch.float32
    assert torch.equal(x, images.permute(0, 2, 3, 4, 1))
    assert torch.equal(y, labels.float().permute(0, 2, 3, 4, 1))
    x32, _ = prepare_batch(images.float().numpy(), labels.float().numpy(),
                           torch.device("cpu"), amp=False)
    assert x32.dtype == torch.float32 and torch.equal(x32.to(torch.bfloat16), x)

"""The port's train CLI against the JAX package's, end to end.

Both CLIs run in-process on copies of the fixture case (two modalities and a
BraTS-coded segmentation on a non-RAS anisotropic affine): 2 training cases,
1 validation case and a ``test_filenames`` group, with the BraTS config cut
to a 3-level DynUNet (filters [4, 8, 16]) at a 16^3 ``desired_shape`` and a
16^3 sliding window, f32, SGD, 2 epochs, and the BraTS augmentations as
published. Both start from the same JAX-initialised ``model.npz`` through
``--pretrained_model_filename``; the port runs on ``device="cpu"``. The
training logs must agree within relative 1e-3, and the predictions of the
validation and test groups within relative L2 1e-3 with equal affines (on
the source grid).
"""
import json
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from unet3d_tpu.config import factory as jax_factory
from unet3d_tpu.data import nifti as jax_nifti
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.scripts import train as jax_train
from unet3d_tpu.train.checkpoint import save_checkpoint

from unet3d_tpu_torch.scripts import train
from unet3d_tpu_torch.train.train import read_training_log

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BRATS = os.path.join(os.path.dirname(__file__), "..", "examples", "brats2020",
                     "brats2020_config.json")
MODEL = dict(in_channels=2, filters=[4, 8, 16], strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2]],
             kernel_size=[[3, 3, 3]] * 3, upsample_kernel_size=[[2, 2, 2]] * 2)


def copy_case(root, name):
    """The fixture case under ``root/name/`` as ``name_t1``, ``name_t2`` and
    ``name_seg``."""
    os.makedirs(os.path.join(root, name))
    files = {}
    for part in ("t1", "t2", "seg"):
        files[part] = os.path.join(root, name, f"{name}_{part}.nii.gz")
        shutil.copy(os.path.join(FIXTURES, f"case_{part}.nii.gz"), files[part])
    return {"image": [files["t1"], files["t2"]], "label": files["seg"]}


def small_brats_config(root, n_train=2, n_val=1, test=True):
    """The BraTS config cut to the fixture's size, with its augmentations."""
    config = json.load(open(BRATS))
    config["model"].update(MODEL)
    config["dataset"]["desired_shape"] = [16, 16, 16]
    config["inference"]["roi_size"] = [16, 16, 16]
    config["training"].update(amp=False, n_epochs=2)
    config["optimizer"] = {"name": "SGD", "lr": 0.05}
    del config["cross_validation"], config["bratsvalidation_filenames"]
    config["training_filenames"] = [copy_case(root, f"train{i}") for i in range(n_train)]
    if n_val:
        config["validation_filenames"] = [copy_case(root, f"val{i}") for i in range(n_val)]
    if test:
        config["test_filenames"] = [{"image": copy_case(root, "test0")["image"]}]
    return config


def jax_model_file(root):
    """A JAX-initialised checkpoint of MODEL and its variables."""
    model = jax_create_model("DynUNet", **{k: v for k, v in json.load(open(BRATS))["model"]
                                           .items() if k != "name"} | MODEL)
    variables = jax.jit(lambda r: model.init(r, jnp.zeros((1, 16, 16, 16, 2)), False))(
        jax.random.PRNGKey(3))
    model_file = os.path.join(root, "model.npz")
    save_checkpoint(variables, model_file)
    return model_file, variables


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One config, one checkpoint, the JAX CLI's run and the port's."""
    root = str(tmp_path_factory.mktemp("train_cli"))
    config_file = os.path.join(root, "small.json")
    json.dump(small_brats_config(root), open(config_file, "w"))
    model_file, variables = jax_model_file(root)
    args = ["--config_filename", config_file, "--pretrained_model_filename", model_file]
    # the JAX CLI initialises its parameter template eagerly (a compile per op,
    # ~40 s on the CPU) before the checkpoint load overwrites every value;
    # hand it the jitted init's tree as the template instead
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_factory, "init_params", lambda *a, **k: variables)
        jax_train.main(args + ["--output_dir", os.path.join(root, "jax")])
    result = train.main(args + ["--output_dir", os.path.join(root, "port")], device="cpu")
    return root, result


def test_training_logs_match_jax(runs):
    root, result = runs
    got = read_training_log(os.path.join(root, "port", "small", "training_log.csv"))
    want = read_training_log(os.path.join(root, "jax", "small", "training_log.csv"))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-3)
    assert all(np.isfinite(row[1]) and np.isfinite(row[3]) for row in got)
    assert result["work_dir"] == os.path.join(root, "port", "small")
    for name in ("model.npz", "model_best.npz", "cache", "data_loader_testing"):
        assert os.path.exists(os.path.join(result["work_dir"], name)), name


@pytest.mark.parametrize("group,case", [("validation", "val0_t1.nii.gz"),
                                        ("test", "test0_t1.nii.gz")])
def test_predictions_match_jax(runs, group, case):
    root, result = runs
    assert [os.path.basename(f) for f in result["predictions"][group]] == [case]
    got, got_affine, _ = jax_nifti.load(os.path.join(root, "port", "small", group, case))
    want, want_affine, _ = jax_nifti.load(os.path.join(root, "jax", "small", group, case))
    source, source_affine, _ = jax_nifti.load(os.path.join(FIXTURES, "case_t1.nii.gz"))
    assert got.shape == want.shape == source.shape + (3,)  # on the source grid
    np.testing.assert_array_equal(got_affine, want_affine)
    np.testing.assert_allclose(got_affine, source_affine, atol=1e-6)
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) < 1e-3
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_the_training_batches_went_through_the_prefetcher(runs):
    _, result = runs
    loader = result["training_loader"]
    assert type(loader).__name__ == "DevicePrefetcher" and len(loader) == 2
    assert loader.dataset.epoch == 2  # the last epoch's augmentation stream
    assert loader.device.type == "cpu"  # the caller's device: nothing pinned or copied

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


# --- SegResNetDS: the batch_stats collection through both CLIs -----------------

SEGRESNET_DS = {"name": "SegResNetDS", "init_filters": 4, "in_channels": 2,
                "out_channels": 3, "blocks_down": [1, 1, 1], "dsdepth": 2}


@pytest.fixture(scope="module")
def ds_runs(tmp_path_factory):
    """The same config with its model section replaced by a small
    SegResNetDS (batch norm, deep supervision on two heads), both CLIs from
    one JAX ``.npz`` with ``params`` and ``batch_stats`` through
    ``--pretrained_model_filename``."""
    from test_torch_batchnorm import bn_init
    root = str(tmp_path_factory.mktemp("train_cli_ds"))
    config = small_brats_config(root)
    config["model"] = dict(SEGRESNET_DS)
    config_file = os.path.join(root, "ds.json")
    json.dump(config, open(config_file, "w"))
    model = jax_create_model("SegResNetDS", **{k: v for k, v in SEGRESNET_DS.items()
                                               if k != "name"})
    variables = bn_init(model, np.zeros((1, 16, 16, 16, 2), np.float32))
    model_file = os.path.join(root, "pretrained.npz")
    save_checkpoint(variables, model_file)
    args = ["--config_filename", config_file, "--pretrained_model_filename", model_file]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_factory, "init_params", lambda *a, **k: variables)
        jax_train.main(args + ["--output_dir", os.path.join(root, "jax")])
    result = train.main(args + ["--output_dir", os.path.join(root, "port")], device="cpu")
    return root, config_file, model_file, result


def test_segresnet_ds_logs_and_statistics_match_jax(ds_runs):
    """The logs within relative 1e-3; both ``model.npz`` hold ``batch_stats``,
    moved off the pretrained file's by the training forwards, the port's
    within 1e-3 of JAX's."""
    root, _, model_file, result = ds_runs
    got = read_training_log(os.path.join(root, "port", "ds", "training_log.csv"))
    want = read_training_log(os.path.join(root, "jax", "ds", "training_log.csv"))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-3)
    assert all(np.isfinite(row[1]) and np.isfinite(row[3]) for row in got)
    start = dict(np.load(model_file))
    ours = dict(np.load(os.path.join(result["work_dir"], "model.npz")))
    theirs = dict(np.load(os.path.join(root, "jax", "ds", "model.npz")))
    assert set(ours) == set(theirs) == set(start)
    stats = sorted(k for k in ours if k.startswith("batch_stats/"))
    assert len(stats) == 5 * 2 * 2  # 5 blocks x 2 BatchNorms x (mean, var)
    for key in stats:
        assert not np.allclose(ours[key], start[key]), key
        assert float(np.linalg.norm(ours[key] - theirs[key]) / np.linalg.norm(theirs[key])) \
            < 1e-3, key


@pytest.mark.parametrize("group,case", [("validation", "val0_t1.nii.gz"),
                                        ("test", "test0_t1.nii.gz")])
def test_segresnet_ds_predictions_match_jax(ds_runs, group, case):
    root, _, _, result = ds_runs
    assert [os.path.basename(f) for f in result["predictions"][group]] == [case]
    got, _, _ = jax_nifti.load(os.path.join(root, "port", "ds", group, case))
    want, _, _ = jax_nifti.load(os.path.join(root, "jax", "ds", group, case))
    source, _, _ = jax_nifti.load(os.path.join(FIXTURES, "case_t1.nii.gz"))
    assert got.shape == want.shape == source.shape + (3,)
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) < 1e-3


def test_segresnet_ds_predict_cli_on_the_train_cli_checkpoint(ds_runs):
    """The port's predict CLI on the checkpoint its train CLI wrote (a strict
    load of both collections) gives the train CLI's own test prediction."""
    from unet3d_tpu_torch.scripts import predict
    root, config_file, _, result = ds_runs
    out = os.path.join(root, "predict")
    predict.main(["--config_filename", config_file, "--model_filename",
                  os.path.join(result["work_dir"], "model.npz"), "--output_directory", out,
                  "--group", "test", "--activation", "sigmoid"], device="cpu")
    got, _, _ = jax_nifti.load(os.path.join(out, "predictions", "test0_t1.nii.gz"))
    trained, _, _ = jax_nifti.load(result["predictions"]["test"][0])
    np.testing.assert_allclose(got, trained, atol=1e-6)


def test_segresnet_ds_dry_run_keeps_the_running_statistics(ds_runs, tmp_path):
    """``--dry_run`` runs the step's forwards and backwards at the config's
    shapes, then puts back the statistics they updated."""
    from unet3d_tpu_torch.convert import model_variables
    _, config_file, model_file, _ = ds_runs
    built = []
    real = train.build_or_load_model_from_config
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(train, "build_or_load_model_from_config",
                      lambda *a, **k: built.append(real(*a, **k)) or built[-1])
        report = train.main(["--config_filename", config_file, "--pretrained_model_filename",
                             model_file, "--output_dir", str(tmp_path), "--dry_run"],
                            device="cpu")
    assert report["backend"] == "cpu" and report["images"][0] == [1, 2, 16, 16, 16]
    start = dict(np.load(model_file))
    for key, value in model_variables(built[0]).items():
        np.testing.assert_array_equal(value, start[key])


# --- UNETR: a transformer through both CLIs ---------------------------------------

UNETR = {"name": "UNETR", "in_channels": 2, "out_channels": 3, "img_size": 32,
         "feature_size": 4, "hidden_size": 32, "mlp_dim": 64, "num_heads": 2, "num_layers": 4}


@pytest.fixture(scope="module")
def unetr_runs(tmp_path_factory):
    """The same config with a small UNETR (a 2^3 patch grid, so 8 tokens
    attend) at a 32^3 ``desired_shape`` and window (UNETR takes only its
    ``img_size``), both CLIs from one JAX ``.npz`` through
    ``--pretrained_model_filename``."""
    from test_torch_batchnorm import bn_init
    root = str(tmp_path_factory.mktemp("train_cli_unetr"))
    config = small_brats_config(root)
    config["model"] = dict(UNETR)
    config["dataset"]["desired_shape"] = [32, 32, 32]
    config["inference"]["roi_size"] = [32, 32, 32]
    config_file = os.path.join(root, "unetr.json")
    json.dump(config, open(config_file, "w"))
    model = jax_create_model("UNETR", **{k: v for k, v in UNETR.items() if k != "name"})
    variables = bn_init(model, np.zeros((1, 32, 32, 32, 2), np.float32))
    model_file = os.path.join(root, "pretrained.npz")
    save_checkpoint(variables, model_file)
    args = ["--config_filename", config_file, "--pretrained_model_filename", model_file]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_factory, "init_params", lambda *a, **k: variables)
        jax_train.main(args + ["--output_dir", os.path.join(root, "jax")])
    result = train.main(args + ["--output_dir", os.path.join(root, "port")], device="cpu")
    return root, model_file, result


def test_unetr_logs_and_checkpoints_match_jax(unetr_runs):
    """The logs within relative 1e-3; both ``model.npz`` hold the same keys
    (``params`` only: no attention constant is a variable), moved off the
    pretrained file's by training."""
    root, model_file, result = unetr_runs
    got = read_training_log(os.path.join(root, "port", "unetr", "training_log.csv"))
    want = read_training_log(os.path.join(root, "jax", "unetr", "training_log.csv"))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-3)
    assert all(np.isfinite(row[1]) and np.isfinite(row[3]) for row in got)
    start = dict(np.load(model_file))
    ours = dict(np.load(os.path.join(result["work_dir"], "model.npz")))
    theirs = dict(np.load(os.path.join(root, "jax", "unetr", "model.npz")))
    assert set(ours) == set(theirs) == set(start)
    assert all(k.startswith("params/") for k in ours)
    key = "params/vit/block0/attn/qkv/kernel"
    assert not np.allclose(ours[key], start[key])
    assert float(np.linalg.norm(ours[key] - theirs[key]) / np.linalg.norm(theirs[key])) < 1e-3


@pytest.mark.parametrize("group,case", [("validation", "val0_t1.nii.gz"),
                                        ("test", "test0_t1.nii.gz")])
def test_unetr_predictions_match_jax(unetr_runs, group, case):
    root, _, result = unetr_runs
    assert [os.path.basename(f) for f in result["predictions"][group]] == [case]
    got, _, _ = jax_nifti.load(os.path.join(root, "port", "unetr", group, case))
    want, _, _ = jax_nifti.load(os.path.join(root, "jax", "unetr", group, case))
    source, _, _ = jax_nifti.load(os.path.join(FIXTURES, "case_t1.nii.gz"))
    assert got.shape == want.shape == source.shape + (3,)
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) < 1e-3
    assert 0.0 <= got.min() and got.max() <= 1.0


# --- BasicUNetPlusPlus with deep supervision through both CLIs -------------------

BASIC_UNET_PP = {"name": "BasicUNetPlusPlus", "in_channels": 2, "out_channels": 3,
                 "features": [4, 4, 8, 8, 16, 4], "deep_supervision": True}


@pytest.fixture(scope="module")
def basicunetpp_runs(tmp_path_factory):
    """The same config with a small BasicUNetPlusPlus whose four heads train
    (the stack through the criterion's 1/2^i weighting), both CLIs from one
    JAX ``.npz`` through ``--pretrained_model_filename``; then the port's
    predict CLI on the train CLI's checkpoint."""
    from test_torch_batchnorm import bn_init
    root = str(tmp_path_factory.mktemp("train_cli_basicunetpp"))
    config = small_brats_config(root)
    config["model"] = dict(BASIC_UNET_PP)
    config_file = os.path.join(root, "basicunetpp.json")
    json.dump(config, open(config_file, "w"))
    model = jax_create_model("BasicUNetPlusPlus",
                             **{k: v for k, v in BASIC_UNET_PP.items() if k != "name"})
    variables = bn_init(model, np.zeros((1, 16, 16, 16, 2), np.float32))
    model_file = os.path.join(root, "pretrained.npz")
    save_checkpoint(variables, model_file)
    args = ["--config_filename", config_file, "--pretrained_model_filename", model_file]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_factory, "init_params", lambda *a, **k: variables)
        jax_train.main(args + ["--output_dir", os.path.join(root, "jax")])
    result = train.main(args + ["--output_dir", os.path.join(root, "port")], device="cpu")
    return root, model_file, result


def test_basicunetpp_logs_and_checkpoints_match_jax(basicunetpp_runs):
    """The logs within relative 1e-3; both ``model.npz`` hold the pretrained
    file's keys (the three extra heads among them), moved by training."""
    root, model_file, result = basicunetpp_runs
    got = read_training_log(os.path.join(root, "port", "basicunetpp", "training_log.csv"))
    want = read_training_log(os.path.join(root, "jax", "basicunetpp", "training_log.csv"))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-3)
    start = dict(np.load(model_file))
    ours = dict(np.load(os.path.join(result["work_dir"], "model.npz")))
    theirs = dict(np.load(os.path.join(root, "jax", "basicunetpp", "model.npz")))
    assert set(ours) == set(theirs) == set(start)
    for key in ("params/final_conv_0_1/kernel", "params/upcat_0_4/convs/conv_0/conv/kernel"):
        assert not np.allclose(ours[key], start[key])
        assert float(np.linalg.norm(ours[key] - theirs[key]) / np.linalg.norm(theirs[key])) < 1e-3


@pytest.mark.parametrize("group,case", [("validation", "val0_t1.nii.gz"),
                                        ("test", "test0_t1.nii.gz")])
def test_basicunetpp_predictions_match_jax(basicunetpp_runs, group, case):
    root, _, result = basicunetpp_runs
    assert [os.path.basename(f) for f in result["predictions"][group]] == [case]
    got, _, _ = jax_nifti.load(os.path.join(root, "port", "basicunetpp", group, case))
    want, _, _ = jax_nifti.load(os.path.join(root, "jax", "basicunetpp", group, case))
    source, _, _ = jax_nifti.load(os.path.join(FIXTURES, "case_t1.nii.gz"))
    assert got.shape == want.shape == source.shape + (3,)
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) < 1e-3


def test_basicunetpp_predict_cli_on_the_train_cli_checkpoint(basicunetpp_runs):
    """The predict CLI on the train CLI's ``model.npz`` gives the train
    CLI's own test prediction."""
    from unet3d_tpu_torch.scripts import predict
    root, _, result = basicunetpp_runs
    out = os.path.join(root, "predict")
    predict.main(["--config_filename", os.path.join(root, "basicunetpp.json"),
                  "--model_filename", os.path.join(result["work_dir"], "model.npz"),
                  "--output_directory", out, "--group", "test", "--activation", "sigmoid"],
                 device="cpu")
    got, _, _ = jax_nifti.load(os.path.join(out, "predictions", "test0_t1.nii.gz"))
    want, _, _ = jax_nifti.load(os.path.join(root, "port", "basicunetpp", "test",
                                             "test0_t1.nii.gz"))
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) < 1e-6

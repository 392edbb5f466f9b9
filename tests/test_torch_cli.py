"""The port's predict and segment CLIs against the JAX package's.

Both predict CLIs run in-process on the fixture case (two modalities, a
non-RAS anisotropic affine) with a 3-level DynUNet config (16^3
``desired_shape``, crop-foreground and resample on, f32) and the same
JAX-written ``.npz`` checkpoint, the port on ``device="cpu"`` (without it the
CLI needs a CUDA GPU); the written NIfTIs must have the same shape
and affine and agree within 1e-4 relative to the largest value (two f32
networks ~1e-5 apart, resampled by the same trilinear weights). The port
runs once with the default routing and once under UNET3D_TPU_CONV=winograd
with the gate's thresholds lowered, so that the Winograd sites exist at 16^3.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.config import factory as jax_factory
from unet3d_tpu.data import nifti as jax_nifti
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.predict import volumetric as jax_volumetric
from unet3d_tpu.scripts import predict as jax_predict
from unet3d_tpu.scripts import segment as jax_segment
from unet3d_tpu.train.checkpoint import save_checkpoint

from unet3d_tpu_torch.ops import winograd_kernel as wino
from unet3d_tpu_torch.predict import volumetric
from unet3d_tpu_torch.scripts import predict, segment

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BRATS = os.path.join(os.path.dirname(__file__), "..", "examples", "brats2020",
                     "brats2020_config.json")
IMAGES = [os.path.join(FIXTURES, "case_t1.nii.gz"), os.path.join(FIXTURES, "case_t2.nii.gz")]
MODEL = dict(in_channels=2, filters=[4, 8, 16], strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2]],
             kernel_size=[[3, 3, 3]] * 3, upsample_kernel_size=[[2, 2, 2]] * 2)


def _option_strings(parser):
    return sorted(s for action in parser._actions for s in action.option_strings)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The config, a JAX-initialised checkpoint and the JAX CLI's output."""
    root = tmp_path_factory.mktemp("cli")
    config = json.load(open(BRATS))
    config["model"].update(MODEL)
    config["dataset"]["desired_shape"] = [16, 16, 16]
    config["training"]["amp"] = False
    config["test_filenames"] = [{"image": IMAGES}]
    del config["training_filenames"], config["bratsvalidation_filenames"]
    config_file = str(root / "config.json")
    json.dump(config, open(config_file, "w"))
    model = jax_create_model("DynUNet", **{k: v for k, v in config["model"].items()
                                           if k != "name"})
    variables = jax.jit(lambda r: model.init(r, jnp.zeros((1, 16, 16, 16, 2)), False))(
        jax.random.PRNGKey(3))
    model_file = str(root / "model.npz")
    save_checkpoint(variables, model_file)
    jax_out = str(root / "jax")
    # the JAX CLI initialises its parameter template eagerly (a compile per op,
    # ~40 s on the CPU) before the strict checkpoint load overwrites every
    # value; hand it the jitted init's tree as the template instead
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_factory, "init_params", lambda *args, **kwargs: variables)
        jax_predict.main(["--config_filename", config_file, "--model_filename", model_file,
                          "--output_directory", jax_out, "--activation", "sigmoid"])
    return config_file, model_file, os.path.join(jax_out, "predictions", "case_t1.nii.gz")


@pytest.mark.parametrize("strategy", [None, "winograd"])
def test_predict_cli_matches_jax(setup, tmp_path, monkeypatch, caplog, strategy):
    config_file, model_file, jax_file = setup
    if strategy:
        monkeypatch.setenv("UNET3D_TPU_CONV", strategy)
        monkeypatch.setattr(wino, "_MIN_WINOGRAD_CHANNELS", 8)
        monkeypatch.setattr(wino, "_MIN_WINOGRAD_VOXELS", 8 ** 3)
    calls = []
    real = wino.winograd_reference
    monkeypatch.setattr(wino, "winograd_reference",
                        lambda *a: calls.append(1) or real(*a))
    out = str(tmp_path / "port")
    caplog.set_level(logging.INFO, logger=volumetric.__name__)
    predict.main(["--config_filename", config_file, "--model_filename", model_file,
                  "--output_directory", out, "--activation", "sigmoid"], device="cpu")
    assert bool(calls) == bool(strategy)  # the Winograd sites ran only with it
    got_file = os.path.join(out, "predictions", "case_t1.nii.gz")
    assert sorted(os.listdir(os.path.join(out, "predictions"))) == ["case_t1.nii.gz"]
    assert os.listdir(os.path.join(out, "cache"))  # the dataset's cache
    got, got_affine, _ = jax_nifti.load(got_file)
    want, want_affine, _ = jax_nifti.load(jax_file)
    source, source_affine, _ = jax_nifti.load(IMAGES[0])
    assert got.shape == want.shape == source.shape + (3,)  # back on the source grid
    np.testing.assert_allclose(got_affine, want_affine, atol=1e-6)
    np.testing.assert_allclose(got_affine, source_affine, atol=1e-6)
    assert float(np.abs(got - want).max() / np.abs(want).max()) < 1e-4
    assert 0.0 <= got.min() and got.max() <= 1.0
    (record,) = [r.case_seconds for r in caplog.records if hasattr(r, "case_seconds")]
    assert record["case"] == "case_t1.nii.gz"
    assert set(record) == {"case", "read_preprocess", "forward", "resample", "write"}


def test_segment_cli_matches_jax(setup, tmp_path):
    _, _, probabilities = setup
    for module, name in ((segment, "port"), (jax_segment, "jax")):
        module.main(["--filenames", probabilities, "--labels", "2", "1", "4",
                     "--hierarchy", "--output_filenames", str(tmp_path / f"{name}.nii.gz")])
    got, got_affine, _ = jax_nifti.load(str(tmp_path / "port.nii.gz"))
    want, want_affine, _ = jax_nifti.load(str(tmp_path / "jax.nii.gz"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_affine, want_affine)
    assert set(np.unique(got)) <= {0, 1, 2, 4}
    segment.main(["--filenames", probabilities, "--labels", "2", "1", "4", "--sum",
                  "--output_replace", "predictions", "segmented"])
    assert os.path.exists(probabilities.replace("predictions", "segmented"))


def test_parsers_take_the_jax_flags():
    assert _option_strings(predict.format_parser()) == _option_strings(
        jax_predict.format_parser())
    assert _option_strings(segment.format_parser()) == _option_strings(
        jax_segment.format_parser())
    args = predict.parse_args(["--output_directory", "o", "--config_filename", "c",
                               "--model_filename", "m"])
    assert args.activation is None and args.group == "test" and args.ngpus == 1


@pytest.mark.parametrize("model_file,machine", [
    ("model.u3dexp", {"n_gpus": 1}), ("model.npz", {"n_gpus": 2}),
    ("model.npz", {"n_gpus": 1, "mesh": "data2"})])
def test_unported_options_raise(setup, tmp_path, model_file, machine):
    config = json.load(open(setup[0]))
    with pytest.raises(NotImplementedError, match="not ported"):
        predict.run_inference(config, str(tmp_path), model_file, "test", None, machine,
                              device="cpu")


def test_unknown_group_raises(setup, tmp_path):
    config = json.load(open(setup[0]))
    with pytest.raises(ValueError, match="bratsvalidation_filenames"):
        predict.run_inference(config, str(tmp_path), setup[1], "bratsvalidation", None,
                              {"n_gpus": 1}, device="cpu")


def test_predict_without_a_gpu_raises_unless_given_the_cpu(setup, tmp_path, monkeypatch):
    """No silent CPU fallback: with no CUDA device and no ``device`` the
    CLI refuses to run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = json.load(open(setup[0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.run_inference(config, str(tmp_path), setup[1], "test", None, {"n_gpus": 1})
    assert not os.path.exists(os.path.join(str(tmp_path), "predictions"))


@pytest.mark.parametrize("filenames", [
    [["/data/sub-01/anat/t1.nii.gz"], ["/data/sub-02/anat/t1.nii.gz"]],
    [["/data/a/x_t1.nii.gz", "/data/a/x_t2.nii.gz"]]])
def test_infer_subject_id_matches_jax(filenames):
    for fn in filenames:
        assert volumetric.infer_subject_id(fn, filenames) == \
            jax_volumetric.infer_subject_id(fn, filenames)

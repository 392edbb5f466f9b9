"""The port's train and predict CLIs on the Myronenko family, on the CPU.

A SegResNetVAE config (the BraTS config with its model section replaced:
init_filters 8, blocks_down [1, 2], blocks_up [1], a 4-channel, 8-d latent,
channel dropout 0.2) trains 2 epochs on copies of the fixture case at 16^3
through the JAX train CLI and through the port's (``device="cpu"``), which
then predicts. The JAX CLI's ``model.npz`` loads strictly into the port
(``convert.load_jax_variables``), whose f32 forward lies within relative L2
1e-5 of an f64 evaluation and gives the JAX forward within 1e-5, or within
twice JAX's own f32 error where that is larger (after training, the
GroupNorm statistics' E[x^2] - E[x]^2 puts JAX's f32 output 2.0e-5 from the
f64 one, the port's 1.4e-6); the port's predict CLI on that checkpoint gives the
JAX train CLI's own predictions of the test group within relative L2 1e-3.
The training runs draw their noise apart (``jax.random`` against the
port's generator), so their logs are held only for finite losses. A UNet3D
config trains and predicts through the port's CLIs too.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.config import factory as jax_factory
from unet3d_tpu.data import nifti as jax_nifti
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.scripts import train as jax_train
from unet3d_tpu.train import checkpoint as jax_checkpoint

from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
from unet3d_tpu_torch.models.remat import checkpointed_blocks
from unet3d_tpu_torch.scripts import predict, train
from unet3d_tpu_torch.train.train import read_training_log

from test_torch_myronenko import _rel, reference_forward
from test_torch_train_cli import FIXTURES, small_brats_config

SEGRESNET_VAE = {"name": "SegResNetVAE", "input_image_size": [16, 16, 16],
                 "init_filters": 8, "in_channels": 2, "out_channels": 3,
                 "dropout_prob": 0.2, "norm_groups": 8, "blocks_down": [1, 2],
                 "blocks_up": [1], "upsample_mode": "nontrainable", "vae_nz": 8,
                 "smallest_filters": 4}
UNET3D = {"name": "UNet3D", "n_features": 2, "base_width": 8, "encoder_blocks": [1, 2],
          "n_outputs": 3}


def _config(root, model, name):
    config = small_brats_config(root)
    config["model"] = dict(model)
    path = os.path.join(root, f"{name}.json")
    json.dump(config, open(path, "w"))
    return config, path


def _predict(config_file, model_file, out):
    predict.main(["--config_filename", config_file, "--model_filename", model_file,
                  "--output_directory", out, "--group", "test", "--activation", "sigmoid"],
                 device="cpu")
    (name,) = os.listdir(os.path.join(out, "predictions"))
    return jax_nifti.load(os.path.join(out, "predictions", name))


@pytest.fixture(scope="module")
def vae_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("myronenko_cli"))
    config, config_file = _config(root, SEGRESNET_VAE, "vae")
    model = jax_create_model("SegResNetVAE", **{k: v for k, v in SEGRESNET_VAE.items()
                                                if k != "name"})
    variables = jax.jit(lambda r: model.init(
        {"params": r, "dropout": r, "sample": r}, jnp.zeros((1, 16, 16, 16, 2)), False))(
        jax.random.PRNGKey(3))
    # the JAX CLI initialises its template eagerly (a compile per op); hand it
    # the jitted init's tree (tests/test_torch_train_cli.py does the same)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_factory, "init_params", lambda *a, **k: variables)
        jax_train.main(["--config_filename", config_file, "--output_dir",
                        os.path.join(root, "jax")])
    result = train.main(["--config_filename", config_file, "--output_dir",
                         os.path.join(root, "port")], device="cpu")
    return root, config, config_file, model, result


def test_port_train_cli_trains_segresnet_vae(vae_runs):
    root, _, _, _, result = vae_runs
    rows = read_training_log(os.path.join(result["work_dir"], "training_log.csv"))
    assert [r[0] for r in rows] == [1, 2]
    assert all(np.isfinite(r[1]) and np.isfinite(r[3]) for r in rows)
    assert type(result["model"]).__name__ == "SegResNetVAE"
    for group, case in (("validation", "val0_t1.nii.gz"), ("test", "test0_t1.nii.gz")):
        assert [os.path.basename(f) for f in result["predictions"][group]] == [case]
        data, affine, _ = jax_nifti.load(result["predictions"][group][0])
        source, source_affine, _ = jax_nifti.load(os.path.join(FIXTURES, "case_t1.nii.gz"))
        assert data.shape == source.shape + (3,)
        assert np.isfinite(data).all() and 0.0 <= data.min() and data.max() <= 1.0
        np.testing.assert_allclose(affine, source_affine, atol=1e-6)
    jax_rows = read_training_log(os.path.join(root, "jax", "vae", "training_log.csv"))
    assert len(jax_rows) == 2 and all(np.isfinite(r[1]) for r in jax_rows)


def test_jax_checkpoint_loads_strictly_and_matches_the_jax_forward(vae_runs):
    root, config, _, model, _ = vae_runs
    model_file = os.path.join(root, "jax", "vae", "model.npz")
    port = build_or_load_model_from_config(config, model_file, torch.device("cpu"),
                                           strict=True, seed=5)
    variables = jax_checkpoint.load_into(
        jax.jit(lambda r: model.init({"params": r, "sample": r},
                                     jnp.zeros((1, 16, 16, 16, 2)), False))(
            jax.random.PRNGKey(0)), model_file, strict=True)
    x = np.random.RandomState(4).randn(2, 16, 16, 16, 2).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, xv: model.apply(v, xv, False))(variables,
                                                                       jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    exact = reference_forward(port, x)
    assert _rel(got, exact) < 1e-5
    assert _rel(got, want) < max(1e-5, 2 * _rel(want, exact)), (_rel(got, want),
                                                               _rel(want, exact))


def test_port_predict_cli_on_the_jax_checkpoint(vae_runs):
    """The port's predict CLI on the JAX train CLI's checkpoint gives the
    JAX train CLI's predictions of the test group."""
    root, _, config_file, _, _ = vae_runs
    got, got_affine, _ = _predict(config_file, os.path.join(root, "jax", "vae", "model.npz"),
                                  os.path.join(root, "predict_jax_model"))
    want, want_affine, _ = jax_nifti.load(os.path.join(root, "jax", "vae", "test",
                                                       "test0_t1.nii.gz"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got_affine, want_affine, atol=1e-6)
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) < 1e-3


def test_port_clis_train_and_predict_unet3d(tmp_path):
    root = str(tmp_path)
    _, config_file = _config(root, UNET3D, "unet")
    result = train.main(["--config_filename", config_file, "--output_dir",
                         os.path.join(root, "out")], device="cpu")
    rows = read_training_log(os.path.join(result["work_dir"], "training_log.csv"))
    assert len(rows) == 2 and all(np.isfinite(r[1]) and np.isfinite(r[3]) for r in rows)
    data, _, _ = _predict(config_file, os.path.join(result["work_dir"], "model.npz"),
                          os.path.join(root, "predict"))
    trained, _, _ = jax_nifti.load(result["predictions"]["test"][0])
    assert data.shape[-1] == 3 and np.isfinite(data).all()
    np.testing.assert_allclose(data, trained, atol=1e-6)


def test_remat_is_refused_for_the_family():
    """``training.remat`` builds the family's nets too: the port recomputes
    them in the backward block by block, as the JAX package wraps them in
    ``nn.remat`` (tests/test_torch_whole_remat.py), with the variables of
    the net without remat; the name is kept from when the port refused it."""
    config = {"model": dict(SEGRESNET_VAE)}
    remat = build_or_load_model_from_config(config, None, torch.device("cpu"), remat=True)
    model = build_or_load_model_from_config(config, None, torch.device("cpu"))
    assert type(model).__name__ == type(remat).__name__ == "SegResNetVAE"
    assert checkpointed_blocks(remat) and not checkpointed_blocks(model)
    assert remat.state_dict().keys() == model.state_dict().keys()
    for key, value in model.state_dict().items():
        assert torch.equal(remat.state_dict()[key], value), key

"""The port's train CLI with the options it took over from the JAX CLI,
against the JAX CLI, through a resume.

Both CLIs train the small BraTS config of tests/test_torch_train_cli.py with
a residual DynUNet, ``remat``, batches of 2 split into 2 microbatches,
DiceFocalLoss, AdamW and the optimizer state saved, for 2 epochs from the
same JAX-initialised checkpoint, then resume to epoch 3 from their work
directories' checkpoints and optimizer files. A third run resumes
the JAX CLI's 2-epoch work directory in the port: its model, its optimizer
file and its log. The three logs must agree within relative 1e-3, and the
validation predictions of the two CLIs within relative L2 1e-3.
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
from unet3d_tpu.train import checkpoint as jax_ckpt

from unet3d_tpu_torch.scripts import train
from unet3d_tpu_torch.train.train import read_training_log

from test_torch_train_cli import BRATS, MODEL, small_brats_config

OPTIONS = dict(remat=True, gradient_accumulation_steps=2, batch_size=2,
               save_optimizer=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_cli_resume"))
    config = small_brats_config(root, n_train=2, n_val=1, test=False)
    config["model"]["res_block"] = True
    config["training"].update(OPTIONS)
    config["loss"] = {"name": "DiceFocalLoss", "sigmoid": True}
    config["optimizer"] = {"name": "AdamW", "lr": 0.01}
    config_file = os.path.join(root, "small.json")
    model_kwargs = {k: v for k, v in json.load(open(BRATS))["model"].items()
                    if k != "name"} | MODEL | {"res_block": True}
    model = jax_create_model("DynUNet", **model_kwargs)
    variables = jax.jit(lambda r: model.init(r, jnp.zeros((1, 16, 16, 16, 2)), False))(
        jax.random.PRNGKey(4))
    model_file = os.path.join(root, "model.npz")
    jax_ckpt.save_checkpoint(variables, model_file)
    work = {k: os.path.join(root, k, "small") for k in ("jax", "port", "cross")}
    for n_epochs in (2, 3):
        config["training"]["n_epochs"] = n_epochs
        json.dump(config, open(config_file, "w"))
        args = ["--config_filename", config_file]
        if n_epochs == 2:  # start from the checkpoint; resume from the work's
            args += ["--pretrained_model_filename", model_file]
        else:  # the JAX CLI's work after 2 epochs, to resume in the port
            shutil.copytree(work["jax"], work["cross"])
        with pytest.MonkeyPatch.context() as patch:
            # the jitted init's tree as the JAX CLI's parameter template (see
            # tests/test_torch_train_cli.py)
            patch.setattr(jax_factory, "init_params", lambda *a, **k: variables)
            jax_train.main(args + ["--output_dir", os.path.dirname(work["jax"])])
        train.main(args + ["--output_dir", os.path.dirname(work["port"])], device="cpu")
    train.main(["--config_filename", config_file, "--output_dir",
                os.path.dirname(work["cross"])], device="cpu")
    return work


def test_logs_match_jax_through_the_resume(runs):
    logs = {k: np.asarray(read_training_log(os.path.join(d, "training_log.csv")))
            for k, d in runs.items()}
    assert all(log.shape == (3, 4) for log in logs.values())
    assert np.isfinite(logs["port"]).all()
    np.testing.assert_allclose(logs["port"], logs["jax"], rtol=1e-3)
    np.testing.assert_allclose(logs["cross"], logs["jax"], rtol=1e-3)


def test_optimizer_files_interchange(runs):
    """Each work directory's optimizer file has the same JAX keys and counts
    3 updates (3 epochs of one batch of 2), and the two CLIs' moments agree
    (Adam's second moments are small: an absolute floor)."""
    files = {k: dict(np.load(os.path.join(d, "model_optimizer.npz")))
             for k, d in runs.items()}
    assert files["port"].keys() == files["jax"].keys() == files["cross"].keys()
    for name, arrays in files.items():
        assert int(arrays[".count"]) == 3, name
        assert int(arrays[".inner_state[0].count"]) == 3, name
    for key in files["jax"]:
        np.testing.assert_allclose(files["port"][key], files["jax"][key], rtol=1e-2,
                                   atol=1e-4, err_msg=key)


def test_validation_predictions_match_jax(runs):
    got, got_affine, _ = jax_nifti.load(os.path.join(runs["port"], "validation",
                                                     "val0_t1.nii.gz"))
    want, want_affine, _ = jax_nifti.load(os.path.join(runs["jax"], "validation",
                                                       "val0_t1.nii.gz"))
    np.testing.assert_array_equal(got_affine, want_affine)
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) < 1e-3

"""The port's prediction path against the JAX package.

The sliding window runs the same converted DynUNet on both sides (JAX
parameters loaded into the port) over the same numpy volume; f32, atol/rtol
1e-4 (two networks that agree to ~1e-5, blended by the same weights).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.data import nifti as jax_nifti
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.predict import sliding_window as jax_sw

from unet3d_tpu_torch.config.factory import (build_inferer_from_config,
                                             get_activation_from_config)
from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.predict import sliding_window as sw
from unet3d_tpu_torch.predict.volumetric import (ACTIVATIONS, apply_activation,
                                                 make_forward, volumetric_predictions)

KWARGS = dict(in_channels=4, out_channels=3, spatial_dims=3,
              strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2]], filters=[4, 8, 16],
              kernel_size=[[3, 3, 3]] * 3, upsample_kernel_size=[[2, 2, 2]] * 2)
BRATS = os.path.join(os.path.dirname(__file__), "..", "examples", "brats2020",
                     "brats2020_config.json")


@pytest.fixture(scope="module")
def networks():
    from flax.traverse_util import flatten_dict
    model = jax_create_model("DynUNet", **KWARGS)
    x0 = jnp.zeros((1, 16, 16, 16, 4), jnp.float32)
    variables = jax.jit(lambda r: model.init(r, x0, False))(jax.random.PRNGKey(1))
    apply = jax.jit(lambda x: model.apply(variables, x, False))
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    port = load_jax_variables(create_model("DynUNet", **KWARGS), flat).eval()
    return apply, port


@pytest.mark.parametrize("image,roi,interval", [
    ((24, 20, 18), (16, 16, 16), (8, 8, 8)),
    ((240, 240, 155), (128, 128, 128), (64, 64, 64)),
    ((10, 16, 33), (16, 16, 16), (8, 16, 5)),
])
def test_patch_grid_equals_jax(image, roi, interval):
    got = sw.dense_patch_slices(image, roi, interval)
    want = jax_sw.dense_patch_slices(image, roi, interval)
    np.testing.assert_array_equal(got, want)
    assert sw._scan_interval(image, roi, 0.5) == jax_sw._scan_interval(image, roi, 0.5)


@pytest.mark.parametrize("roi,sigma", [((16, 16, 16), 0.125), ((7, 12, 9), 0.3)])
def test_gaussian_map_equals_jax(roi, sigma):
    np.testing.assert_array_equal(sw.gaussian_importance_map(roi, sigma),
                                  jax_sw.gaussian_importance_map(roi, sigma))


@pytest.mark.parametrize("shape,mode,sw_batch,padding_mode", [
    ((2, 24, 20, 18, 4), "gaussian", 1, "constant"),
    ((2, 24, 20, 18, 4), "constant", 3, "constant"),   # 8 windows: one repeat masked
    ((1, 12, 20, 10, 4), "gaussian", 2, "constant"),   # smaller than the ROI
    ((1, 12, 20, 10, 4), "constant", 1, "replicate"),
])
def test_sliding_window_matches_jax(networks, shape, mode, sw_batch, padding_mode):
    apply, port = networks
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    kwargs = dict(roi_size=(16, 16, 16), sw_batch_size=sw_batch, overlap=0.5,
                  mode=mode, padding_mode=padding_mode)
    want = np.asarray(jax_sw.sliding_window_inference(jnp.asarray(x), apply, **kwargs))
    got = sw.sliding_window_inference(torch.from_numpy(x), make_forward(port), **kwargs)
    assert got.shape == want.shape == shape[:4] + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_bad_padding_mode_raises(networks):
    with pytest.raises(ValueError, match="padding_mode"):
        sw.sliding_window_inference(torch.zeros(1, 4, 4, 4, 1), lambda v: v,
                                    (8, 8, 8), padding_mode="edge")


def test_volumetric_predictions_write_nifti_jax_reads(networks, tmp_path):
    _, port = networks
    config = json.load(open(BRATS))
    inferer = build_inferer_from_config(
        dict(config, inference=dict(config["inference"], roi_size=[16, 16, 16])))
    activation = get_activation_from_config(config)
    assert isinstance(inferer, sw.SlidingWindowInferer) and activation == "sigmoid"
    image = np.random.RandomState(6).randn(2, 4, 20, 18, 16).astype(np.float32)
    affine = np.array([[-1.5, 0, 0, 10], [0, 1.2, 0, -3], [0, 0, 2.0, 5],
                       [0, 0, 0, 1]])
    batch = {"image": image, "affine": [affine, np.eye(4)],
             "source_filename": [["/d/case_a_flair.nii.gz", "/d/case_a_t1.nii.gz"],
                                 "/d/case_b.nii"]}
    written = volumetric_predictions(port, [batch], str(tmp_path / "pred"),
                                     activation=activation, inferer=inferer)
    assert [os.path.basename(f) for f in written] == ["case_a_flair.nii.gz",
                                                      "case_b.nii.gz"]
    x = torch.from_numpy(image).permute(0, 2, 3, 4, 1).contiguous()
    want = apply_activation(inferer(x, make_forward(port)), "sigmoid").numpy()
    for i, (fn, aff) in enumerate(zip(written, batch["affine"])):
        data, got_affine, _ = jax_nifti.load(fn)
        assert data.shape == (20, 18, 16, 3)
        np.testing.assert_array_equal(data, want[i])
        np.testing.assert_allclose(got_affine, aff, atol=1e-6)
        assert 0.0 <= data.min() and data.max() <= 1.0
    # resample=True reads each source file for its grid (tests/test_torch_cli.py
    # runs it on real files); these sources do not exist
    with pytest.raises(FileNotFoundError):
        volumetric_predictions(port, [batch], str(tmp_path), resample=True,
                               inferer=inferer)


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS) + [None])
def test_apply_activation_matches_jax(activation):
    """Every name of the port's table against the JAX version's lookup
    (jax.numpy, then jax.nn), on signed and on positive inputs (the domain of
    sqrt, log, ...); the channel axis is even for glu. atol 1e-6, rtol 1e-5:
    f32 rounding of the two libraries' elementwise functions."""
    from unet3d_tpu.predict.volumetric import apply_activation as jax_apply_activation
    signed = np.random.RandomState(7).randn(2, 3, 4, 5, 4).astype(np.float32)
    for pred in (signed, np.abs(signed) + 0.1):
        got = apply_activation(torch.from_numpy(pred), activation).numpy()
        want = np.asarray(jax_apply_activation(jnp.asarray(pred), activation))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("activation", ["logsigmoid", "softsign", "hardtanh"])
def test_apply_activation_rejects_torch_only_names_as_jax_does(activation):
    from unet3d_tpu.predict.volumetric import apply_activation as jax_apply_activation
    with pytest.raises(ValueError, match="Unknown activation"):
        jax_apply_activation(jnp.zeros((1, 3)), activation)
    with pytest.raises(ValueError, match="Unknown activation"):
        apply_activation(torch.zeros(1, 3), activation)


def test_apply_activation_rejects_unknown_names():
    with pytest.raises(ValueError, match="Unknown activation"):
        apply_activation(torch.zeros(1, 3), "no_such_function")

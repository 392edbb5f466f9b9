"""The port's registration nets (RegUNet, LocalNet, GlobalNet) and
``warp_image`` against the JAX package's, with the JAX variables
(``params`` and ``batch_stats``, every scale, bias and running statistic
moved off its initial value) carried across strictly.

Small nets at 8^3, batch 2, ``num_channel_initial`` 2, depth 1, which
reaches every branch (the deepest BatchNorms see 128 values a channel; a
JAX train step of these nets compiles for 4-7 s on the CPU, so each runs
one f32 and one AMP step compile): RegUNet with the stride-2 ``pool_conv``
encoder, ``concat_skip`` and ``extract_levels`` (0, 1) (one head resized,
one not); LocalNet with max-pools, additive skips and both levels
extracted (its kernel-7 first block); GlobalNet with max-pools.
Through ``tests/test_torch_batchnorm.py``'s helpers, tolerances as stated
there: eval and train forwards in f32 (relative L2 1e-5, JAX's own distance
from f64 allowed for), the running statistics a train forward leaves, the
first step's gradients in f32 (1e-4, JAX's f64 rule) and bf16 (no further
from JAX's f32 ones than 1.25 times JAX's bf16), two SGD steps (parameters
and ``batch_stats``), the AMP eval step (2e-2) and the dtype flow module by
module under AMP (the extraction mean is f32 when a head is resized).
GlobalNet's head has a zero kernel at init, so every encoder gradient would
be exactly zero there: its variables carry a non-zero head. Also
``warp_image`` in both modes (1e-6), GlobalNet's initialiser and its DDF at
init (exactly 0), the JAX ``.npz`` both ways, one run of the port's train
and predict CLIs with LocalNet at 16^3, and the CLIs' factory building each
of the slice's 14 names.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from unet3d_tpu.models import regunet as jax_regunet
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train import checkpoint as jax_ckpt

from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models import regunet
from unet3d_tpu_torch.models.layers import FastConv, init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (Net, bn_init, check_amp_eval_step, check_dtype_flow,
                                  check_forwards, check_grads, check_train_steps)
from test_torch_myronenko import _flat, _rel, _x

SHAPE = (2, 8, 8, 8, 2)
SMALL = dict(in_channels=2, num_channel_initial=2, depth=1)
NETS = {
    "RegUNet": dict(SMALL, out_channels=3, extract_levels=[0, 1], pooling=False,
                    concat_skip=True),
    "LocalNet": dict(SMALL, out_channels=3),
    "GlobalNet": dict(SMALL),
}


class _GlobalNet(Net):
    """``Net`` for GlobalNet: its DDF's three channels are the labels' (the
    train steps' DiceLoss on it), and the port's affine head is sized by
    ``image_size``."""

    def __init__(self, kwargs, shape, seed=0):
        self.name, self.kwargs = "GlobalNet", dict(kwargs)
        self.x = _x(*shape, seed=seed + 1)
        self.jmod = jax_create_model("GlobalNet", **kwargs)
        self.variables = bn_init(self.jmod, self.x, seed)
        self.flat = _flat(self.variables)
        rng = np.random.RandomState(seed + 3)
        self.batches = [(rng.randn(shape[0], shape[-1], *shape[1:4]).astype(np.float32),
                         (rng.rand(shape[0], 3, *shape[1:4]) > 0.5).astype(np.float32))
                        for _ in range(2)]

    def port(self):
        model = create_model("GlobalNet", **self.kwargs, image_size=self.x.shape[1:4])
        return load_jax_variables(model, self.flat, strict=True).eval()


@functools.lru_cache(maxsize=None)
def _net(name):
    if name == "GlobalNet":
        return _GlobalNet(NETS[name], SHAPE)
    return Net(name, NETS[name], SHAPE)


@pytest.mark.parametrize("name", sorted(NETS))
def test_forwards_match_jax(name):
    check_forwards(_net(name))


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_gradients_match_jax(name, amp):
    check_grads(_net(name), amp)


@pytest.mark.parametrize("name", sorted(NETS))
def test_train_steps_match_jax(name):
    check_train_steps(_net(name), 1)


@pytest.mark.parametrize("name", sorted(NETS))
def test_amp_eval_step_matches_jax(name):
    """f32 outputs in both: a resized head is f32 (the mean of the heads
    too), and GlobalNet's DDF is f32 (its grid)."""
    check_amp_eval_step(_net(name), torch.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_amp_dtype_flow_matches_jax(name, train):
    check_dtype_flow(_net(name), train)


def test_globalnet_gradients_are_not_vacuous():
    """With the head's kernel at its init (zero) every encoder gradient is
    exactly zero; the variables here carry a non-zero head, so the encoder's
    gradients are real."""
    n = _net("GlobalNet")
    assert np.abs(n.flat["params/affine_head/fc/kernel"]).max() > 0
    _, grads, _ = n.steps("jax", 1)
    assert np.abs(grads["encode_0.conv.conv.kernel"]).max() > 0


def test_globalnet_initialiser_and_zero_ddf_at_init():
    """``init_parameters`` gives the affine head JAX's zero kernel and
    identity bias, so the DDF at init is exactly 0; every other kernel is
    drawn."""
    jhead = jax_regunet.AffineHead()
    want = jhead.init(jax.random.PRNGKey(0), jnp.ones((1, 2, 2, 2, 4)))["params"]["fc"]
    model = create_model("GlobalNet", **NETS["GlobalNet"], image_size=SHAPE[1:4])
    init_parameters(model, torch.Generator().manual_seed(0))
    fc = model.affine_head.fc
    assert torch.equal(fc.kernel, torch.zeros_like(fc.kernel))
    np.testing.assert_array_equal(np.asarray(want["kernel"]), 0.0)
    np.testing.assert_array_equal(fc.bias.detach().numpy(), np.asarray(want["bias"]))
    assert model.encode_0.conv.conv.kernel.abs().max() > 0
    with torch.no_grad():
        ddf = model(torch.from_numpy(_x(*SHAPE, seed=4)))
    assert tuple(ddf.shape) == SHAPE[:4] + (3,)
    assert torch.equal(ddf, torch.zeros_like(ddf))


@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_warp_image_matches_jax(mode):
    image = _x(2, 8, 7, 6, 3, seed=5)
    ddf = 2.5 * _x(2, 8, 7, 6, 3, seed=6)  # reaches outside the volume: zeros
    want = jax.jit(lambda i, d: jax_regunet.warp_image(i, d, mode))(
        jnp.asarray(image), jnp.asarray(ddf))
    got = regunet.warp_image(torch.from_numpy(image), torch.from_numpy(ddf), mode)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-6
    zero = regunet.warp_image(torch.from_numpy(image), torch.zeros(2, 8, 7, 6, 3), mode)
    assert torch.equal(zero, torch.from_numpy(image))


def test_structure_matches_jax():
    """The default RegUNet's decoder runs no level (``extract_levels`` is
    ``(depth,)``); LocalNet overrides ``encode_kernel_sizes`` (7 at level 0)
    and extracts every level; the stride-2 encoder's convs are FastConvs.
    The same parameter trees as JAX's."""
    x = np.zeros((1, 8, 8, 8, 2), np.float32)
    for name, kwargs in (("RegUNet", dict(SMALL, depth=2)),
                         ("LocalNet", dict(SMALL, depth=2, encode_kernel_sizes=5)),
                         ("RegUNet", NETS["RegUNet"])):
        jmod = jax_create_model(name, **kwargs)
        tree = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        want = {"/".join(k): v.shape for k, v in flatten_dict(tree).items()}
        model = create_model(name, **kwargs)
        got = {k: tuple(np.shape(v)) for k, v in model_variables(model).items()}
        assert got == want, name
    assert not any(k.startswith("deconv") for k, _ in create_model(
        "RegUNet", **dict(SMALL, depth=2)).named_modules())
    local = create_model("LocalNet", **dict(SMALL, depth=2, encode_kernel_sizes=5))
    assert local.encode_0.conv.conv.kernel_size == (7, 7, 7)
    assert local.encode_1.conv.conv.kernel_size == (3, 3, 3)
    assert local.levels == (0, 1, 2)
    pool = create_model("RegUNet", **NETS["RegUNet"]).pool_conv_0
    assert isinstance(pool, FastConv) and pool.strides == (2, 2, 2)


def test_unsupported_inputs_raise():
    with pytest.raises(ValueError, match="image_size"):
        create_model("GlobalNet", **SMALL)
    model = create_model("GlobalNet", **SMALL, image_size=(8, 8, 8))
    with pytest.raises(ValueError, match="divisible"):
        model(torch.zeros(1, 8, 8, 7, 2))
    with pytest.raises(ValueError, match="image_size"):
        model(torch.zeros(1, 8, 8, 12, 2))
    for name in NETS:
        with pytest.raises(NotImplementedError):
            create_model(name, spatial_dims=2, image_size=(8, 8, 8)) if name == "GlobalNet" \
                else create_model(name, spatial_dims=2)


def test_jax_checkpoint_with_batch_stats_loads_strictly_both_ways(tmp_path):
    """LocalNet's JAX ``.npz`` (``params`` and ``batch_stats``) loads
    strictly into the port; the port's file loads strictly into JAX's tree
    with equal arrays."""
    n = _net("LocalNet")
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(n.variables, path)
    flat = load_checkpoint(path)
    assert any(k.startswith("batch_stats/") for k in flat)
    model = load_jax_variables(create_model("LocalNet", **NETS["LocalNet"]), flat, strict=True)
    out = str(tmp_path / "port.npz")
    save_checkpoint(model, out)
    loaded = jax_ckpt.load_into(n.variables, out, strict=True)
    assert set(loaded) == {"params", "batch_stats"}
    for key, value in _flat(loaded).items():
        np.testing.assert_array_equal(value, flat[key])


def test_train_and_predict_cli_with_localnet(tmp_path):
    """The port's train CLI trains LocalNet on the fixture cases at 16^3 (2
    epochs, f32, SGD): a ``model.npz`` of ``params`` and ``batch_stats``
    (the statistics moved) that reloads strictly; the predict CLI on it
    gives the train CLI's own test prediction, on the source grid in [0, 1]."""
    from test_torch_train_cli import FIXTURES, small_brats_config

    from unet3d_tpu.data import nifti as jax_nifti
    from unet3d_tpu_torch.scripts import predict, train
    root = str(tmp_path)
    config = small_brats_config(root, n_val=0)
    config["model"] = dict(NETS["LocalNet"], name="LocalNet")
    config_file = os.path.join(root, "localnet.json")
    json.dump(config, open(config_file, "w"))
    result = train.main(["--config_filename", config_file, "--output_dir",
                         os.path.join(root, "out")], device="cpu")
    saved = load_checkpoint(os.path.join(result["work_dir"], "model.npz"))
    assert {k.split("/")[0] for k in saved} == {"params", "batch_stats"}
    assert not np.array_equal(saved["batch_stats/encode_0/conv/bn/var"],
                              np.ones_like(saved["batch_stats/encode_0/conv/bn/var"]))
    load_jax_variables(create_model("LocalNet", **NETS["LocalNet"]), saved, strict=True)
    out = os.path.join(root, "predict")
    predict.main(["--config_filename", config_file, "--model_filename",
                  os.path.join(result["work_dir"], "model.npz"), "--output_directory", out,
                  "--group", "test", "--activation", "sigmoid"], device="cpu")
    got, _, _ = jax_nifti.load(os.path.join(out, "predictions", "test0_t1.nii.gz"))
    want, _, _ = jax_nifti.load(os.path.join(result["work_dir"], "test", "test0_t1.nii.gz"))
    source, _, _ = jax_nifti.load(os.path.join(FIXTURES, "case_t1.nii.gz"))
    assert got.shape == want.shape == source.shape + (3,)
    assert 0.0 <= got.min() and got.max() <= 1.0
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) < 1e-6


NEW_NAMES = {
    "AutoEncoder": dict(in_channels=2, out_channels=3, channels=[2, 4], strides=[2, 2]),
    "VarAutoEncoder": dict(in_shape=[2, 16, 16, 16], out_channels=3, channels=[2, 4],
                           strides=[2, 2]),
    "Regressor": dict(in_shape=[2, 16, 16, 16], channels=[2, 4], strides=[2, 2]),
    "Classifier": dict(in_shape=[2, 16, 16, 16], channels=[2, 4], strides=[2, 2]),
    "Discriminator": dict(in_shape=[2, 16, 16, 16], channels=[2, 4], strides=[2, 2]),
    "Critic": dict(in_shape=[2, 16, 16, 16], channels=[2, 4], strides=[2, 2]),
    "Generator": dict(latent_shape=[8], start_shape=[2, 2, 2, 2], channels=[2, 1],
                      strides=[2, 2]),
    "HighResNet": dict(in_channels=2, out_channels=3),
    "AHNet": dict(in_channels=2, out_channels=3, layers=[1, 1, 1, 1]),
    "AHnet": dict(in_channels=2, out_channels=3, layers=[1, 1, 1, 1]),
    "Ahnet": dict(in_channels=2, out_channels=3, layers=[1, 1, 1, 1]),
    "RegUNet": dict(SMALL, out_channels=3),
    "GlobalNet": dict(SMALL),
    "LocalNet": dict(SMALL, out_channels=3),
}


@pytest.mark.parametrize("name", sorted(NEW_NAMES))
def test_the_cli_factory_builds_every_new_name(name):
    """The CLIs' factory builds each of the 14 names from a config's model
    section, initialised (GlobalNet's and AHNet's ``image_size`` from the
    dataset's ``desired_shape``), and none is left in ``NOT_YET_PORTED``."""
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.models.registry import NOT_YET_PORTED
    config = {"model": dict(NEW_NAMES[name], name=name),
              "dataset": {"desired_shape": [16, 16, 16]}}
    model = build_or_load_model_from_config(config, None, torch.device("cpu"))
    assert name not in NOT_YET_PORTED
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if name == "GlobalNet":
        assert model.affine_head.fc.kernel.shape[0] == 4 * 8 ** 3  # 4 channels at (16 / 2)^3
    if name in ("AHNet", "AHnet", "Ahnet"):
        assert model.psp.up3.kernel.shape == (4, 4, 1, 1, 1)  # clamped: 16 / 4 in-plane

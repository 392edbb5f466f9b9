"""The port's VNet against the JAX package's, with the JAX variables
(``params`` and ``batch_stats``) carried across strictly.

VNet has fixed widths (16 to 256 channels, 5-cubed convs, four stride-2
levels), so it runs at its smallest input, 16^3, where its deepest
BatchNorms see one voxel an item. At batch 2 the f32 batch variance of two
values a channel is noise in both packages: against JAX's f64 evaluation
the training forward lies 3e-5 to 8e-5 from it in either, the first step's
gradients 7e-3 to 5e-2, either the nearer (tools/bn_f32_conditioning.py).
At batch 4 (four values) both lie ~2e-6 and 8e-6 to 2.5e-5 from it, so it
runs at batch 4. The same helpers as ``test_torch_monai_nets.py``:
forwards, statistics, gradients, two SGD steps, the AMP eval step and the
dtype flow. VNet drops its skips at 0.5 in every training forward, which
cannot match ``jax.random``: the exact path runs without dropout in both
packages, and the draws are held apart. JAX's ``"prelu"`` is
``leaky_relu(x, 0.25)``, and the port copies it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet3d_tpu.models import vnet as jax_vnet
from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.models import vnet
from unet3d_tpu_torch.models.registry import create_model

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (Net, check_amp_eval_step, check_dtype_flow, check_forwards,
                                  check_grads, check_train_steps)
from test_torch_monai_nets import check_dropout_draws
from test_torch_myronenko import _x

KWARGS = dict(in_channels=2, out_channels=3)
SHAPE = (4, 16, 16, 16, 2)


@functools.lru_cache(maxsize=None)
def _net():
    return Net("VNet", KWARGS, SHAPE)


def test_forwards_match_jax():
    check_forwards(_net())


def test_gradients_match_jax():
    check_grads(_net(), False)


def test_train_steps_match_jax():
    """Two SGD steps in one batch of 4. The microbatch path (2 microbatches
    carrying the statistics as JAX's scan does) is the steps' shared code,
    held on SegResNetDS, AttentionUnet and UNet: 2 microbatches of 2 would
    put VNet's deepest BatchNorms back at two values a channel (the
    parameters after two steps 1e-4 to 2e-3 from JAX's f64 steps in either
    package, tools/bn_f32_conditioning.py), and each of VNet's JAX train
    steps compiles for ~8 s on the CPU."""
    check_train_steps(_net(), 1)


def test_amp_eval_step_matches_jax():
    check_amp_eval_step(_net())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_dtype_flow_matches_jax(train):
    check_dtype_flow(_net(), train)


def test_dropout_draws():
    check_dropout_draws("VNet", KWARGS, (1,) + SHAPE[1:])


def test_activations_match_jax():
    x = np.concatenate([_x(64, seed=7), [0.0]]).astype(np.float32)
    for name in ("elu", "prelu", "relu"):
        np.testing.assert_allclose(vnet._act(name, torch.from_numpy(x)).numpy(),
                                   jax_vnet._act(name, jnp.asarray(x)), rtol=1e-6, atol=1e-7)
    assert vnet._act("prelu", torch.tensor([-1.0])).item() == -0.25  # leaky, not torch's PReLU


def test_input_channels_and_dims_checked_in_both():
    with pytest.raises(ValueError, match="dividing 16"):
        create_model("VNet", in_channels=3)
    model = jax_create_model("VNet", in_channels=3)
    with pytest.raises(ValueError, match="dividing 16"):
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 3))))
    with pytest.raises(NotImplementedError):
        create_model("VNet", spatial_dims=2)

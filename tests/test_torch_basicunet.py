"""The port's BasicUNet against the JAX package's, with the JAX variables
(every kernel, scale and bias seeded off its initial value from
``jax.eval_shape``'s tree, ``test_torch_batchnorm.bn_init``) carried across
strictly (BasicUNetPlusPlus, on the same blocks:
test_torch_basicunetplusplus.py).

Features (4, 4, 8, 8, 16, 4) at 20^3, batch 2: the sizes go 20 -> 10 -> 5
-> 2 -> 1 on the way down, so ``upcat_3``'s up-sampled 4^3 is edge-padded
to its skip's 5^3. Tolerances, relative L2, through
``tests/test_torch_batchnorm.py``'s helpers: eval forward 1e-5 in f32
(the training forward too), 2e-2 in bf16 (the AMP eval step, JAX's own bf16
distance allowed for); the first train step's gradients 1e-4 in f32,
against JAX and JAX's f64 evaluation with JAX's own error allowed for; bf16
gradients no further from JAX's f32 than 1.25x JAX's own; two SGD steps
through ``make_train_step`` 1e-5; every module's output dtype under AMP as
Flax's captured intermediates. Unit pins: the edge pad and the max-pool
(odd sizes floored, the gradient of a tie to the window's first maximum)
against JAX's; the dropout draws; the names and MONAI's default widths.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.models import basicunet as jax_basicunet
from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.models import basicunet
from unet3d_tpu_torch.models.registry import NOT_YET_PORTED, create_model

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (Net, check_amp_eval_step, check_dtype_flow, check_forwards,
                                  check_grads, check_train_steps)
from test_torch_monai_nets import check_dropout_draws
from test_torch_myronenko import _x

FEATURES = [4, 4, 8, 8, 16, 4]
KWARGS = dict(in_channels=2, out_channels=3, features=FEATURES)


@functools.lru_cache(maxsize=None)
def _net():
    return Net("BasicUNet", KWARGS, (2, 20, 20, 20, 2))


def test_forwards_match_jax():
    check_forwards(_net())


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_gradients_match_jax(amp):
    check_grads(_net(), amp)


def test_train_steps_match_jax():
    check_train_steps(_net(), 1)


def test_amp_eval_step_matches_jax():
    check_amp_eval_step(_net())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_dtype_flow_matches_jax(train):
    check_dtype_flow(_net(), train)


def test_pad_to_match_and_max_pool_match_jax():
    """Odd sizes: the pool floors them (5 -> 2), the up-sampled tensor is
    padded at the high side with its edge values; the pool's gradient of a
    tie goes to the window's first maximum in both."""
    x = _x(2, 5, 4, 3, 3, seed=3)
    ref = np.zeros((2, 7, 4, 5, 3), np.float32)
    np.testing.assert_array_equal(
        basicunet._pad_to_match(torch.from_numpy(x), torch.from_numpy(ref)).numpy(),
        np.asarray(jax.jit(jax_basicunet._pad_to_match)(jnp.asarray(x), jnp.asarray(ref))))
    v = np.round(_x(2, 5, 6, 7, 3, seed=4)).astype(np.float32)  # many ties
    g = _x(2, 2, 3, 3, 3, seed=5)
    want, (want_grad,) = jax.jit(lambda a, b: (lambda out, vjp: (out, vjp(b)))(
        *jax.vjp(jax_basicunet._max_pool2, a)))(jnp.asarray(v), jnp.asarray(g))
    vt = torch.from_numpy(v).requires_grad_(True)
    got = basicunet._max_pool2(vt)
    got.backward(torch.from_numpy(g))
    assert got.shape == (2, 2, 3, 3, 3) and got.is_contiguous()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(want_grad))


def test_dropout_draws():
    check_dropout_draws("BasicUNet", dict(KWARGS, dropout=0.3), (1, 16, 16, 16, 2))


def test_names_resolve_and_options_are_checked():
    for name in ("BasicUNet", "BasicUNetPlusPlus", "BasicUnetPlusPlus"):
        assert name not in NOT_YET_PORTED
        assert isinstance(create_model(name), torch.nn.Module)
        with pytest.raises(NotImplementedError):
            create_model(name, spatial_dims=2)
        jmod = jax_create_model(name, spatial_dims=2)
        with pytest.raises(NotImplementedError):
            jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1))))
    assert type(create_model("BasicUnetPlusPlus")).__name__ == "BasicUNetPlusPlus"
    # MONAI's default widths: the top up conv keeps features[1]
    model = create_model("BasicUNet", in_channels=4, out_channels=3, upsample="nontrainable")
    assert tuple(model.upcat_1.upsample.kernel.shape) == (2, 2, 2, 32, 32)
    assert tuple(model.upcat_2.upsample.kernel.shape) == (2, 2, 2, 64, 32)
    assert tuple(model.upcat_1.convs.conv_0.conv.kernel.shape) == (3, 3, 3, 64, 32)

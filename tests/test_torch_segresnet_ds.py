"""The port's SegResNetDS against the JAX package's, with the JAX variables
(``params`` and ``batch_stats``, every scale, bias and running statistic
moved off its initial value) carried across strictly.

A small net (init_filters 4, blocks_down (1, 1, 1), dsdepth 2: two heads,
so training returns the stack, the lower head trilinearly resized; batch
norm, relu; 16^3, batch 2) through ``tests/test_torch_batchnorm.py``'s
helpers: eval and train forwards in f32 (relative L2 1e-5, or JAX's own
distance from f64 allowed for) and bf16 AMP (2e-2), the running statistics
a train forward leaves, the gradients, two SGD steps of ``make_train_step``
in one batch and in 2 microbatches (parameters and ``batch_stats`` within
1e-5) and under AMP (2e-2), the AMP eval step on bf16 statistics, the dtype
flow under AMP module by module. Instance and group norm and leaky ReLU on
the forward path; the options JAX refuses raise in both.
"""
import functools

import pytest

import jax
import jax.numpy as jnp

from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.models.registry import create_model

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (Net, check_amp_eval_step, check_dtype_flow, check_forwards,
                                  check_grads, check_train_steps)

KWARGS = dict(init_filters=4, in_channels=2, out_channels=3, blocks_down=[1, 1, 1],
              dsdepth=2)
SHAPE = (2, 16, 16, 16, 2)


@functools.lru_cache(maxsize=None)
def _net(norm="batch", act="relu"):
    return Net("SegResNetDS", dict(KWARGS, norm=norm, act=act), SHAPE)


def test_forwards_match_jax():
    n = _net()
    check_forwards(n)
    stacked = jax.eval_shape(lambda: n.jmod.apply(n.variables, jnp.asarray(n.x), True,
                                                  mutable=["batch_stats"])[0])
    assert stacked.shape == (2, 2, 16, 16, 16, 3)  # two heads, full resolution first


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_gradients_match_jax(amp):
    check_grads(_net(), amp)


@pytest.mark.parametrize("grad_accum,amp", [(1, False), (2, False), (1, True)],
                         ids=["batch", "2_microbatches", "bf16"])
def test_train_steps_match_jax(grad_accum, amp):
    """The deep-supervision stack goes through the criterion's 1/2^i
    weighting in both packages."""
    check_train_steps(_net(), grad_accum, amp)


def test_amp_eval_step_matches_jax():
    check_amp_eval_step(_net())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_dtype_flow_matches_jax(train):
    check_dtype_flow(_net(), train)


@pytest.mark.parametrize("norm,act", [("instance", "relu"), ("group", "leakyrelu")])
def test_other_norms_and_leaky_relu_match_jax(norm, act):
    """Instance norm (no affine) and group norm (min(8, C) groups, here 4
    and 8 for 4 to 16 channels) have no statistics to carry."""
    check_forwards(_net(norm, act))


def test_unsupported_options_raise_in_both():
    for kwargs, error in ((dict(resolution=[1.0, 1.0, 2.0]), NotImplementedError),
                          (dict(upsample_mode="nontrainable"), NotImplementedError),
                          (dict(norm="layer"), NotImplementedError),
                          (dict(act="prelu"), NotImplementedError),
                          (dict(spatial_dims=2), NotImplementedError),
                          (dict(blocks_up=[1]), ValueError)):
        with pytest.raises(error):
            create_model("SegResNetDS", **dict(KWARGS, **kwargs))
        model = jax_create_model("SegResNetDS", **dict(KWARGS, **kwargs))
        with pytest.raises(error):
            jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 16, 16, 16, 2))))

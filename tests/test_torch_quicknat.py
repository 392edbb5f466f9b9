"""The port's Quicknat against the JAX package's, with the JAX variables
(``test_torch_batchnorm.bn_init``: every kernel, scale, bias and PReLU
slope off its initial value) carried across strictly.

8 filters on a volume of 2 slices of 64^2 (NDHWC (1, 2, 64, 64, 2): the
depth folds into the batch, so every instance norm takes its statistics per
slice), 3 classes. The bottleneck runs at 1 / 16 of the slice: at 16^2 its
instance norms see one pixel a channel (the output is the bias) and the
level above's see four, which amplify bf16 rounding so that either
package's bf16 output lies 5-9% from f32 (the port's, rounded op by op,
twice as far as JAX's jitted one on some seeds); at 64^2 (4^2 at the
bottleneck) the AMP eval step's rule below holds. Tolerances, relative L2, through
``tests/test_torch_batchnorm.py``'s helpers: eval forward 1e-5 in f32 (the
training forward too) with ``se_block`` "CSSE" (both gates and their max)
and on a 4-D NHWC input, 2e-2 in bf16 (the AMP eval step, JAX's own bf16
distance allowed for); the first train step's gradients 1e-4 in f32,
against JAX and JAX's f64 evaluation with JAX's own error allowed for; two
SGD steps through ``make_train_step`` 1e-5; every module's output dtype
under AMP as Flax's captured intermediates; each ``se_block`` value ("None",
"CSE", "SSE", "CSSE") in one dense block, forward and gradients (input
1e-5, parameters 1e-4). The bf16 gradients are not held here: at this size
either package's lie 14-40% from f32 (BasicUNet's and DiNTS's are held).
Unit pins: the pooling mask on a tie-heavy bf16 input (the first maximum
of each window in row-major order) and the unpool, exactly JAX's; Flax's
SAME at stride 2; the raises; the dropout draws.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.models import quicknat as jax_quicknat
from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models import quicknat
from unet3d_tpu_torch.models.registry import NOT_YET_PORTED, create_model

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (F32, Net, bn_init, check_amp_eval_step, check_dtype_flow,
                                  check_forwards, check_grads, check_train_steps)
from test_torch_monai_nets import check_dropout_draws
from test_torch_myronenko import _flat, _rel, _x

KWARGS = dict(num_classes=3, num_channels=2, num_filters=8)
SHAPE = (1, 2, 64, 64, 2)


@functools.lru_cache(maxsize=None)
def _net(se_block="CSSE"):
    return Net("Quicknat", dict(KWARGS, se_block=se_block), SHAPE)


def test_forwards_match_jax():
    check_forwards(_net())


@pytest.mark.parametrize("se_block", ["None", "CSE", "SSE", "CSSE"])
def test_dense_block_matches_jax(se_block):
    """``DenseBlock2D`` with each SE gate (the whole net runs "CSSE", both
    gates and their max): forward and the gradients of the input and every
    parameter, f32, on a batch of slices."""
    x = _x(2, 16, 16, 6, seed=5)
    jmod = jax_quicknat.DenseBlock2D(8, 5, se_block)
    variables = bn_init(jmod, x)
    g = _x(2, 16, 16, 8, seed=6)

    def loss(v, xx):
        return (jmod.apply(v, xx) * g).sum()

    want, (want_v, want_x) = jax.jit(jax.value_and_grad(loss, (0, 1)))(variables, x)
    model = quicknat.DenseBlock2D(6, 8, 5, se_block)
    load_jax_variables(model, _flat(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = (model(xt) * torch.from_numpy(g)).sum()
    got.backward()
    assert abs(got.detach().item() - float(want)) <= 1e-5 * abs(float(want))
    assert _rel(xt.grad.numpy(), want_x) < 1e-5
    # over all parameters at once: a conv bias before an instance norm has
    # a zero gradient, noise in both
    grads = _flat(want_v)
    keys = sorted(k for k, _ in model.named_parameters())
    ours = np.concatenate([model.get_parameter(k).grad.numpy().ravel() for k in keys])
    theirs = np.concatenate([grads["params/" + k.replace(".", "/")].ravel() for k in keys])
    assert _rel(ours, theirs) < 1e-4


def test_gradients_match_jax():
    check_grads(_net(), False)


def test_train_steps_match_jax():
    check_train_steps(_net(), 1)


def test_amp_eval_step_matches_jax():
    check_amp_eval_step(_net())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_dtype_flow_matches_jax(train):
    check_dtype_flow(_net(), train)


def test_slices_input_matches_jax():
    """A 4-D NHWC batch of slices is taken as it is: the 5-D net's variables
    on its input folded by hand give the same output in both."""
    n = _net()
    x = n.x.reshape(-1, *n.x.shape[2:])
    want = jax.jit(n.jmod.apply)(n.variables, jnp.asarray(x))
    with torch.no_grad():
        got = n.port()(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert _rel(got.numpy(), want) < F32
    np.testing.assert_allclose(got.numpy().reshape(n.jax_f32[0].shape), n.jax_f32[0],
                               rtol=1e-5, atol=1e-5)


def test_pool_mask_on_ties_matches_jax():
    """bf16 ties are common: the mask marks the first maximum of each 2x2
    window in row-major order (the ``cumsum == 1`` tiebreak), exactly as in
    JAX, and the unpool puts the pooled value there."""
    x = np.round(2 * _x(2, 8, 6, 5, seed=3)) / 2  # halves: most windows tie
    xb = torch.from_numpy(x).to(torch.bfloat16)
    pooled, mask = quicknat._pool_with_mask(xb, 2)
    want_pooled, want_mask = jax.jit(jax_quicknat._pool_with_mask, static_argnums=1)(
        jnp.asarray(x, jnp.bfloat16), 2)
    assert pooled.dtype == mask.dtype == torch.bfloat16
    np.testing.assert_array_equal(pooled.float().numpy(), np.asarray(want_pooled, np.float32))
    np.testing.assert_array_equal(mask.float().numpy(), np.asarray(want_mask, np.float32))
    windows = mask.float().reshape(2, 4, 2, 3, 2, 5).sum(dim=(2, 4))
    assert torch.equal(windows, torch.ones_like(windows))  # one marked voxel a window
    ties = (xb.reshape(2, 4, 2, 3, 2, 5) == pooled[:, :, None, :, None]).sum(dim=(2, 4))
    assert int((ties > 1).sum()) > 20
    up = quicknat._unpool(pooled, mask, 2)
    want_up = jax.jit(jax_quicknat._unpool, static_argnums=2)(want_pooled, want_mask, 2)
    np.testing.assert_array_equal(up.float().numpy(), np.asarray(want_up, np.float32))


def test_options_raise_in_both():
    x = np.zeros((1, 2, 24, 24, 2), np.float32)  # 24 is no multiple of 2**4
    model = create_model("Quicknat", **KWARGS)
    jmod = jax_create_model("Quicknat", **KWARGS)
    with pytest.raises(ValueError, match="pool"):
        model(torch.from_numpy(x))
    with pytest.raises(ValueError, match="pool"):
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    x = np.zeros(SHAPE, np.float32)
    with pytest.raises(NotImplementedError):
        create_model("Quicknat", **KWARGS, stride_pool=1)(torch.from_numpy(x))
    jmod = jax_create_model("Quicknat", **KWARGS, stride_pool=1)
    with pytest.raises(NotImplementedError):
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))


def test_names_and_widths():
    """Both names resolve; ``num_channels`` is the input width, taken at
    construction (Flax infers it), and the parameters are JAX's keys and
    shapes."""
    for name in ("Quicknat", "QuickNAT"):
        assert name not in NOT_YET_PORTED
        assert type(create_model(name)).__name__ == "Quicknat"
    n = _net()
    ours = {k: tuple(v.shape) for k, v in create_model("Quicknat", **n.kwargs).state_dict().items()}
    assert ours == {k.replace("/", ".")[len("params."):]: v.shape for k, v in n.flat.items()}
    assert ours["enc0.conv0.kernel"] == (5, 5, 2, 8)
    assert ours["dec0.conv2.kernel"] == (1, 1, 32, 8)


def test_dropout_draws():
    check_dropout_draws("Quicknat", dict(KWARGS, drop_out=0.3), SHAPE)


def test_kernel_c_and_stride_follow_flax_same():
    """The classifier with ``kernel_c`` 3 and stride 2 on 64^2 slices: Flax's
    (XLA's) SAME pads it (0, 1), the odd pad at the high side, not k // 2."""
    kwargs = dict(KWARGS, kernel_c=3, stride_conv=2)
    x = _x(*SHAPE, seed=4)
    jmod = jax_create_model("Quicknat", **kwargs)
    variables = bn_init(jmod, x)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    model = create_model("Quicknat", **kwargs)
    load_jax_variables(model, _flat(variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == want.shape == (1, 2, 32, 32, 3)
    assert _rel(got.numpy(), want) < F32

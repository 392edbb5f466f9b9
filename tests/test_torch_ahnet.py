"""The port's AHNet against the JAX package's, with the JAX variables
(``params`` and ``batch_stats``, every scale, bias and running statistic
moved off its initial value) carried across strictly.

A net of one bottleneck a stage (``layers`` (1, 1, 1, 1), the full widths:
64 to 2048 channels) on (2, 64, 64, 4, 2) inputs: the deepest BatchNorms
see 16 values a channel, the PSP pools by 2 to 16 reach a 1 x 1 in-plane
map. Through ``tests/test_torch_batchnorm.py``'s helpers, tolerances as
stated there: in "transpose" mode the eval and train forwards in f32
(relative L2 1e-5, JAX's own distance from f64 allowed for), the running
statistics a train forward leaves, the first step's gradients in f32 (1e-4,
JAX's f64 rule: JAX's own f32 gradients lie 2.3e-3 from its f64 ones here,
the port's 1.1e-4) and bf16 (no further from JAX's f32 ones than 1.25
times JAX's bf16), two SGD steps, the AMP eval step (2e-2) and the dtype
flow module by module under AMP; in "trilinear" and "nearest" mode the eval
forward in f32 and bf16, and in "trilinear" the dtype flow (the resize in
the input's dtype). A JAX train step of this net compiles for ~10 s on the CPU, so the
gradients are taken once, in "transpose" mode. Unit pins: the (1, 1, 3) through-plane max-pool's and the
stem pool's gradients on a tie-heavy bf16 input against XLA's (exact:
integer cotangents), the anisotropic subpixel up-samples against Flax's
``nn.ConvTranspose`` (SAME, kernel = stride), the PSP clamp at a 32 x 32
in-plane input (``image_size``), and JAX's raises.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from unet3d_tpu.models import ahnet as jax_ahnet
from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models import ahnet
from unet3d_tpu_torch.models.layers import SubpixelConvTranspose, max_pool
from unet3d_tpu_torch.models.registry import create_model

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (BF16, COMPILE, F32, Net, bn_init, check_amp_eval_step,
                                  check_dtype_flow, check_forwards, check_grads,
                                  check_train_steps)
from test_torch_myronenko import _cast, _flat, _rel, _x

KWARGS = dict(layers=[1, 1, 1, 1], in_channels=2, out_channels=3)
SHAPE = (2, 64, 64, 4, 2)


@functools.lru_cache(maxsize=None)
def _net():
    return Net("AHNet", KWARGS, SHAPE)


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


@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_resize_modes_match_jax(mode):
    """The eval forward in the resize modes (the FCN decoder's, the PSP's
    and the last up-sample by ``jax.image.resize``), in f32 (1e-5) and on
    bf16 copies of the variables (the AMP eval forward: bf16 output, within
    2e-2 of JAX's f32 or no further from it than 1.25 times JAX's bf16),
    one JAX compile for both; the output dtypes and, for "trilinear" (where
    the resize's f32 weights meet a bf16 input), the module dtypes under AMP
    as JAX's."""
    n = Net("AHNet", dict(KWARGS, upsample_mode=mode), SHAPE)
    both = jax.jit(lambda v, a: (n.jmod.apply(v, a), n.jmod.apply(
        _cast(v), a.astype(jnp.bfloat16))), compiler_options=COMPILE)
    want, want_bf16 = both(n.fresh(), jnp.asarray(n.x))
    assert want_bf16.dtype == jnp.bfloat16
    model = n.port()
    with torch.no_grad():
        assert _rel(model(torch.from_numpy(n.x)).numpy(), want) < F32
        got = copy.deepcopy(model).to(torch.bfloat16)(torch.from_numpy(n.x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want_bf16 = np.asarray(want_bf16.astype(jnp.float32))
    assert _rel(got.float().numpy(), want) <= max(BF16, 1.25 * _rel(want_bf16, want))
    if mode == "trilinear":
        check_dtype_flow(n, False)


@pytest.mark.parametrize("window,strides,padding", [
    ((1, 1, 3), (1, 1, 1), (0, 0, 1)),   # Bottleneck3x3x1's through-plane branch
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),   # the stem pool
])
def test_max_pool_gradient_on_ties_matches_xla(window, strides, padding):
    """bf16 values from a handful of levels (ties in most windows): the
    forward and the gradient (each window's first maximum takes it) equal
    XLA's, the through-plane branch with its sum ``x + pool(x)``."""
    rng = np.random.RandomState(7)
    x = rng.randint(-2, 3, size=(2, 6, 5, 6, 3)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    pads = tuple((p, p) for p in padding)

    def f(v):
        y = jax_ahnet._max_pool(v, window, strides, pads)
        return y + v if strides == (1, 1, 1) else y

    out_shape = jax.eval_shape(f, xj).shape
    g = rng.randint(-3, 4, size=out_shape).astype(np.float32)
    # one compile: an eager VJP dispatches op by op
    want, want_dx = jax.jit(lambda v, c: (f(v), jax.vjp(f, v)[1](c)[0]))(
        xj, jnp.asarray(g).astype(jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = max_pool(xt, window, strides, padding)
    y = y + xt if strides == (1, 1, 1) else y
    y.backward(torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(y.detach().float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want_dx, np.float32))


@pytest.mark.parametrize("scale", [(2, 2, 1), (4, 4, 1), (4, 4, 2)])
def test_anisotropic_subpixel_upsample_matches_flax(scale):
    """Flax's ``nn.ConvTranspose`` with kernel = stride and SAME padding is
    the subpixel form with its taps flipped, per axis, with a bias."""
    x = _x(2, 3, 4, 2, 5, seed=2)
    jmod = fnn.ConvTranspose(4, kernel_size=scale, strides=scale)
    kernel = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))[
        "params"]["kernel"]
    variables = {"params": {"kernel": jnp.asarray(_x(*kernel.shape, seed=4)),
                            "bias": jnp.asarray(_x(4, seed=3))}}
    up = SubpixelConvTranspose(5, 4, scale)
    load_jax_variables(up, _flat(variables), strict=True)
    with torch.no_grad():
        got = up(torch.from_numpy(x))
    assert _rel(got.numpy(), jax.jit(jmod.apply)(variables, jnp.asarray(x))) < F32


def test_psp_clamps_to_the_feature_extent():
    """At 32 x 32 in-plane the features are 8 x 8, so the deepest PSP level
    pools (and up-samples) by 8, not 16: built with ``image_size`` the port
    takes JAX's clamped kernels and matches it; built without, it raises."""
    x = _x(1, 32, 32, 4, 2, seed=5)
    jmod = jax_create_model("AHNet", **KWARGS)
    variables = bn_init(jmod, x)
    assert variables["params"]["psp"]["up3"]["kernel"].shape == (8, 8, 1, 1, 1)
    model = create_model("AHNet", **KWARGS, image_size=(32, 32, 4))
    load_jax_variables(model, _flat(variables), strict=True)
    want = jax.jit(lambda v, a: jmod.apply(v, a))(variables, jnp.asarray(x))
    with torch.no_grad():
        assert _rel(model(torch.from_numpy(x)).numpy(), want) < F32
    unclamped = create_model("AHNet", **KWARGS)
    assert unclamped.psp.up3.kernel.shape == (16, 16, 1, 1, 1)
    with pytest.raises(ValueError, match="image_size"):
        unclamped(torch.from_numpy(x))


def test_raises_match_jax():
    for kwargs, error in ((dict(pretrained=True), NotImplementedError),
                          (dict(psp_block_num=5), ValueError),
                          (dict(spatial_dims=2), NotImplementedError)):
        with pytest.raises(error):
            create_model("AHNet", **kwargs)
        jmod = jax_create_model("AHNet", **kwargs)
        with pytest.raises(error):
            jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4, 1))))
    model = create_model("AHNet", layers=[1, 1, 1, 1])
    jmod = jax_create_model("AHNet", layers=[1, 1, 1, 1])
    for shape in ((1, 48, 64, 4, 1), (1, 64, 64, 3, 1)):
        with pytest.raises(ValueError, match="divisible"):
            model(torch.zeros(shape))
        with pytest.raises(ValueError, match="divisible"):
            jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros(shape)))
    for alias in ("AHnet", "Ahnet"):
        assert type(create_model(alias, layers=[1, 1, 1, 1])) is ahnet.AHNet

"""The port's AttentionUnet and MONAI UNet against the JAX package's, with
the JAX variables (``params`` and ``batch_stats``, every scale, bias, PReLU
slope and running statistic moved off its initial value) carried across
strictly (VNet: test_torch_vnet.py).

Small nets at 16^3, batch 2: AttentionUnet with channels (4, 8, 8) and
strides (2, 2); UNet with channels (4, 8, 8), strides (2, 2), 2 residual
units and batch norm. Through ``tests/test_torch_batchnorm.py``'s helpers:
eval and train forwards in f32 (relative L2 1e-5, JAX's own distance from
f64 allowed for), the running statistics a train forward leaves, the
gradients in f32 and bf16, two SGD steps of ``make_train_step`` in one
batch and in 2 microbatches (parameters and ``batch_stats`` within 1e-5),
the AMP eval step on bf16 statistics (2e-2, JAX's own bf16 distance allowed
for), the dtype flow under AMP. The nets' dropout cannot match
``jax.random``: the exact paths run without it (rate 0), and the draws are
held apart. Also UNet with instance norm and plain convolutions (the top
up-conv conv only) under each activation, the dilated ``Convolution`` and
``ResidualUnit`` (Flax's ``nn.Conv`` through cuDNN), and PReLU.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.models import monai_unet as jax_monai_unet
from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models import monai_unet
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (F32, Net, bn_init, check_amp_eval_step, check_dtype_flow,
                                  check_forwards, check_grads, check_train_steps)
from test_torch_myronenko import _flat, _rel, _x

SHAPE = (2, 16, 16, 16, 2)
NETS = {
    "AttentionUnet": dict(in_channels=2, out_channels=3, channels=[4, 8, 8], strides=[2, 2]),
    "UNet": dict(in_channels=2, out_channels=3, channels=[4, 8, 8], strides=[2, 2],
                 num_res_units=2, norm="batch"),
}


@functools.lru_cache(maxsize=None)
def _net(name, **extra):
    return Net(name, dict(NETS.get(name, {}), **extra), SHAPE)


@pytest.mark.parametrize("name", sorted(NETS))
def test_forwards_match_jax(name):
    check_forwards(_net(name))


@pytest.mark.parametrize("name", sorted(NETS))
def test_gradients_match_jax(name):
    check_grads(_net(name), False)


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["batch", "2_microbatches"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_train_steps_match_jax(name, grad_accum):
    check_train_steps(_net(name), grad_accum)


@pytest.mark.parametrize("name", sorted(NETS))
def test_amp_eval_step_matches_jax(name):
    check_amp_eval_step(_net(name))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_amp_dtype_flow_matches_jax(name, train):
    check_dtype_flow(_net(name), train)


@pytest.mark.parametrize("act", ["prelu", "leakyrelu", "relu"])
def test_unet_instance_norm_matches_jax(act):
    """MONAI's defaults: instance norm without affine, plain Convolutions
    (the top up-conv conv only), here with each activation."""
    check_forwards(Net("UNet", dict(NETS["UNet"], norm="instance", num_res_units=0, act=act),
                       SHAPE))


@pytest.mark.parametrize("unit", ["Convolution", "ResidualUnit"])
def test_dilated_units_match_jax(unit):
    """The dilated branch (Flax's ``nn.Conv`` with pads (k - 1) // 2 *
    dilation; cuDNN in the port), batch norm: eval and train forwards and
    the kernel's gradient."""
    kwargs = dict(features=4, strides=2, dilation=2, norm="batch")
    x = _x(2, 9, 9, 9, 3, seed=4)
    jmod = getattr(jax_monai_unet, unit)(**kwargs)
    variables = bn_init(jmod, x)
    tmod = getattr(monai_unet, unit)(3, **kwargs)
    load_jax_variables(tmod, _flat(variables), strict=True)
    want = jmod.apply(variables, jnp.asarray(x))
    train, _ = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    g = np.random.RandomState(6).randn(*want.shape).astype(np.float32)
    grad = jax.grad(lambda p: (jmod.apply({**variables, "params": p}, jnp.asarray(x), True,
                                          mutable=["batch_stats"])[0] * g).sum())(
        variables["params"])
    with torch.no_grad():
        assert _rel(tmod(torch.from_numpy(x)).numpy(), want) < F32
    out = tmod(torch.from_numpy(x), train=True)
    assert _rel(out.detach().numpy(), train) < F32
    (out * torch.from_numpy(g)).sum().backward()
    kernel = tmod.conv.kernel if unit == "Convolution" else tmod.conv0.kernel
    name = "conv" if unit == "Convolution" else "conv0"
    assert _rel(kernel.grad.numpy(), grad[name]["kernel"]) < 1e-4


def test_prelu_matches_jax():
    x = np.concatenate([_x(64, seed=7), [0.0]]).astype(np.float32)
    prelu = monai_unet.PReLU()
    init_parameters(prelu, torch.Generator())
    assert prelu.alpha.item() == 0.25
    with torch.no_grad():
        prelu.alpha.fill_(0.3)
    jprelu = jax_monai_unet.PReLU()
    want = jprelu.apply({"params": {"alpha": jnp.asarray([0.3])}}, jnp.asarray(x))
    grad = jax.grad(lambda v: jprelu.apply(
        {"params": {"alpha": jnp.asarray([0.3])}}, v).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    prelu(xt).sum().backward()
    np.testing.assert_allclose(prelu(torch.from_numpy(x)).detach().numpy(), want)
    np.testing.assert_allclose(xt.grad.numpy(), grad)  # derivative 1 at 0, as in JAX


def check_dropout_draws(name, kwargs, shape=SHAPE):
    """The dropout masks come from the forward's generator: the same under
    one seed, others under another, none in eval; training without a
    generator raises."""
    model = create_model(name, **kwargs)
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(*shape, seed=8))

    def run(seed):
        with torch.no_grad():
            return model(x, train=True, rng=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        assert torch.equal(model(x), model(x))
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)


@pytest.mark.parametrize("name", sorted(NETS))
def test_dropout_draws(name):
    check_dropout_draws(name, dict(NETS[name], dropout=0.3))


def test_elementwise_and_channel_dropout_draws():
    from unet3d_tpu_torch.models.layers import channel_dropout, dropout
    x = torch.ones(2, 8, 8, 8, 16)
    kept = dropout(x, 0.3, True, torch.Generator().manual_seed(0))
    share = float((kept != 0).float().mean())
    assert abs(share - 0.7) < 0.02 and torch.allclose(kept[kept != 0], torch.tensor(1 / 0.7))
    channels = channel_dropout(x, 0.5, True, torch.Generator().manual_seed(0))
    per_channel = (channels != 0).float().mean(dim=(1, 2, 3))
    assert set(per_channel.flatten().tolist()) <= {0.0, 1.0}


def test_unsupported_options_raise_in_both():
    for name in NETS:
        with pytest.raises(NotImplementedError):
            create_model(name, spatial_dims=2)
    with pytest.raises(ValueError, match="len\\(strides\\)"):
        create_model("UNet", channels=[4, 8, 16], strides=[2])
    model = jax_create_model("UNet", channels=[4, 8, 16], strides=[2])
    with pytest.raises(ValueError, match="len\\(strides\\)"):
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1))))

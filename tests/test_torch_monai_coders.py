"""The port's MONAI AutoEncoder, VarAutoEncoder and the Regressor /
Classifier / Discriminator / Critic / Generator heads against the JAX
package's, with the JAX parameters (every PReLU slope and bias moved off its
initial value, ``bn_init``) carried across strictly.

Small nets on (2, 8, 8, 8, 2) inputs (the instance norms of the deepest
stage see 8 values a channel), channels (2, 4), strides (2, 2): the
autoencoders with 2 residual units and a dilation-1 and a dilation-2
intermediate stage (Flax's ``nn.Conv`` through cuDNN), and without residual
units with one dilation-2 stage and batch norm; the heads with 2 residual
units (Regressor, out_shape (2, 3); Discriminator, Critic) and without
(Classifier with a softmax); the Generator from a 6-element latent. Through
``tests/test_torch_myronenko.py``'s helpers, for each of them: eval forwards
in f32 (relative L2 1e-5) and bf16 AMP (2e-2), gradients of ``sum(out *
g)`` w.r.t. every parameter and the input on the eval path (the dropout of
Discriminator and Critic off) in f32 (1e-4, or JAX's own distance from the
f64 result where it is larger) and bf16 (no further from JAX's f32 ones
than 1.25 times JAX's bf16). VarAutoEncoder is held on its eval path (``z =
mu``, its gradients with ``mu`` and ``logvar`` in the objective); its
draws and the heads' dropout draws are held apart. The Generator's bf16
gradients are held against JAX's without XLA's excess precision (see
``test_gradients_match_jax``). Also the NDHWC flatten of ``mu`` /
``logvar`` / ``final``, the Generator's channel-first reshape, and MONAI's
defaults.
"""
import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models import monai_heads
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
import test_torch_myronenko
from test_torch_batchnorm import Net, bn_init, check_forwards, check_grads
from test_torch_monai_nets import check_dropout_draws
from test_torch_myronenko import BF16, _check_forward, _check_grads, _flat, _x

X = (2, 8, 8, 8, 2)
CODER = dict(channels=[2, 4], strides=[2, 2], num_res_units=2, inter_channels=[4, 4],
             inter_dilations=[1, 2])
HEAD = dict(in_shape=[2, 8, 8, 8], channels=[2, 4], strides=[2, 2])
NETS = {
    "AutoEncoder": (dict(CODER, in_channels=2, out_channels=3), X),
    "VarAutoEncoder": (dict(CODER, in_shape=[2, 8, 8, 8], out_channels=3, latent_size=5), X),
    "Regressor": (dict(HEAD, out_shape=[2, 3]), X),
    "Classifier": (dict(HEAD, classes=3, num_res_units=0, last_act="softmax"), X),
    "Discriminator": (dict(HEAD), X),
    "Critic": (dict(HEAD), X),
    "Generator": (dict(latent_shape=[6], start_shape=[4, 2, 2, 2], channels=[4, 2],
                       strides=[2, 2]), (2, 6)),
}
GRAD_NETS = tuple(sorted(NETS))


@functools.lru_cache(maxsize=None)
def _case(name):
    kwargs, shape = NETS[name]
    x = _x(*shape, seed=1)
    jmod = jax_create_model(name, **kwargs)
    variables = bn_init(jmod, x)
    model = load_jax_variables(create_model(name, **kwargs), _flat(variables), strict=True)
    return jmod, model.eval(), variables, x


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_eval_forward_matches_jax(name, amp):
    """Every output (VarAutoEncoder's recon, mu, logvar and z) in the JAX
    dtype; the variables both ways."""
    jmod, model, variables, x = _case(name)
    ours = model_variables(model)
    assert set(ours) == set(_flat(variables))
    _check_forward(jmod, model, variables, x, BF16 if amp else 1e-5, amp=amp)


def _vae_objective(out, g, scalar_extra, to_f32):
    """``sum(recon * g)`` plus the sums of ``mu`` and ``logvar`` (on the
    eval path ``logvar`` reaches no other output)."""
    return (to_f32(out[0]) * g).sum() + (0.3 * to_f32(out[1]) + 0.7 * to_f32(out[2])).sum()


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", GRAD_NETS)
def test_gradients_match_jax(name, amp):
    """The Generator's bf16 gradients are held against JAX's compiled
    without XLA's excess precision (``xla_allow_excess_precision`` off:
    every op's result rounded to bf16, as the port's eager ops round it).
    With it on, XLA keeps f32 across the fused elementwise chains of the
    instance norms' and PReLUs' backward, and its bf16 gradients lie
    1.3-2.2% from the f32 ones where the port's lie 1.9-3.3% and JAX's
    without it 4.3-6.7% (six draws of ``g``); the other nets' lie alike in
    both packages."""
    jmod, model, variables, x = _case(name)
    with contextlib.ExitStack() as stack:
        if name == "VarAutoEncoder":
            stack.enter_context(mock.patch.object(test_torch_myronenko, "_objective",
                                                  _vae_objective))
        if name == "Generator" and amp:
            jit = functools.partial(jax.jit, compiler_options={
                "xla_allow_excess_precision": False})
            stack.enter_context(mock.patch.object(test_torch_myronenko.jax, "jit", jit))
        _check_grads(jmod, model, variables, x, amp)


def test_batch_norm_autoencoder_matches_jax():
    """No residual units (the last decode stage a bare transposed conv), one
    dilation-2 stage, batch norm: forwards, running statistics and f32
    gradients through the train step."""
    n = Net("AutoEncoder", dict(in_channels=2, out_channels=3, channels=[2, 4], strides=[2, 2],
                                inter_channels=[4], inter_dilations=[2], norm="batch"), X)
    check_forwards(n)
    check_grads(n, False)


def test_flatten_is_ndhwc():
    """``mu`` and ``final`` read the encoding flattened over NDHWC: the
    same output as a Dense on the NDHWC tensor's reshape, not on its NCDHW
    view's."""
    for name, dense in (("VarAutoEncoder", "mu"), ("Regressor", "final")):
        _, model, _, x = _case(name)
        seen = {}
        layer = getattr(model, dense)
        hook = layer.register_forward_hook(lambda m, a, o: seen.update(x=a[0]))
        stages = {"VarAutoEncoder": lambda v: model._encode(v, False, None),
                  "Regressor": lambda v: model.layer_1(model.layer_0(v))}[name]
        with torch.no_grad():
            model(torch.from_numpy(x))
            enc = stages(torch.from_numpy(x))
        hook.remove()
        assert torch.equal(seen["x"], enc.reshape(2, -1))
        assert not torch.equal(seen["x"], enc.permute(0, 4, 1, 2, 3).reshape(2, -1))


def test_generator_reshapes_channel_first():
    """The Dense's output is read as (N, C, D, H, W) and moved to NDHWC, as
    the JAX module does; a channel-last reading gives other values."""
    _, model, _, x = _case("Generator")
    seen = {}
    hook = model.conv_0.register_forward_hook(lambda m, a, o: seen.update(x=a[0]))
    with torch.no_grad():
        model(torch.from_numpy(x))
        dense = model.linear(torch.from_numpy(x))
    hook.remove()
    want = dense.reshape(2, 4, 2, 2, 2).permute(0, 2, 3, 4, 1)
    assert torch.equal(seen["x"], want)
    assert not torch.equal(seen["x"], dense.reshape(2, 2, 2, 2, 4))


def test_var_autoencoder_draws():
    """In training ``z = mu + eps * exp(logvar / 2)`` with ``eps`` from the
    forward's generator: the same under one seed, others under another,
    standard normal moments; in eval ``z = mu``; training without a
    generator raises."""
    model = create_model("VarAutoEncoder", **dict(NETS["VarAutoEncoder"][0], latent_size=64))
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(64, 8, 8, 8, 2, seed=3))

    def run(seed):
        with torch.no_grad():
            return model(x, train=True, rng=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[3], c[3])
    _, mu, logvar, z = a
    eps = ((z - mu) / torch.exp(0.5 * logvar)).double()
    assert abs(float(eps.mean())) < 0.05 and abs(float(eps.std()) - 1.0) < 0.05
    with torch.no_grad():
        _, mu_eval, _, z_eval = model(x)
    assert torch.equal(z_eval, mu_eval) and torch.equal(mu_eval, mu)
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)


@pytest.mark.parametrize("name", ["Discriminator", "Critic", "AutoEncoder"])
def test_dropout_draws(name):
    kwargs, shape = NETS[name]
    check_dropout_draws(name, dict(kwargs, dropout=0.25), shape)


def test_defaults_match_jax():
    """MONAI's defaults: Discriminator and Critic drop at 0.25, the
    Discriminator's one unit through a sigmoid; Classifier replaces
    ``out_shape``; every head's parameter tree at its defaults is JAX's."""
    x = np.zeros((1, 32, 32, 32, 1), np.float32)
    for name in ("Regressor", "Classifier", "Discriminator", "Critic", "Generator",
                 "AutoEncoder", "VarAutoEncoder"):
        jmod = jax_create_model(name)
        xin = np.zeros((1, 64), np.float32) if name == "Generator" else x
        tree = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(xin)))
        want = {"/".join(k): v.shape for k, v in flatten_dict(tree).items()}
        got = {k: tuple(np.shape(v)) for k, v in model_variables(create_model(name)).items()}
        assert got == want, name
    disc, critic = create_model("Discriminator"), create_model("Critic")
    assert disc.last_act == "sigmoid" and critic.last_act is None
    assert disc.layer_0.dropout == critic.layer_0.dropout == 0.25
    assert create_model("Classifier", classes=4, out_shape=[7]).out_shape == (4,)
    with pytest.raises(KeyError):
        monai_heads.Regressor(last_act="gelu")
    with pytest.raises(NotImplementedError):
        create_model("AutoEncoder", spatial_dims=2)

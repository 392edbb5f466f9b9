"""Gradients of the rest of the Myronenko family against the JAX package:
AutoImplantUNet, ConvolutionalAutoEncoder and LabeledVariationalAutoEncoder
(f32 and bf16 AMP), and AutocastUNet against the port's UNet3D (the same
net under another name in both packages), with the JAX parameters carried
across by ``convert.load_jax_variables``.

The helpers and tolerances are ``tests/test_torch_myronenko.py``'s
``_check_grads``: f32 within 1e-4 of JAX and of an f64 evaluation (JAX's
own f32 error allowed for where it is larger), bf16 no further from JAX's
f32 gradients than 1.25 times JAX's own bf16 ones.
"""
import functools

import pytest
import torch
from torch.func import functional_call

from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model

from test_torch_myronenko import S, _check_grads, _init, _port, _x

MODELS = {
    "AutoImplantUNet": dict(n_features=2, base_width=8, encoder_blocks=[1, 2], n_outputs=2),
    "ConvolutionalAutoEncoder": dict(n_features=2, base_width=8, encoder_blocks=[1, 2],
                                     decoder_mirrors_encoder=True, activation="sigmoid"),
    "LabeledVariationalAutoEncoder": dict(
        n_features=2, base_width=8, encoder_blocks=[1, 2], input_shape=[S, S, S],
        n_reduced_latent_feature_maps=4, vae_features=8, n_outputs=3,
        decoder_mirrors_encoder=True),
}


@functools.lru_cache(maxsize=None)
def _jax(name):
    x = _x(2, S, S, S, 2, seed=11)
    jmod = jax_create_model(name, **MODELS[name])
    return jmod, _init(jmod, x), x


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_gradients_match_jax(name, amp):
    jmod, variables, x = _jax(name)
    _check_grads(jmod, _port(create_model(name, **MODELS[name]), variables), variables,
                 x, amp)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_autocast_unet_gradients_equal_unet3d(amp):
    """AutocastUNet is UNet3D (the train step's AMP sets the precision):
    the same parameters give bit-equal gradients."""
    kwargs = dict(n_features=2, base_width=8, encoder_blocks=[1, 2], n_outputs=3)
    unet = create_model("UNet3D", **kwargs)
    init_parameters(unet, torch.Generator().manual_seed(0))
    autocast = create_model("AutocastUNet", **kwargs)
    autocast.load_state_dict(unet.state_dict())
    x = torch.from_numpy(_x(1, 8, 8, 8, 2, seed=12))
    grads = []
    for net in (unet, autocast):
        names, params = zip(*net.named_parameters())
        p = {n: (t.to(torch.bfloat16) if amp else t) for n, t in zip(names, params)}
        out = functional_call(net, p, (x.to(torch.bfloat16) if amp else x,))
        grads.append(torch.autograd.grad(out.float().square().sum(), params))
    assert all(torch.equal(a, b) for a, b in zip(*grads))

"""The port's autoencoders (ConvolutionalAutoEncoder, VariationalAutoEncoder,
LabeledVariationalAutoEncoder) and their variational layer against the JAX
package, with the JAX parameters carried across by
``convert.load_jax_variables``.

The helpers and tolerances are ``tests/test_torch_myronenko.py``'s:
relative L2 1e-5 on an f32 forward, 1e-4 on f32 gradients (against JAX and
an f64 evaluation, ``_check_grads``), 2e-2 on a bf16 AMP forward, bf16
gradients as ``_check_grads`` states. Training samples the latent and drops
channels in the encoder, which cannot match ``jax.random``: parity holds the
eval path (it decodes mu), and separate tests hold the draws.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.models import variational
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model

from test_torch_myronenko import (BF16, S, _check_forward, _check_grads, _init, _port,
                                  _x)

VAE_KWARGS = dict(n_features=2, base_width=8, encoder_blocks=[1, 2], input_shape=[S, S, S],
                  n_reduced_latent_feature_maps=4, vae_features=8)


def test_convolutional_autoencoder_matches_jax():
    """The Myronenko decoder (it upsamples at every level: out = 2 x in);
    sigmoid. The mirrored decoder: test_labeled_vae_matches_jax."""
    kwargs = dict(n_features=2, base_width=8, encoder_blocks=[1, 2],
                  activation="sigmoid")
    x = _x(2, S, S, S, 2, seed=6)
    jmod = jax_create_model("ConvolutionalAutoEncoder", **kwargs)
    variables = _init(jmod, x)
    tmod = _port(create_model("ConvolutionalAutoEncoder", **kwargs), variables)
    _, got = _check_forward(jmod, tmod, variables, x)
    assert tuple(got.shape) == (2,) + (2 * S,) * 3 + (2,)


@pytest.fixture(scope="module")
def vae():
    x = _x(2, S, S, S, 2, seed=7)
    jmod = jax_create_model("VariationalAutoEncoder", **VAE_KWARGS)
    variables = _init(jmod, x)
    return jmod, variables, x


def test_vae_forward_matches_jax(vae):
    """Eval decodes mu: (out, mu, logvar) as in JAX, f32 and bf16."""
    jmod, variables, x = vae
    tmod = _port(create_model("VariationalAutoEncoder", **VAE_KWARGS), variables)
    _, got = _check_forward(jmod, tmod, variables, x)
    assert len(got) == 3 and tuple(got[1].shape) == tuple(got[2].shape) == (2, 8)
    _check_forward(jmod, tmod, variables, x, bound=BF16, amp=True)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_vae_gradients_match_jax(vae, amp):
    jmod, variables, x = vae
    tmod = _port(create_model("VariationalAutoEncoder", **VAE_KWARGS), variables)
    _check_grads(jmod, tmod, variables, x, amp)


def test_labeled_vae_matches_jax():
    """The segmentation head, the mirrored decoder: the input's size."""
    kwargs = dict(VAE_KWARGS, n_outputs=3, decoder_mirrors_encoder=True)
    x = _x(2, S, S, S, 2, seed=8)
    jmod = jax_create_model("LabeledVariationalAutoEncoder", **kwargs)
    variables = _init(jmod, x)
    tmod = _port(create_model("LabeledVariationalAutoEncoder", **kwargs), variables)
    _, got = _check_forward(jmod, tmod, variables, x)
    assert tuple(got[0].shape) == (2, S, S, S, 3)


def test_vae_sampling_draws_from_the_generator(vae):
    """Training samples the latent (and drops channels) from the generator:
    the same under one seed, another under another; sample=False decodes mu
    in training too; without a generator, training raises."""
    _, variables, x = vae
    tmod = _port(create_model("VariationalAutoEncoder", **VAE_KWARGS), variables)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        runs = [tmod(xt, train=True, rng=torch.Generator().manual_seed(s))[0]
                for s in (0, 0, 1)]
        eval_mu = tmod(xt)[1]
        train_mu = tmod(xt, train=True, sample=False, rng=torch.Generator())[1]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert tuple(train_mu.shape) == tuple(eval_mu.shape)
    with pytest.raises(ValueError, match="Generator"):
        tmod(xt, train=True)


def test_variational_layer_reduced_shape_uses_ceil():
    """An odd latent: the stride-2 conv gives ceil(size / 2), as the dense
    widths do."""
    from unet3d_tpu.models import variational as jax_variational
    x = _x(2, 5, 3, 4, 8)
    jmod = jax_variational.MyronenkoVariationalLayer(
        in_features=8, input_shape=(5, 3, 4), reduced_features=4, latent_features=6)
    variables = _init(jmod, x, sample=False)
    tmod = _port(variational.MyronenkoVariationalLayer(
        8, (5, 3, 4), reduced_features=4, latent_features=6), variables)
    assert tmod.reduced_shape == (3, 2, 2)
    _check_forward(jmod, tmod, variables, x, jax_kwargs=dict(sample=False),
                   torch_kwargs=dict(sample=False))


def test_variational_block_draws():
    """The reparameterised sample mu + eps * exp(logvar / 2): eps ~ N(0, 1)
    from the generator (the same under one seed, another under another);
    without sampling, mu exactly."""
    block = variational.VariationalBlock(6, 4, 5)
    init_parameters(block, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(4096, 6))
    with torch.no_grad():
        out_mu, mu, logvar = block(x, sample=False)
        np.testing.assert_allclose(out_mu.numpy(), block.dense2(mu).numpy())
        z = []
        for seed in (0, 0, 1):
            captured = {}
            handle = block.dense2.register_forward_hook(
                lambda m, inp, out: captured.setdefault("z", inp[0]))
            block(x, sample=True, rng=torch.Generator().manual_seed(seed))
            handle.remove()
            z.append(captured["z"])
    assert torch.equal(z[0], z[1]) and not torch.equal(z[0], z[2])
    eps = (z[0] - mu) / torch.exp(0.5 * logvar)
    # 16384 draws: the mean's standard error is 0.008, the std's 0.006
    assert abs(eps.mean().item()) < 0.04 and abs(eps.std().item() - 1.0) < 0.03
    with pytest.raises(ValueError, match="Generator"):
        block(x, sample=True)


def test_vae_requires_input_shape():
    with pytest.raises(ValueError, match="input_shape"):
        create_model("VariationalAutoEncoder", n_features=1)
    model = jax_create_model("VariationalAutoEncoder", n_features=1, base_width=2,
                             encoder_blocks=(1,))
    with pytest.raises(ValueError, match="input_shape"):
        jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0),
                                           "sample": jax.random.PRNGKey(1)},
                                          jnp.zeros((1, 4, 4, 4, 1))))

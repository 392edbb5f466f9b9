"""The port's U-Nets (UNet3D, AutocastUNet, AutoImplantUNet) against the JAX
package, with the JAX parameters carried across by
``convert.load_jax_variables``, and the registry's ported names.

The helpers and tolerances are ``tests/test_torch_myronenko.py``'s:
relative L2 1e-5 on an f32 forward, 1e-4 on f32 gradients (against JAX and
an f64 evaluation, ``_check_grads``), 2e-2 on a bf16 AMP forward, bf16
gradients as ``_check_grads`` states. Training draws noise (UNet3D's encoder
drops channels at level 0), which cannot match ``jax.random``: parity holds
the eval path, and a separate test holds the draws.
"""
import numpy as np
import pytest
import torch

from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model

from test_torch_myronenko import BF16, S, _check_forward, _check_grads, _init, _port, _x

UNET_KWARGS = dict(n_features=2, base_width=8, encoder_blocks=[1, 2], n_outputs=3)


@pytest.fixture(scope="module")
def unet():
    x = _x(2, S, S, S, 2, seed=3)
    jmod = jax_create_model("UNet3D", **UNET_KWARGS)
    variables = _init(jmod, x)
    return jmod, variables, x


def test_unet_forward_matches_jax(unet):
    """f32 and bf16 AMP; AutocastUNet is the same net under another name in
    both packages."""
    jmod, variables, x = unet
    tmod = _port(create_model("UNet3D", **UNET_KWARGS), variables)
    want, got = _check_forward(jmod, tmod, variables, x)
    _check_forward(jmod, tmod, variables, x, bound=BF16, amp=True)
    autocast = _port(create_model("AutocastUNet", **UNET_KWARGS), variables)
    assert issubclass(type(jax_create_model("AutocastUNet")), type(jmod))
    with torch.no_grad():
        assert torch.equal(autocast(torch.from_numpy(x)), got)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_unet_gradients_match_jax(unet, amp):
    jmod, variables, x = unet
    tmod = _port(create_model("UNet3D", **UNET_KWARGS), variables)
    _check_grads(jmod, tmod, variables, x, amp)


def test_unet_options_match_jax():
    """softmax, transposed-conv upsampling (2n - 1, padded to the skip) and
    layer_widths whose decoder input differs from the encoder's output (the
    first decoder block projects)."""
    kwargs = dict(UNET_KWARGS, activation="softmax", use_transposed_convolutions=True,
                  layer_widths=[8, 12, 16])
    x = _x(1, S, S, S, 2, seed=4)
    jmod = jax_create_model("UNet3D", **kwargs)
    variables = _init(jmod, x)
    _check_forward(jmod, _port(create_model("UNet3D", **kwargs), variables), variables, x)


def test_unet_training_draws_from_the_generator():
    """UNet3D's encoder drops channels at level 0 in training (rate 0.2, as
    in JAX): training draws from the generator, eval draws nothing."""
    model = create_model("UNet3D", **UNET_KWARGS)
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(1, 8, 8, 8, 2))
    with pytest.raises(ValueError, match="Generator"):
        model(x, train=True)
    with torch.no_grad():
        a = model(x, train=True, rng=torch.Generator().manual_seed(3))
        b = model(x, train=True, rng=torch.Generator().manual_seed(3))
        c = model(x, train=True, rng=torch.Generator().manual_seed(4))
        assert torch.equal(model(x), model(x, train=False))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_autoimplant_unet_matches_jax():
    """y - x, or the raw y under ``test``, in f32 and bf16."""
    kwargs = dict(UNET_KWARGS, n_outputs=2)
    x = _x(2, S, S, S, 2, seed=5)
    jmod = jax_create_model("AutoImplantUNet", **kwargs)
    variables = _init(jmod, x)
    tmod = _port(create_model("AutoImplantUNet", **kwargs), variables)
    residual, _ = _check_forward(jmod, tmod, variables, x)
    raw, _ = _check_forward(jmod, tmod, variables, x, jax_kwargs=dict(test=True),
                            torch_kwargs=dict(test=True))
    np.testing.assert_allclose(np.asarray(raw) - x, np.asarray(residual), atol=1e-5)
    _check_forward(jmod, tmod, variables, x, bound=BF16, amp=True,
                   jax_kwargs=dict(test=True), torch_kwargs=dict(test=True))


def test_unported_names_still_raise():
    """The family's names and the BatchNorm segmentation nets resolve; the
    last names of the JAX registry (VQVAE, GraphCMR) are ported, so nothing
    is left to port; an unknown name raises with the list."""
    for name in ("SegResNet", "UNet3D", "AutocastUNet", "AutoImplantUNet",
                 "ConvolutionalAutoEncoder", "SegResNetDS", "AttentionUnet", "UNet", "VNet",
                 "VQVAE"):
        assert isinstance(create_model(name), torch.nn.Module)
    from unet3d_tpu_torch.models.registry import MODEL_REGISTRY, NOT_YET_PORTED
    assert NOT_YET_PORTED == () and {"GraphCMR", "VQVAE"} <= set(MODEL_REGISTRY)
    with pytest.raises(ValueError, match="GraphCMR needs ref_vertices"):
        create_model("GraphCMR")
    with pytest.raises(ValueError, match="is unknown; ported: .*VQVAE"):
        create_model("NoSuchNet")

"""The port's SegResNet and SegResNetVAE against the JAX package, with the
JAX parameters carried across by ``convert.load_jax_variables``.

Small nets (init_filters 8, blocks_down (1, 2), blocks_up (1,), 16^3, seeded
numpy inputs); the helpers and tolerances are
``tests/test_torch_myronenko.py``'s: relative L2 1e-5 on an f32 forward,
1e-4 on f32 gradients (against JAX and an f64 evaluation), 2e-2 on a bf16
AMP forward (the parameters cast to bf16 as the JAX step casts them), bf16
gradients as ``_check_grads`` states. The VAE branch is held with
``vae_default_std`` 0 and no dropout (the exact path: its noise cannot
match ``jax.random``); a separate test holds the draws. The dtype flow
under AMP (the decoder in f32 after the trilinear upsample) is asserted
module by module in both packages.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from unet3d_tpu.models.registry import create_model as jax_create_model

from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model

from test_torch_myronenko import (BF16, S, _cast, _check_forward, _check_grads, _init,
                                  _port, _x)

SEG_KWARGS = dict(init_filters=8, in_channels=2, out_channels=3, blocks_down=[1, 2],
                  blocks_up=[1])
VAE_KWARGS = dict(SEG_KWARGS, input_image_size=[S, S, S], vae_nz=8, smallest_filters=4,
                  vae_default_std=0.0)
TRAIN_JAX = dict(train=True, rngs={"sample": jax.random.PRNGKey(1)})


def _train_torch():
    return dict(train=True, rng=torch.Generator().manual_seed(1))


@functools.lru_cache(maxsize=None)
def _segresnet(mode):
    kwargs = dict(SEG_KWARGS, upsample_mode=mode)
    x = _x(2, S, S, S, 2, seed=1)
    jmod = jax_create_model("SegResNet", **kwargs)
    variables = _init(jmod, x)
    return kwargs, jmod, variables, x


@pytest.fixture(scope="module")
def vae():
    x = _x(2, S, S, S, 2, seed=2)
    jmod = jax_create_model("SegResNetVAE", **VAE_KWARGS)
    variables = _init(jmod, x)
    return jmod, variables, x


@pytest.mark.parametrize("mode", ["nontrainable", "deconv"])
def test_segresnet_forward_matches_jax(mode):
    """Both upsample modes, f32 and bf16 AMP; train=True without dropout is
    the same function."""
    kwargs, jmod, variables, x = _segresnet(mode)
    tmod = _port(create_model("SegResNet", **kwargs), variables)
    _check_forward(jmod, tmod, variables, x)
    _check_forward(jmod, tmod, variables, x, bound=BF16, amp=True)
    with torch.no_grad():
        assert torch.equal(tmod(torch.from_numpy(x)), tmod(torch.from_numpy(x), train=True))


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_segresnet_gradients_match_jax(amp):
    """The default (trilinear) decoder."""
    kwargs, jmod, variables, x = _segresnet("nontrainable")
    _check_grads(jmod, _port(create_model("SegResNet", **kwargs), variables), variables,
                 x, amp)


def test_segresnet_vae_eval_matches_jax(vae):
    """Eval returns the segmentation alone, as in JAX."""
    jmod, variables, x = vae
    tmod = _port(create_model("SegResNetVAE", **VAE_KWARGS), variables)
    _, got = _check_forward(jmod, tmod, variables, x)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (2, S, S, S, 3)
    _check_forward(jmod, tmod, variables, x, bound=BF16, amp=True)


def test_segresnet_vae_train_matches_jax(vae):
    """Training returns (seg, mse + reg): the VAE branch replays the shared
    decoder without skips; with std 0 the latent is its mean."""
    jmod, variables, x = vae
    tmod = _port(create_model("SegResNetVAE", **VAE_KWARGS), variables)
    want, got = _check_forward(jmod, tmod, variables, x, jax_kwargs=TRAIN_JAX,
                               torch_kwargs=_train_torch())
    assert got[1].dim() == 0 and got[1].dtype == torch.float32
    _check_forward(jmod, tmod, variables, x, bound=BF16, amp=True, jax_kwargs=TRAIN_JAX,
                   torch_kwargs=_train_torch())


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_segresnet_vae_train_gradients_match_jax(vae, amp):
    """Gradients of sum(seg * g) + the VAE term: every parameter, the VAE
    branch's and the decoder's through both passes."""
    jmod, variables, x = vae
    tmod = _port(create_model("SegResNetVAE", **VAE_KWARGS), variables)
    _check_grads(jmod, tmod, variables, x, amp, jax_kwargs=TRAIN_JAX,
                 torch_kwargs=_train_torch(), scalar_extra=True)


def test_segresnet_vae_estimated_std():
    """vae_estimate_std adds the std's dense layer (``vae_fc2``, as in the
    JAX tree) and always draws: it needs the generator."""
    kwargs = dict(VAE_KWARGS, vae_estimate_std=True)
    x = _x(1, S, S, S, 2, seed=3)
    tmod = create_model("SegResNetVAE", **kwargs)
    init_parameters(tmod, torch.Generator().manual_seed(0))
    assert tuple(tmod.vae_fc2.kernel.shape) == tuple(tmod.vae_fc1.kernel.shape)
    with pytest.raises(ValueError, match="Generator"):
        tmod(torch.from_numpy(x), train=True)
    with torch.no_grad():
        seg, term = tmod(torch.from_numpy(x), train=True, rng=torch.Generator())
    assert torch.isfinite(term) and tuple(seg.shape) == (1, S, S, S, 3)


def test_segresnet_vae_noise_draws():
    """Dropout after convInit and the latent sample come from the
    generator: the same under one seed, others under another; eval draws
    nothing."""
    kwargs = dict(VAE_KWARGS, vae_default_std=0.3, dropout_prob=0.2)
    model = create_model("SegResNetVAE", **kwargs)
    init_parameters(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(1, S, S, S, 2, seed=4))

    def run(seed):
        with torch.no_grad():
            return model(x, train=True, rng=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    with torch.no_grad():
        assert torch.equal(model(x), model(x))


def _jax_dtypes(jmod, variables, x):
    """{module path: output dtype} of every module, bf16 parameters and
    input (the JAX step's cast), from Flax's captured intermediates."""
    _, state = jax.jit(lambda v, xv: jmod.apply(
        v, xv, capture_intermediates=True, mutable=["intermediates"]))(
        _cast(variables), jnp.asarray(x).astype(jnp.bfloat16))
    out = {}
    for path, value in flatten_dict(state["intermediates"]).items():
        if path[-1] == "__call__":
            name = ".".join(path[:-1])
            out[name or "<model>"] = str(value[0].dtype)
    return out


def _torch_dtypes(tmod, x):
    import copy
    net = copy.deepcopy(tmod).to(torch.bfloat16)
    out, handles = {}, []
    for name, module in net.named_modules():
        def hook(m, inp, o, name=name):
            o = o[0] if isinstance(o, tuple) else o
            out[name or "<model>"] = str(o.dtype).replace("torch.", "")
        handles.append(module.register_forward_hook(hook))
    with torch.no_grad():
        net(torch.from_numpy(x).to(torch.bfloat16))
    for h in handles:
        h.remove()
    return out


def test_amp_dtype_flow_matches_jax(vae):
    """Under AMP everything up to up0_conv is bf16; the trilinear upsample
    returns f32, the bf16 skip is added to it, and from up0_block0 on every
    norm, conv and the output are f32 in both packages: the decoder's
    3-cubed convs take the f32 form of the conv kernel on the card."""
    jmod, variables, x = vae
    tmod = _port(create_model("SegResNetVAE", **VAE_KWARGS), variables)
    want, got = _jax_dtypes(jmod, variables, x), _torch_dtypes(tmod, x)
    common = sorted(set(want) & set(got))
    assert len(common) > 30
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    assert got["up0_conv"] == "bfloat16" and got["layer1_block1.conv2.conv"] == "bfloat16"
    assert got["up0_block0.conv1.norm"] == got["up0_block0.conv2.conv"] == "float32"
    assert got["conv_final"] == got["<model>"] == "float32"


def test_unsupported_options_raise_in_both():
    with pytest.raises(NotImplementedError, match="pixelshuffle"):
        create_model("SegResNet", upsample_mode="pixelshuffle")
    model = jax_create_model("SegResNet", upsample_mode="pixelshuffle", blocks_down=[1, 1],
                             blocks_up=[1])
    with pytest.raises(NotImplementedError, match="pixelshuffle"):
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1))))
    with pytest.raises(ValueError, match="len\\(blocks_up\\)"):
        create_model("SegResNetVAE", input_image_size=[16, 16, 16], blocks_down=[1, 2, 2],
                     blocks_up=[1])
    with pytest.raises(NotImplementedError):
        create_model("SegResNet", spatial_dims=2)


def test_parameter_tree_matches_jax(vae):
    """Every key and shape of the Flax tree, the VAE's Dense kernels (in,
    out) and the deconv upsample's kernels included, and the port's
    initialiser fills them all."""
    jmod, variables, _ = vae
    model = create_model("SegResNetVAE", **VAE_KWARGS)
    init_parameters(model, torch.Generator().manual_seed(0))
    want = {"/".join(k[1:]).replace("/", "."): v.shape
            for k, v in flatten_dict(variables).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert want["vae_fc1.kernel"] == (4 * (S // 4) ** 3, 8)
    deconv = create_model("SegResNetVAE", **dict(VAE_KWARGS, upsample_mode="deconv"))
    init_parameters(deconv, torch.Generator().manual_seed(0))
    assert deconv.vae_fc_upsample.kernel.shape == (2, 2, 2, 16, 16)
    assert float(deconv.vae_fc_upsample.kernel.detach().std()) > 0

"""The port's GroupNorm, Myronenko blocks, transposed conv, encoders and
decoders against the JAX package, with the JAX parameters carried across by
``convert.load_jax_variables`` (the U-Nets: test_torch_myronenko_models.py;
the autoencoders: test_torch_variational.py; SegResNet:
test_torch_segresnet.py).

Each JAX module is initialised, its norm scales and biases (and dense
biases) moved off their initial values with seeded numpy, and loaded into
the port's module; the same numpy input goes through both. Tolerances,
relative L2: 1e-5 on an f32 forward, 1e-4 on f32 gradients (GroupNorm sums
in another order), 2e-2 on a bf16 AMP forward and its gradients (the
parameters cast to bf16 as the JAX step casts them; the bound phase 5 of
``chip_smoke.py`` uses). The noise (channel dropout, the VAE sample) cannot
match ``jax.random``: parity holds eval, ``train`` without dropout and the
VAE's ``sample=False`` paths, and separate tests hold the draws.
"""
import copy
from unittest import mock

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp
import flax.linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from unet3d_tpu.models import decoder as jax_decoder
from unet3d_tpu.models import layers as jax_layers
from unet3d_tpu.models import myronenko as jax_myronenko

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models import decoder, layers, myronenko

F32, F32_GRAD, BF16 = 1e-5, 1e-4, 2e-2
S = 16


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _init(module, x, seed=0, **kwargs):
    """JAX variables of ``module`` for ``x``, every scale / bias moved off
    its initial value."""
    rngs = {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(seed + 1),
            "dropout": jax.random.PRNGKey(seed + 2)}
    variables = jax.jit(lambda r, v: module.init(r, v, **kwargs))(rngs, jnp.asarray(x))
    rng = np.random.RandomState(seed + 7)
    flat = {}
    for k, v in flatten_dict(variables).items():
        v = np.asarray(v)
        if k[-1] == "scale":
            v = v + 0.3 * rng.randn(*v.shape).astype(np.float32)
        elif k[-1] == "bias":
            v = v + 0.1 * rng.randn(*v.shape).astype(np.float32)
        flat[k] = jnp.asarray(v)
    return unflatten_dict(flat)


def _port(module, variables):
    load_jax_variables(module, _flat(variables), strict=True)
    return module.eval()


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _cast(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, tree)


def _check_forward(jmod, tmod, variables, x, bound=F32, jax_kwargs=None,
                   torch_kwargs=None, amp=False):
    jax_kwargs, torch_kwargs = jax_kwargs or {}, torch_kwargs or {}
    v, xj = (_cast(variables), jnp.asarray(x).astype(jnp.bfloat16)) if amp else (
        variables, jnp.asarray(x))
    want = jax.jit(lambda a, b: jmod.apply(a, b, **jax_kwargs))(v, xj)
    net = copy.deepcopy(tmod).to(torch.bfloat16) if amp else tmod
    xt = torch.from_numpy(x).to(torch.bfloat16) if amp else torch.from_numpy(x)
    with torch.no_grad():
        got = net(xt, **torch_kwargs)
    for w, g in zip(*(o if isinstance(o, tuple) else (o,) for o in (want, got))):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32))) < bound
    return want, got


def _objective(out, g, scalar_extra, to_f32):
    """sum(out * g), plus the model's scalar extra (SegResNetVAE's VAE
    term) when ``scalar_extra``."""
    value = (to_f32(_first(out)) * g).sum()
    return value + to_f32(out[1]) if scalar_extra else value


_GRADS = {}


def _grads(jmod, variables, x, g, amp, jax_kwargs, scalar_extra=False):
    """JAX gradients of ``_objective`` w.r.t. the f32 parameters (flat,
    torch keys) and the input, through bf16 copies under ``amp``; kept for
    the module's other tests (each compile takes seconds)."""
    key = (id(jmod), id(variables), amp, scalar_extra, repr(sorted(jax_kwargs.items())))
    if key in _GRADS:
        return _GRADS[key]

    def loss(params, xv):
        p, xin = (_cast(params), xv.astype(jnp.bfloat16)) if amp else (params, xv)
        return _objective(jmod.apply({"params": p}, xin, **jax_kwargs), g, scalar_extra,
                          lambda a: a.astype(jnp.float32))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    _GRADS[key] = ({k.replace("/", "."): v for k, v in _flat(gp).items()}, np.asarray(gx))
    return _GRADS[key]


def _all(grads, keys):
    return np.concatenate([np.asarray(grads[k]).ravel() for k in keys])


def _plain_conv3d(xv, w, strides=(1, 1, 1), padding="SAME"):
    from unet3d_tpu_torch.ops.conv3d import _pads, conv3d_torch
    return conv3d_torch(xv, w, tuple(strides), _pads(padding, w.shape[:3]))


def reference_forward(tmod, x, **torch_kwargs):
    """The port module's output in f64, its 3-cubed convs through
    ``F.conv3d`` (the kernels take f32 and bf16 only): the exact value of
    the function both packages compute in f32."""
    net = copy.deepcopy(tmod).double()
    with torch.no_grad(), mock.patch.object(layers, "conv3d", _plain_conv3d):
        return _first(net(torch.from_numpy(x).double(), **torch_kwargs)).numpy()


def _reference_grads(tmod, x, g, torch_kwargs, scalar_extra=False):
    """The port module's gradients in f64 (as ``reference_forward``): the
    exact gradient of the function both packages compute in f32, to measure
    each one's f32 error against."""
    net = copy.deepcopy(tmod).double()
    names, params = zip(*net.named_parameters())
    xt = torch.from_numpy(x).double().requires_grad_(True)
    with mock.patch.object(layers, "conv3d", _plain_conv3d):
        out = net(xt, **torch_kwargs)
    value = _objective(out, torch.from_numpy(np.array(g)).double(), scalar_extra,
                       lambda a: a)
    grads = torch.autograd.grad(value, list(params) + [xt])
    return dict(zip(names, (t.numpy() for t in grads[:-1]))), grads[-1].numpy()


def _check_grads(jmod, tmod, variables, x, amp, bound=F32_GRAD, jax_kwargs=None,
                 torch_kwargs=None, scalar_extra=False):
    """Gradients of ``_objective`` (sum(out * g), plus a scalar extra) w.r.t.
    the f32 parameters and the input, through bf16 copies under ``amp``, all
    parameters' together and the input's.

    f32: within ``bound`` of JAX's, relative L2, and of an f64 evaluation of
    the same function (``_reference_grads``). Flax's GroupNorm takes the
    variance as E[x^2] - E[x]^2 in f32, and its backward loses digits
    through it in either package: for the 16^3 VAE JAX's f32 gradients lie
    1.6e-3 from the f64 ones and the port's 1.0e-3. So where JAX's lie
    further than ``bound`` from them, the port's must lie no further than
    1.25 times JAX's distance, and agree with JAX's within twice it. bf16:
    at these sizes bf16 rounding moves the gradients 5-15% from the f32 ones
    on either side, at other places in each package (XLA keeps f32 inside
    its fusions), so the port's must lie no further from JAX's f32 gradients
    than 1.25 times JAX's own bf16 ones do (two samples of the same rounding
    noise; tests/test_torch_res_remat.py holds DynUNet's alike); the 2e-2
    bound holds on the card at full size, kernels against the plain path
    (chip_smoke.py phase 10)."""
    jax_kwargs, torch_kwargs = jax_kwargs or {}, torch_kwargs or {}
    out = _first(jax.eval_shape(lambda: jmod.apply(variables, jnp.asarray(x), **jax_kwargs)))
    g = jnp.asarray(np.random.RandomState(5).randn(*out.shape).astype(np.float32))
    want, want_x = _grads(jmod, variables, x, g, amp, jax_kwargs, scalar_extra)

    names, params = zip(*tmod.named_parameters())
    xt = torch.from_numpy(x).requires_grad_(True)
    p = {n: (t.to(torch.bfloat16) if amp else t) for n, t in zip(names, params)}
    out_t = functional_call(tmod, p, (xt.to(torch.bfloat16) if amp else xt,), torch_kwargs)
    loss_t = _objective(out_t, torch.from_numpy(np.array(g)), scalar_extra,
                        lambda a: a.float())
    grads = torch.autograd.grad(loss_t, list(params) + [xt])
    got = dict(zip(names, (t.numpy() for t in grads[:-1])))
    got_x = grads[-1].numpy()
    assert set(got) == set(want)
    keys = sorted(want)
    pairs = ((_all(got, keys), _all(want, keys)), (got_x, want_x))
    if amp:
        f32, f32_x = _grads(jmod, variables, x, g, False, jax_kwargs, scalar_extra)
        for (ours, theirs), ref in zip(pairs, (_all(f32, keys), f32_x)):
            assert _rel(ours, ref) <= 1.25 * _rel(theirs, ref), (_rel(ours, ref),
                                                                _rel(theirs, ref))
        return
    ref, ref_x = _reference_grads(tmod, x, g, torch_kwargs, scalar_extra)
    for (ours, theirs), exact in zip(pairs, (_all(ref, keys), ref_x)):
        jax_error = _rel(theirs, exact)
        assert _rel(ours, exact) < max(bound, 1.25 * jax_error), (_rel(ours, exact),
                                                                 jax_error)
        assert _rel(ours, theirs) < max(bound, 2 * jax_error), (_rel(ours, theirs),
                                                               jax_error)


# --- GroupNorm -------------------------------------------------------------


@pytest.mark.parametrize("channels,groups", [(16, 8), (12, 8), (6, 8), (4, 2)])
def test_group_norm_groups_fallback(channels, groups):
    assert layers.group_norm_groups(channels, groups) == jax_layers.group_norm_groups(
        channels, groups)


@pytest.mark.parametrize("x_dtype,p_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
    ("bfloat16", "float32")])
@pytest.mark.parametrize("channels", [16, 12])
def test_group_norm_matches_flax(x_dtype, p_dtype, channels):
    """Flax's statistics (f32, E[x^2] - E[x]^2 clamped, eps 1e-5), its f32
    normalisation and its output dtype, the result type of x and the
    parameters: an f32 input on bf16 parameters comes out f32."""
    groups = layers.group_norm_groups(channels, 8)
    x = _x(2, 5, 4, 3, channels) * 3 + 1
    jmod = fnn.GroupNorm(num_groups=groups, epsilon=1e-5)
    variables = _init(jmod, x)
    jd, td = getattr(jnp, x_dtype), getattr(torch, x_dtype)
    pj = jax.tree_util.tree_map(lambda a: a.astype(getattr(jnp, p_dtype)), variables)
    want = jmod.apply(pj, jnp.asarray(x).astype(jd))
    tmod = _port(layers.GroupNorm(channels, groups), variables).to(getattr(torch, p_dtype))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(td))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    bound = F32 if want.dtype == jnp.float32 else BF16
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < bound


def test_group_norm_gradients_match_flax():
    x = _x(2, 4, 6, 5, 16)
    jmod = fnn.GroupNorm(num_groups=8, epsilon=1e-5)
    variables = _init(jmod, x)
    _check_grads(jmod, _port(layers.GroupNorm(16, 8), variables), variables, x, False)


# --- blocks and the layer --------------------------------------------------


@pytest.mark.parametrize("cin,planes,stride", [(4, 16, 1), (8, 16, 2)])
def test_conv_block_matches_jax(cin, planes, stride):
    x = _x(2, 9, 8, 7, cin)
    jmod = jax_layers.MyronenkoConvBlock(planes, stride=stride)
    variables = _init(jmod, x)
    tmod = _port(layers.MyronenkoConvBlock(cin, planes, stride=stride), variables)
    _check_forward(jmod, tmod, variables, x)


@pytest.mark.parametrize("cin,planes", [(8, 8), (4, 16)])
def test_residual_block_matches_jax(cin, planes):
    """With and without the 1-cubed projection of the identity; forward in
    f32 and bf16 AMP, gradients in f32."""
    x = _x(2, 8, 8, 8, cin)
    jmod = jax_layers.MyronenkoResidualBlock(planes)
    variables = _init(jmod, x)
    tmod = _port(layers.MyronenkoResidualBlock(cin, planes), variables)
    _check_forward(jmod, tmod, variables, x)
    _check_forward(jmod, tmod, variables, x, bound=BF16, amp=True)
    _check_grads(jmod, tmod, variables, x, False)


@pytest.mark.parametrize("dropout", [None, 0.3])
def test_layer_matches_jax_without_noise(dropout):
    """Eval (dropout off) and, without dropout, train: the same function."""
    x = _x(2, 8, 8, 8, 4)
    jmod = jax_layers.MyronenkoLayer(n_blocks=2, planes=8, dropout=dropout)
    variables = _init(jmod, x)
    tmod = _port(layers.MyronenkoLayer(2, 4, 8, dropout=dropout), variables)
    _check_forward(jmod, tmod, variables, x, jax_kwargs=dict(train=False),
                   torch_kwargs=dict(train=False))
    if dropout is None:
        _check_forward(jmod, tmod, variables, x, jax_kwargs=dict(train=True),
                       torch_kwargs=dict(train=True))


def test_channel_dropout_draws():
    """Whole channels dropped with probability p, the rest scaled by
    1 / (1 - p); the same draws under one seed, others under another;
    training without a generator raises; eval draws nothing."""
    x = torch.ones(64, 4, 4, 4, 32)
    p = 0.2

    def run(seed):
        return layers.channel_dropout(x, p, True, torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a, a[:, :1, :1, :1, :].expand_as(a))  # constant per channel
    values = set(a.unique().tolist())
    assert values <= {0.0, 1.0 / (1.0 - p)}
    kept = (a[:, 0, 0, 0, :] != 0).float().mean().item()
    assert abs(kept - (1 - p)) < 0.05  # 2048 draws: 5 sigma is 0.044
    assert abs(a.mean().item() - 1.0) < 0.06
    with pytest.raises(ValueError, match="Generator"):
        layers.channel_dropout(x, p, True, None)
    assert layers.channel_dropout(x, p, False, None) is x
    bf = layers.channel_dropout(x.to(torch.bfloat16), p, True,
                                torch.Generator().manual_seed(0))
    assert bf.dtype == torch.bfloat16


# --- transposed conv, pad / crop -------------------------------------------


@pytest.mark.parametrize("spatial", [(5, 7, 3), (4, 4, 4)])
def test_transposed_conv_k3_s2_matches_flax(spatial):
    """Flax's nn.ConvTranspose does not flip its kernel; torch's
    conv_transpose3d does. Pads (k-1-p, k-1-p+op) = (1, 1): out = 2n - 1."""
    x = _x(2, *spatial, 6)
    jmod = jax_layers.transposed_conv(5, 3, 2)
    assert isinstance(jmod, fnn.ConvTranspose)
    variables = _init(jmod, x)
    tmod = _port(layers.transposed_conv(6, 5, 3, 2), variables)
    assert isinstance(tmod, layers.ConvTranspose)
    want, got = _check_forward(jmod, tmod, variables, x)
    assert tuple(got.shape[1:4]) == tuple(2 * s - 1 for s in spatial)
    _check_grads(jmod, tmod, variables, x, False)
    # bf16 parameters on an f32 input: the result type, f32
    jv = _cast(variables)
    want = jmod.apply(jv, jnp.asarray(x))
    with torch.no_grad():
        got = tmod.to(torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(got.numpy(), np.asarray(want)) < F32


def test_transposed_conv_output_padding_matches_flax():
    x = _x(1, 3, 4, 5, 4)
    jmod = jax_layers.transposed_conv(3, 3, 2, output_padding=1)
    variables = _init(jmod, x)
    tmod = _port(layers.transposed_conv(4, 3, 3, 2, output_padding=1), variables)
    _, got = _check_forward(jmod, tmod, variables, x)
    assert tuple(got.shape[1:4]) == (6, 8, 10)


@pytest.mark.parametrize("spatial,target", [
    ((8, 8, 8), (7, 9, 8)), ((9, 6, 5), (6, 9, 8)), ((4, 4, 4), (4, 4, 4)),
    ((10, 3, 7), (7, 6, 2))])
def test_center_pad_to_matches_jax(spatial, target):
    """A negative difference crops, the larger crop off the start."""
    x = _x(2, *spatial, 3)
    want = np.asarray(jax_decoder._center_pad_to(jnp.asarray(x), target))
    got = decoder._center_pad_to(torch.from_numpy(x), target).numpy()
    assert got.shape == want.shape == (2, *target, 3)
    np.testing.assert_array_equal(got, want)


# --- encoders and decoders -------------------------------------------------


def test_encoders_match_jax():
    """UNetEncoder returns every level's output, deepest first;
    MyronenkoEncoder (the same parameters) the last level's."""
    x = _x(2, S, S, S, 3)
    jmod = jax_myronenko.UNetEncoder(base_width=8, layer_blocks=(1, 2))
    variables = _init(jmod, x)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    assert len(want) == 2
    for cls in (myronenko.UNetEncoder, myronenko.MyronenkoEncoder):
        tmod = _port(cls(3, base_width=8, layer_blocks=(1, 2)), variables)
        with torch.no_grad():
            got = tmod(torch.from_numpy(x))
        got = got if isinstance(got, list) else [got]
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            assert _rel(g.numpy(), np.asarray(w)) < F32


@pytest.mark.parametrize("kind,transposed", [("MirroredDecoder", False),
                                             ("MyronenkoDecoder", True)])
def test_decoders_match_jax(kind, transposed):
    x = _x(2, 4, 4, 4, 16)
    kwargs = dict(base_width=8, layer_blocks=(1, 2), use_transposed_convolutions=transposed)
    jmod = getattr(jax_decoder, kind)(**kwargs)
    variables = _init(jmod, x)
    tmod = _port(getattr(decoder, kind)(16, **kwargs), variables)
    _check_forward(jmod, tmod, variables, x)


def test_unet_decoder_matches_jax():
    """Skips concatenated after the upsample, cropped or padded to them (an
    odd skip: the trilinear upsample overshoots it on D and H, falls short
    on W; the transposed conv's 2n - 1 is held in
    test_torch_myronenko_models.py)."""
    skips = [_x(2, 4, 4, 4, 16, seed=1), _x(2, 7, 9, 9, 8, seed=2)]
    kwargs = dict(base_width=8, layer_blocks=(1, 1))
    jmod = jax_decoder.UNetDecoder(**kwargs)
    js = [jnp.asarray(s) for s in skips]
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), js)
    tmod = _port(decoder.UNetDecoder(16, skip_channels=[8], **kwargs), variables)
    want = jax.jit(jmod.apply)(variables, js)
    with torch.no_grad():
        got = tmod([torch.from_numpy(s) for s in skips])
    assert tuple(got.shape) == want.shape == (2, 7, 9, 9, 8)
    assert _rel(got.numpy(), np.asarray(want)) < F32



"""The port's UNETR, its LayerNorm and attention, and the standalone ViT and
ViTAutoEnc against the JAX package's, with the JAX variables (every kernel,
scale, bias and position embedding seeded off its initial value from
``jax.eval_shape``'s tree, ``test_torch_batchnorm.bn_init``) carried across
strictly (SwinUNETR: test_torch_swin_unetr.py).

UNETR at hidden 32, mlp 64, 2 heads, 4 layers, feature 4 on a 32^3 input
(patch 16: a 2^3 grid), batch 2, ``res_block`` true (every check) and
false (the forwards: its blocks are DynUNet's basic blocks, whose
gradients test_torch_dynunet.py holds; each JAX train step compiles for
~10 s); ViT and
ViTAutoEnc at hidden 32, mlp 64, 2 heads, 2 layers, patch 8 on 32^3.
Tolerances, relative L2, through ``tests/test_torch_batchnorm.py``'s
helpers: eval forward 1e-5 in f32, 2e-2 in bf16 (the AMP eval step, JAX's
own bf16 distance allowed for); the first train step's gradients 1e-4 in
f32, against JAX and JAX's f64 evaluation with JAX's own error allowed
for; bf16 gradients no further from JAX's f32 than 1.25x JAX's own; two
SGD steps through ``make_train_step`` 1e-5; every module's output dtype
under AMP as Flax's captured intermediates (the AMP checks of the whole
net: test_torch_unetr_amp.py, a file of their own so that each file's JAX
compiles stay within a minute). Unit pins: ``layers.LayerNorm``
against ``flax.linen.LayerNorm`` (E[x^2] - E[x]^2 clamped at 0, where
``F.layer_norm``'s two-pass variance lands elsewhere), the attention's
bf16 softmax, the initialisers, the ``.npz`` both ways with no buffer.
"""
import copy
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call

import jax
import jax.numpy as jnp
import flax.linen as fnn

from unet3d_tpu.models import unetr as jax_unetr
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train import checkpoint as jax_ckpt

from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models import unetr
from unet3d_tpu_torch.models.layers import LayerNorm, init_parameters, layer_norm
from unet3d_tpu_torch.models.registry import NOT_YET_PORTED, create_model
from unet3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (BF16, F32, Net, bn_init, check_forwards, check_grads,
                                  check_train_steps)
from test_torch_myronenko import _cast, _check_grads, _flat, _rel, _x

SHAPE = (2, 32, 32, 32, 2)
UNETR_KWARGS = dict(in_channels=2, out_channels=3, img_size=32, feature_size=4,
                    hidden_size=32, mlp_dim=64, num_heads=2, num_layers=4)
VIT_KWARGS = dict(in_channels=2, img_size=[32, 32, 32], patch_size=[8, 8, 8], hidden_size=32,
                  mlp_dim=64, num_layers=2, num_heads=2)
VITS = {"ViT": dict(VIT_KWARGS, classification=True, num_classes=3),
        "ViTAutoEnc": dict(VIT_KWARGS, out_channels=2, deconv_chns=4)}


@functools.lru_cache(maxsize=None)
def _net(res_block=True):
    return Net("UNETR", dict(UNETR_KWARGS, res_block=res_block), SHAPE)


RES = pytest.mark.parametrize("res_block", [True, False], ids=["res_block", "basic_block"])


@RES
def test_forwards_match_jax(res_block):
    check_forwards(_net(res_block))


def test_gradients_match_jax():
    check_grads(_net(), False)


def test_train_steps_match_jax():
    check_train_steps(_net(), 1)


# --- LayerNorm and attention ----------------------------------------------------


@pytest.mark.parametrize("x_dtype,p_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                             ("bfloat16", "float32")])
def test_layer_norm_matches_flax(x_dtype, p_dtype):
    """Statistics in f32, the normalisation in f32, the output in the result
    type of x, scale and bias: bf16 only where all three are."""
    rng = np.random.RandomState(0)
    x = (0.5 + 2 * rng.randn(3, 5, 24)).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(24)).astype(np.float32)
    bias = (0.1 * rng.randn(24)).astype(np.float32)
    v = {"params": {"scale": jnp.asarray(scale).astype(p_dtype),
                    "bias": jnp.asarray(bias).astype(p_dtype)}}
    want = fnn.LayerNorm(epsilon=1e-5).apply(v, jnp.asarray(x).astype(x_dtype))
    norm = LayerNorm(24, 1e-5)
    load_jax_variables(norm, _flat({"params": {"scale": scale, "bias": bias}}), strict=True)
    norm = norm.to(getattr(torch, p_dtype))
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(getattr(torch, x_dtype)))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    bound = F32 if want.dtype == jnp.float32 else 1e-2
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < bound


def test_layer_norm_fast_variance_where_it_cancels():
    """Rows whose mean dwarfs their spread: E[x^2] - E[x]^2 in f32 loses the
    variance, in Flax and in the port alike (rows of 2 and 8 values at
    powers of two, so every sum is the same in any order);
    ``F.layer_norm``'s two-pass variance keeps it and lands elsewhere."""
    for rows in (np.array([[4097.0, 4097.5], [1.0, 3.0]], np.float32),
                 np.array([[3000.0 + 0.25 * i for i in range(8)]], np.float32)):
        c = rows.shape[-1]
        v = {"params": {"scale": jnp.ones(c), "bias": jnp.zeros(c)}}
        want = np.asarray(fnn.LayerNorm(epsilon=1e-5).apply(v, jnp.asarray(rows)))
        got = layer_norm(torch.from_numpy(rows), torch.ones(c), torch.zeros(c), 1e-5).numpy()
        two_pass = F.layer_norm(torch.from_numpy(rows), (c,), eps=1e-5).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.abs(two_pass[0] - want[0]).max() > 10.0


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_self_attention_matches_jax(amp):
    """The packed (n, t, 3, heads, head_dim) qkv, the scale in x's dtype, the
    softmax in x's dtype (bf16 under AMP), the biased out projection; the
    output and the gradients of the input and every parameter."""
    jmod = jax_unetr.SelfAttention(32, 4)
    x = _x(2, 27, 32, seed=3)
    variables = bn_init(jmod, x, seed=4)
    tmod = unetr.SelfAttention(32, 4)
    load_jax_variables(tmod, _flat(variables), strict=True)
    v, xj = (_cast(variables), jnp.asarray(x).astype(jnp.bfloat16)) if amp else (
        variables, jnp.asarray(x))
    want = jax.jit(jmod.apply)(v, xj)
    params = {k: (p.to(torch.bfloat16) if amp else p) for k, p in tmod.named_parameters()}
    xt = torch.from_numpy(x).to(torch.bfloat16) if amp else torch.from_numpy(x)
    with torch.no_grad():
        got = functional_call(tmod, params, (xt,))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < (
        BF16 if amp else F32)
    _check_grads(jmod, tmod, variables, x, amp)


# --- the standalone ViT and ViTAutoEnc -----------------------------------------------


@functools.lru_cache(maxsize=None)
def _vit(name):
    x = _x(2, 32, 32, 32, 2, seed=5)
    jmod = jax_create_model(name, **VITS[name])
    variables = bn_init(jmod, x, seed=6)
    model = load_jax_variables(create_model(name, **VITS[name]), _flat(variables), strict=True)
    return jmod, variables, model.eval(), x


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(VITS))
def test_vit_forward_matches_jax(name, amp):
    """The output (the class logits after tanh, or the reconstruction) and
    every hidden state."""
    jmod, variables, model, x = _vit(name)
    v, xj = (_cast(variables), jnp.asarray(x).astype(jnp.bfloat16)) if amp else (
        variables, jnp.asarray(x))
    want, want_states = jax.jit(jmod.apply)(v, xj)
    net = copy.deepcopy(model).to(torch.bfloat16) if amp else model
    with torch.no_grad():
        got, states = net(torch.from_numpy(x).to(torch.bfloat16 if amp else torch.float32))
    assert len(states) == len(want_states) == VITS[name]["num_layers"]
    for g, w in zip([got] + states, [want] + list(want_states)):
        assert tuple(g.shape) == w.shape and str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32))) < (BF16 if amp else F32)
    if name == "ViT":
        assert got.shape == (2, 3) and float(got.abs().max()) < 1.0  # tanh


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(VITS))
def test_vit_gradients_match_jax(name, amp):
    """Gradients of sum(output * g) w.r.t. every parameter (the class token
    and head included) and the input: f32 within 1e-4 (JAX's own f64 error
    allowed for), bf16 no further from JAX's f32 than 1.25x JAX's own."""
    jmod, variables, model, x = _vit(name)
    _check_grads(jmod, model, variables, x, amp, jax_kwargs={"train": True},
                 torch_kwargs={"train": True})


# --- shapes, names, initialisers and checkpoints ----------------------------------------


def test_names_resolve_and_shapes_are_checked():
    for name in ("UNETR", "SwinUNETR", "ViT", "ViTAutoEnc"):
        assert name not in NOT_YET_PORTED
        assert isinstance(create_model(name), torch.nn.Module)
    model = create_model("UNETR", **UNETR_KWARGS)
    with pytest.raises(ValueError, match="img_size"):
        model(torch.zeros(1, 48, 48, 48, 2))
    jmod = jax_create_model("UNETR", **UNETR_KWARGS)
    with pytest.raises(ValueError, match="img_size"):
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 48, 2))))
    with pytest.raises(ValueError, match="divisible"):
        create_model("UNETR", img_size=40)
    with pytest.raises(NotImplementedError):
        create_model("UNETR", spatial_dims=2)


def test_initialisers_follow_flax():
    """pos_embedding normal(0.02), cls_token zeros, Swin's relative-position
    tables Flax's truncated_normal(0.02): a standard normal cut at +-2 times
    0.02 (standard deviation 0.02 * 0.8796), not rescaled as the kernels."""
    vit = create_model("ViT", **dict(VITS["ViT"], hidden_size=64, mlp_dim=64))
    swin = create_model("SwinUNETR", img_size=[64] * 3, feature_size=12, depths=[2, 2, 2, 2],
                        num_heads=[3, 3, 3, 3])
    for model in (vit, swin):
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(7.0)
        init_parameters(model, torch.Generator().manual_seed(0))
    pos = vit.pos_embedding.detach().numpy()
    assert abs(pos.mean()) < 2e-3 and abs(pos.std() - 0.02) < 1e-3
    assert torch.equal(vit.cls_token, torch.zeros(1, 1, 64))
    tables = np.concatenate([p.detach().numpy().ravel() for k, p in swin.named_parameters()
                             if k.endswith("relative_position_bias_table")])
    assert tables.size > 20000
    assert np.abs(tables).max() <= 0.04 and abs(tables.mean()) < 1e-3
    assert abs(tables.std() - 0.02 * 0.87962566) < 5e-4


def test_jax_checkpoint_loads_strictly_both_ways(tmp_path):
    """A JAX ``.npz`` loads strictly into the port and the port's file into
    the JAX tree with equal arrays; the model has no buffer, so nothing
    lands in ``batch_stats``."""
    n = _net()
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(n.variables, path)
    flat = load_checkpoint(path)
    model = load_jax_variables(create_model("UNETR", **UNETR_KWARGS), flat, strict=True)
    assert list(model.buffers()) == []
    ours = model_variables(model)
    assert set(ours) == set(flat) and all(k.startswith("params/") for k in ours)
    assert "params/vit/pos_embedding" in ours
    out = str(tmp_path / "port.npz")
    save_checkpoint(model, out)
    loaded = jax_ckpt.load_into(n.variables, out, strict=True)
    assert set(loaded) == {"params"}
    for key, value in _flat(loaded).items():
        np.testing.assert_array_equal(value, flat[key])

"""The port's SwinUNETR and its pieces against the JAX package's, with the
JAX variables (every kernel, scale, bias and relative-position table seeded
off its initial value from ``jax.eval_shape``'s tree,
``test_torch_batchnorm.bn_init``) carried across strictly.

SwinUNETR at feature 6, depths (2, 2, 1, 1), heads (1, 2, 2, 2), window 7,
patch 2 on a 32^3 input, batch 2: the stages are 16^3, 8^3, 4^3 and 2^3,
so the window pads two stages (16 -> 21, 8 -> 14), is clamped to the other
two (4^3, 2^3), and the two-block stages shift by 3 under the boundary
mask (the AMP checks: test_torch_swin_unetr_amp.py, a file of their own
so that each file's JAX compiles stay within a minute). Not 64^3: each JAX train step there compiles and runs for ~20 s, and
its full-resolution blocks see 262,144 voxels a channel, where an f32
forward in either package puts a leaky ReLU or two on the other side of
its kink from the f64 one, and each such voxel moves its block's f32
gradients ~1e-3 from f64 (a UnetResBlock at 64^3: the port 1.0e-3 and JAX
3.3e-6 on one input, the port 5.6e-6 and JAX 7.8e-4 on another; one
sign flip at the port's final leaky ReLU on the first), so the 1e-4 bound
would hold neither package there. Tolerances, relative L2, through ``tests/test_torch_batchnorm.py``'s
helpers: eval forward 1e-5 in f32, 2e-2 in bf16 (the AMP eval step, JAX's
own bf16 distance allowed for); the first train step's gradients 1e-4 in
f32 against JAX and JAX's f64 evaluation, JAX's own error allowed for (the
f32 softmax is f32 in that evaluation too, as the JAX module casts it);
bf16 gradients no further from JAX's f32 than 1.25x JAX's own; two SGD
steps 1e-5; every module's output dtype under AMP as Flax's. Unit pins:
window partition and reverse, the relative-position index and the shift
masks against the JAX helpers; PatchMerging's octant order with odd dims;
a block whose window pads one axis, is clamped on another and shifts; the
window attention's f32 softmax; the constants are not in the state.
"""
import functools

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp

from unet3d_tpu.models import swin_unetr as jax_swin
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train import checkpoint as jax_ckpt

from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models import swin_unetr
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (BF16, F32, Net, bn_init, check_forwards, check_grads,
                                  check_train_steps)
from test_torch_myronenko import _cast, _check_grads, _flat, _rel, _x

SHAPE = (2, 32, 32, 32, 2)
SWIN_KWARGS = dict(img_size=[32, 32, 32], in_channels=2, out_channels=3, feature_size=6,
                   depths=[2, 2, 1, 1], num_heads=[1, 2, 2, 2])


@functools.lru_cache(maxsize=None)
def _net():
    return Net("SwinUNETR", SWIN_KWARGS, SHAPE)


def test_forwards_match_jax():
    check_forwards(_net())


def test_gradients_match_jax():
    check_grads(_net(), False)


def test_train_steps_match_jax():
    check_train_steps(_net(), 1)


# --- windows, masks and merging ------------------------------------------------------


@pytest.mark.parametrize("ws", [(2, 3, 4), (4, 2, 8), (1, 2, 1)])
def test_window_partition_and_reverse_match_jax(ws):
    x = _x(2, 4, 6, 8, 5, seed=1)
    want = np.asarray(jax_swin._window_partition(jnp.asarray(x), ws))
    got = swin_unetr._window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    back = swin_unetr._window_reverse(got, ws, (2, 4, 6, 8))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_swin._window_reverse(jnp.asarray(want), ws, (2, 4, 6, 8))))


@pytest.mark.parametrize("dims,ws,shift", [((14, 14, 14), (7, 7, 7), (3, 3, 3)),
                                           ((8, 6, 4), (4, 3, 4), (2, 1, 0)),
                                           ((9, 6, 3), (3, 3, 3), (1, 1, 1))])
def test_relative_index_and_shift_mask_match_jax(dims, ws, shift):
    np.testing.assert_array_equal(swin_unetr._relative_position_index(ws),
                                  jax_swin._relative_position_index(ws))
    got = swin_unetr._shift_attn_mask(dims, ws, shift)
    np.testing.assert_array_equal(got, jax_swin._shift_attn_mask(dims, ws, shift))
    assert got.shape == (np.prod(dims) // np.prod(ws), np.prod(ws), np.prod(ws))
    assert (got != 0).any() and (got == 0).any()


def _module_pair(jmod, tmod, x, seed):
    variables = bn_init(jmod, x, seed=seed)
    load_jax_variables(tmod, _flat(variables), strict=True)
    return variables


def _check_module(jmod, tmod, variables, x, amp):
    v, xj = (_cast(variables), jnp.asarray(x).astype(jnp.bfloat16)) if amp else (
        variables, jnp.asarray(x))
    want = jax.jit(jmod.apply)(v, xj)
    params = {k: (p.to(torch.bfloat16) if amp else p) for k, p in tmod.named_parameters()}
    with torch.no_grad():
        got = functional_call(tmod, params, (torch.from_numpy(x).to(
            torch.bfloat16 if amp else torch.float32),))
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < (
        BF16 if amp else F32)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_patch_merging_with_odd_dims_matches_jax(amp):
    """Odd dims padded on the high side, the octants in (d, h, w) offset
    order: 8 * C channels, LayerNorm, the bias-free reduction."""
    x = _x(2, 5, 4, 3, 6, seed=2)
    jmod, tmod = jax_swin.PatchMerging(6), swin_unetr.PatchMerging(6)
    variables = _module_pair(jmod, tmod, x, 3)
    _check_module(jmod, tmod, variables, x, amp)
    # the octant order itself, through the norm and the reduction: the
    # concatenation of x[a::2, b::2, c::2] over (a, b, c) in that order
    padded = np.pad(x, ((0, 0), (0, 1), (0, 0), (0, 1), (0, 0)))
    octants = np.concatenate([padded[:, a::2, b::2, c::2] for a in range(2) for b in range(2)
                              for c in range(2)], axis=-1)
    with torch.no_grad():
        want = tmod.reduction(tmod.norm(torch.from_numpy(octants)))
        np.testing.assert_allclose(tmod(torch.from_numpy(x)).numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_block_with_pad_clamp_and_shift_matches_jax(amp):
    """A shifted block on a (9, 5, 3) volume with a window of 4: clamped to
    3 along w (no shift there), padded to (12, 8, 3), shifted by (2, 2, 0)
    under the mask built on the padded dims; the output and the gradients."""
    x = _x(2, 9, 5, 3, 8, seed=4)
    jmod = jax_swin.SwinTransformerBlock(8, 2, (4, 4, 4), shift=True)
    tmod = swin_unetr.SwinTransformerBlock(8, 2, (4, 4, 4), (9, 5, 3), shift=True)
    assert tmod.ws == (4, 4, 3)
    variables = _module_pair(jmod, tmod, x, 5)
    _check_module(jmod, tmod, variables, x, amp)
    _check_grads(jmod, tmod, variables, x, amp)
    with pytest.raises(ValueError, match="window"):
        tmod(torch.zeros(1, 9, 5, 2, 8))


def test_window_attention_softmax_is_f32_under_amp():
    """bf16 scores divided by the numpy scalar sqrt(head_dim) become f32 in
    JAX, so the bias, the mask and the softmax run in f32: the port's
    output stays within bf16 rounding of JAX's, and a bf16 softmax (UNETR's)
    on the same scores lands farther."""
    x = _x(4, 27, 8, seed=6)
    ws = (3, 3, 3)
    mask = jax_swin._shift_attn_mask((6, 3, 3), ws, (1, 1, 1))
    jmod = jax_swin.WindowAttention(8, 2, ws)
    tmod = swin_unetr.WindowAttention(8, 2, ws)
    variables = _module_pair(jmod, tmod, x, 7)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jmod.apply(_cast(variables), xb, jnp.asarray(mask)).astype(jnp.float32))
    exact = np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(mask)))
    params = {k: p.to(torch.bfloat16) for k, p in tmod.named_parameters()}
    with torch.no_grad():
        got = functional_call(tmod, params, (torch.from_numpy(x).to(torch.bfloat16),
                                             torch.from_numpy(mask)))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) < BF16
    assert _rel(got.float().numpy(), exact) <= 1.25 * _rel(want, exact)


# --- shapes, constants and checkpoints ----------------------------------------------


def test_shapes_are_checked_and_constants_stay_out_of_the_state():
    model = create_model("SwinUNETR", **SWIN_KWARGS)
    with pytest.raises(ValueError, match="divisible"):
        model(torch.zeros(1, 48, 48, 48, 2))
    jmod = jax_create_model("SwinUNETR", **SWIN_KWARGS)
    with pytest.raises(ValueError, match="divisible"):
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 48, 2))))
    # a 64^3 input needs a window of 7 at stage 2 (8^3): its table was built
    # for the window clamped to 4^3
    with pytest.raises(ValueError, match="window"):
        model(torch.zeros(1, 64, 64, 64, 2))
    assert list(model.buffers()) == [] and not any(
        "index" in k or "mask" in k for k in model.state_dict())
    with pytest.raises(NotImplementedError):
        create_model("SwinUNETR", spatial_dims=2)


def test_jax_checkpoint_loads_strictly_both_ways(tmp_path):
    n = _net()
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(n.variables, path)
    flat = load_checkpoint(path)
    model = load_jax_variables(create_model("SwinUNETR", **SWIN_KWARGS), flat, strict=True)
    ours = model_variables(model)
    assert set(ours) == set(flat) and all(k.startswith("params/") for k in ours)
    assert ours["params/stage1_block0/attn/relative_position_bias_table"].shape == (13 ** 3, 2)
    assert ours["params/stage3_block0/attn/relative_position_bias_table"].shape == (3 ** 3, 2)
    out = str(tmp_path / "port.npz")
    save_checkpoint(model, out)
    loaded = jax_ckpt.load_into(n.variables, out, strict=True)
    assert set(loaded) == {"params"}
    for key, value in _flat(loaded).items():
        np.testing.assert_array_equal(value, flat[key])

"""The port's EfficientNetBN against the JAX package's (the ``Classifier``
harness of ``tests/test_torch_resnet.py``: one jitted JAX computation of
the eval and training forwards, the running statistics and the gradients,
one ``jax.vjp`` each in f32 and bf16 AMP, no JAX train step; the tolerances
stated there).

Structure: b7 (the widest and deepest table) has JAX's variable names and
shapes and loads strictly (b0's tree is the numerics' below), and the width
and depth rounding is JAX's for every variant. Numerics on b0 (its table is
fixed: sixteen MBConv blocks) at (8, 16^3, 1) without noise
(``drop_connect_rate`` and ``dropout_rate`` 0: ``jax.random`` cannot be
matched): the forwards, the statistics and the f32 gradients, and the bf16
eval forward; the bf16 gradients and statistics on one MBConv block with
every part (expansion, a 5-cubed depthwise conv, squeeze-and-excitation,
the identity), whose JAX compile is a fraction of the net's. Then the pieces with
their own conventions: TF's "same" pads (the odd pad at the high side) at
stride 2 on even and odd sizes against JAX's ``_tf_same_pads``, and the
drop-connect draws held apart: one mask value per item, the kept items
scaled by 1 / keep, the same under one seed and other under another.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from unet3d_tpu.models import efficientnet as jax_effnet

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models import efficientnet
from unet3d_tpu_torch.models.layers import Conv, init_parameters

from test_torch_batchnorm import F32, few_threads  # noqa: F401 (autouse)
from test_torch_myronenko import _rel, _x
from test_torch_resnet import (Classifier, check_bf16, check_forwards, check_grads_f32,
                               check_structure)


def test_structure_matches_jax():
    check_structure("EfficientNetBN", dict(model_name="efficientnet-b7", in_channels=2,
                                           num_classes=3), (1, 32, 32, 32, 2))


def test_rounding_matches_jax():
    for width, depth, _, _ in jax_effnet._PARAMS.values():
        for *_, ci, co, _ in jax_effnet._B0_BLOCKS:
            for f in (ci, co, 32, 1280):
                assert efficientnet._round_filters(f, width) == jax_effnet._round_filters(f, width)
        for r, *_ in jax_effnet._B0_BLOCKS:
            assert efficientnet._round_repeats(r, depth) == jax_effnet._round_repeats(r, depth)
    assert efficientnet._PARAMS == jax_effnet._PARAMS
    assert efficientnet._B0_BLOCKS == jax_effnet._B0_BLOCKS


KWARGS = dict(model_name="efficientnet-b0", in_channels=1, num_classes=3,
              drop_connect_rate=0.0, dropout_rate=0.0)


@functools.lru_cache(maxsize=None)
def _case(which):
    if which == "net":
        return Classifier(jax_effnet.EfficientNetBN(**KWARGS),
                          lambda: efficientnet.EfficientNetBN(**KWARGS),
                          _x(8, 16, 16, 16, 1, seed=1), 3, bf16_grads=False)
    # one MBConv block with every part: expansion, a 5-cubed depthwise conv,
    # squeeze-and-excitation and the identity
    block = dict(kernel=5, stride=1, expand_ratio=6, out_channels=8, se_ratio=0.25,
                 drop_connect=0.0)
    return Classifier(jax_effnet.MBConvBlock(**block),
                      lambda: efficientnet.MBConvBlock(8, 5, 1, 6, 8, 0.25, 0.0),
                      _x(4, 6, 6, 6, 8, seed=2))


@pytest.mark.parametrize("which", ["net", "block"])
def test_forwards_match_jax(which):
    check_forwards(_case(which))


@pytest.mark.parametrize("which", ["net", "block"])
def test_f32_gradients_match_jax(which):
    check_grads_f32(_case(which))


@pytest.mark.parametrize("which", ["net", "block"])
def test_bf16_forwards_match_jax(which):
    """The net's bf16 eval forward; the block's, with AMP training's
    gradients and statistics."""
    check_bf16(_case(which))


@pytest.mark.parametrize("size,kernel", [(8, 3), (9, 3), (8, 5), (7, 5)])
def test_same_pads_match_jax_at_stride_2(size, kernel):
    """``layers.Conv(padding="SAME")`` at stride 2 (the stem, the
    depthwise convs) pads as JAX's ``_tf_same_pads``: the odd pad at the
    high side; the depthwise conv (one group per channel) equals JAX's."""
    x = _x(2, size, size + 1, size, 4, seed=2)
    conv = Conv(4, 4, kernel, 2, "SAME", use_bias=False, groups=4)
    assert conv._pads(x.shape[1:4]) == jax_effnet._tf_same_pads(x.shape[1:4], kernel, 2)
    jconv = fnn.Conv(4, (kernel,) * 3, strides=(2,) * 3,
                     padding=jax_effnet._tf_same_pads(x.shape[1:4], kernel, 2),
                     feature_group_count=4, use_bias=False)
    w = _x(kernel, kernel, kernel, 1, 4, seed=3)
    load_jax_variables(conv, {"params/kernel": w}, strict=True)
    want = jax.jit(jconv.apply)({"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
    with torch.no_grad():
        assert _rel(conv(torch.from_numpy(x)).numpy(), want) < F32


def test_drop_connect_draws_one_mask_per_item():
    """In training a block with drop-connect keeps or drops each item's
    residual branch whole (scaled by 1 / keep when kept), draws from the
    generator: the same masks under one seed, others under another; eval
    draws nothing."""
    block = efficientnet.MBConvBlock(8, 3, 1, 1, 8, 0.25, 0.5)
    init_parameters(block, torch.Generator().manual_seed(0))
    x = torch.randn(64, 4, 4, 4, 8)
    with torch.no_grad():
        saved = block.drop_connect
        block.drop_connect = 0.0
        full = block(x, train=True) - x
        block.drop_connect = saved
        runs = [block(x, train=True, rng=torch.Generator().manual_seed(s)) - x
                for s in (1, 1, 2)]
        assert torch.equal(block(x), block(x, train=False, rng=torch.Generator()))
    for r in runs:
        kept = r.flatten(1).abs().sum(1) > 0
        np.testing.assert_allclose(r[kept].numpy(), (full[kept] / 0.5).numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert 16 < int(kept.sum()) < 48
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="rng"):
        block(x, train=True)

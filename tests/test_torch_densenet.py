"""The port's DenseNet against the JAX package's (the ``Classifier`` harness
of ``tests/test_torch_resnet.py``: one jitted JAX computation of the eval
and training forwards, the running statistics and the gradients in f32 and
bf16 AMP, the tolerances stated there).

Structure: ``DenseNet`` and the 121 / 169 / 201 / 264 factories have JAX's
variable names and shapes (``jax.eval_shape``: no compile) and load
strictly. Numerics on the smallest net that reaches every block: two dense
blocks of (2, 1) layers (growth 8, ``bn_size`` 4: ``conv2`` 32 -> 8, the
3-cubed ``FastConv`` the hand kernel runs on the card), one transition
(BN, relu, a 1-cubed conv halving the channels, the 2-cubed VALID average
pool) on (4, 16^3, 2) inputs; and the concatenation order, ``[x, y]``.
"""
import functools

import numpy as np
import pytest
import torch

from unet3d_tpu.models import densenet as jax_densenet

from unet3d_tpu_torch.models import densenet

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_myronenko import _x
from test_torch_resnet import (Classifier, check_bf16, check_forwards, check_grads_f32,
                               check_structure)

NAMES = ("DenseNet", "DenseNet121", "DenseNet169", "DenseNet201", "DenseNet264")


@pytest.mark.parametrize("name", NAMES)
def test_structure_matches_jax(name):
    check_structure(name, dict(in_channels=2, out_channels=3), (1, 32, 32, 32, 2))


KWARGS = dict(in_channels=2, out_channels=3, init_features=16, growth_rate=8,
              block_config=(2, 1), bn_size=4)


@functools.lru_cache(maxsize=None)
def _case():
    return Classifier(jax_densenet.DenseNet(**KWARGS), lambda: densenet.DenseNet(**KWARGS),
                      _x(4, 16, 16, 16, 2, seed=1), 3)


def test_forwards_match_jax():
    check_forwards(_case())


def test_f32_gradients_match_jax():
    check_grads_f32(_case())


def test_bf16_forward_gradients_and_statistics_match_jax():
    check_bf16(_case())


def test_dense_layer_concatenates_its_input_first():
    """A dense layer's output is ``[x, y]``: its input's channels first,
    unchanged, then the ``growth_rate`` new ones."""
    layer = densenet.DenseLayer(5, 3, 2, 0.0)
    for p in layer.parameters():
        torch.nn.init.normal_(p)
    x = torch.randn(2, 4, 4, 4, 5)
    with torch.no_grad():
        y = layer(x)
    assert y.shape == (2, 4, 4, 4, 8)
    assert torch.equal(y[..., :5], x)
    assert not torch.equal(y[..., 5:], torch.zeros_like(y[..., 5:]))
    assert np.isfinite(y.numpy()).all()

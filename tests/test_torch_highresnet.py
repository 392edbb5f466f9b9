"""The port's HighResNet against the JAX package's, with the JAX variables
(``params`` and ``batch_stats``, every scale, bias and running statistic
moved off its initial value) carried across strictly.

HighResNet's widths are fixed (16 / 32 / 64 / 80 channels, dilations 1 / 2
/ 4, no downsampling), so it runs at 6^3, batch 2 (every BatchNorm sees 432
values a channel). At 8^3 one ReLU input (after ``res_2_1.bn0``) lies 9e-7
from its kink in JAX's f64 evaluation and the port's f32 forward puts it at
-1.7e-7, on the other side: that one element carries 1.7% of the gradient
norm there, so the port's f32 gradients land 5.7e-3 from f64 where JAX's,
on the f64 side, land 1.5e-6 (a kink flip, as SwinUNETR's at 64^3; either
package can draw one). Through ``tests/test_torch_batchnorm.py``'s helpers,
tolerances as stated there: eval and train forwards in f32 (relative L2
1e-5, JAX's own distance from f64 allowed for), the running statistics a
train forward leaves, the first step's gradients in f32 (1e-4, JAX's f64
rule) and bf16 (no further from JAX's f32 ones than 1.25 times JAX's bf16),
two SGD steps (parameters and ``batch_stats``), the AMP eval step (2e-2)
and the dtype flow module by module under AMP. Also the channel pad
(``total // 2`` zeros before, the rest after) against the JAX block, the
whole-channel dropout's draws, and the JAX ``.npz`` both ways.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet3d_tpu.models import highresnet as jax_highresnet
from unet3d_tpu.train import checkpoint as jax_ckpt

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models import highresnet
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (F32, Net, bn_init, check_amp_eval_step, check_dtype_flow,
                                  check_forwards, check_grads, check_train_steps)
from test_torch_monai_nets import check_dropout_draws
from test_torch_myronenko import _flat, _rel, _x

KWARGS = dict(in_channels=2, out_channels=3)
SHAPE = (2, 6, 6, 6, 2)


@functools.lru_cache(maxsize=None)
def _net():
    return Net("HighResNet", KWARGS, SHAPE)


def test_forwards_match_jax():
    check_forwards(_net())


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_gradients_match_jax(amp):
    check_grads(_net(), amp)


def test_train_steps_match_jax():
    check_train_steps(_net(), 1)


def test_amp_eval_step_matches_jax():
    check_amp_eval_step(_net())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_dtype_flow_matches_jax(train):
    check_dtype_flow(_net(), train)


@pytest.mark.parametrize("cin,features", [(16, 32), (32, 64), (5, 16)])
def test_channel_pad_matches_jax(cin, features):
    """A block that grows the width pads the identity with ``total // 2``
    zero channels before and the rest after (an odd total too), in eval and
    train forwards."""
    x = _x(2, 4, 4, 4, cin, seed=3)
    jmod = jax_highresnet.HighResBlock(features, 2)
    variables = bn_init(jmod, x)
    block = highresnet.HighResBlock(cin, features, 2)
    load_jax_variables(block, _flat(variables), strict=True)
    # one compile for both modes: an eager apply dispatches op by op
    ev, (tr, _) = jax.jit(lambda v, a: (jmod.apply(v, a), jmod.apply(
        v, a, True, mutable=["batch_stats"])))(variables, jnp.asarray(x))
    with torch.no_grad():
        assert _rel(block(torch.from_numpy(x)).numpy(), ev) < F32
        assert _rel(block(torch.from_numpy(x), True).numpy(), tr) < F32
    # the identity alone: zero convs leave y = 0 after the second conv
    with torch.no_grad():
        block.conv1.kernel.zero_()
        out = block(torch.from_numpy(x)).numpy()
    total = features - cin
    np.testing.assert_array_equal(out[..., :total // 2], 0.0)
    np.testing.assert_array_equal(out[..., total // 2:total // 2 + cin], x)
    np.testing.assert_array_equal(out[..., total // 2 + cin:], 0.0)


def test_dropout_draws():
    check_dropout_draws("HighResNet", dict(KWARGS, dropout_prob=0.3), (1, 4, 4, 4, 2))


def test_jax_checkpoint_with_batch_stats_loads_strictly_both_ways(tmp_path):
    n = _net()
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(n.variables, path)
    flat = load_checkpoint(path)
    assert any(k.startswith("batch_stats/") for k in flat)
    model = load_jax_variables(create_model("HighResNet", **KWARGS), flat, strict=True)
    out = str(tmp_path / "port.npz")
    save_checkpoint(model, out)
    loaded = jax_ckpt.load_into(n.variables, out, strict=True)
    assert set(loaded) == {"params", "batch_stats"}
    for key, value in _flat(loaded).items():
        np.testing.assert_array_equal(value, flat[key])


def test_unsupported_options_raise():
    with pytest.raises(NotImplementedError):
        create_model("HighResNet", spatial_dims=2)
    model = create_model("HighResNet", in_channels=4, out_channels=3)
    assert model.conv_0.kernel.shape == (3, 3, 3, 4, 16)
    assert model.res_3_0.conv0.dilation == (4, 4, 4)

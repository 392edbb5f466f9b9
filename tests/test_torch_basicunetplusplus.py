"""The port's BasicUNetPlusPlus against the JAX package's, with the JAX
variables (``test_torch_batchnorm.bn_init``) carried across strictly; its
blocks are BasicUNet's (test_torch_basicunet.py, which also holds the bf16
gradients).

Features (4, 4, 8, 8, 16, 4) at 16^3, batch 2, with ``deep_supervision``
(in training the stack of the four heads, ``final_conv_0_4`` last) and, on
the same variables without the extra heads, without it. Tolerances,
relative L2, through ``tests/test_torch_batchnorm.py``'s helpers: eval and
training forwards 1e-5 in f32, 2e-2 in bf16 (the AMP eval step, JAX's own
bf16 distance allowed for); the first train step's gradients 1e-4 in f32,
against JAX and JAX's f64 evaluation with JAX's own error allowed for; two
SGD steps through ``make_train_step`` 1e-5 (the stack through the
criterion's 1/2^i weighting in both packages); every module's output dtype
under AMP as Flax's captured intermediates; the ``.npz`` both ways.
"""
import functools

import numpy as np
import pytest
import torch

from unet3d_tpu.train import checkpoint as jax_ckpt

from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from test_torch_basicunet import KWARGS
from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (F32, Net, check_amp_eval_step, check_dtype_flow,
                                  check_forwards, check_grads, check_train_steps)
from test_torch_myronenko import _flat, _rel


@functools.lru_cache(maxsize=None)
def _net():
    return Net("BasicUNetPlusPlus", dict(KWARGS, deep_supervision=True), (2, 16, 16, 16, 2))


def test_forwards_match_jax():
    check_forwards(_net())


def test_gradients_match_jax():
    check_grads(_net(), False)


def test_train_steps_match_jax():
    check_train_steps(_net(), 1)


def test_amp_eval_step_matches_jax():
    check_amp_eval_step(_net())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_dtype_flow_matches_jax(train):
    check_dtype_flow(_net(), train)


def test_without_deep_supervision_matches_jax():
    """``deep_supervision`` false: no extra heads, and the eval and training
    outputs are JAX's eval output of the same variables (the deep-supervision
    net's ``final_conv_0_4``: the heads are outside the path)."""
    n = _net()
    flat = {k: v for k, v in n.flat.items() if "final_conv_0_4" in k
            or not k.startswith("params/final_conv")}
    model = load_jax_variables(create_model(n.name, **KWARGS), flat, strict=True)
    assert not hasattr(model, "final_conv_0_1")
    x = torch.from_numpy(n.x)
    with torch.no_grad():
        for train in (False, True):
            assert _rel(model(x, train=train).numpy(), n.jax_f32[0]) < F32


def test_deep_supervision_heads():
    """The three extra heads exist whenever ``deep_supervision`` is set; in
    training the four heads are stacked on axis 1, ``final_conv_0_4`` last
    (the eval output); without it training returns the eval output alone."""
    n = _net()
    model = n.port()
    assert {f"final_conv_0_{j}" for j in (1, 2, 3, 4)} <= {k for k, _ in model.named_children()}
    x = torch.from_numpy(n.x)
    with torch.no_grad():
        out, stack = model(x), model(x, train=True)
    assert stack.shape == (2, 4) + tuple(out.shape[1:])
    assert torch.equal(stack[:, 3], out)


def test_jax_checkpoint_loads_strictly_both_ways(tmp_path):
    """A JAX ``.npz`` (the deep-supervision heads included) loads strictly
    into the port and the port's file into the JAX tree with equal arrays;
    no buffer, so nothing lands in ``batch_stats``."""
    n = _net()
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(n.variables, path)
    flat = load_checkpoint(path)
    model = load_jax_variables(create_model(n.name, **n.kwargs), flat, strict=True)
    assert list(model.buffers()) == []
    ours = model_variables(model)
    assert set(ours) == set(flat) and "params/final_conv_0_2/kernel" in ours
    out = str(tmp_path / "port.npz")
    save_checkpoint(model, out)
    loaded = jax_ckpt.load_into(n.variables, out, strict=True)
    assert set(loaded) == {"params"}
    for key, value in _flat(loaded).items():
        np.testing.assert_array_equal(value, flat[key])

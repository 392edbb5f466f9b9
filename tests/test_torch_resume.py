"""Optimizer state across a resume, in the JAX package's file format, and the
flexible (non-strict) checkpoint load.

A state the JAX package saves (``save_opt_state``) after 3 updates loads into
the port's optimizer, and 3 more updates on both sides agree within 1e-5; a
state the port saves loads in the JAX package's ``load_opt_state`` with the
same leaves (its key strings, shapes and values), and continues the same way.
The port's ``run_training`` with ``save_optimizer`` resumed after 2 of 3
epochs ends bit-equal to an uninterrupted run on the CPU. The flexible load
(tile, then truncate, a tensor of another shape) is bit-equal to the JAX
package's ``match_state_shapes``.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train import checkpoint as jax_ckpt

from unet3d_tpu_torch.convert import load_jax_variables, state_dict_to_flax
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.train import checkpoint, losses, optim, step, train

from test_torch_optim import (CASES, IDS, LR, _nested, gradients, initial_params,
                              jax_run, port_params, port_run)

MODEL_KWARGS = dict(in_channels=2, out_channels=3, strides=[[1, 1, 1], [2, 2, 2]],
                    filters=[4, 8], kernel_size=[[3, 3, 3]] * 2,
                    upsample_kernel_size=[[2, 2, 2]])


def _keyed(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_a_jax_optimizer_file_resumes_in_the_port(name, kwargs, tmp_path):
    params, grads = initial_params(), gradients()
    history, state, tx = jax_run(name, kwargs, params, grads[:3])
    path = str(tmp_path / "model_optimizer.npz")
    jax_ckpt.save_opt_state(jax.device_get(state), path)
    tensors = port_params(history[-1])
    opt = optim.build_optimizer(name, list(tensors.values()), lr=LR, **kwargs)
    checkpoint.load_opt_state(opt, list(tensors), path)
    assert opt.update_count == 3
    # the loaded state, written again, is the file JAX wrote
    saved = np.load(path)
    arrays = checkpoint.opt_state_arrays(opt, list(tensors))
    assert arrays.keys() == set(saved.files)
    for key in saved.files:
        assert arrays[key].dtype == saved[key].dtype, key
        np.testing.assert_array_equal(arrays[key], saved[key], err_msg=key)
    want, _, _ = jax_run(name, kwargs, history[-1], grads[3:], tx=tx, state=state)
    got = port_run(opt, tensors, grads[3:])
    for k in want[-1]:
        np.testing.assert_allclose(got[-1][k], want[-1][k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_the_port_optimizer_file_loads_in_jax(name, kwargs, tmp_path):
    params, grads = initial_params(), gradients()
    tensors = port_params(params)
    opt = optim.build_optimizer(name, list(tensors.values()), lr=LR, **kwargs)
    # before any update the file is optax's initial state
    _, fresh, tx = jax_run(name, kwargs, params, [])
    initial = checkpoint.opt_state_arrays(opt, list(tensors))
    want_initial = _keyed(fresh)
    assert initial.keys() == want_initial.keys()
    for key, value in want_initial.items():
        np.testing.assert_array_equal(initial[key], value, err_msg=key)
    after = port_run(opt, tensors, grads[:3])
    path = str(tmp_path / "model_optimizer.npz")
    checkpoint.save_opt_state(opt, list(tensors), path)
    template = tx.init(_nested(params))
    state = jax_ckpt.load_opt_state(template, path)
    saved = np.load(path)
    for key, value in _keyed(state).items():
        np.testing.assert_array_equal(value, saved[key], err_msg=key)
    assert int(state.count) == 3
    want, _, _ = jax_run(name, kwargs, after[-1], grads[3:], tx=tx,
                         state=jax.tree_util.tree_map(jnp.asarray, state))
    got = port_run(opt, tensors, grads[3:])
    for k in want[-1]:
        np.testing.assert_allclose(got[-1][k], want[-1][k], atol=1e-5, rtol=0, err_msg=k)


def test_a_mismatched_optimizer_file_raises(tmp_path):
    tensors = port_params(initial_params())
    names = list(tensors)
    opt = optim.build_optimizer("Adam", list(tensors.values()))
    good = checkpoint.opt_state_arrays(opt, names)
    bad = {
        "missing": {k: v for k, v in good.items() if "['b']" not in k},
        "extra": {**good, ".inner_state[0].mu['c']": np.zeros(2, np.float32)},
        "shape": {k: (np.zeros((4, 3), np.float32) if k.endswith("['a']['kernel']") else v)
                  for k, v in good.items()},
    }
    for what, arrays in bad.items():
        path = str(tmp_path / f"{what}.npz")
        np.savez(path, **arrays)
        with pytest.raises(checkpoint.OptStateMismatchError, match={
                "missing": "missing leaf", "extra": "unexpected", "shape": "shape"}[what]):
            checkpoint.load_opt_state(opt, names, path)
    with pytest.raises(checkpoint.OptStateMismatchError, match="Cannot read"):
        checkpoint.load_opt_state(opt, names, str(tmp_path / "nothing.npz"))
    sgd = optim.build_optimizer("SGD", list(tensors.values()), momentum=0.9)
    path = str(tmp_path / "adam.npz")
    np.savez(path, **good)
    with pytest.raises(checkpoint.OptStateMismatchError):
        checkpoint.load_opt_state(sgd, names, path)


class Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def _engine_run(directory, n_epochs, model=None):
    """run_training of a small DynUNet with AdamW and a scheduler, the
    optimizer state saved; a second call in ``directory`` resumes, its model
    reloaded from the checkpoint as the train CLI does."""
    if model is None:
        model = create_model("DynUNet", **MODEL_KWARGS)
        init_parameters(model, torch.Generator().manual_seed(4))
        model_file = os.path.join(directory, "model.npz")
        if os.path.exists(model_file):
            load_jax_variables(model, checkpoint.load_checkpoint(model_file))
    rng = np.random.RandomState(8)
    batches = [{"image": rng.randn(1, 2, 8, 8, 8).astype(np.float32),
                "label": (rng.rand(1, 3, 8, 8, 8) > 0.5).astype(np.float32)}
               for _ in range(2)]
    criterion = losses.DiceLoss(sigmoid=True)
    opt = optim.build_optimizer("AdamW", model.parameters(), lr=1e-2)
    scheduler = optim.build_scheduler("StepLR", 1e-2, step_size=1, gamma=0.5)
    train.run_training(step.make_train_step(model, criterion, opt),
                       step.make_eval_step(model, criterion), model, opt, n_epochs,
                       Loader(batches), Loader(batches[:1]),
                       os.path.join(directory, "training_log.csv"),
                       os.path.join(directory, "model.npz"), scheduler=scheduler,
                       save_optimizer=True)
    return model, opt


def test_run_training_resumes_with_the_saved_optimizer_state(tmp_path, monkeypatch):
    whole, resumed = tmp_path / "whole", tmp_path / "resumed"
    whole.mkdir()
    resumed.mkdir()
    want, _ = _engine_run(str(whole), 3)
    _engine_run(str(resumed), 2)
    saved = dict(np.load(str(resumed / "model_optimizer.npz")))
    loads = []
    real_load = train.load_opt_state

    def recorded(opt, names, filename):
        real_load(opt, names, filename)
        loads.append(checkpoint.opt_state_arrays(opt, names))

    monkeypatch.setattr(train, "load_opt_state", recorded)
    got, opt = _engine_run(str(resumed), 3)
    (loaded,) = loads
    assert loaded.keys() == saved.keys()
    for key in saved:
        np.testing.assert_array_equal(loaded[key], saved[key], err_msg=key)
    rows = train.read_training_log(str(resumed / "training_log.csv"))
    assert [r[0] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(r[1]) and np.isfinite(r[3]) for r in rows)
    assert opt.update_count == 6
    np.testing.assert_array_equal(np.asarray(rows),
                                  np.asarray(train.read_training_log(
                                      str(whole / "training_log.csv"))))
    for (key, a), b in zip(got.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), key


def test_first_step_failure_carries_the_memory_hint():
    def failing_step(images, labels):
        raise MemoryError("out of memory")

    batch = {"image": np.zeros((1, 2, 8, 8, 8), np.float32), "label": None}
    with pytest.raises(RuntimeError, match="remat") as info:
        train.epoch_training(Loader([batch]), failing_step, epoch=1)
    assert isinstance(info.value.__cause__, MemoryError)
    with pytest.raises(MemoryError):
        train.epoch_training(Loader([batch]), failing_step, epoch=2)


@pytest.mark.parametrize("out_channels,filters", [(1, [4, 8]), (5, [6, 8])],
                         ids=["truncate", "tile"])
def test_flexible_load_equals_match_state_shapes(out_channels, filters, tmp_path):
    """A checkpoint of the 3-output net into nets of other outputs and
    widths: bit-equal to the JAX package's flexible load, the keys the
    checkpoint lacks (none here) kept, and strict loading refusing it."""
    source = create_model("DynUNet", **MODEL_KWARGS)
    init_parameters(source, torch.Generator().manual_seed(5))
    path = str(tmp_path / "model.npz")
    checkpoint.save_checkpoint(source, path)
    kwargs = dict(MODEL_KWARGS, out_channels=out_channels, filters=filters)
    target = create_model("DynUNet", **kwargs)
    init_parameters(target, torch.Generator().manual_seed(6))
    fixed = state_dict_to_flax(target.state_dict())
    want = jax_ckpt.match_state_shapes(
        unflatten_dict({tuple(k.split("/")): v for k, v in fixed.items()}),
        jax_ckpt.load_checkpoint(path))
    want = {"/".join(k): np.asarray(v) for k, v in flatten_dict(want).items()}
    load_jax_variables(target, checkpoint.load_checkpoint(path), strict=False)
    got = state_dict_to_flax(target.state_dict())
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_variables(create_model("DynUNet", **kwargs),
                           checkpoint.load_checkpoint(path), strict=True)


def test_flexible_load_keeps_missing_and_drops_extra_keys(tmp_path):
    """A basic-block checkpoint into a res-block net: the projections keep
    their init, and keys of other collections are dropped."""
    model = jax_create_model("DynUNet", **MODEL_KWARGS)
    variables = jax.jit(lambda r: model.init(r, jnp.zeros((1, 8, 8, 8, 2)), False))(
        jax.random.PRNGKey(2))
    variables = {**variables, "batch_stats": {"x": jnp.ones(3)}}
    path = str(tmp_path / "model.npz")
    jax_ckpt.save_checkpoint(variables, path)
    target = create_model("DynUNet", **MODEL_KWARGS, res_block=True)
    init_parameters(target, torch.Generator().manual_seed(7))
    before = {k: v.clone() for k, v in target.state_dict().items()}
    load_jax_variables(target, checkpoint.load_checkpoint(path), strict=False)
    loaded = {"/".join(k): np.asarray(v)
              for k, v in flatten_dict(variables["params"]).items()}
    for key, value in target.state_dict().items():
        flax_key = key.replace(".", "/")
        if flax_key in loaded:
            np.testing.assert_array_equal(value.numpy(), loaded[flax_key], err_msg=key)
        else:
            assert "conv3" in key or "norm3" in key
            assert torch.equal(value, before[key]), key


# Adam, SGD with momentum and the port's own RMSprop (optax's, with momentum)
LEGACY_CASES = [CASES[0], CASES[5], CASES[8]]


def _write_legacy(state, path):
    """An optax state as the JAX package's older positional file: leaf_{i}
    in ``jax.tree_util.tree_leaves`` order."""
    np.savez(path, **{f"leaf_{i}": np.asarray(v)
                      for i, v in enumerate(jax.tree_util.tree_leaves(state))})


@pytest.mark.parametrize("name,kwargs", LEGACY_CASES, ids=[c[0] for c in LEGACY_CASES])
def test_a_legacy_positional_optimizer_file_loads_as_its_keyed_twin(name, kwargs, tmp_path):
    params, grads = initial_params(), gradients()
    history, state, tx = jax_run(name, kwargs, params, grads[:3])
    state = jax.device_get(state)
    keyed, legacy = str(tmp_path / "keyed.npz"), str(tmp_path / "legacy.npz")
    jax_ckpt.save_opt_state(state, keyed)
    _write_legacy(state, legacy)
    # the JAX package reads the legacy file into the same state
    back = jax_ckpt.load_opt_state(tx.init(_nested(history[-1])), legacy)
    assert _keyed(back).keys() == _keyed(state).keys()
    for key, value in _keyed(state).items():
        np.testing.assert_array_equal(_keyed(back)[key], value, err_msg=key)
    loaded = {}
    for which, path in (("keyed", keyed), ("legacy", legacy)):
        tensors = port_params(history[-1])
        opt = optim.build_optimizer(name, list(tensors.values()), lr=LR, **kwargs)
        checkpoint.load_opt_state(opt, list(tensors), path)
        loaded[which] = (opt.update_count, opt.param_groups[0]["lr"],
                         checkpoint.opt_state_arrays(opt, list(tensors)))
    count, lr, arrays = loaded["legacy"]
    assert (count, lr) == loaded["keyed"][:2] and count == 3
    assert arrays.keys() == loaded["keyed"][2].keys() == set(np.load(keyed).files)
    for key, value in loaded["keyed"][2].items():
        np.testing.assert_array_equal(arrays[key], value, err_msg=key)


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_the_port_leaf_order_is_jax_flatten_order(name, kwargs):
    """``opt_state_keys`` spells JAX's ``tree_flatten_with_path`` order (and
    the shapes) for every optimizer of the menu."""
    params = initial_params()
    _, state, _ = jax_run(name, kwargs, params, [])
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    tensors = port_params(params)
    opt = optim.build_optimizer(name, list(tensors.values()), lr=LR, **kwargs)
    keys = checkpoint.opt_state_keys(opt, list(tensors))
    assert list(keys) == [jax.tree_util.keystr(p) for p, _ in flat]
    assert list(keys.values()) == [tuple(np.shape(v)) for _, v in flat]


def test_a_legacy_optimizer_file_of_another_leaf_count_raises(tmp_path):
    params, grads = initial_params(), gradients()
    _, state, _ = jax_run("Adam", {}, params, grads[:1])
    leaves = [np.asarray(v) for v in jax.tree_util.tree_leaves(jax.device_get(state))]
    tensors = port_params(params)
    opt = optim.build_optimizer("Adam", list(tensors.values()), lr=LR)
    for what, kept, match in (("short", leaves[:-1], "missing leaf"),
                              ("long", leaves + [leaves[-1]], "unexpected"),
                              ("shape", leaves[:4] + [leaves[4].T] + leaves[5:], "shape")):
        path = str(tmp_path / f"{what}.npz")
        np.savez(path, **{f"leaf_{i}": v for i, v in enumerate(kept)})
        with pytest.raises(checkpoint.OptStateMismatchError, match=match):
            checkpoint.load_opt_state(opt, list(tensors), path)

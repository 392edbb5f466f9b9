"""Read and write the JAX package's flat-key ``.npz`` checkpoints, of the
model and of the optimizer state.

``unet3d_tpu/train/checkpoint.py`` saves the Flax variable tree with '/'-joined
keys, e.g. ``params/input_block/conv1/kernel``. ``convert.py`` maps them onto
the port's modules and back, so a checkpoint either package writes loads in
the other.

The optimizer state is the JAX package's file too: a flat ``.npz`` keyed by
``jax.tree_util.keystr`` of the optax state, e.g.
``.inner_state[0].mu['input_block']['conv1']['kernel']``, with the
``inject_hyperparams`` count and learning rate (``.count``,
``.hyperparams['learning_rate']``). The port spells those keys itself from the
optimizer's chain (``_layout``) and maps each optax leaf onto the torch
optimizer's per-parameter state, so a run of either package resumes in the
other. A missing or extra key or a wrong shape raises
``OptStateMismatchError``, as in the JAX package.

The JAX package's older positional format (``leaf_0``, ``leaf_1``, ... in the
order of ``jax.tree_util.tree_flatten_with_path``) loads too, as it does
there: the port spells that order itself (``opt_state_keys``: NamedTuple
fields in declaration order, tuple items by index, dict keys sorted), and the
leaf count and every shape must match.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from unet3d_tpu_torch.convert import state_dict_to_flax
from unet3d_tpu_torch.train import optim


def load_checkpoint(filename: str) -> Dict[str, np.ndarray]:
    """The flat ``{key: array}`` dict of a JAX ``.npz`` checkpoint."""
    if os.path.isdir(filename):
        raise ValueError(f"{filename!r} is a directory; only .npz checkpoints "
                         "are read (orbax directories are not ported)")
    with np.load(filename) as data:
        return {k: data[k] for k in data.files}


def save_checkpoint(model: torch.nn.Module, filename: str) -> None:
    """Write ``model``'s parameters as a flat-key ``.npz``, atomically (a
    temporary file, then a rename)."""
    if str(filename).endswith(".orbax"):
        raise NotImplementedError("orbax checkpoints are not ported (see ROADMAP.md)")
    _write_npz(state_dict_to_flax(model.state_dict()), filename)


class OptStateMismatchError(RuntimeError):
    """An optimizer-state file does not match the optimizer."""


_COUNT, _LR = ".count", ".hyperparams['learning_rate']"


def _keystr(name: str) -> str:
    """``a.b.kernel`` -> ``['a']['b']['kernel']``, the key path of a Flax
    parameter in ``jax.tree_util.keystr``'s spelling."""
    return "".join(f"['{part}']" for part in name.split("."))


_STEP = (".count", "step", np.int32)
_MOMENTS = [(".mu", "exp_avg"), (".nu", "exp_avg_sq")]


def _layout(optimizer: torch.optim.Optimizer) -> Tuple[list, list]:
    """Where the optax state keeps each leaf: ``scalars`` [(key, torch state
    key, dtype)] of one value per optimizer (torch keeps it per parameter),
    ``trees`` [(key prefix, torch state key)] of one tensor per parameter.
    The prefixes follow the JAX package's chains: a weight decay there is an
    ``add_decayed_weights`` stage in front."""
    group = optimizer.param_groups[0]
    decay = bool(group.get("weight_decay", 0.0))
    scalars, kind = [], type(optimizer)
    if kind is optim.Adam:
        prefix = ".inner_state[1][0]" if decay else ".inner_state[0]"
        scalars, trees = [_STEP], _MOMENTS
    elif kind is optim.AdamW:
        prefix, scalars, trees = ".inner_state[0]", [_STEP], _MOMENTS
    elif kind is optim.SGD:
        prefix = ".inner_state[1][0]" if decay else ".inner_state[0][0]"
        trees = [(".trace", "momentum_buffer")] if group["momentum"] else []
    elif kind is optim.RMSprop:
        prefix = ".inner_state"
        trees = [("[0].nu", "nu")] + ([("[2].trace", "trace")] if group["momentum"] else [])
    elif kind is optim.Adagrad:
        prefix, trees = ".inner_state[0]", [(".sum_of_squares", "sum_of_squares")]
    elif kind is optim.Adadelta:
        prefix, trees = ".inner_state[1]", [(".e_g", "square_avg"), (".e_x", "acc_delta")]
    elif kind is optim.Adamax:
        prefix = ".inner_state[1][0]" if decay else ".inner_state[0][0]"
        scalars, trees = [_STEP], [(".mu", "exp_avg"), (".nu", "exp_inf")]
    elif kind is optim.NAdam:
        prefix = ".inner_state[1]" if decay else ".inner_state[0]"
        scalars = [_STEP, (".mu_product", "mu_product", np.float32)]
        trees = [(".m", "exp_avg"), (".v", "exp_avg_sq")]
    elif kind is optim.RAdam:
        prefix = ".inner_state[1][0]" if decay else ".inner_state[0][0]"
        scalars, trees = [_STEP], [(".mu", "mu"), (".nu", "nu")]
    else:
        raise TypeError(f"{kind.__name__} has no optax state layout; build the "
                        "optimizer with train.optim.build_optimizer")
    return ([(prefix + k, key, dt) for k, key, dt in scalars],
            [(prefix + k, key) for k, key in trees])


def opt_state_keys(optimizer: torch.optim.Optimizer,
                   names: Sequence[str]) -> Dict[str, tuple]:
    """The optax state's leaves as {key: shape}, in the order of JAX's
    ``tree_flatten_with_path``: ``InjectHyperparamsState``'s count and
    learning rate, then the inner state's scalars (a state's count and
    ``mu_product`` come first among its fields), then each tree (fields in
    declaration order, e.g. ``ScaleByAdamState(count, mu, nu)``), a tree's
    leaves by their key paths sorted (JAX sorts dict keys)."""
    params = _params(optimizer, names)
    scalars, trees = _layout(optimizer)
    shapes = dict(zip(names, (tuple(p.shape) for p in params)))
    ordered = sorted(names, key=lambda name: name.split("."))
    keys = {_COUNT: (), _LR: ()}
    keys.update({key: () for key, _, _ in scalars})
    keys.update({prefix + _keystr(name): shapes[name]
                 for prefix, _ in trees for name in ordered})
    return keys


def _params(optimizer: torch.optim.Optimizer, names: Sequence[str]) -> List[torch.Tensor]:
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if len(params) != len(names):
        raise ValueError(f"{len(names)} parameter names for {len(params)} parameters")
    return params


def opt_state_arrays(optimizer: torch.optim.Optimizer,
                     names: Sequence[str]) -> Dict[str, np.ndarray]:
    """The optimizer's state as the JAX package's flat keyed arrays; ``names``
    are the parameters' ``named_parameters`` names, in the optimizer's order.
    A parameter the optimizer has not updated yet has optax's initial state
    (zeros, ``mu_product`` 1)."""
    params = _params(optimizer, names)
    scalars, trees = _layout(optimizer)
    out = {_COUNT: np.asarray(optimizer.update_count, np.int32),
           _LR: np.asarray(optimizer.param_groups[0]["lr"], np.float32)}
    updated = [optimizer.state[p] for p in params if optimizer.state.get(p)]
    for key, state_key, dtype in scalars:
        value = updated[0][state_key] if updated else (1.0 if state_key == "mu_product" else 0)
        out[key] = np.asarray(float(value), dtype)
    for name, p in zip(names, params):
        state = optimizer.state.get(p) or _initial_state(optimizer, p)
        for prefix, state_key in trees:
            value = state.get(state_key)
            value = torch.zeros_like(p) if value is None else value
            out[prefix + _keystr(name)] = value.detach().float().cpu().numpy().copy()
    return out


def _initial_state(optimizer: torch.optim.Optimizer, p: torch.Tensor) -> dict:
    """The state optax starts a parameter with: the optimizer's own first
    state where it is written here (Adagrad's accumulator), else zeros."""
    state = {}
    if isinstance(optimizer, optim._Elementwise):
        optimizer._init_state(p, state, optimizer.param_groups[0])
    return state


def _write_npz(arrays: Dict[str, np.ndarray], filename: str) -> None:
    tmp = f"{filename}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, filename)


def save_opt_state(optimizer: torch.optim.Optimizer, names: Sequence[str],
                   filename: str) -> None:
    """Write the optimizer state as the JAX package's ``save_opt_state`` does
    (atomically: a temporary file, then a rename)."""
    _write_npz(opt_state_arrays(optimizer, names), filename)


def load_opt_state(optimizer: torch.optim.Optimizer, names: Sequence[str],
                   filename: str) -> None:
    """Restore a state written by either package's ``save_opt_state`` into
    ``optimizer`` (its moments, counts and learning rate), keyed or in the
    legacy positional ``leaf_{i}`` format. Raises ``OptStateMismatchError``
    when the file cannot be read, lacks a leaf, has one of another shape, or
    has leaves the optimizer does not."""
    params = _params(optimizer, names)
    try:
        with np.load(filename) as data:
            loaded = {k: data[k] for k in data.files}
    except Exception as error:
        raise OptStateMismatchError(
            f"Cannot read optimizer state {filename}: {error}") from error
    scalars, trees = _layout(optimizer)
    want = opt_state_keys(optimizer, names)
    if all(k.startswith("leaf_") for k in loaded):  # the legacy positional file
        for i, key in enumerate(want):
            if f"leaf_{i}" in loaded:
                loaded[key] = loaded.pop(f"leaf_{i}")
    for key, shape in want.items():
        if key not in loaded:
            raise OptStateMismatchError(
                f"Optimizer state {filename} is missing leaf {key!r} "
                f"(have {len(loaded)} leaves, the optimizer needs {len(want)})")
        if tuple(loaded[key].shape) != shape:
            raise OptStateMismatchError(
                f"Optimizer state {filename} leaf {key!r} has shape "
                f"{loaded[key].shape}, expected {shape} — the model or "
                f"optimizer changed; delete the file to restart moments")
    extra = sorted(set(loaded) - set(want))
    if extra:
        raise OptStateMismatchError(
            f"Optimizer state {filename} has {len(extra)} unexpected leaves, "
            f"e.g. {extra[:3]}")
    count = int(loaded[_COUNT])
    state_dict = optimizer.state_dict()
    state = {}
    for i, (name, p) in enumerate(zip(names, params)):
        entry = {}
        for key, state_key, _ in scalars:
            value = loaded[key]
            if state_key == "step" and isinstance(optimizer, optim._Elementwise):
                entry[state_key] = int(value)
            else:
                entry[state_key] = torch.tensor(float(value), dtype=torch.float32)
        if isinstance(optimizer, optim.Adadelta):  # its step counts updates only
            entry["step"] = torch.tensor(float(count), dtype=torch.float32)
        for prefix, state_key in trees:
            entry[state_key] = torch.from_numpy(loaded[prefix + _keystr(name)].copy())
        if entry:
            state[i] = entry
    state_dict["state"] = state
    for group in state_dict["param_groups"]:
        group["lr"] = float(loaded[_LR])
    optimizer.load_state_dict(state_dict)
    optimizer.update_count = count

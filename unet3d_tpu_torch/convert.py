"""Carry the JAX package's parameters into the port's modules.

The port keeps the Flax names and layouts (DHWIO kernels, ``scale`` / ``bias``
norms), so a flat Flax key ``params/a/b/kernel`` is the ``state_dict`` key
``a.b.kernel`` with the same array. A non-strict load is the JAX package's
flexible load (``unet3d_tpu/train/checkpoint.py::match_state_shapes``): a
tensor whose shape differs is tiled, then truncated, onto the model's shape,
so a checkpoint of another label count initialises a fine-tuning run.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

_PARAMS = "params/"


def flax_to_state_dict(flat: Mapping[str, np.ndarray],
                       strict: bool = True) -> Dict[str, torch.Tensor]:
    """``{'params/a/b/kernel': array}`` -> ``{'a.b.kernel': tensor}``. Keys of
    other collections (batch_stats, ...) have no counterpart yet: they raise,
    or are dropped when not ``strict`` (as the flexible load drops every key
    the model lacks)."""
    out = {}
    for key, value in flat.items():
        if not key.startswith(_PARAMS):
            if not strict:
                continue
            raise ValueError(f"checkpoint key {key!r} is outside the params "
                             "collection; no ported model has other collections")
        out[key[len(_PARAMS):].replace("/", ".")] = torch.from_numpy(
            np.array(value, copy=True))
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{'a.b.kernel': tensor}`` -> ``{'params/a/b/kernel': array}``, the
    inverse of ``flax_to_state_dict``."""
    return {_PARAMS + key.replace(".", "/"): value.detach().cpu().numpy()
            for key, value in state_dict.items()}


def match_tensor_sizes(fixed: np.ndarray, moving: np.ndarray) -> np.ndarray:
    """Tile-then-truncate ``moving`` to the shape of ``fixed``, dim by dim
    (the JAX package's ``match_tensor_sizes``)."""
    moving = np.asarray(moving)
    for dim in range(moving.ndim):
        if fixed.shape[dim] > moving.shape[dim]:
            reps = [1] * moving.ndim
            reps[dim] = int(math.ceil(fixed.shape[dim] / moving.shape[dim]))
            moving = np.tile(moving, reps)
        if fixed.shape[dim] != moving.shape[dim]:
            moving = np.take(moving, range(fixed.shape[dim]), axis=dim)
    return moving


def load_jax_variables(model: nn.Module, flat: Mapping[str, np.ndarray],
                       strict: bool = True) -> nn.Module:
    """Copy flat JAX parameters into ``model`` in place.

    ``strict`` raises on a missing or extra key and on any shape mismatch.
    Otherwise keys the checkpoint lacks keep the model's values, keys the
    model lacks are dropped, and a tensor of another shape is tiled and
    truncated onto the model's (``match_tensor_sizes``)."""
    loaded = flax_to_state_dict(flat, strict=strict)
    own = model.state_dict()
    if strict:
        missing = sorted(set(own) - set(loaded))
        extra = sorted(set(loaded) - set(own))
        mismatched = sorted(k for k in set(own) & set(loaded)
                            if tuple(own[k].shape) != tuple(loaded[k].shape))
        if missing or extra or mismatched:
            raise ValueError(
                f"load failed (strict=True). missing: {missing[:5]} extra: {extra[:5]} "
                f"shape mismatch: {[(k, tuple(own[k].shape), tuple(loaded[k].shape)) for k in mismatched[:5]]}")
    with torch.no_grad():
        for key, target in own.items():
            if key not in loaded:
                continue
            value = loaded[key]
            if tuple(value.shape) != tuple(target.shape):
                value = torch.from_numpy(np.ascontiguousarray(match_tensor_sizes(
                    np.empty(tuple(target.shape)), value.numpy())))
            target.copy_(value.to(target.dtype))
    return model

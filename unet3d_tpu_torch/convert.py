"""Carry the JAX package's variables into the port's modules and back.

The port keeps the Flax names and layouts (DHWIO kernels, ``scale`` / ``bias``
norms), so a flat Flax key ``params/a/b/kernel`` is the ``state_dict`` key
``a.b.kernel`` with the same array. The other collections live in module
buffers, each in the collection its owning module declares in its
``BUFFER_COLLECTION`` attribute: ``batch_stats`` (a BatchNorm's running
``mean`` and ``var``: ``batch_stats/a/b/mean`` is the buffer ``a.b.mean``)
and ``codebook`` (VQVAE's EMA codebooks: ``codebook/quantize_t/embed``). A
buffer is never written under ``params/``. A non-strict load is the JAX
package's flexible load (``unet3d_tpu/train/checkpoint.py::match_state_shapes``)
over every collection: a tensor whose shape differs is tiled, then
truncated, onto the model's shape, so a checkpoint of another label count
initialises a fine-tuning run.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

PARAMS = "params"
# the collections of the JAX variable trees the ported models have
COLLECTIONS = (PARAMS, "batch_stats", "codebook")


def flax_to_state_dict(flat: Mapping[str, np.ndarray],
                       strict: bool = True) -> Dict[str, torch.Tensor]:
    """``{'params/a/b/kernel': array, 'batch_stats/a/b/mean': array,
    'codebook/q/embed': array}`` -> ``{'a.b.kernel': tensor, 'a.b.mean':
    tensor, 'q.embed': tensor}``. Keys of other collections have no
    counterpart: they raise, or are dropped when not ``strict`` (as the
    flexible load drops every key the model lacks)."""
    out = {}
    for key, value in flat.items():
        collection, _, path = key.partition("/")
        if collection not in COLLECTIONS:
            if not strict:
                continue
            raise ValueError(f"checkpoint key {key!r} is outside the collections "
                             f"{', '.join(COLLECTIONS)}; no ported model has others")
        out[path.replace("/", ".")] = torch.from_numpy(np.array(value, copy=True))
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{'a.b.kernel': tensor}`` -> ``{'params/a/b/kernel': array}``, the
    inverse of ``flax_to_state_dict`` for a model without buffers; a model
    with running statistics goes through ``model_variables``."""
    return {f"{PARAMS}/" + key.replace(".", "/"): value.detach().cpu().numpy()
            for key, value in state_dict.items()}


def buffer_collections(model: nn.Module) -> Dict[str, str]:
    """``{buffer name: collection}``: each buffer in the ``BUFFER_COLLECTION``
    its owning module declares. A buffer of a module that declares none
    raises: nothing maps it to a JAX collection."""
    out = {}
    for prefix, module in model.named_modules():
        for leaf, _ in module.named_buffers(recurse=False):
            collection = getattr(module, "BUFFER_COLLECTION", None)
            if collection not in COLLECTIONS[1:]:
                raise ValueError(f"{type(module).__name__} declares no JAX collection "
                                 f"(BUFFER_COLLECTION) for its buffer {leaf!r}")
            out[f"{prefix}.{leaf}" if prefix else leaf] = collection
    return out


def flax_keys(model: nn.Module) -> Dict[str, str]:
    """The flat JAX key of each ``state_dict`` entry of ``model``: its
    parameters under ``params/``, each buffer under its collection
    (``buffer_collections``)."""
    buffers = buffer_collections(model)
    return {f"{buffers.get(key, PARAMS)}/" + key.replace(".", "/"): key
            for key in model.state_dict()}


def model_variables(model: nn.Module) -> Dict[str, np.ndarray]:
    """``model``'s parameters and buffers as the JAX package's flat
    variables of every collection (what its ``save_checkpoint`` writes)."""
    sd = model.state_dict()
    return {k: sd[v].detach().cpu().numpy() for k, v in flax_keys(model).items()}


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
    """Copy flat JAX variables (``params``, ``batch_stats``, ``codebook``)
    into ``model`` in place.

    ``strict`` raises on a missing or extra key of any collection (a key of
    a collection the model does not have is extra) and on any shape
    mismatch. Otherwise keys the checkpoint lacks keep the model's values,
    keys the model lacks are dropped, and a tensor of another shape is tiled
    and truncated onto the model's (``match_tensor_sizes``)."""
    keys = flax_keys(model)
    own = model.state_dict()
    if strict:
        missing = sorted(set(keys) - set(flat))
        extra = sorted(set(flat) - set(keys))
        mismatched = sorted(k for k in set(keys) & set(flat)
                            if tuple(own[keys[k]].shape) != tuple(np.shape(flat[k])))
        if missing or extra or mismatched:
            raise ValueError(
                f"load failed (strict=True). missing: {missing[:5]} extra: {extra[:5]} "
                "shape mismatch: "
                f"{[(k, tuple(own[keys[k]].shape), np.shape(flat[k])) for k in mismatched[:5]]}")
    with torch.no_grad():
        for flax_key, key in keys.items():
            if flax_key not in flat:
                continue
            target, value = own[key], np.asarray(flat[flax_key])
            if tuple(value.shape) != tuple(target.shape):
                value = match_tensor_sizes(np.empty(tuple(target.shape)), value)
            target.copy_(torch.from_numpy(np.array(value, copy=True)).to(target.dtype))
    return model

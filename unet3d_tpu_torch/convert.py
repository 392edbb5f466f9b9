"""Carry the JAX package's parameters into the port's modules.

The port keeps the Flax names and layouts (DHWIO kernels, ``scale`` / ``bias``
norms), so a flat Flax key ``params/a/b/kernel`` is the ``state_dict`` key
``a.b.kernel`` with the same array.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

_PARAMS = "params/"


def flax_to_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``{'params/a/b/kernel': array}`` -> ``{'a.b.kernel': tensor}``. Keys of
    other collections (batch_stats, ...) have no counterpart yet and raise."""
    out = {}
    for key, value in flat.items():
        if not key.startswith(_PARAMS):
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


def load_jax_variables(model: nn.Module, flat: Mapping[str, np.ndarray],
                       strict: bool = True) -> nn.Module:
    """Copy flat JAX parameters into ``model`` in place.

    A shape mismatch always raises; ``strict`` also raises on a missing or
    extra key, which non-strict loading skips. (The JAX package's flexible
    tile/truncate load for transfer learning comes with training.)"""
    loaded = flax_to_state_dict(flat)
    own = model.state_dict()
    missing = sorted(set(own) - set(loaded))
    extra = sorted(set(loaded) - set(own))
    mismatched = sorted(k for k in set(own) & set(loaded)
                        if tuple(own[k].shape) != tuple(loaded[k].shape))
    if mismatched or (strict and (missing or extra)):
        raise ValueError(
            f"load failed (strict={strict}). missing: {missing[:5]} extra: {extra[:5]} "
            f"shape mismatch: {[(k, tuple(own[k].shape), tuple(loaded[k].shape)) for k in mismatched[:5]]}")
    with torch.no_grad():
        for key, target in own.items():
            if key in loaded:
                target.copy_(loaded[key].to(target.dtype))
    return model

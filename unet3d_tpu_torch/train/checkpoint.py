"""Read and write the JAX package's flat-key ``.npz`` checkpoints.

``unet3d_tpu/train/checkpoint.py`` saves the Flax variable tree with '/'-joined
keys, e.g. ``params/input_block/conv1/kernel``. ``convert.py`` maps them onto
the port's modules and back, so a checkpoint either package writes loads in
the other.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from unet3d_tpu_torch.convert import state_dict_to_flax


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
    tmp = f"{filename}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **state_dict_to_flax(model.state_dict()))
    os.replace(tmp, filename)

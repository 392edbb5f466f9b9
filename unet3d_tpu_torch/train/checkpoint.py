"""Read the JAX package's flat-key ``.npz`` checkpoints.

``unet3d_tpu/train/checkpoint.py`` saves the Flax variable tree with '/'-joined
keys, e.g. ``params/input_block/conv1/kernel``. ``convert.py`` maps them onto
the port's modules.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def load_checkpoint(filename: str) -> Dict[str, np.ndarray]:
    """The flat ``{key: array}`` dict of a JAX ``.npz`` checkpoint."""
    if os.path.isdir(filename):
        raise ValueError(f"{filename!r} is a directory; only .npz checkpoints "
                         "are read (orbax directories are not ported)")
    with np.load(filename) as data:
        return {k: data[k] for k in data.files}

"""Fully connected network (counterpart of ``unet3d_tpu/models/fcn.py``): a
``Dense`` layer per ``hidden_layers_list`` entry (``hidden{i}``), each
followed by a relu, then ``out`` to ``n_outputs``. ``n_inputs`` is the
input width (Flax infers it)."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import Dense


class FCN(nn.Module):

    def __init__(self, hidden_layers_list: Sequence[int], n_inputs: int, n_outputs: int):
        super().__init__()
        self.n_hidden = len(hidden_layers_list)
        width = n_inputs
        for i, features in enumerate(hidden_layers_list):
            self.add_module(f"hidden{i}", Dense(width, features))
            width = features
        self.out = Dense(width, n_outputs)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"hidden{i}")(x))
        return self.out(x)

"""MONAI's BasicUNetPlusPlus (counterpart of
``unet3d_tpu/models/basicunetplusplus.py``): the nested U-Net (Zhou et al.
2018) on BasicUNet's blocks (``models/basicunet.py``).

- The encoder column ``conv_i_0`` as BasicUNet's; each nested node
  ``upcat_i_j`` up-samples ``x_{i+1,j-1}`` and concatenates, as its skip,
  the row ``x_{i,0..j-1}`` in index order, which ``UpCat`` puts before the
  up-sampled tensor. The top row's UpCats up-sample to ``features[1]``,
  not halved.
- Heads: ``final_conv_0_4`` on ``x_{0,4}``; with ``deep_supervision`` also
  ``final_conv_0_{1,2,3}`` (they exist whatever the mode, as in the Flax
  tree). In training they are stacked on axis 1 with ``final_conv_0_4``
  last (the train step weights such a stack); in eval only
  ``final_conv_0_4`` is returned.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.basicunet import TwoConv, UpCat, _max_pool2
from unet3d_tpu_torch.models.layers import conv1


class BasicUNetPlusPlus(nn.Module):
    """MONAI BasicUNetPlusPlus config surface (3D); ``upsample`` accepted and
    not read, as in JAX."""

    def __init__(self, spatial_dims: int = 3, in_channels: int = 1, out_channels: int = 2,
                 features: Sequence[int] = (32, 32, 64, 128, 256, 32),
                 deep_supervision: bool = False, dropout: float = 0.0,
                 upsample: str = "deconv"):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch BasicUNetPlusPlus is 3D")
        fea, dr = tuple(features), dropout
        self.deep_supervision = deep_supervision
        self.conv_0_0 = TwoConv(in_channels, fea[0], dr)
        for i in range(1, 5):
            self.add_module(f"conv_{i}_0", TwoConv(fea[i - 1], fea[i], dr))
        # upcat_i_j: x_{i+1,j-1} up-sampled onto the row x_{i,0..j-1}; row i
        # holds fea[i] channels a node, row 0 fea[0] (its last node fea[5])
        for j in range(1, 5):
            for i in range(5 - j):
                up = fea[1] if i == 0 else fea[i + 1] // 2
                out = fea[5] if (i, j) == (0, 4) else fea[i]
                self.add_module(f"upcat_{i}_{j}", UpCat(fea[i + 1], j * fea[i], up, out, dr))
        self.final_conv_0_4 = conv1(fea[5], out_channels)
        if deep_supervision:
            for j in (1, 2, 3):
                self.add_module(f"final_conv_0_{j}", conv1(fea[0], out_channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        rows = [[self.conv_0_0(x, train, rng)]]
        for i in range(1, 5):
            # x_{i,0}, then the diagonal it completes: x_{i-j,j} for j = 1..i
            rows.append([getattr(self, f"conv_{i}_0")(_max_pool2(rows[i - 1][0]), train, rng)])
            for j in range(1, i + 1):
                r = i - j
                skip = rows[r][0] if j == 1 else torch.cat(rows[r], dim=-1)
                rows[r].append(getattr(self, f"upcat_{r}_{j}")(rows[r + 1][j - 1], skip,
                                                              train, rng))
        out = self.final_conv_0_4(rows[0][4])
        if self.deep_supervision and train:
            heads = [getattr(self, f"final_conv_0_{j}")(rows[0][j]) for j in (1, 2, 3)]
            return torch.stack(heads + [out], dim=1)
        return out

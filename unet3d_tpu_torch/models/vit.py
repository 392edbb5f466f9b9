"""Standalone ``ViT`` and ``ViTAutoEnc`` (counterparts of
``unet3d_tpu/models/vit.py``), with MONAI's call contracts.

Both are UNETR's encoder (``models/unetr.ViT``: a patch embedding, learned
position embeddings, ``num_layers`` transformer blocks, a final LayerNorm)
on the patch grid of ``img_size``:

- ``ViT`` returns ``(tokens, hidden_states)``; with ``classification`` a
  zero-initialised class token is prepended and the head is a Dense over it
  with ``post_activation`` "Tanh" (MONAI's default; anything else none):
  ``(logits, hidden_states)``.
- ``ViTAutoEnc`` reshapes the normed tokens onto the grid and upsamples
  them with two transposed convs with kernel = stride, ``s1 = min(4, p)``
  then ``s2 = p / s1`` per axis (MONAI hardcodes 4 and 4 for its 16-cubed
  patch): hidden -> ``deconv_chns`` -> ``out_channels``;
  ``(reconstruction, hidden_states)``.

They launch no hand kernel: every product is a channel matmul.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from unet3d_tpu_torch.models import unetr
from unet3d_tpu_torch.models.layers import Dense, _triple, transposed_conv


def _grid(img_size, patch_size):
    img, p = _triple(img_size), _triple(patch_size)
    if any(s % q for s, q in zip(img, p)):
        raise ValueError(f"img_size {img} not divisible by patch {p}")
    return tuple(s // q for s, q in zip(img, p))


class ViT(unetr.ViT):
    """monai.networks.nets.ViT config surface (3D, NDHWC)."""

    def __init__(self, in_channels: int = 1, img_size: Sequence[int] = (96, 96, 96),
                 patch_size: Sequence[int] = (16, 16, 16), hidden_size: int = 768,
                 mlp_dim: int = 3072, num_layers: int = 12, num_heads: int = 12,
                 classification: bool = False, num_classes: int = 2,
                 dropout_rate: float = 0.0, post_activation: Optional[str] = "Tanh",
                 spatial_dims: int = 3):
        if spatial_dims != 3:
            raise NotImplementedError("ViT is 3D")
        super().__init__(in_channels, hidden_size, mlp_dim, num_layers, num_heads,
                         patch_size, _grid(img_size, patch_size), dropout_rate)
        self.classification = classification
        self.tanh = (post_activation or "").lower() == "tanh"
        if classification:
            self.cls_token = nn.Parameter(torch.empty(1, 1, hidden_size))
            self.classification_head = Dense(hidden_size, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None):
        x = self.embed(x)
        if self.classification:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
            x = torch.cat([cls, x], dim=1)
        x, states = self.encode(x, train, rng)
        if not self.classification:
            return x, states
        logits = self.classification_head(x[:, 0])
        return (torch.tanh(logits) if self.tanh else logits), states


class ViTAutoEnc(unetr.ViT):
    """monai.networks.nets.ViTAutoEnc config surface (3D, NDHWC)."""

    def __init__(self, in_channels: int = 1, img_size: Sequence[int] = (96, 96, 96),
                 patch_size: Sequence[int] = (16, 16, 16), out_channels: int = 1,
                 deconv_chns: int = 16, hidden_size: int = 768, mlp_dim: int = 3072,
                 num_layers: int = 12, num_heads: int = 12, dropout_rate: float = 0.0,
                 spatial_dims: int = 3):
        if spatial_dims != 3:
            raise NotImplementedError("ViTAutoEnc is 3D")
        super().__init__(in_channels, hidden_size, mlp_dim, num_layers, num_heads,
                         patch_size, _grid(img_size, patch_size), dropout_rate)
        p = _triple(patch_size)
        s1 = tuple(min(4, v) for v in p)
        s2 = tuple(v // a for v, a in zip(p, s1))
        self.conv3d_transpose = transposed_conv(hidden_size, deconv_chns, s1, s1)
        self.conv3d_transpose_1 = transposed_conv(deconv_chns, out_channels, s2, s2)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None):
        x, states = super().forward(x, train, rng)
        x = x.reshape(x.shape[0], *self.grid, x.shape[-1])
        return self.conv3d_transpose_1(self.conv3d_transpose(x)), states

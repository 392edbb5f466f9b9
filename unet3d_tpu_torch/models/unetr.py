"""UNETR (counterpart of ``unet3d_tpu/models/unetr.py``).

MONAI's UNETR (Hatamizadeh et al., WACV 2022) on NDHWC, with the JAX
package's module names: a ViT encoder (a patch embedding with kernel =
stride = ``patch_size``, learned position embeddings, ``num_layers``
pre-norm transformer blocks, a final LayerNorm) whose block outputs are
tapped every ``num_layers // 4`` blocks, reshaped onto the patch grid and
deconvolved to the skip resolutions (``UnetrPrUpBlock``), then merged top
down by transposed conv + concat + conv block rungs (``UnetrUpBlock``) and a
1-cubed head. The conv blocks are DynUNet's (``models/dynunet.py``), so on
CUDA their 3-cubed convs run the hand kernels (``conv_stats`` for conv1,
``block_stats`` for conv2, ``conv`` for their input gradients).

Attention follows the JAX dtype flow: a bias-free packed ``qkv`` read as
(n, t, 3, heads, head_dim), the scores divided by sqrt(head_dim) taken in
the input's dtype and the softmax in that dtype (bf16 under AMP: unlike
SwinUNETR's f32 softmax), then a biased ``out_proj``. The two attention
products are ``ops/conv3d.channel_matmul`` (f32 in full f32). GELU is the
exact erf form, LayerNorm Flax's (``layers.LayerNorm``, eps 1e-5).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from unet3d_tpu_torch.models.dynunet import UnetBasicBlock, UnetResBlock
from unet3d_tpu_torch.models.layers import (Dense, LayerNorm, PatchConv, PointwiseConv,
                                            _triple, dropout, transposed_conv)
from unet3d_tpu_torch.ops.conv3d import channel_matmul

Ints3 = Union[int, Sequence[int]]
_EPS = 1e-5


class SelfAttention(nn.Module):
    """MONAI's SABlock: bias-free packed ``qkv``, biased ``out_proj``, scale
    head_dim^-0.5 in the input's dtype, the softmax in that dtype."""

    def __init__(self, hidden_size: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads, self.dropout_rate = num_heads, dropout_rate
        self.qkv = Dense(hidden_size, 3 * hidden_size, use_bias=False)
        self.out_proj = Dense(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        n, t, c = x.shape
        head_dim = c // self.num_heads
        qkv = self.qkv(x).reshape(n, t, 3, self.num_heads, head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (n, heads, t, hd)
        # the divisor sqrt(head_dim) as the JAX module takes it: in x's dtype
        root = float(torch.sqrt(torch.tensor(float(head_dim), dtype=x.dtype)))
        attn = torch.softmax(channel_matmul(q, k.transpose(-1, -2)) / root, dim=-1)
        attn = dropout(attn, self.dropout_rate, train, rng)
        y = channel_matmul(attn, v).transpose(1, 2).reshape(n, t, c)
        return dropout(self.out_proj(y), self.dropout_rate, train, rng)


class TransformerBlock(nn.Module):
    """Pre-norm block: LN -> attention -> residual, LN -> GELU MLP -> residual."""

    def __init__(self, hidden_size: int, mlp_dim: int, num_heads: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.norm1 = LayerNorm(hidden_size, _EPS)
        self.attn = SelfAttention(hidden_size, num_heads, dropout_rate)
        self.norm2 = LayerNorm(hidden_size, _EPS)
        self.mlp1 = Dense(hidden_size, mlp_dim)
        self.mlp2 = Dense(mlp_dim, hidden_size)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), train, rng)
        h = F.gelu(self.mlp1(self.norm2(x)))  # exact erf GELU
        h = dropout(h, self.dropout_rate, train, rng)
        h = dropout(self.mlp2(h), self.dropout_rate, train, rng)
        return x + h


class ViT(nn.Module):
    """Patch embedding + position embedding + transformer stack on a fixed
    patch ``grid``; returns (the normed tokens, every block's output).
    ``embed`` and ``encode`` are the two halves, for the standalone ViT's
    class token (``models/vit.py``)."""

    def __init__(self, in_channels: int, hidden_size: int, mlp_dim: int, num_layers: int,
                 num_heads: int, patch_size: Ints3, grid: Tuple[int, int, int],
                 dropout_rate: float = 0.0):
        super().__init__()
        self.grid, self.num_layers, self.dropout_rate = tuple(grid), num_layers, dropout_rate
        self.patch_embedding = PatchConv(in_channels, hidden_size, patch_size)
        self.pos_embedding = nn.Parameter(torch.empty(1, math.prod(grid), hidden_size))
        for i in range(num_layers):
            self.add_module(f"block{i}", TransformerBlock(hidden_size, mlp_dim, num_heads,
                                                          dropout_rate))
        self.norm = LayerNorm(hidden_size, _EPS)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(x)
        n, gd, gh, gw, c = x.shape
        if (gd, gh, gw) != self.grid:
            raise ValueError(f"ViT built for a patch grid {self.grid}, got {(gd, gh, gw)}")
        return x.reshape(n, gd * gh * gw, c) + self.pos_embedding.to(x.dtype)

    def encode(self, x: torch.Tensor, train: bool = False,
               rng: Optional[torch.Generator] = None):
        x = dropout(x, self.dropout_rate, train, rng)
        states = []
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, train, rng)
            states.append(x)
        return self.norm(x), states

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None):
        return self.encode(self.embed(x), train, rng)


def _block(res_block: bool):
    return UnetResBlock if res_block else UnetBasicBlock


class UnetrPrUpBlock(nn.Module):
    """Progressive deconv chain projecting a ViT state to a skip resolution:
    a transposed conv, then ``num_layer`` (transposed conv, conv block)."""

    def __init__(self, in_channels: int, out_channels: int, num_layer: int,
                 kernel_size: Ints3 = 3, res_block: bool = True):
        super().__init__()
        self.num_layer = num_layer
        self.transp_conv_init = transposed_conv(in_channels, out_channels, 2, 2,
                                                use_bias=False)
        for i in range(num_layer):
            self.add_module(f"transp_{i}", transposed_conv(out_channels, out_channels, 2, 2,
                                                           use_bias=False))
            self.add_module(f"conv_{i}", _block(res_block)(out_channels, out_channels,
                                                           kernel_size, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transp_conv_init(x)
        for i in range(self.num_layer):
            x = getattr(self, f"conv_{i}")(getattr(self, f"transp_{i}")(x))
        return x


class UnetrUpBlock(nn.Module):
    """Transposed-conv upsample + skip concat + conv block (a decoder rung);
    the skip has ``out_channels`` channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Ints3 = 3,
                 res_block: bool = True):
        super().__init__()
        self.transp_conv = transposed_conv(in_channels, out_channels, 2, 2, use_bias=False)
        self.conv_block = _block(res_block)(2 * out_channels, out_channels, kernel_size, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class UNETR(nn.Module):
    """MONAI UNETR config surface (3D, NDHWC); the input's spatial shape
    must be ``img_size``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 2,
                 img_size: Ints3 = 96, feature_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 3072, num_heads: int = 12, num_layers: int = 12,
                 dropout_rate: float = 0.0, res_block: bool = True, spatial_dims: int = 3,
                 patch_size: int = 16):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("UNETR is 3D")
        self.img_size = _triple(img_size)
        p = patch_size
        if any(s % p for s in self.img_size):
            raise ValueError(f"img_size {self.img_size} not divisible by patch {p}")
        self.grid = tuple(s // p for s in self.img_size)
        self.hidden_size, self.num_layers = hidden_size, num_layers
        fs = feature_size
        self.vit = ViT(in_channels, hidden_size, mlp_dim, num_layers, num_heads, p, self.grid,
                       dropout_rate)
        self.encoder1 = _block(res_block)(in_channels, fs, 3, 1)
        self.encoder2 = UnetrPrUpBlock(hidden_size, fs * 2, 2, res_block=res_block)
        self.encoder3 = UnetrPrUpBlock(hidden_size, fs * 4, 1, res_block=res_block)
        self.encoder4 = UnetrPrUpBlock(hidden_size, fs * 8, 0, res_block=res_block)
        self.decoder5 = UnetrUpBlock(hidden_size, fs * 8, res_block=res_block)
        self.decoder4 = UnetrUpBlock(fs * 8, fs * 4, res_block=res_block)
        self.decoder3 = UnetrUpBlock(fs * 4, fs * 2, res_block=res_block)
        self.decoder2 = UnetrUpBlock(fs * 2, fs, res_block=res_block)
        self.out = PointwiseConv(fs, out_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if tuple(x.shape[1:4]) != self.img_size:
            raise ValueError(f"UNETR built for img_size {self.img_size}, got input spatial "
                             f"{tuple(x.shape[1:4])}")
        seq, states = self.vit(x, train, rng)

        def proj(z):
            return z.reshape(z.shape[0], *self.grid, self.hidden_size)

        # MONAI taps hidden_states_out[3]/[6]/[9], the outputs of blocks
        # 4/7/10: states[tap]/[2*tap]/[3*tap] (states[i] is block i's output)
        tap = self.num_layers // 4
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(proj(states[tap]))
        enc3 = self.encoder3(proj(states[2 * tap]))
        enc4 = self.encoder4(proj(states[3 * tap]))
        dec3 = self.decoder5(proj(seq), enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        return self.out(self.decoder2(dec1, enc1))

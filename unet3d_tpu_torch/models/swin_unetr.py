"""SwinUNETR (counterpart of ``unet3d_tpu/models/swin_unetr.py``).

MONAI's SwinUNETR (Hatamizadeh et al. 2022) on NDHWC, with the JAX
package's module names: a patch embedding (kernel = stride = ``patch_size``),
four stages of ``depths`` Swin blocks alternating window and shifted-window
attention with a learned relative-position bias, PatchMerging (MONAI's v2:
the 8 octants concatenated -> LayerNorm -> a bias-free linear to 2 * dim)
after each stage; the embedding and every stage's merged output tapped,
normalised by a parameterless channel norm (``normalize``), and decoded by
DynUNet's ``UnetResBlock`` encoders and UNETR's ``UnetrUpBlock`` rungs
(``models/unetr.py``), whose 3-cubed convs run the hand kernels on CUDA.

In a block the window is clamped to the volume (``min(window, size)``),
the LayerNorm comes first, then a zero pad on the high side to a multiple of
the window, then the roll by -shift (half the window, on odd blocks, along
axes longer than the window) with the boundary mask built on the padded
dims; the reverse roll comes before the crop. Window attention has a biased
``qkv``; the scores, divided by sqrt(head_dim) as a numpy scalar promotes
them (f32 under AMP), take the gathered bias and the mask (-1e9 between
regions) in their dtype, and the softmax runs in f32 and is cast back to
the input's dtype (unlike UNETR's). The relative-position index and the
masks are numpy constants, cached per (window, dims, shift) on each device;
they are not buffers, so neither the state nor a checkpoint holds them.

The relative-position tables are parameters whose shape depends on each
stage's clamped window, which Flax infers from the input; the port sizes
them from ``img_size`` and raises on an input whose windows differ.
``use_checkpoint`` and ``norm_name`` are accepted and ignored, as in JAX.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unet3d_tpu_torch.models.dynunet import UnetResBlock
from unet3d_tpu_torch.models.layers import (Dense, LayerNorm, PatchConv, PointwiseConv,
                                            _triple, dropout)
from unet3d_tpu_torch.models.unetr import UnetrUpBlock
from unet3d_tpu_torch.ops.conv3d import channel_matmul

Int3 = Tuple[int, int, int]
_EPS = 1e-5


def _window_partition(x: torch.Tensor, ws: Int3) -> torch.Tensor:
    """(n, d, h, w, c) -> (n * n_windows, prod(ws), c)."""
    n, d, h, w, c = x.shape
    x = x.reshape(n, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def _window_reverse(x: torch.Tensor, ws: Int3, dims: Tuple[int, int, int, int]) -> torch.Tensor:
    n, d, h, w = dims
    x = x.reshape(n, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(n, d, h, w, x.shape[-1])


def _relative_position_index(ws: Int3) -> np.ndarray:
    """Flattened pairwise relative position -> bias-table row, (vol, vol)."""
    coords = np.stack(np.meshgrid(np.arange(ws[0]), np.arange(ws[1]),
                                  np.arange(ws[2]), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 2] += ws[2] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= (2 * ws[2] - 1)
    return rel.sum(-1)


def _shift_attn_mask(dims: Int3, ws: Int3, shift: Int3) -> np.ndarray:
    """Swin's boundary mask for shifted windows on the padded ``dims``: -1e9
    between regions that were not neighbours before the roll; (n_windows,
    vol, vol) float32."""
    img = np.zeros(dims, np.int32)
    cnt = 0
    for sd in (slice(0, -ws[0]), slice(-ws[0], -shift[0]), slice(-shift[0], None)):
        for sh in (slice(0, -ws[1]), slice(-ws[1], -shift[1]), slice(-shift[1], None)):
            for sw in (slice(0, -ws[2]), slice(-ws[2], -shift[2]), slice(-shift[2], None)):
                img[sd, sh, sw] = cnt
                cnt += 1
    d, h, w = dims
    win = img.reshape(d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2])
    win = win.transpose(0, 2, 4, 1, 3, 5).reshape(-1, ws[0] * ws[1] * ws[2])
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def _on_device(key: tuple, make, device: torch.device) -> torch.Tensor:
    """The numpy constant ``make()`` as a tensor on ``device``, made once per
    (``key``, device); a normal tensor even when first made under
    ``torch.inference_mode`` (a prediction), so training can save it for
    its backward."""
    key = key + (str(device),)
    if key not in _CONSTANTS:
        with torch.inference_mode(False):
            _CONSTANTS[key] = torch.from_numpy(make()).to(device)
    return _CONSTANTS[key]


def clamped_window(window: Int3, size: Int3) -> Int3:
    """The window of a block on a ``size`` volume: clamped to the volume."""
    return tuple(min(w, s) for w, s in zip(window, size))


class WindowAttention(nn.Module):
    """Multi-head attention within windows of ``window_size`` with a learned
    relative-position bias (``relative_position_bias_table``)."""

    def __init__(self, dim: int, num_heads: int, window_size: Int3, qkv_bias: bool = True,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads, self.window_size, self.dropout_rate = num_heads, window_size, dropout_rate
        ws = window_size
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * ws[0] - 1) * (2 * ws[1] - 1) * (2 * ws[2] - 1), num_heads))
        self.qkv = Dense(dim, 3 * dim, use_bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        bw, nvol, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(bw, nvol, 3, heads, c // heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scores = channel_matmul(q, k.transpose(-1, -2))
        # the JAX module divides by a numpy f64 scalar, which promotes bf16
        # scores to f32
        attn = scores.to(torch.promote_types(scores.dtype, torch.float32)) / math.sqrt(c // heads)
        index = _on_device(("index", self.window_size),
                           lambda: _relative_position_index(self.window_size), x.device)
        bias = self.relative_position_bias_table[index.reshape(-1)].reshape(nvol, nvol, heads)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, heads, nvol, nvol) + mask[None, :, None].to(
                attn.dtype)
            attn = attn.reshape(bw, heads, nvol, nvol)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        y = channel_matmul(attn, v).transpose(1, 2).reshape(bw, nvol, c)
        # MONAI routes drop_rate to the attention's output projection too
        return dropout(self.proj(y), self.dropout_rate, train, rng)


class SwinTransformerBlock(nn.Module):
    """(Shifted-)window attention and a GELU MLP, each pre-norm with a
    residual, on a volume of ``size`` (which fixes the clamped window)."""

    def __init__(self, dim: int, num_heads: int, window_size: Int3, size: Int3,
                 shift: bool = False, mlp_ratio: float = 4.0, dropout_rate: float = 0.0):
        super().__init__()
        self.window, self.shift, self.dropout_rate = tuple(window_size), shift, dropout_rate
        self.ws = clamped_window(self.window, size)
        self.norm1 = LayerNorm(dim, _EPS)
        self.attn = WindowAttention(dim, num_heads, self.ws, dropout_rate=dropout_rate)
        self.norm2 = LayerNorm(dim, _EPS)
        self.mlp1 = Dense(dim, int(dim * mlp_ratio))
        self.mlp2 = Dense(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        n, d, h, w, c = x.shape
        ws = clamped_window(self.window, (d, h, w))
        if ws != self.ws:
            raise ValueError(f"block built for a {self.ws} window (img_size); a {(d, h, w)} "
                             f"stage needs {ws}")
        shift = tuple(wi // 2 if (self.shift and s > wi) else 0 for wi, s in zip(ws, (d, h, w)))
        pad = tuple((-s) % wi for s, wi in zip((d, h, w), ws))
        y = self.norm1(x)
        if any(pad):
            y = F.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        dims = (n, d + pad[0], h + pad[1], w + pad[2])
        mask = None
        if any(shift):
            y = torch.roll(y, (-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
            mask = _on_device(("mask", dims[1:], ws, shift),
                              lambda: _shift_attn_mask(dims[1:], ws, shift), x.device)
        y = _window_reverse(self.attn(_window_partition(y, ws), mask, train, rng), ws, dims)
        if any(shift):
            y = torch.roll(y, shift, dims=(1, 2, 3))
        if any(pad):
            y = y[:, :d, :h, :w]
        x = x + y
        y = F.gelu(self.mlp1(self.norm2(x)))  # exact erf GELU
        y = dropout(y, self.dropout_rate, train, rng)
        return x + dropout(self.mlp2(y), self.dropout_rate, train, rng)


class PatchMerging(nn.Module):
    """MONAI's PatchMergingV2: odd dims zero-padded, the 2x2x2 octants
    concatenated ((d, h, w) offsets in that order, 8 * dim channels) ->
    LayerNorm -> a bias-free linear to 2 * dim."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim, _EPS)
        self.reduction = Dense(8 * dim, 2 * dim, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, d, h, w, c = x.shape
        pad = (d % 2, h % 2, w % 2)
        if any(pad):
            x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
            d, h, w = d + pad[0], h + pad[1], w + pad[2]
        x = x.reshape(n, d // 2, 2, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(n, d // 2, h // 2, w // 2, 8 * c)
        return self.reduction(self.norm(x))


def _channel_norm(h: torch.Tensor) -> torch.Tensor:
    """MONAI's proj_out: a parameterless layer norm over the channels in f32
    with the two-pass variance (``jnp.var``), eps 1e-5, cast back."""
    hf = h.float()
    mean = hf.mean(dim=-1, keepdim=True)
    var = (hf - mean).square().mean(dim=-1, keepdim=True)
    return ((hf - mean) * torch.rsqrt(var + _EPS)).to(h.dtype)


class SwinUNETR(nn.Module):
    """MONAI SwinUNETR config surface (3D, NDHWC)."""

    def __init__(self, img_size: Sequence[int] = (96, 96, 96), in_channels: int = 1,
                 out_channels: int = 2, feature_size: int = 24,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 2, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, spatial_dims: int = 3, norm_name: str = "instance",
                 use_checkpoint: bool = False, normalize: bool = True):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("SwinUNETR is 3D")
        self.depths, self.normalize, self.drop_rate = tuple(depths), normalize, drop_rate
        self.patch = _triple(patch_size)
        f = feature_size
        self.patch_embed = PatchConv(in_channels, f, self.patch)
        size = tuple(s // p for s, p in zip(_triple(img_size), self.patch))
        dim = f
        for stage, depth in enumerate(self.depths):
            for b in range(depth):
                self.add_module(f"stage{stage}_block{b}", SwinTransformerBlock(
                    dim, num_heads[stage], _triple(window_size), size, shift=b % 2 == 1,
                    mlp_ratio=mlp_ratio, dropout_rate=drop_rate))
            self.add_module(f"merge{stage}", PatchMerging(dim))
            size = tuple((s + 1) // 2 for s in size)
            dim *= 2
        self.encoder1 = UnetResBlock(in_channels, f)
        self.encoder2 = UnetResBlock(f, f)
        self.encoder3 = UnetResBlock(2 * f, 2 * f)
        self.encoder4 = UnetResBlock(4 * f, 4 * f)
        self.encoder10 = UnetResBlock(16 * f, 16 * f)
        self.decoder5 = UnetrUpBlock(16 * f, 8 * f)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f)
        self.decoder2 = UnetrUpBlock(2 * f, f)
        self.decoder1 = UnetrUpBlock(f, f)
        self.out = PointwiseConv(f, out_channels)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        spatial = tuple(x.shape[1:4])
        down = self.patch[0] * 2 ** len(self.depths)
        if any(s % down for s in spatial):
            raise ValueError(f"SwinUNETR input spatial dims {spatial} must be divisible by "
                             f"patch_size * 2^n_stages = {down}")
        h = dropout(self.patch_embed(x), self.drop_rate, train, rng)  # pos_drop
        hidden = [h]
        for stage, depth in enumerate(self.depths):
            for b in range(depth):
                h = getattr(self, f"stage{stage}_block{b}")(h, train, rng)
            h = getattr(self, f"merge{stage}")(h)
            hidden.append(h)
        # hidden: [/2 f, /4 2f, /8 4f, /16 8f, /32 16f]
        if self.normalize:
            hidden = [_channel_norm(hh) for hh in hidden]
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        d3 = self.decoder5(self.encoder10(hidden[4]), hidden[3])
        d2 = self.decoder4(d3, enc3)
        d1 = self.decoder3(d2, enc2)
        d0 = self.decoder2(d1, enc1)
        return self.out(self.decoder1(d0, enc0))

"""QuickNAT (counterpart of ``unet3d_tpu/models/quicknat.py``): Roy et al.
2019's slice-wise segmenter, MONAI's ``Quicknat`` surface.

A 5-D NDHWC volume is folded into a batch of 2-D NHWC slices (depth into
the batch) before anything else and restored at the end, so every instance
norm takes its statistics per slice; a 4-D NHWC input is taken as it is.

- ``DenseBlock2D``: ``o1 = ADN(conv5(x))``, ``o2 = ADN(conv5([x, o1]))``,
  ``out = ADN(conv1([x, o1, o2]))``, each ADN Flax's ``GroupNorm`` with one
  group per channel (eps 1e-5) then a one-slope PReLU, then the SE gate:
  ``CSE`` (mean over H, W -> Dense to ``max(c // 2, 1)`` -> relu -> Dense
  -> sigmoid), ``SSE`` (a biased 1x1 conv to one channel -> sigmoid),
  ``CSSE`` (the elementwise max of the two gated tensors) or none;
- four encoder blocks, each followed by a ``pool`` x ``pool`` max-pool that
  keeps a mask of each window's **first** maximum in row-major order (the
  JAX ``cumsum == 1`` tiebreak, pinned because bf16 ties are common); a
  bottleneck block; four decoder stages: the max-unpool ``repeat(v, pool)
  * mask``, ``[unpooled, skip]`` concatenated, a dense block;
- elementwise dropout after each encoder and decoder block in training;
- ``classifier``: a ``kernel_c`` conv with stride ``stride_conv``.

The convs are Flax ``nn.Conv`` (XLA's in the JAX package), so here they are
``layers.Conv`` on cuDNN with HWIO kernels and XLA's SAME padding. The
width of the input is ``num_channels``, given at construction.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import Conv, Dense, GroupNorm, dropout
from unet3d_tpu_torch.models.monai_unet import PReLU


class _ChannelSE(nn.Module):
    """Channel squeeze-and-excitation, reduction ratio 2."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc1 = Dense(channels, max(channels // 2, 1))
        self.fc2 = Dense(max(channels // 2, 1), channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # jnp.mean: f32 sums, the result in x's dtype
        s = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        s = self.fc2(torch.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class _SpatialSE(nn.Module):
    """Spatial squeeze-and-excitation: a biased 1x1 conv -> sigmoid gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.squeeze = Conv(channels, 1, (1, 1), padding="SAME")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.squeeze(x))


class _SEGate(nn.Module):
    def __init__(self, kind: str, channels: int):
        super().__init__()
        self.kind = kind
        if kind in ("CSE", "CSSE"):
            self.cse = _ChannelSE(channels)
        if kind in ("SSE", "CSSE"):
            self.sse = _SpatialSE(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "CSE":
            return self.cse(x)
        if self.kind == "SSE":
            return self.sse(x)
        if self.kind == "CSSE":
            return torch.maximum(self.cse(x), self.sse(x))
        return x


class DenseBlock2D(nn.Module):
    """Two dense k x k stages and a pointwise bottleneck back to
    ``num_filters``, each conv -> instance norm -> PReLU, then the SE gate."""

    def __init__(self, in_channels: int, num_filters: int = 64, kernel_size: int = 5,
                 se_block: str = "None"):
        super().__init__()
        k, f = (kernel_size, kernel_size), num_filters
        self.conv0 = Conv(in_channels, f, k, padding="SAME")
        self.conv1 = Conv(in_channels + f, f, k, padding="SAME")
        self.conv2 = Conv(in_channels + 2 * f, f, (1, 1), padding="SAME")
        for i in range(3):
            self.add_module(f"norm{i}", GroupNorm(f, f))
            self.add_module(f"act{i}", PReLU())
        self.se = _SEGate(se_block, f)

    def _adn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"act{i}")(getattr(self, f"norm{i}")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o1 = self._adn(0, self.conv0(x))
        o2 = self._adn(1, self.conv1(torch.cat([x, o1], dim=-1)))
        out = self._adn(2, self.conv2(torch.cat([x, o1, o2], dim=-1)))
        return self.se(out)


def _pool_with_mask(x: torch.Tensor, pool: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pool`` x ``pool`` max-pool (kernel = stride) of NHWC ``x`` and a mask
    in x's dtype, 1 at each window's first maximum in row-major order."""
    n, h, w, c = x.shape
    blocks = x.reshape(n, h // pool, pool, w // pool, pool, c)
    pooled = blocks.amax(dim=(2, 4))
    is_max = blocks == pooled[:, :, None, :, None, :]
    flat = is_max.permute(0, 1, 3, 2, 4, 5).reshape(n, h // pool, w // pool, pool * pool, c)
    first = torch.cumsum(flat.to(torch.int32), dim=3) == 1
    mask = (flat & first).reshape(n, h // pool, w // pool, pool, pool, c)
    mask = mask.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)
    return pooled, mask.to(x.dtype)


def _unpool(x: torch.Tensor, mask: torch.Tensor, pool: int) -> torch.Tensor:
    up = torch.repeat_interleave(torch.repeat_interleave(x, pool, dim=1), pool, dim=2)
    return up * mask


class Quicknat(nn.Module):
    """MONAI ``Quicknat`` config surface (PReLU and instance norm pinned).
    Takes NHWC slices or an NDHWC volume (depth folded into the batch,
    restored on the output)."""

    def __init__(self, num_classes: int = 33, num_channels: int = 1, num_filters: int = 64,
                 kernel_size: int = 5, kernel_c: int = 1, stride_conv: int = 1, pool: int = 2,
                 stride_pool: int = 2, se_block: str = "None", drop_out: float = 0.0):
        super().__init__()
        self.pool, self.stride_pool, self.drop_out = pool, stride_pool, drop_out
        f = num_filters

        def block(in_channels):
            return DenseBlock2D(in_channels, f, kernel_size, se_block)

        for i in range(4):
            self.add_module(f"enc{i}", block(num_channels if i == 0 else f))
        self.bottleneck = block(f)
        for i in range(4):
            self.add_module(f"dec{i}", block(2 * f))
        self.classifier = Conv(f, num_classes, (kernel_c, kernel_c), stride_conv,
                               padding="SAME")

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.pool != self.stride_pool:
            raise NotImplementedError(
                "Quicknat: only pool == stride_pool (non-overlapping pooling) is supported")
        volume_depth = None
        if x.dim() == 5:  # NDHWC volume -> a batch of slices
            volume_depth = x.shape[1]
            x = x.reshape((-1,) + tuple(x.shape[2:]))
        if x.shape[1] % self.pool ** 4 or x.shape[2] % self.pool ** 4:
            raise ValueError(f"Quicknat: spatial dims {tuple(x.shape[1:3])} must be divisible "
                             f"by pool**4 = {self.pool ** 4}")
        skips, masks = [], []
        h = x
        for i in range(4):
            h = dropout(getattr(self, f"enc{i}")(h), self.drop_out, train, rng)
            skips.append(h)
            h, m = _pool_with_mask(h, self.pool)
            masks.append(m)
        h = self.bottleneck(h)
        for i in reversed(range(4)):
            h = torch.cat([_unpool(h, masks[i], self.pool), skips[i]], dim=-1)
            h = dropout(getattr(self, f"dec{i}")(h), self.drop_out, train, rng)
        out = self.classifier(h)
        if volume_depth is not None:
            out = out.reshape((-1, volume_depth) + tuple(out.shape[1:]))
        return out

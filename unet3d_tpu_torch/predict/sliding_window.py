"""Sliding-window inference with overlap blending (NDHWC tensors).

Counterpart of ``unet3d_tpu/predict/sliding_window.py`` (MONAI
``SlidingWindowInferer`` semantics). The patch grid is computed on the host;
windows are sliced on the input's device, run through the network
``sw_batch_size`` at a time, weighted by a constant or gaussian importance map
and accumulated into f32 sums on the device.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _scan_interval(image_size, roi_size, overlap: float) -> Tuple[int, ...]:
    interval = []
    for i, r in zip(image_size, roi_size):
        if r == i:
            interval.append(int(r))
        else:
            interval.append(int(max(r * (1.0 - overlap), 1)))
    return tuple(interval)


def dense_patch_slices(image_size, roi_size, interval) -> np.ndarray:
    """Start indices of the dense patch grid (MONAI-compatible coverage)."""
    starts = []
    for size, roi, step in zip(image_size, roi_size, interval):
        if size <= roi:
            axis_starts = [0]
        else:
            n = int(np.ceil((size - roi) / step)) + 1
            axis_starts = sorted(set(min(i * step, size - roi) for i in range(n)))
        starts.append(axis_starts)
    grid = np.stack(np.meshgrid(*starts, indexing="ij"), axis=-1).reshape(-1, 3)
    return grid.astype(np.int32)


def gaussian_importance_map(roi_size, sigma_scale: float = 0.125) -> np.ndarray:
    """MONAI gaussian blending map: centered gaussian, sigma = sigma_scale * size."""
    grids = []
    for s in roi_size:
        x = np.arange(s, dtype=np.float64)
        center = (s - 1) / 2.0
        sigma = max(s * sigma_scale, 1e-6)
        grids.append(np.exp(-0.5 * ((x - center) / sigma) ** 2))
    m = grids[0][:, None, None] * grids[1][None, :, None] * grids[2][None, None, :]
    m = m / m.max()
    return np.clip(m, np.finfo(np.float32).tiny, None).astype(np.float32)


_PAD_MODES = ("constant", "reflect", "replicate", "circular")  # F.pad names


def sliding_window_inference(inputs: torch.Tensor, network: Callable,
                             roi_size: Sequence[int], sw_batch_size: int = 1,
                             overlap: float = 0.25, mode: str = "constant",
                             sigma_scale: float = 0.125,
                             padding_mode: str = "constant",
                             cval: float = 0.0) -> torch.Tensor:
    """Blend ``network`` over the dense patch grid of NDHWC ``inputs``."""
    batch, *spatial, channels = inputs.shape
    roi_size = tuple(int(r) for r in roi_size)
    if padding_mode not in _PAD_MODES:
        raise ValueError(f"padding_mode {padding_mode!r} is not supported; "
                         f"expected one of {sorted(_PAD_MODES)} (torch F.pad names)")
    # pad up to roi where the volume is smaller
    pads = [(max(r - s, 0) // 2, max(r - s, 0) - max(r - s, 0) // 2)
            for s, r in zip(spatial, roi_size)]
    padded_spatial = [s + lo + hi for s, (lo, hi) in zip(spatial, pads)]
    if any(p != (0, 0) for p in pads):
        (dl, dh), (hl, hh), (wl, wh) = pads
        x = inputs.permute(0, 4, 1, 2, 3)
        if padding_mode == "constant":
            x = F.pad(x, (wl, wh, hl, hh, dl, dh), value=cval)
        else:
            x = F.pad(x, (wl, wh, hl, hh, dl, dh), mode=padding_mode)
        inputs = x.permute(0, 2, 3, 4, 1)

    interval = _scan_interval(padded_spatial, roi_size, overlap)
    starts = dense_patch_slices(padded_spatial, roi_size, interval).tolist()
    n_patches = len(starts)
    # the last group is filled by repeating the last window; the repeats run
    # through the network but are left out of both sums
    pad_to = -(-n_patches // sw_batch_size) * sw_batch_size
    starts += [starts[-1]] * (pad_to - n_patches)

    device = inputs.device
    if mode == "gaussian":
        importance = torch.from_numpy(gaussian_importance_map(roi_size, sigma_scale))
    else:
        importance = torch.ones(roi_size, dtype=torch.float32)
    imp = importance.to(device)[None, :, :, :, None]

    out_sum = None
    weight_sum = torch.zeros((1, *padded_spatial, 1), dtype=torch.float32,
                             device=device)
    for g in range(0, pad_to, sw_batch_size):
        group = starts[g:g + sw_batch_size]
        windows = [inputs[:, z:z + roi_size[0], y:y + roi_size[1],
                          x:x + roi_size[2], :] for z, y, x in group]
        outs = network(torch.cat(windows, dim=0)).float()
        outs = outs.reshape(len(group), batch, *roi_size, outs.shape[-1]) * imp
        if out_sum is None:
            out_sum = torch.zeros((batch, *padded_spatial, outs.shape[-1]),
                                  dtype=torch.float32, device=device)
        for j, (z, y, x) in enumerate(group):
            if g + j >= n_patches:
                continue
            sl = (slice(None), slice(z, z + roi_size[0]),
                  slice(y, y + roi_size[1]), slice(x, x + roi_size[2]))
            out_sum[sl] += outs[j]
            weight_sum[sl] += imp
    out = out_sum / weight_sum
    (dl, _), (hl, _), (wl, _) = pads
    return out[:, dl:dl + spatial[0], hl:hl + spatial[1], wl:wl + spatial[2], :]


class SlidingWindowInferer:
    """Callable ``inferer(inputs_ndhwc, network) -> ndhwc output`` with the
    MONAI config kwargs: roi_size, sw_batch_size, overlap, mode ('constant' |
    'gaussian'), sigma_scale, padding_mode, cval."""

    def __init__(self, roi_size: Sequence[int], sw_batch_size: int = 1,
                 overlap: float = 0.25, mode: str = "constant",
                 sigma_scale: float = 0.125, padding_mode: str = "constant",
                 cval: float = 0.0, progress: bool = False):
        self.roi_size = tuple(int(r) for r in roi_size)
        self.sw_batch_size = int(sw_batch_size)
        self.overlap = float(overlap)
        self.mode = mode
        self.sigma_scale = sigma_scale
        self.padding_mode = padding_mode
        self.cval = cval
        del progress

    def __call__(self, inputs: torch.Tensor, network: Callable) -> torch.Tensor:
        return sliding_window_inference(
            inputs, network, roi_size=self.roi_size,
            sw_batch_size=self.sw_batch_size, overlap=self.overlap,
            mode=self.mode, sigma_scale=self.sigma_scale,
            padding_mode=self.padding_mode, cval=self.cval)


class SimpleInferer:
    """Direct forward (monai.inferers.SimpleInferer parity)."""

    def __call__(self, inputs: torch.Tensor, network: Callable) -> torch.Tensor:
        return network(inputs)


INFERER_REGISTRY = {
    "SlidingWindowInferer": SlidingWindowInferer,
    "SlidingWindowInfererAdapt": SlidingWindowInferer,
    "SimpleInferer": SimpleInferer,
}


def build_inferer(name: str, **kwargs):
    if name not in INFERER_REGISTRY:
        raise ValueError(f"Inferer {name} is not supported")
    return INFERER_REGISTRY[name](**kwargs)

"""Nearest-neighbour NDHWC resize (counterpart of ``unet3d_tpu/ops/interpolate.py``).

Only ``mode="nearest"`` is ported: the DynUNet deep-supervision heads use it.
Source index ``floor(i * s_in / s_out)``, clipped, as torch's ``nearest``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _nearest_index(s_in: int, s_out: int) -> np.ndarray:
    v = np.arange(s_out, dtype=np.float64)
    return np.clip(np.floor(v * (s_in / s_out)), 0, s_in - 1).astype(np.int64)


def resize_ndhwc(x: torch.Tensor, out_spatial: Sequence[int],
                 mode: str = "nearest") -> torch.Tensor:
    """Resize ``(N, D, H, W, C)`` to spatial ``out_spatial``."""
    if mode != "nearest":
        raise NotImplementedError(
            f"resize mode {mode!r}: only 'nearest' is ported so far (see ROADMAP.md)")
    for axis, (s_in, s_out) in enumerate(zip(x.shape[1:4], out_spatial), start=1):
        if s_in != int(s_out):
            index = torch.from_numpy(_nearest_index(s_in, int(s_out))).to(x.device)
            x = torch.index_select(x, axis, index)
    return x

"""Separable NDHWC resize (counterpart of ``unet3d_tpu/ops/interpolate.py``).

Used by the decoders' upsampling and DynUNet's deep-supervision heads. Each
spatial axis whose size changes is resampled on its own: the nearest modes
take one index per output voxel, the linear modes two indices and a lerp.
Source coordinates follow ``torch.nn.functional.interpolate``.

Dtypes follow the JAX version: the nearest modes keep the input's dtype; the
linear modes multiply by an f32 weight, so a bf16 input comes out f32 once
any axis is resampled (an axis of unchanged size is skipped and casts
nothing).

On the space axis (``parallel/``: x an NDHWC slab of the volume's D planes)
``resize_ndhwc`` (and ``upsample_ndhwc``, which calls it) resizes D by an
integer factor: the slab takes one plane from each neighbour
(``parallel/halo.exchange_halo``) and places every output plane of its slab
by the whole volume's coordinates, clamped at the volume's edges, so each
slab is the slab of the single-device result (one plane reaches any
integer factor: output plane i of slab r reads source planes within one of
[r d, (r + 1) d)). Any other change of D raises there.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from unet3d_tpu_torch.parallel.distributed import space_rank, space_size
from unet3d_tpu_torch.parallel.halo import exchange_halo


def axis_coords(s_in: int, s_out: int, mode: str, align_corners: bool) -> np.ndarray:
    """The source coordinate of each of ``s_out`` samples along an axis of
    ``s_in``, as ``torch.nn.functional.interpolate`` places them."""
    v = np.arange(s_out, dtype=np.float64)
    if mode == "nearest":
        return np.clip(np.floor(v * (s_in / s_out)), 0, s_in - 1)
    if mode == "nearest-exact":
        return np.clip(np.floor((v + 0.5) * (s_in / s_out)), 0, s_in - 1)
    if align_corners:
        return v * ((s_in - 1) / max(s_out - 1, 1))
    return np.clip((v + 0.5) * (s_in / s_out) - 0.5, 0, s_in - 1)


def resize_ndhwc(x: torch.Tensor, out_spatial: Sequence[int], mode: str = "trilinear",
                 align_corners: bool = False) -> torch.Tensor:
    """Resize ``(N, D, H, W, C)`` to spatial ``out_spatial``: ``nearest``,
    ``nearest-exact``, or any other mode name as linear (``trilinear``). On
    the space axis x and ``out_spatial`` are a D slab's (an integer factor
    on D)."""
    size = space_size()
    depth, d_out = x.shape[1], int(out_spatial[0])
    if size > 1 and d_out != depth:
        if d_out % depth:
            raise NotImplementedError(
                f"a resize of a D slab of {depth} planes to {d_out} (not an integer "
                "factor) has no form for the 'space' mesh axis (see ROADMAP.md)")
        rank = space_rank()
        xh, _ = exchange_halo(x, 1, 1)
        coords = axis_coords(depth * size, d_out * size, mode, align_corners)
        x = _resample_axis(xh, 1, coords[rank * d_out:(rank + 1) * d_out], depth * size, mode,
                           first=rank * depth - (1 if rank > 0 else 0))
    for axis, (s_in, s_out) in enumerate(zip(x.shape[1:4], out_spatial), start=1):
        s_out = int(s_out)
        if s_in == s_out:
            continue
        x = _resample_axis(x, axis, axis_coords(s_in, s_out, mode, align_corners), s_in, mode)
    return x


def _resample_axis(x: torch.Tensor, axis: int, coords: np.ndarray, s_in: int, mode: str,
                   first: int = 0) -> torch.Tensor:
    """x resampled along ``axis`` at source ``coords`` of an axis of ``s_in``
    samples, of which x holds those from ``first`` on."""
    if mode in ("nearest", "nearest-exact"):
        index = torch.from_numpy(coords.astype(np.int64) - first).to(x.device)
        return torch.index_select(x, axis, index)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, s_in - 1)
    shape = [1] * x.dim()
    shape[axis] = len(coords)
    w = torch.from_numpy((coords - lo).astype(np.float32)).to(x.device).reshape(shape)
    return (torch.index_select(x, axis, torch.from_numpy(lo - first).to(x.device)) * (1.0 - w)
            + torch.index_select(x, axis, torch.from_numpy(hi - first).to(x.device)) * w)


def upsample_ndhwc(x: torch.Tensor, scale: int = 2, mode: str = "trilinear",
                   align_corners: bool = False) -> torch.Tensor:
    """scale_factor-style upsample (torch semantics: out = floor(in * scale));
    on the space axis, of a D slab (an integer ``scale``)."""
    out_spatial = tuple(int(s * scale) for s in x.shape[1:4])
    return resize_ndhwc(x, out_spatial, mode=mode, align_corners=align_corners)


def image_resize(x: torch.Tensor, factors: Sequence[int],
                 method: str = "trilinear") -> torch.Tensor:
    """``jax.image.resize(x, spatial * factors, method)`` on NDHWC ``x`` for
    integer upsampling ``factors`` (one per spatial axis): one axis at a time
    (the JAX einsum's contractions), each with half-pixel centres, clamped at
    the edges (where JAX renormalises the weights: the same values for an
    upsample), in f32 and rounded to x's dtype; ``nearest`` takes source
    index ``floor((i + 0.5) / factor)``, JAX's nearest."""
    dtype = x.dtype
    mode = "trilinear" if method == "trilinear" else "nearest-exact"
    for axis, factor in enumerate(factors):
        out = list(x.shape[1:4])
        out[axis] *= int(factor)
        x = resize_ndhwc(x, out, mode).to(dtype)
    return x

"""Grid resampling: affine resample and resize, trilinear / nearest, in torch.

Counterpart of ``unet3d_tpu/ops/resample.py``, with its conventions:

* ``resample`` maps each destination voxel to a source voxel through
  ``inv(src_affine) @ dst_affine`` (MONAI ``SpatialResample``'s effective
  mapping for either align_corners setting);
* ``resize`` follows ``torch.nn.functional.interpolate`` (MONAI ``Resize``):
  ``(v + 0.5) * S_in / S_out - 0.5`` without align_corners,
  ``v * (S_in - 1) / (S_out - 1)`` with it, legacy ``nearest`` as
  ``floor(v * S_in / S_out)`` and ``nearest-exact`` with the half-voxel shift;
* reads outside the volume are zeros.

Sampling coordinates are elementwise f32 multiply-adds of the grid, as the
JAX package computes them. Functions take channel-first ``(C, D, H, W)``
arrays or tensors and return tensors on the input's device (a numpy input
computes on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from unet3d_tpu_torch.utils.device import as_tensor

from unet3d_tpu_torch.ops import affine as affine_ops

_TRILINEAR_MODES = ("trilinear", "linear", "bilinear")
_NEAREST_MODES = ("nearest", "nearest-exact")


def _flat_gather(data_flat: torch.Tensor, z, y, x, shape) -> torch.Tensor:
    """``data_flat`` (C, D*H*W) at integer voxel coordinates, zero outside."""
    d, h, w = shape
    in_bounds = (z >= 0) & (z <= d - 1) & (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
    flat = ((z.clamp(0, d - 1) * h + y.clamp(0, h - 1)) * w + x.clamp(0, w - 1))
    vals = data_flat.index_select(1, flat.reshape(-1)).reshape(
        (data_flat.shape[0],) + tuple(flat.shape))
    return torch.where(in_bounds[None], vals, torch.zeros((), dtype=vals.dtype,
                                                          device=vals.device))


def sample_at_coords(data: torch.Tensor, coords: torch.Tensor,
                     mode: str = "trilinear") -> torch.Tensor:
    """Sample ``data (C, D, H, W)`` at float source-voxel ``coords (3, *out)``;
    ``nearest_floor`` takes the floor (torch's legacy nearest)."""
    shape = tuple(data.shape[-3:])
    data_flat = data.reshape(data.shape[0], -1)
    cz, cy, cx = coords[0], coords[1], coords[2]
    if mode == "nearest_floor":
        return _flat_gather(data_flat, cz.floor().long(), cy.floor().long(),
                            cx.floor().long(), shape)
    if mode in _NEAREST_MODES:
        return _flat_gather(data_flat, cz.round().long(), cy.round().long(),
                            cx.round().long(), shape)
    if mode not in _TRILINEAR_MODES:
        raise ValueError(f"Unsupported interpolation mode: {mode}")
    z0, y0, x0 = cz.floor(), cy.floor(), cx.floor()
    fz, fy, fx = ((cz - z0).to(data.dtype), (cy - y0).to(data.dtype),
                  (cx - x0).to(data.dtype))
    z0, y0, x0 = z0.long(), y0.long(), x0.long()
    out = torch.zeros((data.shape[0],) + tuple(coords.shape[1:]), dtype=data.dtype,
                      device=data.device)
    for dz in (0, 1):
        wz = fz if dz else (1.0 - fz)
        for dy in (0, 1):
            wy = fy if dy else (1.0 - fy)
            for dx in (0, 1):
                wx = fx if dx else (1.0 - fx)
                corner = _flat_gather(data_flat, z0 + dz, y0 + dy, x0 + dx, shape)
                out = out + corner * (wz * wy * wx)[None]
    return out


def _dst_voxel_grid(dst_shape, device) -> torch.Tensor:
    """Voxel-centre grid of a destination volume, (3, *dst_shape) f32."""
    axes = [torch.arange(s, dtype=torch.float32, device=device) for s in dst_shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def resample_transform(data, transform, dst_shape, mode: str = "trilinear",
                       clip_max=None) -> torch.Tensor:
    """Resample with a 4x4 dst-voxel -> src-voxel ``transform``; ``clip_max``
    (3,) clamps source coordinates to [0, clip_max] per axis."""
    data = as_tensor(data)
    transform = torch.as_tensor(np.asarray(transform), dtype=torch.float32,
                                device=data.device)
    grid = _dst_voxel_grid(tuple(int(s) for s in dst_shape), data.device)
    rot, trans = transform[:3, :3], transform[:3, 3]
    # elementwise multiply-adds, as the JAX package computes them (no matmul)
    coords = torch.stack([rot[i, 0] * grid[0] + rot[i, 1] * grid[1]
                          + rot[i, 2] * grid[2] + trans[i] for i in range(3)])
    if clip_max is not None:
        clip_max = torch.as_tensor(clip_max, dtype=torch.float32, device=data.device)
        coords = torch.minimum(coords.clamp(min=0.0), clip_max[:, None, None, None])
    return sample_at_coords(data, coords, mode=mode)


def resize_bucketed(data, true_shape, out_shape, mode: str = "trilinear",
                    align_corners: bool = False) -> torch.Tensor:
    """The values of the JAX ``resize_bucketed``: its f32 scale and offset and
    its clamp of the source coordinates to the true extent. The JAX package
    zero-pads the input to a 32-voxel multiple so that one XLA program serves
    a bucket of shapes; reads past the true extent carry zero weight or fall
    on that zero padding, so the port samples the array as it is."""
    data = as_tensor(data)
    true_shape = tuple(int(s) for s in true_shape)
    ts = torch.tensor(true_shape, dtype=torch.float32)
    os_ = torch.tensor([int(s) for s in out_shape], dtype=torch.float32)
    transform = torch.zeros(4, 4)
    transform[3, 3] = 1.0
    if mode in _NEAREST_MODES:
        scale = ts / os_
        for i in range(3):
            transform[i, i] = scale[i]
            if mode == "nearest-exact":
                transform[i, 3] = 0.5 * scale[i]
        return resample_transform(data, transform, out_shape, mode="nearest_floor",
                                  clip_max=ts - 1)
    if align_corners:
        scale = (ts - 1) / torch.clamp(os_ - 1, min=1)
        offset = torch.zeros(3)
    else:
        scale = ts / os_
        offset = 0.5 * scale - 0.5
    for i in range(3):
        transform[i, i] = scale[i]
        transform[i, 3] = offset[i]
    return resample_transform(data, transform, out_shape, mode=mode, clip_max=ts - 1)


def resample(data, src_affine, dst_affine, dst_shape, mode: str = "trilinear",
             margin: float = 1e-6):
    """Resample a channel-first volume onto the grid ``(dst_affine, dst_shape)``;
    returned as is when the affines agree within ``margin`` and the shapes
    are equal."""
    src_affine = np.asarray(src_affine, dtype=np.float64)
    dst_affine = np.asarray(dst_affine, dtype=np.float64)
    dst_shape = tuple(int(s) for s in dst_shape)
    if (np.all(np.abs(src_affine - dst_affine) < margin)
            and tuple(data.shape[-3:]) == dst_shape):
        return data
    transform = affine_ops.voxel_to_voxel_transform(src_affine, dst_affine)
    return resample_transform(data, transform, dst_shape, mode=mode)


def resample_to_img(data, src_affine, target_affine, target_shape,
                    mode: str = "trilinear"):
    """Resample onto another image's grid."""
    return resample(data, src_affine, target_affine, target_shape, mode=mode)


def resize(data, out_shape, mode: str = "trilinear",
           align_corners: bool = False) -> torch.Tensor:
    """Resize ``(C, D, H, W)`` to ``(C, *out_shape)`` with torch-interpolate
    semantics (MONAI ``ResizeD``)."""
    data = as_tensor(data)
    in_shape = tuple(data.shape[-3:])
    out_shape = tuple(int(s) for s in out_shape)
    axes = []
    for s_in, s_out in zip(in_shape, out_shape):
        v = torch.arange(s_out, dtype=torch.float32, device=data.device)
        if mode in _NEAREST_MODES:
            if mode == "nearest":
                c = torch.floor(v * (s_in / s_out))
            else:
                c = torch.floor((v + 0.5) * (s_in / s_out))
            c = torch.clamp(c, 0, s_in - 1)
        elif align_corners:
            c = v * ((s_in - 1) / max(s_out - 1, 1))
        else:
            c = (v + 0.5) * (s_in / s_out) - 0.5
        axes.append(c)
    coords = torch.stack([axes[0][:, None, None].expand(out_shape),
                          axes[1][None, :, None].expand(out_shape),
                          axes[2][None, None, :].expand(out_shape)])
    if mode in _NEAREST_MODES:
        return sample_at_coords(data, coords, mode="nearest")
    # torch clamps the +1 neighbour at the upper edge (weight ~0 there), and
    # negative coordinates at the lower edge clamp to 0
    hi = torch.tensor([s - 1 for s in in_shape], dtype=torch.float32,
                      device=data.device)[:, None, None, None]
    return sample_at_coords(data, torch.minimum(coords.clamp(min=0.0), hi), mode=mode)


def resample_image_to_spacing(data, affine, new_spacing, mode: str = "trilinear"):
    """Resample to a new voxel spacing; returns (data, new_affine). The new
    shape is floor(extent / new_spacing + eps) and the field-of-view centre
    stays put."""
    affine = np.asarray(affine, dtype=np.float64)
    new_spacing = np.asarray(new_spacing, dtype=np.float64)
    current_spacing = affine_ops.get_spacing_from_affine(affine)
    new_affine = affine_ops.adjust_affine_spacing(affine, new_spacing,
                                                  spacing=current_spacing)
    extent = affine_ops.get_extent_from_shape(data.shape, affine)
    new_shape = tuple(int(s) for s in
                      np.floor(extent / new_spacing + np.finfo(np.float64).eps))
    return resample(data, affine, new_affine, new_shape, mode=mode), new_affine

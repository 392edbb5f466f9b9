"""Affine (voxel->world) algebra for volumetric grids (a copy of
``unet3d_tpu/ops/affine.py``, numpy float64 on the host).

Host-side metadata math on 4x4 NIfTI-style affines, kept in numpy: affines describe
*grids*, not bulk data, so they never need to live on-device. Semantics match the
reference's affine helpers (`unet3d/utils/affine.py:12-62`): spacing is the column
norm of the rotation-zoom block; changing spacing preserves the position of the
*center of the first voxel* shifted by half the spacing delta (so the field-of-view
center stays put on resize).
"""
from __future__ import annotations

import numpy as np


def get_spacing_from_affine(affine: np.ndarray) -> np.ndarray:
    """Voxel spacing = column-wise L2 norm of the 3x3 rotation-zoom block.

    Parity: `unet3d/utils/affine.py:12-14`.
    """
    rzs = np.asarray(affine, dtype=np.float64)[:3, :3]
    return np.sqrt(np.sum(rzs * rzs, axis=0))


def set_affine_spacing(affine: np.ndarray, spacing) -> np.ndarray:
    """Rescale the affine columns so the voxel spacing becomes ``spacing``.

    Parity: `unet3d/utils/affine.py:17-22`.
    """
    affine = np.asarray(affine, dtype=np.float64)
    scale = np.asarray(spacing, dtype=np.float64) / get_spacing_from_affine(affine)
    transform = np.diag(np.concatenate([scale, [1.0]]))
    return affine @ transform


def calculate_origin_offset(new_spacing, old_spacing) -> np.ndarray:
    """Half-voxel origin shift (in old-voxel units) induced by a spacing change.

    Parity: `unet3d/utils/affine.py:5-9`.
    """
    new_spacing = np.asarray(new_spacing, dtype=np.float64)
    old_spacing = np.asarray(old_spacing, dtype=np.float64)
    return (new_spacing - old_spacing) / 2.0 / old_spacing


def adjust_affine_spacing(affine: np.ndarray, new_spacing, spacing=None) -> np.ndarray:
    """Change spacing while keeping the field of view centered.

    Parity: `unet3d/utils/affine.py:30-39` (translate origin by the half-voxel
    offset in voxel coordinates, then rescale the columns).
    """
    affine = np.asarray(affine, dtype=np.float64)
    if spacing is None:
        spacing = get_spacing_from_affine(affine)
    offset = calculate_origin_offset(new_spacing, spacing)
    translation = np.eye(4)
    translation[:3, 3] = offset
    return set_affine_spacing(affine @ translation, new_spacing)


def resize_affine(affine: np.ndarray, shape, target_shape) -> np.ndarray:
    """Affine for a grid resized from ``shape`` to ``target_shape`` over the same extent.

    Parity: `unet3d/utils/affine.py:51-62`.
    """
    shape = np.asarray(shape, dtype=np.float64)
    target_shape = np.asarray(target_shape, dtype=np.float64)
    if np.all(shape == target_shape):
        return np.asarray(affine, dtype=np.float64).copy()
    spacing = get_spacing_from_affine(affine)
    target_spacing = spacing * shape / target_shape
    return adjust_affine_spacing(affine, target_spacing)


def get_extent_from_shape(shape, affine: np.ndarray) -> np.ndarray:
    """Physical extent (mm) of a grid: spatial shape * spacing.

    Parity: `unet3d/utils/affine.py:25-28` (last 3 dims are spatial).
    """
    return np.asarray(shape[-3:], dtype=np.float64) * get_spacing_from_affine(affine)


def is_diag(x: np.ndarray) -> bool:
    """True when a matrix has no off-diagonal nonzeros (`unet3d/utils/affine.py:65-66`)."""
    x = np.asarray(x)
    return int(np.count_nonzero(x - np.diag(np.diagonal(x)))) == 0


def assert_affine_is_diagonal(affine: np.ndarray) -> None:
    """Parity: `unet3d/utils/affine.py:69-71`."""
    if not is_diag(np.asarray(affine)[:3, :3]):
        raise NotImplementedError(
            "Hemisphere swapping for non-diagonal affines is not yet implemented.")


def crop_affine(affine: np.ndarray, start) -> np.ndarray:
    """Affine of a sub-grid starting at voxel index ``start`` (origin translated)."""
    affine = np.asarray(affine, dtype=np.float64).copy()
    start = np.asarray(start, dtype=np.float64)
    affine[:3, 3] = affine[:3, 3] + affine[:3, :3] @ start
    return affine


def voxel_to_voxel_transform(src_affine: np.ndarray, dst_affine: np.ndarray) -> np.ndarray:
    """4x4 matrix mapping destination voxel indices to source voxel indices.

    ``v_src = inv(src_affine) @ dst_affine @ v_dst`` — the world-space composition
    used by grid resampling (equivalent to MONAI SpatialResample's normalized-grid
    construction; the align_corners normalization cancels, see ops/resample.py).
    """
    src = np.asarray(src_affine, dtype=np.float64)
    dst = np.asarray(dst_affine, dtype=np.float64)
    return np.linalg.solve(src, dst)

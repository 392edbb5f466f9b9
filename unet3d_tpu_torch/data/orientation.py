"""Anatomical orientation (axis codes) handling (a copy of
``unet3d_tpu/data/orientation.py``, numpy only).

Replaces the reference's MONAI ``Orientation`` usage
(`unet3d/utils/utils.py:127-128`, `unet3d/datasets/segmentation.py:47-48`): reorder
spatial axes and flip directions so the voxel axes align with requested axis codes
(default RAS). Pure host-side metadata + transpose/flip math (numpy), standard
nibabel-style orientation algebra implemented from scratch.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_CODE_TO_AXIS = {
    "R": (0, 1), "L": (0, -1),
    "A": (1, 1), "P": (1, -1),
    "S": (2, 1), "I": (2, -1),
}


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """For each voxel axis: (closest world axis, direction). Greedy max-|cosine|."""
    rzs = np.asarray(affine, dtype=np.float64)[:3, :3]
    zooms = np.sqrt(np.sum(rzs * rzs, axis=0))
    zooms = np.where(zooms == 0, 1.0, zooms)
    normed = rzs / zooms
    ornt = np.zeros((3, 2))
    q = np.abs(normed).copy()
    for _ in range(3):
        world, voxel = np.unravel_index(np.argmax(q), q.shape)
        ornt[voxel] = (world, 1.0 if normed[world, voxel] > 0 else -1.0)
        q[world, :] = -1.0
        q[:, voxel] = -1.0
    return ornt


def axcodes_to_orientation(axcodes: str) -> np.ndarray:
    """Axis codes like "RAS" -> orientation array."""
    if len(axcodes) != 3:
        raise ValueError(f"Expected 3 axis codes, got {axcodes!r}")
    return np.array([_CODE_TO_AXIS[c.upper()] for c in axcodes], dtype=np.float64)


def orientation_to_axcodes(ornt: np.ndarray) -> str:
    inverse = {v: k for k, v in _CODE_TO_AXIS.items()}
    return "".join(inverse[(int(w), int(d))] for w, d in ornt)


def orientation_transform(start: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Transform taking axes in ``start`` orientation to ``end``: rows are
    (source voxel axis, flip) for each output axis."""
    transform = np.zeros((3, 2))
    for out_axis, (world, direction) in enumerate(end):
        for in_axis, (w2, d2) in enumerate(start):
            if w2 == world:
                transform[out_axis] = (in_axis, direction * d2)
                break
        else:
            raise ValueError("Incompatible orientations")
    return transform


def apply_orientation(data: np.ndarray, affine: np.ndarray,
                      axcodes: str = "RAS") -> Tuple[np.ndarray, np.ndarray]:
    """Reorder a channel-first ``(C, D, H, W)`` array + affine to ``axcodes``.

    Parity with MONAI ``Orientation(axcodes=...)`` on the last three axes.
    """
    data = np.asarray(data)
    n_lead = data.ndim - 3
    current = io_orientation(affine)
    target = axcodes_to_orientation(axcodes)
    transform = orientation_transform(current, target)

    # Permute/flip the spatial axes of the data
    perm = [int(a) for a, _ in transform]
    data = np.transpose(data, tuple(range(n_lead)) + tuple(n_lead + p for p in perm))
    flips = [n_lead + i for i, (_, d) in enumerate(transform) if d < 0]
    if flips:
        data = np.flip(data, axis=tuple(flips))

    # Update the affine: new voxel coords -> old voxel coords -> world
    old_shape = np.asarray([data.shape[n_lead + i] for i in range(3)])  # new spatial shape
    mat = np.zeros((4, 4))
    mat[3, 3] = 1.0
    for out_axis, (in_axis, direction) in enumerate(transform):
        mat[int(in_axis), out_axis] = direction
        if direction < 0:
            mat[int(in_axis), 3] = old_shape[out_axis] - 1
    new_affine = np.asarray(affine, dtype=np.float64) @ mat
    return np.ascontiguousarray(data), new_affine

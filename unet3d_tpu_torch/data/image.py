"""Affine-carrying volume container (counterpart of ``unet3d_tpu/data/image.py``).

A host-side ``(C, D, H, W)`` array plus its 4x4 voxel->world affine and
metadata.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from unet3d_tpu_torch.data import nifti
from unet3d_tpu_torch.ops import affine as affine_ops


@dataclass
class Volume:
    data: Any  # (C, D, H, W) channel-first (or (D, H, W)), numpy
    affine: np.ndarray
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self.affine = np.asarray(self.affine, dtype=np.float64)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def spatial_shape(self):
        return tuple(self.data.shape[-3:])

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def spacing(self) -> np.ndarray:
        return affine_ops.get_spacing_from_affine(self.affine)

    def make_similar(self, data, affine: Optional[np.ndarray] = None,
                     copy_meta: bool = True) -> "Volume":
        """New Volume with this one's affine/meta unless overridden."""
        if affine is None:
            affine = self.affine
        meta = dict(self.meta) if copy_meta else {}
        return Volume(data=data, affine=np.asarray(affine, dtype=np.float64), meta=meta)

    def astype(self, dtype) -> "Volume":
        return self.make_similar(np.asarray(self.data).astype(dtype))

    def to_filename(self, filename: str) -> None:
        """Write as NIfTI: channels moved last and squeezed."""
        arr = np.asarray(self.data)
        if arr.ndim > 3:
            arr = np.moveaxis(arr, 0, -1)
        nifti.save(filename, np.squeeze(arr), self.affine)

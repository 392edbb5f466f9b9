"""Volume IO: NIfTI load/save with channel handling and RAS reorder (a copy
of ``unet3d_tpu/data/io.py``, numpy only).

Parity with `unet3d/utils/utils.py:88-156`: multi-file channel concat, uint16 ->
int16 narrowing, 4D channels-last -> channels-first moveaxis, optional axis-code
reorder; plus the half-resolution decomposition utilities used for
super-resolution workflows.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from unet3d_tpu_torch.data import nifti
from unet3d_tpu_torch.data.image import Volume
from unet3d_tpu_torch.data.orientation import apply_orientation


def load_single_image(filename: str, reorder: bool = True, dtype=None,
                      axcodes: str = "RAS") -> Volume:
    """Load one NIfTI file as a channel-first Volume.

    Parity: `unet3d/utils/utils.py:102-124` (uint16->int16, 4D moveaxis(-1, 0),
    3D gets a singleton channel, RAS reorder by default).
    """
    data, affine, _hdr = nifti.load(filename)
    if data.dtype == np.uint16:
        data = data.astype(np.int16)
    if data.ndim > 3:
        data = np.moveaxis(data, -1, 0)
    else:
        data = data[None]
    if dtype is not None:
        data = data.astype(dtype)
    volume = Volume(data=data, affine=affine, meta={"source_filename": filename})
    if reorder:
        return reorder_image(volume, axcodes=axcodes)
    return volume


def load_image(filename: Union[str, Sequence[str]], reorder: bool = True, dtype=None,
               axcodes: str = "RAS") -> Volume:
    """Load one file, or concatenate several single-file images along channels.

    Parity: `unet3d/utils/utils.py:88-99`.
    """
    if isinstance(filename, (list, tuple)):
        volumes = [load_single_image(fn, reorder=reorder, dtype=dtype, axcodes=axcodes)
                   for fn in filename]
        data = np.concatenate([np.asarray(v.data) for v in volumes], axis=0)
        return volumes[0].make_similar(data)
    return load_single_image(filename, reorder=reorder, dtype=dtype, axcodes=axcodes)


def reorder_image(volume: Volume, axcodes: str = "RAS") -> Volume:
    """Reorient a Volume to the given axis codes (`unet3d/utils/utils.py:127-128`)."""
    data, affine = apply_orientation(np.asarray(volume.data), volume.affine, axcodes)
    return Volume(data=data, affine=affine, meta=dict(volume.meta))


def save_volume(volume: Volume, filename: str) -> None:
    volume.to_filename(filename)


def break_down_volume_into_half_size_volumes(data: np.ndarray) -> tuple:
    """Eight interleaved half-resolution volumes (`unet3d/utils/utils.py:135-145`)."""
    return (data[::2, ::2, ::2],
            data[1::2, ::2, ::2],
            data[1::2, 1::2, ::2],
            data[1::2, ::2, 1::2],
            data[1::2, 1::2, 1::2],
            data[::2, 1::2, ::2],
            data[::2, 1::2, 1::2],
            data[::2, ::2, 1::2])


def combine_half_size_volumes(volumes: List[np.ndarray]) -> np.ndarray:
    """Inverse of the half-size decomposition (`unet3d/utils/utils.py:148-156`)."""
    shape = tuple(np.asarray(volumes[0].shape[:3]) * 2) + tuple(volumes[0].shape[3:])
    data = np.zeros(shape, dtype=volumes[0].dtype)
    data[::2, ::2, ::2] = volumes[0]
    data[1::2, ::2, ::2] = volumes[1]
    data[1::2, 1::2, ::2] = volumes[2]
    data[1::2, ::2, 1::2] = volumes[3]
    data[1::2, 1::2, 1::2] = volumes[4]
    data[::2, 1::2, ::2] = volumes[5]
    data[::2, 1::2, 1::2] = volumes[6]
    data[::2, ::2, 1::2] = volumes[7]
    return data

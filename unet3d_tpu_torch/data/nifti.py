"""Self-contained NIfTI-1 codec (read/write .nii and .nii.gz).

The reference delegates NIfTI IO to nibabel (`unet3d/utils/utils.py:88-128`,
`unet3d/utils/image.py:26-33`); this framework owns its file format layer instead.
Implemented directly from the NIfTI-1.1 specification (348-byte header, optional
gzip container): sform/qform affine resolution, datatype table, scl_slope/scl_inter
intensity scaling, and both-endian support.
"""
from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

_HDR_SIZE = 348
_MAGIC_SINGLE = b"n+1\x00"
_MAGIC_PAIR = b"ni1\x00"

# NIfTI-1 datatype codes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiHeader:
    dim: Tuple[int, ...]
    datatype: int
    pixdim: Tuple[float, ...]
    vox_offset: float
    scl_slope: float
    scl_inter: float
    qform_code: int
    sform_code: int
    quatern: Tuple[float, float, float]
    qoffset: Tuple[float, float, float]
    srow: np.ndarray  # (3, 4)
    endian: str = "<"
    descrip: bytes = b""
    xyzt_units: int = 10  # NIFTI_UNITS_MM | NIFTI_UNITS_SEC
    cal_max: float = 0.0
    cal_min: float = 0.0
    extra: dict = field(default_factory=dict)

    @property
    def shape(self) -> Tuple[int, ...]:
        ndim = self.dim[0]
        return tuple(int(d) for d in self.dim[1:1 + ndim])

    @property
    def zooms(self) -> Tuple[float, ...]:
        ndim = self.dim[0]
        return tuple(float(p) for p in self.pixdim[1:1 + ndim])


def _quaternion_to_affine(hdr: NiftiHeader) -> np.ndarray:
    b, c, d = hdr.quatern
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    rot = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    zooms = np.array(hdr.pixdim[1:4], dtype=np.float64)
    qfac = -1.0 if hdr.pixdim[0] < 0 else 1.0
    zooms = zooms * np.array([1.0, 1.0, qfac])
    affine = np.eye(4)
    affine[:3, :3] = rot * zooms
    affine[:3, 3] = hdr.qoffset
    return affine


def header_affine(hdr: NiftiHeader) -> np.ndarray:
    """sform preferred, then qform, then pixdim-scaled identity (nifti1 spec order)."""
    if hdr.sform_code > 0:
        affine = np.eye(4)
        affine[:3, :] = hdr.srow
        return affine
    if hdr.qform_code > 0:
        return _quaternion_to_affine(hdr)
    # both codes 0: nibabel's base affine centers the volume on the world
    # origin (origin = -(shape-1)/2 * zooms), not at voxel (0,0,0)
    zooms = np.asarray(hdr.pixdim[1:4], dtype=np.float64)
    affine = np.diag(list(zooms) + [1.0])
    shape3 = (list(hdr.shape) + [1, 1, 1])[:3]
    affine[:3, 3] = -(np.asarray(shape3, dtype=np.float64) - 1.0) / 2.0 * zooms
    return affine


def _open_maybe_gz(filename: str, mode: str):
    if str(filename).endswith(".gz"):
        return gzip.open(filename, mode)
    return open(filename, mode)


def read_header(raw: bytes) -> NiftiHeader:
    if len(raw) < _HDR_SIZE:
        raise ValueError("Truncated NIfTI header")
    (sizeof_hdr,) = struct.unpack("<i", raw[0:4])
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        (sizeof_hdr,) = struct.unpack(">i", raw[0:4])
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr)")
        endian = ">"
    e = endian
    dim = struct.unpack(e + "8h", raw[40:56])
    datatype, bitpix = struct.unpack(e + "2h", raw[70:74])
    pixdim = struct.unpack(e + "8f", raw[76:108])
    (vox_offset,) = struct.unpack(e + "f", raw[108:112])
    scl_slope, scl_inter = struct.unpack(e + "2f", raw[112:120])
    cal_max, cal_min = struct.unpack(e + "2f", raw[124:132])
    (xyzt_units,) = struct.unpack(e + "b", raw[123:124])
    descrip = raw[148:228].rstrip(b"\x00")
    qform_code, sform_code = struct.unpack(e + "2h", raw[252:256])
    quatern = struct.unpack(e + "3f", raw[256:268])
    qoffset = struct.unpack(e + "3f", raw[268:280])
    srow = np.array(struct.unpack(e + "12f", raw[280:328])).reshape(3, 4)
    magic = raw[344:348]
    if magic not in (_MAGIC_SINGLE, _MAGIC_PAIR):
        raise ValueError(f"Bad NIfTI magic: {magic!r}")
    return NiftiHeader(dim=dim, datatype=datatype, pixdim=pixdim, vox_offset=vox_offset,
                       scl_slope=scl_slope, scl_inter=scl_inter, qform_code=qform_code,
                       sform_code=sform_code, quatern=quatern, qoffset=qoffset, srow=srow,
                       endian=endian, descrip=descrip, xyzt_units=xyzt_units,
                       cal_max=cal_max, cal_min=cal_min)


def load(filename: str, scale: bool = True
         ) -> Tuple[np.ndarray, np.ndarray, Optional[NiftiHeader]]:
    """Read a .nii/.nii.gz file -> (data, affine, header).

    ``scale`` applies scl_slope/scl_inter like nibabel's ``dataobj`` access
    (the reference relies on this at `unet3d/utils/utils.py:105`).
    """
    with _open_maybe_gz(filename, "rb") as f:
        raw = f.read()
    hdr = read_header(raw)
    if hdr.datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {hdr.datatype}")
    dtype = np.dtype(_DTYPES[hdr.datatype]).newbyteorder(hdr.endian)
    shape = hdr.shape
    count = int(np.prod(shape)) if shape else 0
    if raw[344:348] == _MAGIC_PAIR:
        # two-file ("ni1") pair: voxels live in the sibling .img, where
        # vox_offset is relative to that file (commonly 0)
        base = str(filename)
        for ext in (".hdr.gz", ".hdr"):
            if base.endswith(ext):
                base = base[: -len(ext)]
                break
        img_name = None
        for cand in (base + ".img", base + ".img.gz"):
            if os.path.exists(cand):
                img_name = cand
                break
        if img_name is None:
            raise FileNotFoundError(
                f"NIfTI pair {filename}: sibling .img/.img.gz not found")
        with _open_maybe_gz(img_name, "rb") as f:
            raw_img = f.read()
        data = np.frombuffer(raw_img, dtype=dtype, count=count,
                             offset=int(hdr.vox_offset))
    else:
        data = np.frombuffer(raw, dtype=dtype, count=count,
                             offset=int(hdr.vox_offset))
    # NIfTI data is Fortran-ordered over (i, j, k, t, ...)
    data = data.reshape(shape, order="F")
    if data.dtype.byteorder not in ("=", "|") and hdr.endian == ">":
        data = data.astype(data.dtype.newbyteorder("="))
    # NaN/inf slope = "no scaling" (nibabel get_slope_inter). A valid slope
    # with a non-finite intercept is a malformed header nibabel refuses to
    # read; sanitize to 0 instead of multiplying NaN into every voxel.
    inter = hdr.scl_inter if np.isfinite(hdr.scl_inter) else 0.0
    slope_ok = np.isfinite(hdr.scl_slope) and hdr.scl_slope not in (0.0, 1.0)
    inter_ok = (inter != 0.0
                and np.isfinite(hdr.scl_slope) and hdr.scl_slope != 0.0)
    if scale and (slope_ok or inter_ok):
        data = data.astype(np.float32) * hdr.scl_slope + inter
    return np.asarray(data), header_affine(hdr), hdr


def save(filename: str, data: np.ndarray, affine: np.ndarray, descrip: bytes = b"unet3d_tpu") -> None:
    """Write a .nii/.nii.gz with the affine stored as both sform and qform-less sform."""
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    affine = np.asarray(affine, dtype=np.float64)
    ndim = data.ndim
    if ndim > 7:
        raise ValueError("NIfTI supports at most 7 dimensions")
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    zooms = np.sqrt(np.sum(affine[:3, :3] ** 2, axis=0))
    pixdim = [1.0] + list(zooms) + [1.0] * (7 - 3)
    pixdim = pixdim[:8]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    hdr[38] = ord("r")  # regular
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, _DTYPE_CODES[np.dtype(data.dtype)], data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope, scl_inter
    struct.pack_into("<b", hdr, 123, 10)  # xyzt_units: mm | sec
    descrip = descrip[:79]
    hdr[148:148 + len(descrip)] = descrip
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform_code=0, sform_code=1 (aligned)
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr[344:348] = _MAGIC_SINGLE

    payload = bytes(hdr) + b"\x00" * 4 + np.asarray(data, order="F").tobytes(order="F")
    with _open_maybe_gz(filename, "wb") as f:
        f.write(payload)

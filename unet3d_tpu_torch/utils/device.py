"""CUDA device selection, the capability the port's kernels are built for,
the port's f32 precision policy, and host arrays as tensors."""
from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import numpy as np
import torch

# the kernels are compiled for sm_90a (Hopper) only
REQUIRED_CAPABILITY = (9, 0)


def sm_version(device: torch.device) -> Tuple[int, int]:
    """Compute capability (major, minor) of a CUDA device."""
    return torch.cuda.get_device_capability(device)


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when there is none or it is not sm_90."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need an sm_90 GPU")
    device = torch.device("cuda", index)
    cap = sm_version(device)
    if cap != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}; the "
            f"kernels are built for sm_{REQUIRED_CAPABILITY[0]}"
            f"{REQUIRED_CAPABILITY[1]}a")
    return device


def _fp32_flags() -> tuple:
    """torch's per-operation f32 precision settings the policy scopes:
    cuDNN's conv and cuBLAS's matmul."""
    return torch.backends.cudnn.conv, torch.backends.cuda.matmul


@contextlib.contextmanager
def full_f32(*tensors: torch.Tensor) -> Iterator[None]:
    """The port's f32 precision policy: inside the block, cuDNN convolutions
    and cuBLAS matmuls take f32 operands in full f32 (IEEE), TF32 off,
    whatever the process's flags say (torch runs cuDNN's f32 convs in TF32
    by default, about 3 decimal digits). Entered only where one of
    ``tensors`` is an f32 CUDA tensor: bf16 and CPU calls pay nothing. Set
    and restored through torch's per-operation ``fp32_precision`` settings
    alone (one API: inside the block torch's legacy ``cudnn.allow_tf32``
    getter raises, its check against a mix of the two, so nothing in the
    block may read it)."""
    if not any(t.is_cuda and t.dtype == torch.float32 for t in tensors):
        yield
        return
    flags = _fp32_flags()
    saved = [f.fp32_precision for f in flags]
    try:
        for f in flags:
            f.fp32_precision = "ieee"
        yield
    finally:
        for f, value in zip(flags, saved):
            f.fp32_precision = value


def as_tensor(data) -> torch.Tensor:
    """A tensor as it is; a numpy array (or list) as a CPU tensor sharing its
    memory, or a copy when the array is read-only (memory-mapped caches,
    decoded NIfTI buffers), which torch cannot share."""
    if isinstance(data, torch.Tensor):
        return data
    arr = np.asarray(data)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())

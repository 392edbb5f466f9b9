"""CUDA device selection, the capability the port's kernels are built for,
and host arrays as tensors."""
from __future__ import annotations

from typing import Tuple

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


def as_tensor(data) -> torch.Tensor:
    """A tensor as it is; a numpy array (or list) as a CPU tensor sharing its
    memory, or a copy when the array is read-only (memory-mapped caches,
    decoded NIfTI buffers), which torch cannot share."""
    if isinstance(data, torch.Tensor):
        return data
    arr = np.asarray(data)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())

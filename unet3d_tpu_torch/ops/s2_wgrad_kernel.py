"""Weight gradient of the 3x3x3 stride-2 conv (pads of 1) and its plain version.

``s2_wgrad(x, g)`` takes x (N, D, H, W, Cin) and the output cotangent
g (N, Do, Ho, Wo, Cout), Do = ceil(D / 2), and returns dw (3, 3, 3, Cin, Cout)
in f32. A CUDA tensor goes to the kernel of ``ops/kernels/s2_wgrad.cu``; a CPU
tensor to ``s2_wgrad_reference``, the f32 autograd of ``F.conv3d``; any other
device raises. ``LAUNCHES["s2_wgrad"]`` counts kernel launches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

LAUNCHES: Dict[str, int] = {"s2_wgrad": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BK = 32            # voxels per stage of the kernel (s2_wgrad.cu)
_BM, _BN = 128, 64  # its dw tile
_MIN_STAGES = 4     # least K a split takes, in stages
_BLOCKS_PER_SM = 4  # blocks to aim for per SM when splitting K


def reset_launches() -> None:
    LAUNCHES["s2_wgrad"] = 0


def s2_wgrad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """f32 dw of ``conv3d(x, w, stride 2, pads 1)`` for cotangent ``g``."""
    cin, cout = x.shape[-1], g.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        x.float().permute(0, 4, 1, 2, 3), (cout, cin, 3, 3, 3),
        g.float().permute(0, 4, 1, 2, 3), stride=2, padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def _check(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 5 or g.dim() != 5:
        raise ValueError(f"expected x (N,D,H,W,C) and g (N,Do,Ho,Wo,Cout), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    want = (x.shape[0],) + tuple((s + 1) // 2 for s in x.shape[1:4])
    if tuple(g.shape[:4]) != want:
        raise ValueError(f"g must be {want + (g.shape[-1],)} for x "
                         f"{tuple(x.shape)}, got {tuple(g.shape)}")
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise TypeError(f"x and g must share a dtype in {list(_DTYPES)}, got "
                        f"{x.dtype} and {g.dtype}")
    if x.numel() == 0 or g.numel() == 0:
        raise ValueError("empty input")
    if g.device != x.device:
        raise ValueError("x and g must be on one device")
    if x.device.type == "cuda" and not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("the CUDA kernel needs contiguous operands")


def split_k(m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """(splits, voxels per split) for a dw of m x n over k voxels: enough
    blocks to fill ``sms`` SMs, each split at least _MIN_STAGES stages."""
    tiles = -(-m // _BM) * -(-n // _BN)
    stages = -(-k // _BK)
    want = -(-_BLOCKS_PER_SM * sms // tiles)
    splits = max(1, min(want, stages // _MIN_STAGES))
    per_split = -(-stages // splits) * _BK
    return -(-k // per_split), per_split


def _launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    from unet3d_tpu_torch.kernels.build import load_library

    lib = load_library()
    n, d, h, w, cin = x.shape
    _, do, ho, wo, cout = g.shape
    m = 27 * cin
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, per_split = split_k(m, cout, n * do * ho * wo, sms)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    part = None
    if splits > 1:
        part = torch.empty((splits, m, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.unet3d_s2_wgrad_ndhwc(
            _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(),
            part.data_ptr() if part is not None else None, dw.data_ptr(),
            n, d, h, w, cin, do, ho, wo, cout, splits, per_split, stream)
    if err != 0:
        raise RuntimeError(f"s2_wgrad launch failed: "
                           f"{lib.unet3d_cuda_error_string(err).decode()}")
    LAUNCHES["s2_wgrad"] += 1
    return dw


def s2_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    _check(x, g)
    if x.device.type == "cpu":
        return s2_wgrad_reference(x, g)
    return _launch(x, g)

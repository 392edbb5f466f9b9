"""The 3x3x3 stride-1 SAME conv kernels (NDHWC / DHWIO) and their plain versions.

Three variants of one CUDA source (``ops/kernels/conv3d.cu``):

* ``conv3x3x3``                   y = conv(x, w)
* ``conv3x3x3_with_stats``        y plus per-(n, c) f32 sum / sum of squares of
                                  y as rounded to its dtype
* ``conv3x3x3_block_with_stats``  conv(lrelu(x * inv + shift), w) plus the same
                                  statistics; ``inv`` / ``shift`` are (N, Cin)

Each takes a CUDA tensor to its kernel, and a CPU tensor to its plain version
(``*_reference``); any other device raises. The plain versions compute in f32
and round once, as the kernels do, and take the statistics of the rounded y.
``LAUNCHES`` counts kernel launches per variant.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

LAUNCHES: Dict[str, int] = {"conv": 0, "conv_stats": 0, "block_stats": 0}

_VARIANTS = {"conv": 0, "conv_stats": 1, "block_stats": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def instance_stats(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (sum, sum of squares) of NDHWC ``y`` per (item, channel)."""
    yf = y.float()
    return yf.sum(dim=(1, 2, 3)), (yf * yf).sum(dim=(1, 2, 3))


def affine_lrelu(x, inv, shift, alpha):
    """lrelu(x * inv + shift) in f32 with (N, C) ``inv`` / ``shift``, rounded
    to x's dtype. Differentiable, with the JAX derivative 1 at 0."""
    z = x.float() * inv[:, None, None, None, :] + shift[:, None, None, None, :]
    return torch.where(z >= 0, z, z * alpha).to(x.dtype)


def conv3d_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3),
                 w.float().permute(4, 3, 0, 1, 2), padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def conv3d_with_stats_reference(x, w):
    y = conv3d_reference(x, w)
    return (y, *instance_stats(y))


def conv3d_block_with_stats_reference(x, w, inv, shift, alpha=0.01):
    return conv3d_with_stats_reference(affine_lrelu(x, inv, shift, alpha), w)


def _check(x: torch.Tensor, w: torch.Tensor, inv=None, shift=None) -> None:
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"expected x (N,D,H,W,C) and w (3,3,3,C,Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[3] != x.shape[4]:
        raise ValueError(f"w has {w.shape[3]} input channels, x has {x.shape[4]}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share a dtype in {list(_DTYPES)}, got "
                        f"{x.dtype} and {w.dtype}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError("empty input")
    tensors = [x, w]
    if inv is not None:
        for t in (inv, shift):
            if t.dtype != torch.float32 or tuple(t.shape) != (x.shape[0], x.shape[4]):
                raise ValueError(f"inv/shift must be f32 (N, C) = "
                                 f"{(x.shape[0], x.shape[4])}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        tensors += [inv, shift]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on one device")
    if x.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel needs contiguous operands")


def _launch(variant: str, x: torch.Tensor, w: torch.Tensor,
            inv: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None, alpha: float = 0.01):
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    from unet3d_tpu_torch.kernels.build import load_library

    lib = load_library()
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    stats = None
    if variant != "conv":
        stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.unet3d_conv3x3x3_ndhwc(
            _DTYPES[x.dtype], _VARIANTS[variant], x.data_ptr(), w.data_ptr(),
            y.data_ptr(), inv.data_ptr() if inv is not None else None,
            shift.data_ptr() if shift is not None else None,
            stats.data_ptr() if stats is not None else None,
            n, d, h, wd, cin, cout, float(alpha), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3x3 {variant} launch failed: "
                           f"{lib.unet3d_cuda_error_string(err).decode()}")
    LAUNCHES[variant] += 1
    return y, stats


def conv3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    if x.device.type == "cpu":
        return conv3d_reference(x, w)
    return _launch("conv", x, w)[0]


def conv3x3x3_with_stats(x: torch.Tensor, w: torch.Tensor):
    _check(x, w)
    if x.device.type == "cpu":
        return conv3d_with_stats_reference(x, w)
    y, stats = _launch("conv_stats", x, w)
    return y, stats[:, 0], stats[:, 1]


def conv3x3x3_block_with_stats(x: torch.Tensor, w: torch.Tensor,
                               inv: torch.Tensor, shift: torch.Tensor,
                               alpha: float = 0.01):
    _check(x, w, inv, shift)
    if x.device.type == "cpu":
        return conv3d_block_with_stats_reference(x, w, inv, shift, alpha)
    y, stats = _launch("block_stats", x, w, inv, shift, alpha)
    return y, stats[:, 0], stats[:, 1]

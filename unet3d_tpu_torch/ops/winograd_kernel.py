"""The Winograd-DH 3x3x3 stride-1 SAME conv kernel (NDHWC / DHWIO) and its plain
versions.

Winograd F(2,3) x F(2,3) on the D and H axes with a direct 3-tap W axis: each
2x2 (D, H) output tile of every column comes from 48 channel products
(4 x 4 transform points x 3 W taps) in place of the direct conv's 4 x 27.
Two variants of one CUDA source (``ops/kernels/winograd.cu``):

* ``winograd3x3x3``             y = conv(x, w)
* ``winograd3x3x3_with_stats``  y plus per-(n, c) f32 sum / sum of squares of
                                y as rounded to its dtype

Each takes a CUDA tensor to its kernel and a CPU tensor to its plain version
(``*_reference``); any other device raises. The plain versions round where
the JAX Pallas kernel rounds: the D and then the H input transform in the
working dtype, the transformed weight ``transform_weights_dh`` in the working
dtype, the 48 channel products and the inverse transform in f32, one rounding
at the store. ``LAUNCHES`` counts kernel launches per variant.

The gate (``winograd_applies``) is the JAX package's: the shape part of
``winograd_available`` (stride 1, SAME, 3^3, D and H even) and
``winograd_profitable`` (at least ``_MIN_WINOGRAD_CHANNELS`` input channels
and ``_MIN_WINOGRAD_VOXELS`` voxels), read at call time so tests can lower
the thresholds.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unet3d_tpu_torch.ops.conv3d_kernel import _DTYPES, _check, instance_stats

LAUNCHES: Dict[str, int] = {"winograd": 0, "winograd_stats": 0}

_MIN_WINOGRAD_CHANNELS = 96
_MIN_WINOGRAD_VOXELS = 64 ** 3

_G = np.array([[1, 0, 0],
               [0.5, 0.5, 0.5],
               [0.5, -0.5, 0.5],
               [0, 0, 1]], np.float32)
# B^T of F(2,3): transform point j of rows r0..r3 is r[a] + s * r[b]
_BT = ((0, 2, -1), (1, 2, 1), (2, 1, -1), (1, 3, -1))
# A^T: output row o takes transform point j with this sign
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))
# the kernel's channel chunk and output-channel tile: the wrapper zero-pads
# the transformed weight to these multiples
_CIN_PAD, _COUT_PAD = 16, 64


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def winograd_profitable(x_shape) -> bool:
    """The JAX package's profitability gate on the conv's input shape."""
    n, d, h, w, c = x_shape
    return c >= _MIN_WINOGRAD_CHANNELS and d * h * w >= _MIN_WINOGRAD_VOXELS


def winograd_shape_ok(x_shape, w_shape, stride, pads) -> bool:
    """The shape part of the JAX ``winograd_available``: a 3^3 stride-1 conv
    with pads of 1 on an input whose D and H are even."""
    return (tuple(w_shape[:3]) == (3, 3, 3) and tuple(stride) == (1, 1, 1)
            and tuple(pads) == ((1, 1),) * 3 and len(x_shape) == 5
            and x_shape[1] % 2 == 0 and x_shape[2] % 2 == 0)


def winograd_applies(x_shape, w_shape, stride, pads) -> bool:
    return (winograd_shape_ok(x_shape, w_shape, stride, pads)
            and winograd_profitable(x_shape))


def transform_weights_dh(w: torch.Tensor, dtype) -> torch.Tensor:
    """(3,3,3,C,Co) -> (48, C, Co): G x G over (dz, dy) in f32, direct over dx,
    rounded to ``dtype``. Row (jd * 4 + jh) * 3 + dx."""
    g = torch.from_numpy(_G).to(w.device)
    u = torch.einsum("az,by,zyxio->abxio", g, g, w.float())
    return u.reshape(48, w.shape[3], w.shape[4]).to(dtype)


def _transform(rows, j):
    a, b, s = _BT[j]
    return rows[a] + rows[b] if s > 0 else rows[a] - rows[b]


def winograd_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain Winograd-DH conv with the JAX kernel's rounding points."""
    n, d, h, wd, c = x.shape
    u2 = transform_weights_dh(w, x.dtype).float()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    rows_d = [xp[:, k:k + d:2] for k in range(4)]       # D rows 2t + k, padded
    out = [[0.0, 0.0], [0.0, 0.0]]
    for jd in range(4):
        vd = _transform(rows_d, jd)                       # working dtype
        rows_h = [vd[:, :, k:k + h:2] for k in range(4)]  # H rows 2s + k
        for jh in range(4):
            v = _transform(rows_h, jh).float()            # (N, D/2, H/2, W+2, C)
            m = sum(torch.matmul(v[:, :, :, dx:dx + wd], u2[(jd * 4 + jh) * 3 + dx])
                    for dx in range(3))
            for od in range(2):
                for oh in range(2):
                    sign = _AT[od][jd] * _AT[oh][jh]
                    if sign:
                        out[od][oh] = out[od][oh] + sign * m
    y = torch.stack([torch.stack(out[od], dim=3) for od in range(2)], dim=2)
    return y.reshape(n, d, h, wd, -1).to(x.dtype)


def winograd_with_stats_reference(x, w):
    y = winograd_reference(x, w)
    return (y, *instance_stats(y))


def _check_winograd(x: torch.Tensor, w: torch.Tensor) -> None:
    _check(x, w)
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"Winograd-DH needs even D and H, got x {tuple(x.shape)}")


def _launch(variant: str, x: torch.Tensor, w: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    from unet3d_tpu_torch.kernels.build import load_library

    lib = load_library()
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    cp = -(-cin // _CIN_PAD) * _CIN_PAD
    cop = -(-cout // _COUT_PAD) * _COUT_PAD
    u2 = F.pad(transform_weights_dh(w, x.dtype), (0, cop - cout, 0, cp - cin))
    u2 = u2.contiguous()
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    stats = None
    if variant == "winograd_stats":
        stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.unet3d_winograd3x3x3_ndhwc(
            _DTYPES[x.dtype], int(stats is not None), x.data_ptr(), u2.data_ptr(),
            y.data_ptr(), stats.data_ptr() if stats is not None else None,
            n, d, h, wd, cin, cout, cp, cop, stream)
    if err != 0:
        raise RuntimeError(f"winograd3x3x3 {variant} launch failed: "
                           f"{lib.unet3d_cuda_error_string(err).decode()}")
    LAUNCHES[variant] += 1
    return y, stats


def winograd3x3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check_winograd(x, w)
    if x.device.type == "cpu":
        return winograd_reference(x, w)
    return _launch("winograd", x, w)[0]


def winograd3x3x3_with_stats(x: torch.Tensor, w: torch.Tensor):
    _check_winograd(x, w)
    if x.device.type == "cpu":
        return winograd_with_stats_reference(x, w)
    y, stats = _launch("winograd_stats", x, w)
    return y, stats[:, 0], stats[:, 1]

"""The Winograd-DH 3x3x3 stride-1 SAME conv kernel (NDHWC / DHWIO) and its plain
versions.

Winograd F(2,3) x F(2,3) on the D and H axes with a direct 3-tap W axis: each
2x2 (D, H) output tile of every column comes from 48 channel products
(4 x 4 transform points x 3 W taps) in place of the direct conv's 4 x 27.
Two variants:

* ``winograd3x3x3``             y = conv(x, w)
* ``winograd3x3x3_with_stats``  y plus per-(n, c) f32 sum / sum of squares of
                                y as rounded to its dtype

each in three CUDA forms (``kernel_form``): ``wgmma``
(``ops/kernels/winograd_wgmma.cu``), the Hopper form, for bf16 with Cin and
Cout multiples of 8 (every Winograd site of the DynUNet), tiled by
``wgmma_plan`` with U2 packed per call by ``pack_u2``; ``wmma``
(``ops/kernels/winograd.cu``) for the other bf16 calls; ``tf32x3``
(``ops/kernels/winograd_tf32x3.cu``) for every f32 call, the wgmma form's
pipeline in 3xTF32 (three TF32 products per product, f32-accurate), tiled by
``tf32_plan`` with U2's TF32 hi and lo parts packed by ``pack_u2_tf32``.

Each takes a CUDA tensor to its kernel and a CPU tensor to its plain version
(``*_reference``); any other device raises. The plain versions round where
the JAX Pallas kernel rounds: the D and then the H input transform in the
working dtype, the transformed weight ``transform_weights_dh`` in the working
dtype, the 48 channel products and the inverse transform in f32, one rounding
at the store. ``LAUNCHES`` counts kernel launches per variant,
``FORM_LAUNCHES`` per (variant, form).

The gate (``winograd_applies``) is the JAX package's: the shape part of
``winograd_available`` (stride 1, SAME, 3^3, D and H even) and
``winograd_profitable`` (at least ``_MIN_WINOGRAD_CHANNELS`` input channels
and ``_MIN_WINOGRAD_VOXELS`` voxels), read at call time so tests can lower
the thresholds.
"""
from __future__ import annotations

import collections
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unet3d_tpu_torch.ops.conv3d_kernel import _check, instance_stats, tf32_split
from unet3d_tpu_torch.utils.device import full_f32

LAUNCHES: Dict[str, int] = {"winograd": 0, "winograd_stats": 0}
FORM_LAUNCHES: Dict[Tuple[str, str], int] = collections.Counter()

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
# the wmma form's channel chunk and output-channel tile: the wrapper
# zero-pads the transformed weight to these multiples
_CIN_PAD, _COUT_PAD = 16, 64

# the wgmma form's tile configurations, in the order of the C table
# (winograd_wgmma.cu CONFIGS, checked when the library loads): H tiles of 2
# output rows and columns per block (BHT, BW: 128 positions, 64 per
# warpgroup), output channels per block (BN), input channels per chunk (CK),
# 128-byte B slabs in the ring
WGMMA_CONFIGS = ((4, 32, 64, 32, 7), (4, 32, 48, 32, 8))
POINTS = 16           # (jd, jh) transform points
SLAB_K = 64           # K values (bf16) per 128-byte B slab
# the tf32x3 form's (winograd_tf32x3.cu CONFIGS, checked the same way): BHT,
# BW, BN, CK (16 f32 channels: the bf16 form's 64-byte window rows), slab
# pairs (a hi and a lo slab of 32 K values) in the ring, and the points
# whose slabs load ahead; BN <= 48 leaves registers for the split A
TF32_CONFIGS = ((4, 32, 48, 16, 4, 1), (4, 32, 32, 16, 7, 3))
TF32_SLAB_K = 32      # K values (f32) per 128-byte B slab row


class WgmmaPlan(NamedTuple):
    config: int    # index of WGMMA_CONFIGS
    bht: int       # H tiles (2 output rows each) per block
    bw: int        # output columns per block
    bn: int        # output channels per block
    ck: int        # input channels per chunk
    stages: int    # B slabs in the ring
    h_tiles: int   # blocks along H / 2
    w_tiles: int   # blocks along W
    n_tiles: int   # blocks along Cout
    chunks: int    # chunks along Cin


def _plan(x_shape, cout: int, configs) -> WgmmaPlan:
    """N tiles of at most the widest configured BN, equal in width, each
    rounded up to a configured BN; a block owns BHT H tiles x BW columns of
    one depth tile."""
    n, d, h, w, cin = x_shape
    n_tiles = -(-cout // max(c[2] for c in configs))
    bn = min(c[2] for c in configs if c[2] >= -(-cout // n_tiles))
    config = next(i for i, c in enumerate(configs) if c[2] == bn)
    bht, bw, _, ck, stages = configs[config][:5]
    return WgmmaPlan(config, bht, bw, bn, ck, stages, -(-(h // 2) // bht), -(-w // bw),
                     -(-cout // bn), -(-cin // ck))


def wgmma_plan(x_shape, cout: int) -> WgmmaPlan:
    """The wgmma form's tiling of x (N, D, H, W, Cin) -> Cout: N tiles of at
    most 64 channels (a warpgroup holds 5 BN / 2 f32 accumulators a thread:
    one point's product and the four output tiles), equal in width, each
    rounded up to a configured BN (Cout 64: one of 64, 96: two of 48, 192:
    three of 64); a block owns BHT H tiles x BW columns of one depth tile."""
    return _plan(x_shape, cout, WGMMA_CONFIGS)


def tf32_plan(x_shape, cout: int) -> WgmmaPlan:
    """The tf32x3 form's tiling: ``wgmma_plan``'s rule over TF32_CONFIGS,
    N tiles of at most 48 channels (Cout 64: two of 32, 96: two of 48, 192:
    four of 48), 16-channel chunks."""
    return _plan(x_shape, cout, TF32_CONFIGS)


def pack_u2(w: torch.Tensor, plan: WgmmaPlan) -> torch.Tensor:
    """DHWIO ``w`` as the wgmma form's B slabs: ``transform_weights_dh`` in
    w's dtype, zero-padded to whole chunks and N tiles, as (n_tiles, chunks, 24,
    BN, 64); slab s of a chunk holds, for each output channel, the K values
    (point p, tap dx, channel k) with (p * 3 + dx) // 2 == s, in that order,
    32 channels of one (p, dx) after another."""
    cin, cout = w.shape[3], w.shape[4]
    cp, cop = plan.chunks * plan.ck, plan.n_tiles * plan.bn
    u = transform_weights_dh(w, w.dtype)
    if cp != cin or cop != cout:
        u = F.pad(u, (0, cop - cout, 0, cp - cin))
    pairs = 3 * POINTS * plan.ck // SLAB_K
    u = u.reshape(pairs, SLAB_K // plan.ck, plan.chunks, plan.ck, plan.n_tiles, plan.bn)
    return (u.permute(4, 2, 0, 5, 1, 3).contiguous()
            .view(plan.n_tiles, plan.chunks, pairs, plan.bn, SLAB_K))


def pack_u2_tf32(w: torch.Tensor, plan: WgmmaPlan) -> torch.Tensor:
    """f32 DHWIO ``w`` as the tf32x3 form's B slabs: ``transform_weights_dh``
    in f32, zero-padded to whole chunks and N tiles, split into its TF32 hi
    and lo parts (``tf32_split``), as (n_tiles, chunks, 24, 2, BN, 32): slab
    s of a chunk holds, for each output channel, the hi (then the lo) parts
    of K values 32 s .. 32 s + 31 of the chunk's K order (point p, tap dx,
    channel k), K-major."""
    cin, cout = w.shape[3], w.shape[4]
    cp, cop = plan.chunks * plan.ck, plan.n_tiles * plan.bn
    u = transform_weights_dh(w, torch.float32)
    if cp != cin or cop != cout:
        u = F.pad(u, (0, cop - cout, 0, cp - cin))
    parts = torch.stack(tf32_split(u))                   # (2, 48, cp, cop)
    parts = parts.view(2, POINTS * 3, plan.chunks, plan.ck, plan.n_tiles, plan.bn)
    slabs = 3 * POINTS * plan.ck // TF32_SLAB_K
    parts = parts.permute(4, 2, 1, 3, 0, 5).reshape(   # (nt, c, K, part, n)
        plan.n_tiles, plan.chunks, slabs, TF32_SLAB_K, 2, plan.bn)
    return parts.permute(0, 1, 2, 4, 5, 3).contiguous()


def kernel_form(x: torch.Tensor, w: torch.Tensor) -> str:
    """The CUDA form a call takes: ``wgmma``, ``wmma`` or ``tf32x3``."""
    if x.dtype == torch.float32:
        return "tf32x3"
    aligned = x.data_ptr() % 16 == 0
    return "wgmma" if x.shape[4] % 8 == 0 and w.shape[4] % 8 == 0 and aligned else "wmma"


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    FORM_LAUNCHES.clear()


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


_G_ON: Dict[torch.device, torch.Tensor] = {}


def _g_on(device: torch.device) -> torch.Tensor:
    """G on ``device``, copied once: a copy from pageable host memory per call
    would wait for the stream's queued work."""
    g = _G_ON.get(device)
    if g is None:
        g = _G_ON[device] = torch.from_numpy(_G).to(device)
    return g


def transform_weights_dh(w: torch.Tensor, dtype) -> torch.Tensor:
    """(3,3,3,C,Co) -> (48, C, Co): G x G over (dz, dy) in f32, direct over dx,
    rounded to ``dtype``. Row (jd * 4 + jh) * 3 + dx. Full f32 on the card."""
    g = _g_on(w.device)
    with full_f32(g):
        u = torch.einsum("az,by,zyxio->abxio", g, g, w.float())
    return u.reshape(48, w.shape[3], w.shape[4]).to(dtype)


def _transform(rows, j):
    a, b, s = _BT[j]
    return rows[a] + rows[b] if s > 0 else rows[a] - rows[b]


def winograd_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain Winograd-DH conv with the JAX kernel's rounding points (its
    f32 products in full f32 on the card)."""
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
            with full_f32(v):
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
    form = kernel_form(x, w)
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    stats = None
    if variant == "winograd_stats":
        stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    stats_ptr = stats.data_ptr() if stats is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if form == "wgmma":
            plan = wgmma_plan(tuple(x.shape), cout)
            u2 = pack_u2(w, plan)
            err = lib.unet3d_winograd_wgmma(
                int(stats is not None), plan.config, x.data_ptr(), u2.data_ptr(),
                y.data_ptr(), stats_ptr, n, d, h, wd, cin, cout, plan.h_tiles,
                plan.w_tiles, plan.n_tiles, plan.chunks, stream)
        elif form == "tf32x3":
            plan = tf32_plan(tuple(x.shape), cout)
            u2 = pack_u2_tf32(w, plan)
            err = lib.unet3d_winograd_tf32x3(
                int(stats is not None), plan.config, x.data_ptr(), u2.data_ptr(),
                y.data_ptr(), stats_ptr, n, d, h, wd, cin, cout, plan.h_tiles,
                plan.w_tiles, plan.n_tiles, plan.chunks, stream)
        else:
            cp = -(-cin // _CIN_PAD) * _CIN_PAD
            cop = -(-cout // _COUT_PAD) * _COUT_PAD
            u2 = F.pad(transform_weights_dh(w, x.dtype), (0, cop - cout, 0, cp - cin))
            u2 = u2.contiguous()
            err = lib.unet3d_winograd3x3x3_ndhwc(
                int(stats is not None), x.data_ptr(), u2.data_ptr(), y.data_ptr(),
                stats_ptr, n, d, h, wd, cin, cout, cp, cop, stream)
    if err != 0:
        raise RuntimeError(f"winograd3x3x3 {variant} ({form}) launch failed: "
                           f"{lib.unet3d_cuda_error_string(err).decode()}")
    LAUNCHES[variant] += 1
    FORM_LAUNCHES[variant, form] += 1
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

"""Weight gradient of the 3x3x3 stride-2 conv (pads of 1) and its plain version.

``s2_wgrad(x, g)`` takes x (N, D, H, W, Cin) and the output cotangent
g (N, Do, Ho, Wo, Cout), Do = ceil(D / 2), and returns dw (3, 3, 3, Cin, Cout)
in f32. A CPU tensor goes to ``s2_wgrad_reference``, the f32 autograd of
``F.conv3d``; any device other than CUDA raises. A CUDA tensor goes to one of
three forms (``kernel_form``): ``wgmma`` (``ops/kernels/s2_wgrad_wgmma.cu``),
the Hopper form, for bf16 with Cin and Cout multiples of 8 (every stride-2
site of the DynUNet), tiled by ``wgmma_plan``; ``narrow`` (``s2_wgrad.cu``)
for the other bf16 calls (Cin or Cout % 8 != 0, or an operand off 16-byte
alignment), tiled by ``narrow_plan``; ``tf32x3``
(``s2_wgrad_tf32x3.cu``) for every f32 call, the same staging on the tensor
cores in 3xTF32 (wgmma m64nNk8 tf32, three products per product), tiled by
``tf32_plan``. ``LAUNCHES["s2_wgrad"]`` counts every launch,
``FORM_LAUNCHES`` per ("s2_wgrad", form).

``pad_lo`` is the zero planes below x on D: 1 for the SAME conv, 0 in the
D-halo mode of the space axis (``parallel/``), where x is a slab of an even
number of D planes that starts at an even plane of the volume, with the
plane below it prepended (``parallel/halo.exchange_halo``); output plane j
then reads x planes 2j ... 2j + 2 and no high pad is in reach. Do =
(D + pad_lo) // 2. ``HALO_LAUNCHES`` counts the launches with ``pad_lo`` 0.
"""
from __future__ import annotations

import collections
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from unet3d_tpu_torch.utils.device import full_f32

LAUNCHES: Dict[str, int] = {"s2_wgrad": 0}
FORM_LAUNCHES: Dict[Tuple[str, str], int] = collections.Counter()
HALO_LAUNCHES: Dict[Tuple[str, Tuple[int, int]], int] = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the wgmma form (s2_wgrad_wgmma.cu): (BN output channels per block, ring
# stages) of each instantiation; a block owns the three kw taps of one
# (kd, kh) pair for one 64-channel chunk of Cin and walks segments of 64
# output voxels, one block per SM
WGMMA_CONFIGS = ((64, 6), (96, 6), (128, 6), (192, 5))
CHUNK = 64           # input channels per block
SEGMENT = 64         # output voxels per segment
_MIN_SW = 4          # least output voxels per line in a segment
_MAX_BN = 192        # widest N tile; wider Cout splits into equal tiles
_MIN_SEGMENTS = 2    # least segments a split takes
# the tf32x3 form (s2_wgrad_tf32x3.cu): (BN, ring stages) of each
# instantiation (a warpgroup per kw tap, 64 input channels by BN outputs;
# two accumulators of BN / 2 registers each bound BN), the input channels
# per block, its widest N tile
TF32_CONFIGS = ((32, 2), (64, 2), (96, 2))
TF32_CHUNK = 64
_TF32_MAX_BN = 96
# a block that walks a single segment keeps no f32 total beside its
# accumulator, which frees the registers for 128 output channels
TF32_ONE_SEGMENT_CONFIG = (128, 2)
# the narrow form (s2_wgrad.cu): a block owns 8 input channels (27 taps x 8:
# 14 m16 tiles), 1-4 n8 tiles of output channels and a range of segments of
# NARROW_K voxels or more: `lines` output lines of `sw` voxels (sw a multiple
# of 16, at most 128)
NARROW_CHUNK = 8
NARROW_MAX_NT = 4
NARROW_K = 64
NARROW_MAX_SW = 128
_NARROW_BLOCKS_PER_SM = 3   # blocks to aim for per SM when splitting K


class WgmmaPlan(NamedTuple):
    bn: int          # output channels per block
    stages: int      # cp.async ring stages
    n_tiles: int     # blocks along Cout
    chunks: int      # 64-channel chunks along Cin
    sw: int          # output voxels per line in a segment (a power of two)
    lines: int       # output lines per segment (SEGMENT // sw)
    segments: int    # segments over all output voxels
    splits: int      # contiguous ranges of segments, one per blockIdx.y
    per_split: int   # segments per split (the last may take fewer)


class NarrowPlan(NamedTuple):
    nt: int          # n8 tiles of output channels per block
    n_tiles: int     # blocks along Cout (8 nt channels each)
    chunks: int      # 8-channel chunks along Cin
    sw: int          # output voxels per line in a segment (a multiple of 16)
    lines: int       # output lines per segment
    ow_blocks: int   # segments along a line
    segments: int    # segments over all output voxels
    splits: int      # contiguous ranges of segments, one per blockIdx.y
    per_split: int   # segments per split (the last may take fewer)


def reset_launches() -> None:
    LAUNCHES["s2_wgrad"] = 0
    FORM_LAUNCHES.clear()
    HALO_LAUNCHES.clear()


def s2_wgrad_reference(x: torch.Tensor, g: torch.Tensor, pad_lo: int = 1) -> torch.Tensor:
    """f32 dw of ``conv3d(x, w, stride 2, pads 1)`` for cotangent ``g``, in
    full f32 on the card; with ``pad_lo`` 0, x padded on D by (0, 1) and the
    conv VALID on D."""
    cin, cout = x.shape[-1], g.shape[-1]
    xf, padding = x.float().permute(0, 4, 1, 2, 3), 1
    if pad_lo != 1:
        xf, padding = torch.nn.functional.pad(xf, (0, 0, 0, 0, pad_lo, 1)), (0, 1, 1)
    with full_f32(xf):
        dw = torch.nn.grad.conv3d_weight(
            xf, (cout, cin, 3, 3, 3), g.float().permute(0, 4, 1, 2, 3), stride=2,
            padding=padding)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def _check(x: torch.Tensor, g: torch.Tensor, pad_lo: int = 1) -> None:
    if x.dim() != 5 or g.dim() != 5:
        raise ValueError(f"expected x (N,D,H,W,C) and g (N,Do,Ho,Wo,Cout), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if pad_lo not in (0, 1):
        raise ValueError(f"pad_lo must be 0 or 1, got {pad_lo}")
    want = ((x.shape[0], (x.shape[1] + pad_lo) // 2)
            + tuple((s + 1) // 2 for s in x.shape[2:4]))
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


@functools.lru_cache(maxsize=256)
def narrow_plan(x_shape: Tuple[int, ...], cout: int, sms: int, pad_lo: int = 1) -> NarrowPlan:
    """The narrow form's tiling for x (N, D, H, W, Cin) and Cout output
    channels on a card of ``sms`` SMs. N tiles: equal tiles of at most 32
    channels, each rounded up to whole n8 tiles. Segments: ``lines`` output
    lines of ``sw`` voxels, sw = Wo rounded up to 16 (at most 128, longer
    lines in blocks of 128), lines = NARROW_K // sw (at least 1). Splits:
    contiguous ranges of segments, enough that chunks x N tiles x splits
    make _NARROW_BLOCKS_PER_SM blocks a SM, each at least two segments.
    ``pad_lo`` as ``s2_wgrad``'s."""
    n, d, h, w, cin = x_shape
    do, ho, wo = (d + pad_lo) // 2, (h + 1) // 2, (w + 1) // 2
    n_tiles = -(-cout // (8 * NARROW_MAX_NT))
    share = -(-cout // n_tiles)
    nt = -(-share // 8)
    chunks = -(-cin // NARROW_CHUNK)
    sw = min(NARROW_MAX_SW, -(-wo // 16) * 16)
    lines = max(1, NARROW_K // sw)
    ow_blocks = -(-wo // sw)
    segments = -(-(n * do * ho) // lines) * ow_blocks
    splits = max(1, min(_NARROW_BLOCKS_PER_SM * sms // (chunks * n_tiles), segments // 2))
    per_split = -(-segments // splits)
    return NarrowPlan(nt, n_tiles, chunks, sw, lines, ow_blocks, segments,
                      -(-segments // per_split), per_split)


def _segment_plan(x_shape, cout, sms, pad_lo, configs, chunk, max_bn) -> WgmmaPlan:
    """Segments of 64 output voxels, N tiles and splits over ``configs``'
    (BN, stages) for blocks of three kw taps x ``chunk`` input channels:
    ``wgmma_plan``'s rule, for the wgmma and the tf32x3 form."""
    n, d, h, w, cin = x_shape
    do, ho, wo = (d + pad_lo) // 2, (h + 1) // 2, (w + 1) // 2
    chunks = -(-cin // chunk)
    sw = min(SEGMENT, max(_MIN_SW, 1 << max(0, wo - 1).bit_length()))
    lines = SEGMENT // sw
    segments = -(-(n * do * ho) // lines) * -(-wo // sw)
    best = None
    for n_tiles in range(-(-cout // max_bn), -(-cout // configs[0][0]) + 1):
        bn, stages = next(c for c in configs if c[0] >= -(-cout // n_tiles))
        if (n_tiles - 1) * bn >= cout:  # an empty tile
            continue
        tiles = 9 * chunks * n_tiles
        splits = max(1, min(sms // tiles, segments // _MIN_SEGMENTS))
        filled = tiles * splits if tiles * splits <= sms else 0
        if best is None or filled > best[0]:
            best = (filled, bn, stages, n_tiles, splits)
    _, bn, stages, n_tiles, splits = best
    per_split = -(-segments // splits)
    return WgmmaPlan(bn, stages, n_tiles, chunks, sw, lines, segments,
                     -(-segments // per_split), per_split)


@functools.lru_cache(maxsize=256)
def wgmma_plan(x_shape: Tuple[int, ...], cout: int, sms: int, pad_lo: int = 1) -> WgmmaPlan:
    """The wgmma form's tiling for x (N, D, H, W, Cin) and Cout output
    channels on a card of ``sms`` SMs. Segments: 64 output voxels as 64 / sw
    output lines of sw voxels, sw the power of two >= Wo (4 to 64), so short
    lines fill a segment. Blocks: 9 (kd, kh) x chunks x N tiles, times splits
    of K, each split at least _MIN_SEGMENTS segments. N tiles: equal tiles
    of Cout, each rounded up to an instantiated width, at most 192 wide; of
    the tile counts that leave no tile empty, the fewest whose blocks, split
    as far as the segments allow, fill the most SMs in one wave. Where K is
    long that is Cout in one tile (each staged segment serves every output
    channel); at the deep sites, whose few segments cannot fill the card,
    narrower tiles. Cached: a training step asks for the same few shapes
    every step. ``pad_lo`` as ``s2_wgrad``'s."""
    return _segment_plan(x_shape, cout, sms, pad_lo, WGMMA_CONFIGS, CHUNK, _MAX_BN)


@functools.lru_cache(maxsize=256)
def tf32_plan(x_shape: Tuple[int, ...], cout: int, sms: int, pad_lo: int = 1) -> WgmmaPlan:
    """The tf32x3 form's tiling: ``wgmma_plan``'s segments, N tiles and
    splits, with N tiles of 32, 64 or 96 output channels
    (``TF32_CONFIGS``), and of 128 where all the output voxels fit one
    segment (``TF32_ONE_SEGMENT_CONFIG``: the 8^3 site's 384 outputs in 3
    tiles, one wave of blocks)."""
    plan = _segment_plan(x_shape, cout, sms, pad_lo, TF32_CONFIGS, TF32_CHUNK, _TF32_MAX_BN)
    if plan.segments > 1:
        return plan
    return _segment_plan(x_shape, cout, sms, pad_lo, TF32_CONFIGS + (TF32_ONE_SEGMENT_CONFIG,),
                         TF32_CHUNK, TF32_ONE_SEGMENT_CONFIG[0])


def kernel_form(x: torch.Tensor, g: torch.Tensor) -> str:
    """The CUDA form a call takes: ``wgmma`` or ``narrow`` (bf16), ``tf32x3``
    (f32)."""
    if x.dtype == torch.float32:
        return "tf32x3"
    aligned = x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    return "wgmma" if x.shape[4] % 8 == 0 and g.shape[4] % 8 == 0 and aligned else "narrow"


def _launch(x: torch.Tensor, g: torch.Tensor, pad_lo: int = 1) -> torch.Tensor:
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    from unet3d_tpu_torch.kernels.build import load_library

    lib = load_library()
    n, d, h, w, cin = x.shape
    _, do, ho, wo, cout = g.shape
    m = 27 * cin
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    form = kernel_form(x, g)
    planner = {"wgmma": wgmma_plan, "tf32x3": tf32_plan, "narrow": narrow_plan}[form]
    plan = planner(tuple(x.shape), cout, sms, pad_lo)
    splits = plan.splits
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    part = None
    if splits > 1:
        part = torch.empty((splits, m, cout), dtype=torch.float32, device=x.device)
    part_ptr = part.data_ptr() if part is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if form == "wgmma":
            err = lib.unet3d_s2_wgrad_wgmma(
                plan.bn, plan.stages, x.data_ptr(), g.data_ptr(), part_ptr,
                dw.data_ptr(), n, d, h, w, cin, do, ho, wo, cout, plan.n_tiles,
                plan.chunks, plan.sw, plan.segments, plan.splits, plan.per_split, pad_lo,
                stream)
        elif form == "tf32x3":
            err = lib.unet3d_s2_wgrad_tf32x3(
                plan.bn, x.data_ptr(), g.data_ptr(), part_ptr, dw.data_ptr(), n, d, h, w,
                cin, do, ho, wo, cout, plan.n_tiles, plan.chunks, plan.sw, plan.segments,
                plan.splits, plan.per_split, pad_lo, stream)
        else:
            err = lib.unet3d_s2_wgrad_narrow(
                plan.nt, x.data_ptr(), g.data_ptr(), part_ptr, dw.data_ptr(), n, d, h, w, cin,
                do, ho, wo, cout, plan.n_tiles, plan.chunks, plan.sw, plan.lines,
                plan.segments, plan.splits, plan.per_split, pad_lo, stream)
    if err != 0:
        raise RuntimeError(f"s2_wgrad ({form}) launch failed: "
                           f"{lib.unet3d_cuda_error_string(err).decode()}")
    LAUNCHES["s2_wgrad"] += 1
    FORM_LAUNCHES["s2_wgrad", form] += 1
    if pad_lo != 1:
        HALO_LAUNCHES["s2_wgrad", (pad_lo, 0)] += 1
    return dw


def s2_wgrad(x: torch.Tensor, g: torch.Tensor, pad_lo: int = 1) -> torch.Tensor:
    _check(x, g, pad_lo)
    if x.device.type == "cpu":
        return s2_wgrad_reference(x, g, pad_lo)
    return _launch(x, g, pad_lo)

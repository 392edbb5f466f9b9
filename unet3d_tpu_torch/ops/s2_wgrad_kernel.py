"""Weight gradient of the 3x3x3 stride-2 conv (pads of 1) and its plain version.

``s2_wgrad(x, g)`` takes x (N, D, H, W, Cin) and the output cotangent
g (N, Do, Ho, Wo, Cout), Do = ceil(D / 2), and returns dw (3, 3, 3, Cin, Cout)
in f32. A CPU tensor goes to ``s2_wgrad_reference``, the f32 autograd of
``F.conv3d``; any device other than CUDA raises. A CUDA tensor goes to one of
three forms (``kernel_form``): ``wgmma`` (``ops/kernels/s2_wgrad_wgmma.cu``),
the Hopper form, for bf16 with Cin and Cout multiples of 8 (every stride-2
site of the DynUNet), tiled by ``wgmma_plan``; ``wmma`` (``s2_wgrad.cu``) for
the other bf16 calls, and ``fma`` (the same source) for f32, split by
``split_k``. ``LAUNCHES["s2_wgrad"]`` counts every launch, ``FORM_LAUNCHES``
per ("s2_wgrad", form).
"""
from __future__ import annotations

import collections
import functools
from typing import Dict, NamedTuple, Tuple

import torch

LAUNCHES: Dict[str, int] = {"s2_wgrad": 0}
FORM_LAUNCHES: Dict[Tuple[str, str], int] = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BK = 32            # voxels per stage of the wmma / fma kernel (s2_wgrad.cu)
_BM, _BN = 128, 64  # its dw tile
_MIN_STAGES = 4     # least K a split takes, in stages
_BLOCKS_PER_SM = 4  # blocks to aim for per SM when splitting K

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


def reset_launches() -> None:
    LAUNCHES["s2_wgrad"] = 0
    FORM_LAUNCHES.clear()


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
    """(splits, voxels per split) of the wmma / fma form for a dw of m x n
    over k voxels: enough blocks to fill ``sms`` SMs, each split at least
    _MIN_STAGES stages."""
    tiles = -(-m // _BM) * -(-n // _BN)
    stages = -(-k // _BK)
    want = -(-_BLOCKS_PER_SM * sms // tiles)
    splits = max(1, min(want, stages // _MIN_STAGES))
    per_split = -(-stages // splits) * _BK
    return -(-k // per_split), per_split


@functools.lru_cache(maxsize=256)
def wgmma_plan(x_shape: Tuple[int, ...], cout: int, sms: int) -> WgmmaPlan:
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
    every step."""
    n, d, h, w, cin = x_shape
    do, ho, wo = (d + 1) // 2, (h + 1) // 2, (w + 1) // 2
    chunks = -(-cin // CHUNK)
    sw = min(SEGMENT, max(_MIN_SW, 1 << max(0, wo - 1).bit_length()))
    lines = SEGMENT // sw
    segments = -(-(n * do * ho) // lines) * -(-wo // sw)
    best = None
    for n_tiles in range(-(-cout // _MAX_BN), -(-cout // WGMMA_CONFIGS[0][0]) + 1):
        bn, stages = next(c for c in WGMMA_CONFIGS if c[0] >= -(-cout // n_tiles))
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


def kernel_form(x: torch.Tensor, g: torch.Tensor) -> str:
    """The CUDA form a call takes: ``wgmma``, ``wmma`` or ``fma``."""
    if x.dtype == torch.float32:
        return "fma"
    aligned = x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
    return "wgmma" if x.shape[4] % 8 == 0 and g.shape[4] % 8 == 0 and aligned else "wmma"


def _launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    from unet3d_tpu_torch.kernels.build import load_library

    lib = load_library()
    n, d, h, w, cin = x.shape
    _, do, ho, wo, cout = g.shape
    m = 27 * cin
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    form = kernel_form(x, g)
    if form == "wgmma":
        plan = wgmma_plan(tuple(x.shape), cout, sms)
        splits = plan.splits
    else:
        splits, per_split = split_k(m, cout, n * do * ho * wo, sms)
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
                plan.chunks, plan.sw, plan.segments, plan.splits, plan.per_split, stream)
        else:
            err = lib.unet3d_s2_wgrad_ndhwc(
                _DTYPES[x.dtype], x.data_ptr(), g.data_ptr(), part_ptr, dw.data_ptr(),
                n, d, h, w, cin, do, ho, wo, cout, splits, per_split, stream)
    if err != 0:
        raise RuntimeError(f"s2_wgrad ({form}) launch failed: "
                           f"{lib.unet3d_cuda_error_string(err).decode()}")
    LAUNCHES["s2_wgrad"] += 1
    FORM_LAUNCHES["s2_wgrad", form] += 1
    return dw


def s2_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    _check(x, g)
    if x.device.type == "cpu":
        return s2_wgrad_reference(x, g)
    return _launch(x, g)

"""The 3x3x3 stride-1 SAME conv kernels (NDHWC / DHWIO) and their plain versions.

Three variants, each in several CUDA forms:

* ``conv3x3x3``                   y = conv(x, w)
* ``conv3x3x3_with_stats``        y plus per-(n, c) f32 sum / sum of squares of
                                  y as rounded to its dtype
* ``conv3x3x3_block_with_stats``  conv(lrelu(x * inv + shift), w) plus the same
                                  statistics; ``inv`` / ``shift`` are (N, Cin)

Forms: ``wgmma`` (``ops/kernels/conv3d_wgmma.cu``), the Hopper form, takes
every bf16 call whose Cin is a multiple of 4 and Cout of 8 and whose x is
16-byte aligned (every site of the DynUNet), with the weight pre-packed per
call (``pack_weight``) and a tile configuration picked from the shape
(``wgmma_plan``); ``narrow`` (``ops/kernels/conv3d_narrow.cu``) takes every
other bf16 call (3- and 4-channel heads, one-channel inputs, their input
gradients, ragged Cin, 2-byte-aligned microbatch slices): halo-staged bricks,
8-wide N tiles, below 16 input channels the taps folded into K, with its own
packing (``pack_narrow``, the B fragments in the kernel's K order,
``narrow_weight``) and plan (``narrow_plan``); ``tf32x3``
(``ops/kernels/conv3d_tf32x3.cu``), the Hopper form in f32, takes every f32
call whose Cin is a multiple of 4 and whose x is 16-byte aligned, on the
tensor cores in 3xTF32 (each f32 operand split into a TF32 high and low
part, ``tf32_split``; three products in an f32 accumulator keep f32
accuracy), with its own packing (``pack_tf32``) and plan (``tf32_plan``);
``tf32x3_narrow`` (``conv3d_narrow.cu``'s f32 instantiation) takes the other
f32 calls (3- and 1-channel heads and their input gradients, ragged Cin,
4-byte-aligned slices): the narrow form's bricks, folded taps and 8-wide N
tiles with m16n8k8 TF32 products, three per k8 step, its plan
``narrow_plan(..., torch.float32)`` and its B fragments from
``pack_narrow`` (split into TF32 hi and lo).

Each takes a CUDA tensor to its kernel, and a CPU tensor to its plain version
(``*_reference``); any other device raises. The plain versions compute in f32
(TF32 off on the card, ``utils/device.full_f32``) and round once, as the
kernels do, and take the statistics of the rounded y. ``LAUNCHES`` counts
kernel launches per variant, ``FORM_LAUNCHES`` per (variant, form).

The D-halo mode (``pads``, each form and variant): x holds a slab of a
volume's D planes with up to one neighbour plane on each side (the space
axis of ``parallel/``, after ``parallel/halo.exchange_halo``), and ``pads``
= (pad_lo, pad_hi) says how many zero planes stand in for a missing
neighbour at each end (the volume's edges). The output has ``x.D - 2 +
pad_lo + pad_hi`` planes, output plane z reading x planes z - pad_lo ... z
+ 2 - pad_lo; H and W stay SAME. The SAME conv is pads (1, 1). The input
gradient of a halo conv is the conv of the cotangent with pads (2 - pad_lo,
2 - pad_hi), which gives every plane of x. The statistics cover the output's
planes only; ``block_stats`` activates a neighbour plane like any other
(it holds the neighbour's pre-norm values) and keeps a pad plane zero.
``HALO_LAUNCHES`` counts the launches per (variant, pads) other than (1, 1),
``HALO_FORM_LAUNCHES`` the same launches per (variant, form).

The three variants are torch.library operators of the ``unet3d_tpu_torch``
namespace (``conv3x3x3``, ``conv3x3x3_stats``, ``conv3x3x3_block_stats``),
registered when this module is imported: their CPU implementation is the
plain version, their CUDA implementation the launch, and their fake
implementation gives the output's shapes, so a ``torch.export`` graph holds
each call as one node and a loaded artifact launches the kernels
(``predict/export.py``). They are defined on the low-level
``torch.library.Library``, whose dispatch costs a few microseconds of host
time per call, less than ``torch.library.custom_op``'s. The statistics
variants return ``(y, stats)`` with (N, 2, Cout) f32 ``stats``, which the
public functions split (an operator's outputs may not alias each other);
the public functions check their operands (``_check``) before the call.
"""
from __future__ import annotations

import collections
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from unet3d_tpu_torch.utils.device import full_f32

LAUNCHES: Dict[str, int] = {"conv": 0, "conv_stats": 0, "block_stats": 0}
FORM_LAUNCHES: Dict[Tuple[str, str], int] = collections.Counter()
HALO_LAUNCHES: Dict[Tuple[str, Tuple[int, int]], int] = collections.Counter()
HALO_FORM_LAUNCHES: Dict[Tuple[str, str], int] = collections.Counter()
SAME = (1, 1)  # the D pads of the SAME conv

_VARIANTS = {"conv": 0, "conv_stats": 1, "block_stats": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the wgmma form's tile configurations, in the order of the C table
# (conv3d_wgmma.cu CONFIGS, checked when the library loads): brick (z, y, x)
# of output voxels, BN output channels per block, M tiles of 64 rows per
# warpgroup, B stages, halo buffers (2: the next chunk's halo loads while this
# one's taps run; 1: Cin <= 64, leaving room for the registers or a second
# block per SM), blocks per SM
WGMMA_CONFIGS = ((4, 4, 16, 64, 2, 4, 2, 1), (2, 4, 16, 96, 1, 4, 2, 1),
                 (2, 4, 16, 128, 1, 4, 2, 1), (2, 4, 16, 192, 1, 4, 2, 1),
                 (2, 4, 16, 256, 1, 3, 2, 1), (4, 4, 16, 64, 2, 3, 1, 1),
                 (2, 4, 16, 128, 1, 3, 1, 2))
CHUNK = 64  # input channels per staged chunk (one 128-byte row)
TAPS = 27
# the tf32x3 form's tile configurations, in the order of its C table
# (conv3d_tf32x3.cu CONFIGS), with the fields of WGMMA_CONFIGS: BN up to
# 128 (each f32 B tile is held twice, hi and lo), two M tiles of 64 rows per
# warpgroup up to BN = 64; the one-halo configurations for Cin <= 32
TF32_CONFIGS = ((4, 4, 16, 8, 2, 4, 2, 1), (4, 4, 16, 16, 2, 4, 2, 1),
                (4, 4, 16, 32, 2, 4, 2, 1), (4, 4, 16, 64, 2, 4, 2, 1),
                (2, 4, 16, 96, 1, 4, 2, 1), (2, 4, 16, 128, 1, 3, 2, 1),
                (2, 4, 16, 32, 1, 4, 1, 2), (4, 4, 16, 64, 2, 3, 1, 1))
TF32_CHUNK = 32  # f32 input channels per staged chunk (one 128-byte row)
TF32_MAX_BN = 128
# the narrow form's output brick (z, y, x) per block (conv3d_narrow.cu BZ, BY,
# BX), below which Cin the taps fold into K, and its widest N block
NARROW_BRICK = (4, 8, 16)
NARROW_FOLD_BELOW = 16
NARROW_MAX_NT = {torch.bfloat16: 8, torch.float32: 4}  # 8-wide N tiles per block
NARROW_KD = {torch.bfloat16: 16, torch.float32: 8}  # K elements per mma step


class WgmmaPlan(NamedTuple):
    config: int                   # index of WGMMA_CONFIGS (TF32_CONFIGS)
    brick: Tuple[int, int, int]   # output voxels per block, (z, y, x)
    bn: int                       # output channels per block
    n_tiles: int                  # blocks along Cout
    chunks: int                   # 64-channel (32-channel) chunks along Cin
    bricks: Tuple[int, int, int]  # bricks along (D, H, W)


class NarrowPlan(NamedTuple):
    fold: bool                    # Cin < 16: K = (tap, channel), the taps folded in
    cs: int                       # staged channels per voxel (the brick's row)
    kh: int                       # from 16 channels: k steps per tap and chunk, else 0
    chunks: int                   # staged chunks of kh * kd channels (1 when folded)
    ksteps: int                   # k steps in all
    nt: int                       # 8-wide N tiles per block: 1, 2, 4 or 8
    n_blocks: int                 # blocks along Cout
    bricks: Tuple[int, int, int]  # bricks along (D, H, W)
    kd: int = 16                  # K elements per mma step: 16 (bf16), 8 (f32, tf32)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    FORM_LAUNCHES.clear()
    HALO_LAUNCHES.clear()
    HALO_FORM_LAUNCHES.clear()


def wgmma_plan(spatial: Tuple[int, int, int], cin: int, cout: int) -> WgmmaPlan:
    """The wgmma form's tiling of a (D, H, W) volume, Cin -> Cout: BN = Cout
    rounded up to a configured width where Cout <= 256 (one N tile, so each
    staged input brick serves every output channel), 192-wide tiles above;
    the one-halo configuration of that width when Cin fits one chunk and
    there is one (measured faster on the H100 at 64 -> 64 and 64 -> 128),
    else the two-halo one."""
    chunks = -(-cin // CHUNK)
    bn = next((c[3] for c in WGMMA_CONFIGS if c[3] >= cout), 192)
    halos = 1 if chunks == 1 and (bn, 1) in {(c[3], c[6]) for c in WGMMA_CONFIGS} else 2
    config = next(i for i, c in enumerate(WGMMA_CONFIGS) if c[3] == bn and c[6] == halos)
    brick = WGMMA_CONFIGS[config][:3]
    bricks = tuple(-(-n // b) for n, b in zip(spatial, brick))
    return WgmmaPlan(config, brick, bn, -(-cout // bn), chunks, bricks)


def pack_weight(w: torch.Tensor, bn: int) -> torch.Tensor:
    """DHWIO ``w`` as the wgmma form's B tiles: (n_tiles, chunks, 27, bn, 64),
    K-major (64 input channels of one output channel contiguous), zero past
    Cin and Cout; step (chunk, tap) of N tile t is ``packed[t, chunk, tap]``."""
    cin, cout = w.shape[3], w.shape[4]
    chunks, n_tiles = -(-cin // CHUNK), -(-cout // bn)
    wp = w.reshape(TAPS, cin, cout)
    if chunks * CHUNK != cin or n_tiles * bn != cout:  # one copy fewer without
        wp = F.pad(wp, (0, n_tiles * bn - cout, 0, chunks * CHUNK - cin))
    return (wp.view(TAPS, chunks, CHUNK, n_tiles, bn)
            .permute(3, 1, 0, 4, 2).contiguous())


def tf32_plan(spatial: Tuple[int, int, int], cin: int, cout: int) -> WgmmaPlan:
    """The tf32x3 form's tiling of a (D, H, W) volume, Cin -> Cout: the
    fewest N tiles of at most 128 channels, each Cout / n_tiles rounded up to
    a configured width (BN = Cout rounded up where Cout <= 128: 32 at the
    SegResNet decoder's 32-channel sites); the one-halo configuration of
    that width when Cin fits one 32-channel chunk and there is one, else the
    two-halo one."""
    chunks = -(-cin // TF32_CHUNK)
    n_tiles = -(-cout // TF32_MAX_BN)
    bn = next(c[3] for c in TF32_CONFIGS if c[3] >= -(-cout // n_tiles))
    halos = 1 if chunks == 1 and (bn, 1) in {(c[3], c[6]) for c in TF32_CONFIGS} else 2
    config = next(i for i, c in enumerate(TF32_CONFIGS) if c[3] == bn and c[6] == halos)
    brick = TF32_CONFIGS[config][:3]
    bricks = tuple(-(-n // b) for n, b in zip(spatial, brick))
    return WgmmaPlan(config, brick, bn, -(-cout // bn), chunks, bricks)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: the low 13 bits of the
    result are zero. Magnitudes within half a TF32 step of the f32 maximum
    round to infinity, as there; subnormals keep their TF32 steps."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``v`` as the sum of two TF32 values, hi = rna(v) and lo =
    rna(v - hi): |v - hi - lo| <= max(2^-22 |v|, 2^-137) (the TF32 subnormal
    step's half). The tf32x3 kernel splits A this way in registers, and
    ``pack_tf32`` splits the weight."""
    hi = tf32_round(v)
    return hi, tf32_round(v - hi)


def pack_tf32(w: torch.Tensor, bn: int) -> torch.Tensor:
    """f32 DHWIO ``w`` as the tf32x3 form's B tiles: (n_tiles, chunks, 27, 2,
    bn, 32), the TF32 high part then the low part (``tf32_split``), K-major
    (32 input channels of one output channel contiguous), zero past Cin and
    Cout; step (chunk, tap) of N tile t is ``packed[t, chunk, tap]``."""
    cin, cout = w.shape[3], w.shape[4]
    chunks, n_tiles = -(-cin // TF32_CHUNK), -(-cout // bn)
    wp = F.pad(w.reshape(TAPS, cin, cout),
               (0, n_tiles * bn - cout, 0, chunks * TF32_CHUNK - cin))
    parts = torch.stack(tf32_split(wp))
    return (parts.view(2, TAPS, chunks, TF32_CHUNK, n_tiles, bn)
            .permute(4, 2, 1, 0, 5, 3).contiguous())


def narrow_plan(spatial: Tuple[int, int, int], cin: int, cout: int,
                dtype: torch.dtype = torch.bfloat16) -> NarrowPlan:
    """The narrow form's tiling of a (D, H, W) volume, Cin -> Cout, in bf16
    (m16n8k16, K steps of kd = 16) or f32 (the tf32x3_narrow form: m16n8k8
    tf32, kd = 8); each k step is 32 bytes of channels.

    Below 16 input channels the taps fold into K: a staged voxel holds CS =
    Cin channels (bf16: rounded up to even, one 32-bit word a pair) and K =
    27 * CS rounded up to kd. From 16 up, K = (chunk, tap, k step) with
    chunks of 16 channels (bf16 Cin = 16: one k16 step a tap; f32: two k8
    steps) or 32 (bf16, two k16 steps), staged in rows padded by 16 bytes
    (CS = 24 or 40 bf16, 20 f32). N: Cout in 8-wide tiles, 1, 2, 4 or 8 of
    them per block (Cout up to 8, 16, 32, then blocks of 64; f32 blocks of
    32)."""
    kd = NARROW_KD[dtype]
    fold = cin < NARROW_FOLD_BELOW
    if fold:
        cs, kh, chunks = (cin if dtype == torch.float32 else cin + cin % 2), 0, 1
        ksteps = -(-TAPS * cs // kd)
    else:
        kh = 2 if dtype == torch.float32 or cin > 16 else 1
        width, size = kh * kd, 32 // kd  # a k step is 32 bytes of channels
        cs, chunks = width + 16 // size, -(-cin // width)
        ksteps = chunks * TAPS * kh
    tiles = -(-cout // 8)
    nt = next((n for n in (1, 2, 4) if n >= tiles), NARROW_MAX_NT[dtype])
    bricks = tuple(-(-n // b) for n, b in zip(spatial, NARROW_BRICK))
    return NarrowPlan(fold, cs, kh, chunks, ksteps, nt, -(-tiles // nt), bricks, kd)


def narrow_weight(w: torch.Tensor, plan: NarrowPlan) -> torch.Tensor:
    """DHWIO ``w`` as the narrow form's B matrix, (ksteps * kd, n_blocks * nt
    * 8), rows in the kernel's K order, zero past Cin and Cout: folded, row
    tap * CS + c; else row ((chunk * 27 + tap) * kh + half) * kd + k of
    channel (chunk * kh + half) * kd + k."""
    cin, cout = w.shape[3], w.shape[4]
    n_pad = plan.n_blocks * plan.nt * 8 - cout
    wp = w.reshape(TAPS, cin, cout)
    if plan.fold:
        wp = F.pad(wp, (0, n_pad, 0, plan.cs - cin)).reshape(TAPS * plan.cs, -1)
        return F.pad(wp, (0, 0, 0, plan.ksteps * plan.kd - TAPS * plan.cs))
    width = plan.kh * plan.kd
    wp = F.pad(wp, (0, n_pad, 0, plan.chunks * width - cin))
    return (wp.view(TAPS, plan.chunks, width, -1).permute(1, 0, 2, 3)
            .reshape(plan.ksteps * plan.kd, -1))


def pack_narrow(w: torch.Tensor, plan: NarrowPlan) -> torch.Tensor:
    """``narrow_weight`` as the B fragments the kernel reads: (n_blocks,
    ksteps, nt, 32, 4), lane n * 4 + q of N tile j in column j * 8 + n of
    its N block holding, for a bf16 plan (m16n8k16), rows 2q, 2q + 1, 2q + 8,
    2q + 9 of k16 step s; for an f32 plan (m16n8k8 tf32), the TF32 high parts
    of rows q and q + 4 of k8 step s, then their low parts (``tf32_split``)."""
    wk = narrow_weight(w, plan)
    if plan.kd == NARROW_KD[torch.float32]:
        parts = torch.stack(tf32_split(wk.float()))
        return (parts.view(2, plan.ksteps, 2, 4, plan.n_blocks, plan.nt, 8)
                .permute(4, 1, 5, 6, 3, 0, 2)
                .reshape(plan.n_blocks, plan.ksteps, plan.nt, 32, 4))
    return (wk.view(plan.ksteps, 2, 4, 2, plan.n_blocks, plan.nt, 8)
            .permute(4, 0, 5, 6, 2, 1, 3).reshape(plan.n_blocks, plan.ksteps, plan.nt, 32, 4))


def kernel_form(x: torch.Tensor, w: torch.Tensor) -> str:
    """The CUDA form a call takes: ``wgmma`` or ``narrow`` (bf16),
    ``tf32x3`` or ``tf32x3_narrow`` (f32)."""
    aligned = x.data_ptr() % 16 == 0
    if x.dtype == torch.float32:
        return "tf32x3" if x.shape[4] % 4 == 0 and aligned else "tf32x3_narrow"
    return "wgmma" if x.shape[4] % 4 == 0 and w.shape[4] % 8 == 0 and aligned else "narrow"


def instance_stats(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (sum, sum of squares) of NDHWC ``y`` per (item, channel)."""
    yf = y.float()
    return yf.sum(dim=(1, 2, 3)), (yf * yf).sum(dim=(1, 2, 3))


def affine_lrelu(x, inv, shift, alpha):
    """lrelu(x * inv + shift) in f32 with (N, C) ``inv`` / ``shift``, rounded
    to x's dtype. Differentiable, with the JAX derivative 1 at 0."""
    z = x.float() * inv[:, None, None, None, :] + shift[:, None, None, None, :]
    return torch.where(z >= 0, z, z * alpha).to(x.dtype)


def conv3d_reference(x: torch.Tensor, w: torch.Tensor, pads=SAME) -> torch.Tensor:
    """The conv in f32, rounded to x's dtype; with D ``pads`` other than
    SAME's, x zero-padded on D by them and the conv VALID on D."""
    xf = x.float().permute(0, 4, 1, 2, 3)
    padding = 1
    if tuple(pads) != SAME:
        xf, padding = F.pad(xf, (0, 0, 0, 0, *pads)), (0, 1, 1)
    with full_f32(x):
        y = F.conv3d(xf, w.float().permute(4, 3, 0, 1, 2), padding=padding)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def conv3d_with_stats_reference(x, w, pads=SAME):
    y = conv3d_reference(x, w, pads)
    return (y, *instance_stats(y))


def conv3d_block_with_stats_reference(x, w, inv, shift, alpha=0.01, pads=SAME):
    """The activation of every plane of x (neighbour planes included), then
    the conv with zero pad planes: SAME padding pads the activation."""
    return conv3d_with_stats_reference(affine_lrelu(x, inv, shift, alpha), w, pads)


def out_depth(x: torch.Tensor, pads) -> int:
    """The output's D for x and D ``pads``."""
    return x.shape[1] - 2 + pads[0] + pads[1]


def _check(x: torch.Tensor, w: torch.Tensor, inv=None, shift=None, pads=SAME) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {x.device}")
    if x.dim() != 5 or w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"expected x (N,D,H,W,C) and w (3,3,3,C,Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if len(pads) != 2 or not all(p in (0, 1, 2) for p in pads) or out_depth(x, pads) < 1:
        raise ValueError(f"D pads {tuple(pads)} for x of depth {x.shape[1]}: each of "
                         "0, 1, 2, and at least one output plane")
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
    if x.device.type == "cuda":
        check_contiguous(*tensors)


def check_contiguous(*tensors: Optional[torch.Tensor]) -> None:
    """Raises unless every operand given is contiguous, as a CUDA kernel
    reads them (also where an exported graph calls the operator, which
    ``_check`` does not see)."""
    if not all(t is None or t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel needs contiguous operands")


def _launch(variant: str, x: torch.Tensor, w: torch.Tensor,
            inv: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None, alpha: float = 0.01, pads=SAME):
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    check_contiguous(x, w, inv, shift)
    from unet3d_tpu_torch.kernels.build import load_library

    lib = load_library()
    n, d_in, h, wd, cin = x.shape
    d = out_depth(x, pads)
    cout = w.shape[-1]
    form = kernel_form(x, w)
    y = torch.empty((n, d, h, wd, cout), dtype=x.dtype, device=x.device)
    stats = None
    if variant != "conv":
        stats = torch.zeros((n, 2, cout), dtype=torch.float32, device=x.device)
    ptrs = (inv.data_ptr() if inv is not None else None,
            shift.data_ptr() if shift is not None else None,
            stats.data_ptr() if stats is not None else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if form in ("narrow", "tf32x3_narrow"):
            plan = narrow_plan((d, h, wd), cin, cout, x.dtype)
            wp = pack_narrow(w, plan)
            entry = (lib.unet3d_conv3x3x3_narrow if form == "narrow"
                     else lib.unet3d_conv3x3x3_narrow_tf32x3)
            err = entry(
                _VARIANTS[variant], x.data_ptr(), wp.data_ptr(), y.data_ptr(), *ptrs, n, d,
                h, wd, cin, cout, d_in, pads[0], int(plan.fold), plan.cs, plan.kh,
                plan.chunks, plan.ksteps, plan.nt, plan.n_blocks, *plan.bricks, float(alpha),
                stream)
        else:
            tf32 = form == "tf32x3"
            plan = (tf32_plan if tf32 else wgmma_plan)((d, h, wd), cin, cout)
            wp = (pack_tf32 if tf32 else pack_weight)(w, plan.bn)
            entry = lib.unet3d_conv3x3x3_tf32x3 if tf32 else lib.unet3d_conv3x3x3_wgmma
            err = entry(
                _VARIANTS[variant], plan.config, x.data_ptr(), wp.data_ptr(),
                y.data_ptr(), *ptrs, n, d, h, wd, cin, cout, d_in, pads[0],
                *plan.bricks, plan.n_tiles, plan.chunks, float(alpha), stream)
    if err != 0:
        raise RuntimeError(f"conv3x3x3 {variant} ({form}) launch failed: "
                           f"{lib.unet3d_cuda_error_string(err).decode()}")
    LAUNCHES[variant] += 1
    FORM_LAUNCHES[variant, form] += 1
    if tuple(pads) != SAME:
        HALO_LAUNCHES[variant, tuple(pads)] += 1
        HALO_FORM_LAUNCHES[variant, form] += 1
    return y, stats


# the operators: one DEF library for the namespace (ops/winograd_kernel.py
# defines its two on it), each with its plain version on the CPU, its launch
# on CUDA and its output shapes for tracing
LIBRARY = torch.library.Library("unet3d_tpu_torch", "DEF")


def define_op(name: str, schema: str, cpu, cuda, fake):
    """Defines ``unet3d_tpu_torch::<name><schema>`` with its CPU, CUDA and
    fake implementations; returns its default overload."""
    LIBRARY.define(name + schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"unet3d_tpu_torch::{name}", fake, lib=LIBRARY)
    return getattr(torch.ops.unet3d_tpu_torch, name).default


def stacked(y, s1, s2):
    """A plain version's (y, sum, sum of squares) as an operator's (y, stats)."""
    return y, torch.stack((s1, s2), dim=1)


def fake_outputs(x: torch.Tensor, w: torch.Tensor, pads, with_stats: bool):
    """The shapes of a conv operator's outputs, for tracing."""
    y = x.new_empty((x.shape[0], out_depth(x, pads), x.shape[2], x.shape[3], w.shape[4]))
    if not with_stats:
        return y
    return y, x.new_empty((x.shape[0], 2, w.shape[4]), dtype=torch.float32)


_conv_op = define_op(
    "conv3x3x3", "(Tensor x, Tensor w, int[] pads) -> Tensor",
    conv3d_reference, lambda x, w, pads: _launch("conv", x, w, pads=pads)[0],
    lambda x, w, pads: fake_outputs(x, w, pads, False))
_conv_stats_op = define_op(
    "conv3x3x3_stats", "(Tensor x, Tensor w, int[] pads) -> (Tensor, Tensor)",
    lambda x, w, pads: stacked(*conv3d_with_stats_reference(x, w, pads)),
    lambda x, w, pads: _launch("conv_stats", x, w, pads=pads),
    lambda x, w, pads: fake_outputs(x, w, pads, True))
_block_stats_op = define_op(
    "conv3x3x3_block_stats",
    "(Tensor x, Tensor w, Tensor inv, Tensor shift, float alpha, int[] pads) "
    "-> (Tensor, Tensor)",
    lambda x, w, inv, shift, alpha, pads: stacked(
        *conv3d_block_with_stats_reference(x, w, inv, shift, alpha, pads)),
    lambda x, w, inv, shift, alpha, pads: _launch("block_stats", x, w, inv, shift, alpha,
                                                  pads),
    lambda x, w, inv, shift, alpha, pads: fake_outputs(x, w, pads, True))


def conv3x3x3(x: torch.Tensor, w: torch.Tensor, pads=SAME) -> torch.Tensor:
    _check(x, w, pads=pads)
    return _conv_op(x, w, pads)


def conv3x3x3_with_stats(x: torch.Tensor, w: torch.Tensor, pads=SAME):
    _check(x, w, pads=pads)
    y, stats = _conv_stats_op(x, w, pads)
    return y, stats[:, 0], stats[:, 1]


def conv3x3x3_block_with_stats(x: torch.Tensor, w: torch.Tensor,
                               inv: torch.Tensor, shift: torch.Tensor,
                               alpha: float = 0.01, pads=SAME):
    _check(x, w, inv, shift, pads)
    y, stats = _block_stats_op(x, w, inv, shift, alpha, pads)
    return y, stats[:, 0], stats[:, 1]

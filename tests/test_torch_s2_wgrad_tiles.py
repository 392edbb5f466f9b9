"""Host-side logic of the wgmma form of the stride-2 weight gradient
(``ops/s2_wgrad_kernel.py``).

The CUDA kernel (``ops/kernels/s2_wgrad_wgmma.cu``) takes its tiling from
``wgmma_plan``. These tests hold the plan on the CPU: every (tap, ci) row and
output channel of dw belongs to exactly one block, every output voxel to
exactly one segment of one split, ragged volumes and the BraTS DynUNet's five
stride-2 sites included. A plain-torch emulation of the kernel's
decomposition (blocks of three kw taps of one (kd, kh) pair and one
64-channel chunk; segments of output lines whose input x-line is staged once,
zero-filled in the padding, tap kw of voxel ow reading row 2 ow + kw; f32
partial tiles per split summed in a fixed order) equals ``s2_wgrad_reference``
and the Pallas kernel in interpret mode, in f32, within 1e-5 relative to the
largest |dw| (sums of the same products in another order). The ``cuda`` tests
run the kernel on a GPU and skip without one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unet3d_tpu.ops.pallas.s2_wgrad_kernel import s2_wgrad_pallas

from unet3d_tpu_torch.ops import s2_wgrad_kernel as W

SMS = 132                # streaming multiprocessors of an H100 SXM
SMEM_PER_BLOCK = 232448  # bytes a block of an H100 can use
XROWS = 144              # staged input rows of a segment (16 lines of 9 rows)
F32 = 1e-5

# x (N, D, H, W), Cin, Cout: the five stride-2 sites of the BraTS DynUNet at
# 128^3, then ragged volumes and channel counts
SITES = [((1, 128, 128, 128), 64, 96), ((1, 64, 64, 64), 96, 128),
         ((1, 32, 32, 32), 128, 192), ((1, 16, 16, 16), 192, 256),
         ((1, 8, 8, 8), 256, 384)]
RAGGED = [((1, 9, 13, 17), 64, 96), ((1, 9, 13, 17), 96, 192), ((2, 7, 5, 3), 24, 40),
          ((2, 3, 1, 1), 8, 8), ((1, 5, 4, 150), 72, 200), ((3, 11, 6, 9), 136, 520)]
# SegResNetVAE's new widths: down1 at level 0 and the VAE branch's down conv
MYRONENKO = [((1, 128, 128, 128), 32, 64), ((1, 16, 16, 16), 256, 16)]


def _outputs(x_shape):
    n, d, h, w = x_shape[:4]
    return n, (d + 1) // 2, (h + 1) // 2, (w + 1) // 2


def _segment_voxels(plan, x_shape):
    """(line, ow) of every voxel slot of every segment, and whether the slot
    holds a voxel, as the kernel decodes a segment index."""
    n, do, ho, wo = _outputs(x_shape)
    ow_blocks = -(-wo // plan.sw)
    seg = np.arange(plan.segments)[:, None]
    v = np.arange(W.SEGMENT)[None, :]
    line = (seg // ow_blocks) * plan.lines + v // plan.sw
    ow = (seg % ow_blocks) * plan.sw + v % plan.sw
    return line, ow, (line < n * do * ho) & (ow < wo)


@pytest.mark.parametrize("x_shape,cin,cout", SITES + RAGGED + MYRONENKO)
def test_wgmma_plan_covers_every_row_column_and_voxel_once(x_shape, cin, cout):
    plan = W.wgmma_plan(x_shape + (cin,), cout, SMS)
    assert (plan.bn, plan.stages) in W.WGMMA_CONFIGS
    # rows: block (kd, kh, chunk) x warpgroup kw x 64 rows -> (tap, ci)
    rows = np.zeros(27 * cin, np.int64)
    for kd in range(3):
        for kh in range(3):
            for c in range(plan.chunks):
                for kw in range(3):
                    ci = c * W.CHUNK + np.arange(W.CHUNK)
                    tap = (kd * 3 + kh) * 3 + kw
                    np.add.at(rows, tap * cin + ci[ci < cin], 1)
    assert (rows == 1).all()
    cols = np.zeros(plan.n_tiles * plan.bn, np.int64)
    for t in range(plan.n_tiles):
        cols[t * plan.bn:(t + 1) * plan.bn] += 1
    assert (cols[:cout] == 1).all() and plan.n_tiles * plan.bn - cout < plan.bn
    assert plan.n_tiles == 1 or plan.bn < cout
    # voxels: segments of `lines` lines of `sw` voxels, split in order
    assert plan.sw & (plan.sw - 1) == 0 and 4 <= plan.sw <= 64
    assert plan.lines * plan.sw == W.SEGMENT and plan.lines * (2 * plan.sw + 1) <= XROWS
    assert (plan.splits - 1) * plan.per_split < plan.segments <= plan.splits * plan.per_split
    n, do, ho, wo = _outputs(x_shape)
    line, ow, ok = _segment_voxels(plan, x_shape)
    hits = np.zeros(n * do * ho * wo, np.int64)
    np.add.at(hits, (line * wo + ow)[ok], 1)
    assert (hits == 1).all()
    # one wave of blocks: splits fill the SMs the tiles leave, no further
    tiles = 9 * plan.chunks * plan.n_tiles
    assert plan.splits == 1 or tiles * plan.splits <= SMS


def test_wgmma_plan_at_the_brats_sites():
    """Level 0 splits K 14 ways over its nine (kd, kh) blocks; short lines
    pack several per segment; the deep sites take one or two splits, and 8^3
    (one segment) three N tiles of 128 rather than two of 192 (108 blocks
    against 72)."""
    plans = [W.wgmma_plan(s + (cin,), cout, SMS) for s, cin, cout in SITES]
    assert [(p.bn, p.n_tiles, p.chunks) for p in plans] == [
        (96, 1, 1), (128, 1, 2), (192, 1, 2), (128, 2, 3), (128, 3, 4)]
    assert [(p.sw, p.lines, p.segments) for p in plans] == [
        (64, 1, 4096), (32, 2, 512), (16, 4, 64), (8, 8, 8), (4, 16, 1)]
    assert [p.splits for p in plans] == [14, 7, 7, 2, 1]


@pytest.mark.parametrize("config", W.WGMMA_CONFIGS)
def test_wgmma_configs_fit_one_block(config):
    """The ring of (x lines, g tile) stages and the 1024-byte alignment slack
    fit a block's shared memory (the kernel's static_asserts, mirrored); the
    g tile is stored in 64-wide MN-major atoms of 64 rows of 128 bytes."""
    bn, stages = config
    x_bytes = -(-XROWS * 128 // 1024) * 1024
    stage = x_bytes + -(-bn // 64) * 64 * 128
    assert stage % 1024 == 0 and stages >= 3 and bn % 8 == 0
    assert stages * stage + 1024 <= SMEM_PER_BLOCK


def emulate_wgmma_form(x: torch.Tensor, g: torch.Tensor, plan) -> torch.Tensor:
    """dw as the wgmma form computes it, in plain torch (f32)."""
    n, d, h, w, cin = x.shape
    _, do, ho, wo, cout = g.shape
    total = n * do * ho
    pitch = 2 * plan.sw + 1
    ow_blocks = -(-wo // plan.sw)
    gl = g.reshape(total, wo, cout)
    part = torch.zeros(plan.splits, 27 * cin, cout)
    v = torch.arange(W.SEGMENT)
    for kd in range(3):
        for kh in range(3):
            for c in range(plan.chunks):
                ch = c * W.CHUNK + torch.arange(W.CHUNK)
                for nt in range(plan.n_tiles):
                    co = nt * plan.bn + torch.arange(plan.bn)
                    for s in range(plan.splits):
                        acc = torch.zeros(3, W.CHUNK, plan.bn)
                        for seg in range(s * plan.per_split,
                                         min((s + 1) * plan.per_split, plan.segments)):
                            l0 = (seg // ow_blocks) * plan.lines
                            ow0 = (seg % ow_blocks) * plan.sw
                            # the staged input lines: (lines, pitch, 64), zero-filled
                            line = l0 + torch.arange(plan.lines)
                            nn, od, oh = line // (do * ho), (line // ho) % do, line % ho
                            iz, iy = 2 * od + kd - 1, 2 * oh + kh - 1
                            ix = 2 * ow0 - 1 + torch.arange(pitch)
                            ok = ((line < total) & (iz >= 0) & (iz < d) & (iy >= 0)
                                  & (iy < h))[:, None, None]
                            ok = ok & ((ix >= 0) & (ix < w))[None, :, None] & (ch < cin)
                            staged = x[nn.clamp(max=n - 1)[:, None, None],
                                       iz.clamp(0, d - 1)[:, None, None],
                                       iy.clamp(0, h - 1)[:, None, None],
                                       ix.clamp(0, w - 1)[None, :, None],
                                       ch.clamp(max=cin - 1)[None, None, :]]
                            staged = torch.where(ok, staged, 0.0).reshape(-1, W.CHUNK)
                            # the g tile: (64 voxels, bn), zero past the volume
                            vl, vow = l0 + v // plan.sw, ow0 + v % plan.sw
                            gok = ((vl < total) & (vow < wo))[:, None] & (co < cout)
                            gt = gl[vl.clamp(max=total - 1)[:, None],
                                    vow.clamp(max=wo - 1)[:, None],
                                    co.clamp(max=cout - 1)[None, :]]
                            gt = torch.where(gok, gt, 0.0)
                            for kw in range(3):  # row 2 ow + kw of its line
                                a = staged[(v // plan.sw) * pitch + 2 * (v % plan.sw) + kw]
                                acc[kw] += a.T @ gt
                        for kw in range(3):
                            tap = (kd * 3 + kh) * 3 + kw
                            rows, cols = ch[ch < cin], co[co < cout]
                            part[s, (tap * cin + rows)[:, None], cols[None, :]] = \
                                acc[kw][:len(rows), :len(cols)]
    dw = part[0]
    for s in range(1, plan.splits):  # the split-K sum's fixed order
        dw = dw + part[s]
    return dw.reshape(3, 3, 3, cin, cout)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("x_shape,cin,cout,sms", [
    ((2, 7, 5, 3), 24, 40, SMS),   # 16 lines of 4 voxels: two segments, one split
    ((1, 5, 9, 21), 72, 16, 60),   # two chunks, Wo 11 in 16-voxel lines; 2 splits
    ((1, 3, 4, 150), 8, 200, 40),  # Wo 75: two 64-voxel blocks a line; 2 N tiles, 2 splits
])
def test_emulated_decomposition_matches_reference(x_shape, cin, cout, sms):
    rng = np.random.RandomState(sum(x_shape) + cin)
    x = torch.from_numpy(rng.randn(*x_shape, cin).astype(np.float32))
    g = torch.from_numpy(rng.randn(*_outputs(x_shape), cout).astype(np.float32))
    plan = W.wgmma_plan(tuple(x.shape), cout, sms)
    got = emulate_wgmma_form(x, g, plan)
    assert _rel(got, W.s2_wgrad_reference(x, g)) < F32


def test_emulated_decomposition_matches_pallas_kernel():
    """Even D/H/W and C = 64 (the TPU kernel's 128-lane (2, C) block); Wo = 5
    leaves 3 of each 8-voxel line slot empty; 5 segments in 2 splits."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 8, 10, 64)).astype(np.float32)
    g = rng.normal(size=(2, 5, 4, 5, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = s2_wgrad_pallas(jnp.asarray(x), jnp.asarray(g))
    plan = W.wgmma_plan(x.shape, 16, 20)
    assert plan.splits > 1
    got = emulate_wgmma_form(torch.from_numpy(x), torch.from_numpy(g), plan)
    assert _rel(got, want) < F32


def test_kernel_form_by_dtype_and_channels():
    x, g = torch.zeros(1, 4, 4, 4, 64), torch.zeros(1, 2, 2, 2, 96)
    assert W.kernel_form(x, g) == "fma"
    assert W.kernel_form(x.bfloat16(), g.bfloat16()) == "wgmma"
    assert W.kernel_form(torch.zeros(1, 4, 4, 4, 5, dtype=torch.bfloat16),
                         g.bfloat16()) == "wmma"
    assert W.kernel_form(x.bfloat16(), torch.zeros(1, 2, 2, 2, 12,
                                                   dtype=torch.bfloat16)) == "wmma"


def test_cpu_calls_count_no_launch_and_no_form():
    W.reset_launches()
    W.s2_wgrad(torch.randn(1, 4, 4, 4, 8, dtype=torch.bfloat16),
               torch.randn(1, 2, 2, 2, 8, dtype=torch.bfloat16))
    assert W.LAUNCHES["s2_wgrad"] == 0 and not W.FORM_LAUNCHES


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cuda_inputs(device, x_shape, cin, cout, seed=7):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*x_shape, cin).astype(np.float32))
    g = torch.from_numpy(rng.randn(*_outputs(x_shape), cout).astype(np.float32))
    return x.to(device, torch.bfloat16), g.to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,cin,cout", [
    ((1, 9, 13, 17), 64, 96), ((1, 9, 13, 17), 64, 192), ((1, 9, 13, 17), 96, 96),
    ((1, 9, 13, 17), 96, 192), ((1, 8, 8, 8), 256, 384), ((2, 7, 5, 3), 24, 40),
    ((1, 5, 4, 150), 72, 200)])
def test_cuda_wgmma_form_matches_plain_at_ragged_shapes(cuda_device, x_shape, cin, cout):
    x, g = _cuda_inputs(cuda_device, x_shape, cin, cout)
    W.reset_launches()
    got = W.s2_wgrad(x, g)
    torch.cuda.synchronize()
    assert dict(W.FORM_LAUNCHES) == {("s2_wgrad", "wgmma"): 1}
    assert W.LAUNCHES["s2_wgrad"] == 1
    # both sum the same bf16 products in f32, in another order
    assert _rel(got.cpu(), W.s2_wgrad_reference(x, g).cpu()) < F32


@pytest.mark.cuda
def test_cuda_wgmma_form_is_bit_reproducible(cuda_device):
    """Split-K partials are summed in a fixed order: two calls agree to the bit."""
    x, g = _cuda_inputs(cuda_device, (1, 64, 64, 64), 96, 128, seed=8)
    assert W.wgmma_plan(tuple(x.shape), 128, SMS).splits > 1
    first = W.s2_wgrad(x, g)
    second = W.s2_wgrad(x, g)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_channels_off_the_wgmma_form_take_wmma(cuda_device):
    x, g = _cuda_inputs(cuda_device, (1, 9, 13, 17), 5, 96, seed=9)
    W.reset_launches()
    got = W.s2_wgrad(x, g)
    torch.cuda.synchronize()
    assert dict(W.FORM_LAUNCHES) == {("s2_wgrad", "wmma"): 1}
    assert _rel(got.cpu(), W.s2_wgrad_reference(x, g).cpu()) < F32

"""Host-side logic of the f32 form of the stride-2 weight gradient
(``tf32x3``: ``ops/kernels/s2_wgrad_tf32x3.cu``, wgmma TF32 products in
3xTF32).

The kernel takes its tiling from ``s2_wgrad_kernel.tf32_plan``. These tests
hold the plan on the CPU: every (tap, ci) row and output channel of dw
belongs to exactly one block, every output voxel to exactly one segment of
one split, ragged volumes, the D-halo mode's ``pad_lo`` 0 and the BraTS
DynUNet's five stride-2 sites included. A plain-torch emulation of the
kernel's decomposition and arithmetic (blocks of three kw taps of one
(kd, kh) pair and one 64-channel chunk; segments of output lines whose input
x-line is staged once, tap kw of voxel ow reading row 2 ow + kw; each staged
x and g element split into TF32 hi and lo, the products lo*hi, hi*lo and
hi*hi, each segment's sum added into the total; f32 partial tiles per split
summed in a fixed order) equals ``s2_wgrad_reference`` and the Pallas kernel
in interpret mode. The ``cuda`` tests run the kernel on a GPU and skip
without one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unet3d_tpu.ops.pallas.s2_wgrad_kernel import s2_wgrad_pallas

from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
from unet3d_tpu_torch.ops.conv3d_kernel import tf32_split

SMS = 132                # streaming multiprocessors of an H100 SXM
SMEM_PER_BLOCK = 232448  # bytes a block of an H100 can use
XROWS = 144              # staged input rows of a segment (16 lines of 9 rows)
F32 = 1e-5

# x (N, D, H, W), Cin, Cout: the five stride-2 sites of the BraTS DynUNet at
# 128^3, the other nets' f32 sites, then ragged volumes and channel counts
SITES = [((1, 128, 128, 128), 64, 96), ((1, 64, 64, 64), 96, 128),
         ((1, 32, 32, 32), 128, 192), ((1, 16, 16, 16), 192, 256),
         ((1, 8, 8, 8), 256, 384)]
OTHERS = [((1, 128, 128, 128), 32, 64), ((1, 16, 16, 16), 256, 16),
          ((1, 128, 128, 128), 4, 16), ((1, 128, 128, 128), 16, 16),
          ((1, 64, 64, 64), 64, 128), ((1, 32, 32, 32), 128, 256)]
RAGGED = [((1, 9, 13, 17), 64, 96), ((2, 7, 5, 3), 24, 40), ((2, 3, 1, 1), 5, 7),
          ((1, 5, 4, 150), 72, 200), ((3, 11, 6, 9), 136, 520), ((1, 6, 5, 7), 3, 1)]


def _outputs(x_shape, pad_lo=1):
    n, d, h, w = x_shape[:4]
    return n, (d + pad_lo) // 2, (h + 1) // 2, (w + 1) // 2


@pytest.mark.parametrize("pad_lo", [1, 0])
@pytest.mark.parametrize("x_shape,cin,cout", SITES + OTHERS + RAGGED)
def test_tf32_plan_covers_every_row_column_and_voxel_once(x_shape, cin, cout, pad_lo):
    plan = W.tf32_plan(tuple(x_shape) + (cin,), cout, SMS, pad_lo)
    # BN 128 only where a split walks one segment (no f32 total beside it)
    assert ((plan.bn, plan.stages) in W.TF32_CONFIGS
            or ((plan.bn, plan.stages) == W.TF32_ONE_SEGMENT_CONFIG and plan.per_split == 1))
    # rows: 9 (kd, kh) blocks x chunks of 64 channels x 3 kw taps
    assert plan.chunks == -(-cin // W.TF32_CHUNK)
    rows = np.zeros(27 * cin, int)
    for kd in range(3):
        for kh in range(3):
            for c in range(plan.chunks):
                ci = np.arange(c * 64, min((c + 1) * 64, cin))
                for kw in range(3):
                    rows[((kd * 3 + kh) * 3 + kw) * cin + ci] += 1
    assert (rows == 1).all()
    # columns: n_tiles of bn, none empty, the last covering Cout
    assert (plan.n_tiles - 1) * plan.bn < cout <= plan.n_tiles * plan.bn
    # voxels: each (line, ow) in exactly one slot of one segment of one split
    n, do, ho, wo = _outputs(x_shape, pad_lo)
    ow_blocks = -(-wo // plan.sw)
    seg = np.arange(plan.segments)[:, None]
    v = np.arange(W.SEGMENT)[None, :]
    line = (seg // ow_blocks) * plan.lines + v // plan.sw
    ow = (seg % ow_blocks) * plan.sw + v % plan.sw
    ok = (line < n * do * ho) & (ow < wo)
    seen = np.zeros((n * do * ho, wo), int)
    np.add.at(seen, (line[ok], ow[ok]), 1)
    assert (seen == 1).all()
    assert plan.splits * plan.per_split >= plan.segments > (plan.splits - 1) * plan.per_split
    assert 9 * plan.chunks * plan.n_tiles * plan.splits <= max(SMS, 9 * plan.chunks
                                                               * plan.n_tiles)


def test_tf32_plan_at_the_brats_sites():
    """Level 0 takes its 96 outputs in one tile, split over the card; the
    deep sites fill it with tiles (16^3, 8^3: one split)."""
    plans = [W.tf32_plan(x + (cin,), cout, SMS) for x, cin, cout in SITES]
    assert [(p.bn, p.n_tiles) for p in plans] == [(96, 1), (64, 2), (96, 2), (64, 4), (128, 3)]
    assert [p.splits for p in plans] == [14, 3, 3, 1, 1]


@pytest.mark.parametrize("config", W.TF32_CONFIGS + (W.TF32_ONE_SEGMENT_CONFIG,))
def test_tf32_configs_fit_one_block(config):
    """(x rows of 68 floats + 64 raw g rows of BN + 4 floats, each 1024-byte
    aligned) x the ring's stages, the hi and lo B tiles (2 K blocks of BN
    rows of 128 bytes each) and the alignment slack fit a block's shared
    memory (the kernel's static_asserts, mirrored); the x pitch puts the
    lanes of an A fragment load (rows 2 q apart) on 32 banks."""
    bn, stages = config

    def align(n):
        return -(-n // 1024) * 1024
    stage = align(XROWS * 68 * 4) + align(64 * (bn + 4) * 4)
    assert bn % 32 == 0 and bn <= 128 and (bn * 128) % 1024 == 0
    assert len({(2 * q * 68 + r) % 32 for q in range(4) for r in range(8)}) == 32
    assert stages * stage + 4 * bn * 128 + 1024 <= SMEM_PER_BLOCK


def emulate_tf32x3_form(x: torch.Tensor, g: torch.Tensor, plan, pad_lo=1) -> torch.Tensor:
    """dw as the tf32x3 form computes it, in plain torch: the TF32 products
    and their sums within a segment in f64 (the tensor cores' sums differ
    from them by their rounding alone), each segment's sum added into an f32
    total, the split partials summed in order in f32."""
    n, d, h, w, cin = x.shape
    _, do, ho, wo, cout = g.shape
    total = n * do * ho
    pitch = 2 * plan.sw + 1
    ow_blocks = -(-wo // plan.sw)
    ck = W.TF32_CHUNK
    gl = g.reshape(total, wo, cout)
    part = torch.zeros(plan.splits, 27 * cin, cout)
    v = torch.arange(W.SEGMENT)
    for kd in range(3):
        for kh in range(3):
            for c in range(plan.chunks):
                ch = c * ck + torch.arange(ck)
                for nt in range(plan.n_tiles):
                    co = nt * plan.bn + torch.arange(plan.bn)
                    for s in range(plan.splits):
                        acc = torch.zeros(3, ck, plan.bn)
                        for seg in range(s * plan.per_split,
                                         min((s + 1) * plan.per_split, plan.segments)):
                            l0 = (seg // ow_blocks) * plan.lines
                            ow0 = (seg % ow_blocks) * plan.sw
                            line = l0 + torch.arange(plan.lines)
                            nn, od, oh = line // (do * ho), (line // ho) % do, line % ho
                            iz, iy = 2 * od + kd - pad_lo, 2 * oh + kh - 1
                            ix = 2 * ow0 - 1 + torch.arange(pitch)
                            ok = ((line < total) & (iz >= 0) & (iz < d) & (iy >= 0)
                                  & (iy < h))[:, None, None]
                            ok = ok & ((ix >= 0) & (ix < w))[None, :, None] & (ch < cin)
                            staged = x[nn.clamp(max=n - 1)[:, None, None],
                                       iz.clamp(0, d - 1)[:, None, None],
                                       iy.clamp(0, h - 1)[:, None, None],
                                       ix.clamp(0, w - 1)[None, :, None],
                                       ch.clamp(max=cin - 1)[None, None, :]]
                            staged = torch.where(ok, staged, 0.0).reshape(-1, ck)
                            vl, vow = l0 + v // plan.sw, ow0 + v % plan.sw
                            gok = ((vl < total) & (vow < wo))[:, None] & (co < cout)
                            gt = gl[vl.clamp(max=total - 1)[:, None],
                                    vow.clamp(max=wo - 1)[:, None],
                                    co.clamp(max=cout - 1)[None, :]]
                            ghi, glo = (t.double() for t in tf32_split(torch.where(gok, gt, 0.0)))
                            for kw in range(3):  # row 2 ow + kw of its line
                                a = staged[(v // plan.sw) * pitch + 2 * (v % plan.sw) + kw]
                                ahi, alo = (t.double() for t in tf32_split(a))
                                seg_sum = alo.T @ ghi + ahi.T @ glo + ahi.T @ ghi
                                acc[kw] += seg_sum.float()
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
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("x_shape,cin,cout,sms,pad_lo", [
    ((2, 7, 5, 3), 24, 40, SMS, 1),   # 16 lines of 4 voxels: one segment, one split
    ((1, 5, 9, 21), 40, 16, 60, 1),   # two chunks, Wo 11 in 16-voxel lines; 2 splits
    ((1, 3, 4, 150), 5, 200, 40, 1),  # Wo 75: two 64-voxel blocks a line; 2 N tiles
    ((1, 8, 9, 21), 7, 3, 27, 0),     # the D-halo mode: pad_lo 0, ragged channels
])
def test_emulated_decomposition_matches_reference(x_shape, cin, cout, sms, pad_lo):
    rng = np.random.RandomState(sum(x_shape) + cin)
    x = torch.from_numpy(rng.randn(*x_shape, cin).astype(np.float32))
    g = torch.from_numpy(rng.randn(*_outputs(x_shape, pad_lo), cout).astype(np.float32))
    plan = W.tf32_plan(tuple(x.shape), cout, sms, pad_lo)
    got = emulate_tf32x3_form(x, g, plan, pad_lo)
    assert _rel(got, W.s2_wgrad_reference(x, g, pad_lo)) < F32


def test_emulated_decomposition_matches_pallas_kernel():
    """Even D/H/W and C = 64 (the TPU kernel's 128-lane (2, C) block); Wo = 5
    leaves 3 of each 8-voxel line slot empty; 5 segments in 2 splits."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 8, 10, 64)).astype(np.float32)
    g = rng.normal(size=(2, 5, 4, 5, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = s2_wgrad_pallas(jnp.asarray(x), jnp.asarray(g))
    plan = W.tf32_plan(x.shape, 16, 40)
    assert plan.splits > 1
    got = emulate_tf32x3_form(torch.from_numpy(x), torch.from_numpy(g), plan)
    assert _rel(got, want) < F32


def test_kernel_form_sends_every_f32_call_to_tf32x3():
    for cin, cout in ((64, 96), (4, 16), (5, 7), (3, 1)):
        x, g = torch.zeros(1, 4, 4, 4, cin), torch.zeros(1, 2, 2, 2, cout)
        assert W.kernel_form(x, g) == "tf32x3"
    # any alignment: a slice one element into its storage
    x = torch.zeros(1 + 4 * 4 * 4 * 8)[1:].view(1, 4, 4, 4, 8)
    assert W.kernel_form(x, torch.zeros(1, 2, 2, 2, 8)) == "tf32x3"


def test_cpu_f32_calls_take_the_plain_version_and_count_no_launch():
    W.reset_launches()
    x, g = torch.randn(1, 5, 4, 6, 3), torch.randn(1, 3, 2, 3, 5)
    assert torch.equal(W.s2_wgrad(x, g), W.s2_wgrad_reference(x, g))
    assert W.LAUNCHES["s2_wgrad"] == 0 and not W.FORM_LAUNCHES


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _cuda_inputs(device, x_shape, cin, cout, pad_lo=1, seed=7, offset=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*x_shape, cin).astype(np.float32)).to(device)
    if offset:
        store = torch.empty(offset + x.numel(), device=device)
        x = store[offset:].view(x.shape).copy_(x)
    g = torch.from_numpy(rng.randn(*_outputs(x_shape, pad_lo), cout).astype(np.float32))
    return x, g.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,cin,cout,pad_lo,offset", [
    ((1, 128, 128, 128), 64, 96, 1, 0), ((1, 16, 16, 16), 192, 256, 1, 0),
    ((1, 8, 8, 8), 256, 384, 1, 0), ((1, 9, 13, 17), 64, 96, 1, 0),
    ((2, 7, 5, 3), 24, 40, 1, 0), ((1, 5, 4, 150), 72, 200, 1, 0),
    ((3, 11, 6, 9), 5, 7, 1, 0), ((1, 128, 128, 128), 4, 16, 1, 0),
    ((2, 10, 13, 17), 24, 40, 0, 0), ((1, 9, 13, 17), 12, 20, 1, 1)])
def test_cuda_tf32x3_form_matches_plain(cuda_device, x_shape, cin, cout, pad_lo, offset):
    x, g = _cuda_inputs(cuda_device, x_shape, cin, cout, pad_lo, offset=offset)
    W.reset_launches()
    got = W.s2_wgrad(x, g, pad_lo)
    torch.cuda.synchronize()
    assert dict(W.FORM_LAUNCHES) == {("s2_wgrad", "tf32x3"): 1}
    # the plain version on an aligned copy (cuDNN faults on a misaligned f32 x)
    assert _rel(got.cpu(), W.s2_wgrad_reference(x.clone(), g, pad_lo).cpu()) < F32


@pytest.mark.cuda
def test_cuda_tf32x3_form_is_bit_reproducible(cuda_device):
    """Split-K partials are summed in a fixed order: two calls agree to the bit."""
    x, g = _cuda_inputs(cuda_device, (1, 64, 64, 64), 96, 128, seed=8)
    assert W.tf32_plan(tuple(x.shape), 128, SMS).splits > 1
    first = W.s2_wgrad(x, g)
    second = W.s2_wgrad(x, g)
    torch.cuda.synchronize()
    assert torch.equal(first, second)

"""Host-side logic of the narrow form of the bf16 stride-2 weight gradient
(``narrow``: ``ops/kernels/s2_wgrad.cu``, every bf16 call that the wgmma
form does not take).

The kernel takes its tiling from ``s2_wgrad_kernel.narrow_plan``. These
tests hold the plan on the CPU: every (tap, ci) row and output channel of dw
belongs to exactly one block, every output voxel to exactly one segment of
one split (ragged volumes, Cin and Cout in {1, 3, 4, 12, 16, 17}, the
D-halo mode's ``pad_lo`` 0), the W-parity rows of a staged line give each
tap's input column, and a block's stages fit its shared memory. A
plain-torch emulation of the kernel's decomposition (blocks of 8 input
channels x 28 taps (the last a zero row) x 8 nt output channels; segments
of ``lines`` output lines of ``sw`` voxels, each (line, kd, kh) input line
staged once with its W parity split and tap kw of voxel ow reading row ow,
sw + 1 + ow or ow + 1; each k16 step's products summed in f64 and added into
an f32 accumulator; the f32 partial tiles of the splits summed in order)
equals ``s2_wgrad_reference`` and JAX's weight gradient of the same conv
(``jax.vjp`` of ``lax.conv_general_dilated`` with explicit pads: the Pallas
kernel refuses 2 C % 128 != 0) on bf16 inputs within 1e-5 relative to the
largest |dw| (f32 sums in other orders; the bf16 products are exact in f32).
The ``cuda`` tests run the kernel on a GPU and skip without one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu_torch.ops import s2_wgrad_kernel as W

SMS = 132                # streaming multiprocessors of an H100 SXM
SMEM_PER_BLOCK = 232448  # bytes a block of an H100 can use
SMEM_PER_SM = 233472     # bytes an SM holds, 1024 reserved per block
STAGES = 3               # s2_wgrad.cu's ring of segments
F32 = 1e-5

CHANNELS = (1, 3, 4, 12, 16, 17)
# (Cin, Cout) pairs that take every count of CHANNELS on both sides
PAIRS = [(1, 17), (3, 12), (4, 16), (4, 4), (12, 3), (16, 1), (17, 4)]
SHAPES = [(1, 128, 128, 128), (2, 7, 5, 3), (1, 9, 13, 17), (3, 11, 6, 9), (1, 5, 4, 150),
          (1, 6, 5, 300), (2, 3, 1, 1)]


def _outputs(x_shape, pad_lo=1):
    n, d, h, w = x_shape[:4]
    return n, (d + pad_lo) // 2, (h + 1) // 2, (w + 1) // 2


def _stage_rows(plan) -> int:
    return plan.lines * 9 * (2 * plan.sw + 1) + plan.nt * plan.lines * plan.sw


@pytest.mark.parametrize("pad_lo", [1, 0])
@pytest.mark.parametrize("cin,cout", PAIRS)
@pytest.mark.parametrize("x_shape", SHAPES)
def test_narrow_plan_covers_every_row_column_and_voxel_once(x_shape, cin, cout, pad_lo):
    plan = W.narrow_plan(tuple(x_shape) + (cin,), cout, SMS, pad_lo)
    assert 1 <= plan.nt <= W.NARROW_MAX_NT
    assert plan.sw % 16 == 0 and 16 <= plan.sw <= W.NARROW_MAX_SW
    assert plan.lines * plan.sw <= 128
    # rows: chunks of 8 channels x 28 taps, the 28th discarded
    rows = np.zeros(27 * cin, int)
    for c in range(plan.chunks):
        for tap in range(28):
            ci = c * W.NARROW_CHUNK + np.arange(W.NARROW_CHUNK)
            if tap < 27:
                np.add.at(rows, tap * cin + ci[ci < cin], 1)
    assert (rows == 1).all()
    # columns: n_tiles of 8 nt, the last covering Cout, none empty
    bn = 8 * plan.nt
    assert (plan.n_tiles - 1) * bn < cout <= plan.n_tiles * bn
    # voxels: each (line, ow) in exactly one slot of one segment of one split
    n, do, ho, wo = _outputs(x_shape, pad_lo)
    assert plan.ow_blocks == -(-wo // plan.sw)
    seg = np.arange(plan.segments)[:, None]
    v = np.arange(plan.lines * plan.sw)[None, :]
    line = (seg // plan.ow_blocks) * plan.lines + v // plan.sw
    ow = (seg % plan.ow_blocks) * plan.sw + v % plan.sw
    ok = (line < n * do * ho) & (ow < wo)
    seen = np.zeros((n * do * ho, wo), int)
    np.add.at(seen, (line[ok], ow[ok]), 1)
    assert (seen == 1).all()
    assert plan.splits * plan.per_split >= plan.segments > (plan.splits - 1) * plan.per_split
    # a block's ring fits
    assert STAGES * _stage_rows(plan) * 16 + 16 <= SMEM_PER_BLOCK


def test_narrow_plan_at_the_128_sites():
    """UNet's 4 -> 16 and the AutoEncoder's 4 -> 4 at x 128^3: one chunk, one
    N tile of 16 (8), lines of 64 voxels one a segment, three blocks a SM
    (their stages fit three times) in 373 splits."""
    for cout, nt in ((16, 2), (4, 1)):
        plan = W.narrow_plan((1, 128, 128, 128, 4), cout, SMS)
        assert (plan.nt, plan.n_tiles, plan.chunks, plan.sw, plan.lines) == (nt, 1, 1, 64, 1)
        assert plan.segments == 64 * 64 and plan.splits == 373
        assert 3 * (STAGES * _stage_rows(plan) * 16 + 16 + 1024) <= SMEM_PER_SM


def _tap_row(kw, ow, sw):
    return (ow, sw + 1 + ow, ow + 1)[kw]


def _staged_column(row, om, sw):
    """The input column staged at ``row`` of a line segment of x-block om."""
    return 2 * om * sw - 1 + (2 * row if row <= sw else 2 * (row - sw) - 1)


@pytest.mark.parametrize("sw", [16, 48, 64, 128])
def test_parity_rows_give_each_taps_input_column(sw):
    """Tap kw of output voxel ow reads input column 2 ow + kw - 1 (pads of 1),
    and the rows of consecutive voxels are consecutive (one ldmatrix row
    each)."""
    pitch = 2 * sw + 1
    for om in range(3):
        cols = [_staged_column(r, om, sw) for r in range(pitch)]
        assert sorted(cols) == list(range(2 * om * sw - 1, 2 * om * sw + 2 * sw))
        for kw in range(3):
            for ow in range(sw):
                row = _tap_row(kw, ow, sw)
                assert 0 <= row < pitch
                assert _staged_column(row, om, sw) == 2 * (om * sw + ow) + kw - 1
                if ow:
                    assert row == _tap_row(kw, ow - 1, sw) + 1


def emulate_narrow_form(x: torch.Tensor, g: torch.Tensor, plan, pad_lo=1) -> torch.Tensor:
    """dw as the narrow form computes it, in plain torch (the module note)."""
    n, d, h, w, cin = x.shape
    _, do, ho, wo, cout = g.shape
    total, sw, lines = n * do * ho, plan.sw, plan.lines
    pitch, k_seg, bn = 2 * sw + 1, plan.lines * plan.sw, 8 * plan.nt
    xf, gf = x.float(), g.float().reshape(total, wo, cout)
    part = torch.zeros(plan.splits, 27 * cin, cout)
    rows = torch.arange(pitch)
    q = torch.where(rows <= sw, 2 * rows, 2 * (rows - sw) - 1)
    kv = torch.arange(k_seg)
    # tap t of voxel k reads staged row tap_row(t % 3, k % sw) of input line
    # (k // sw, t // 3)
    taps = torch.arange(27)
    a_rows = torch.tensor([[_tap_row(t % 3, k % sw, sw) for k in range(k_seg)]
                           for t in range(27)])
    for c in range(plan.chunks):
        ch = c * 8 + torch.arange(8)
        for nt in range(plan.n_tiles):
            co = nt * bn + torch.arange(bn)
            for s in range(plan.splits):
                acc = torch.zeros(28, 8, bn)
                for seg in range(s * plan.per_split,
                                 min((s + 1) * plan.per_split, plan.segments)):
                    lb, om = divmod(seg, plan.ow_blocks)
                    line = lb * lines + torch.arange(lines)
                    nn, od, oh = line // (do * ho), (line // ho) % do, line % ho
                    staged = torch.zeros(lines, 9, pitch, 8)
                    iw = 2 * om * sw - 1 + q
                    for kk in range(9):
                        iz, iy = 2 * od + kk // 3 - pad_lo, 2 * oh + kk % 3 - 1
                        ok = ((line < total) & (iz >= 0) & (iz < d) & (iy >= 0)
                              & (iy < h))[:, None, None]
                        ok = ok & ((iw >= 0) & (iw < w))[None, :, None] & (ch < cin)
                        vals = xf[nn.clamp(max=n - 1)[:, None, None],
                                  iz.clamp(0, d - 1)[:, None, None],
                                  iy.clamp(0, h - 1)[:, None, None],
                                  iw.clamp(0, w - 1)[None, :, None],
                                  ch.clamp(max=cin - 1)[None, None, :]]
                        staged[:, kk] = torch.where(ok, vals, 0.0)
                    vl, vow = lb * lines + kv // sw, om * sw + kv % sw
                    gok = ((vl < total) & (vow < wo))[:, None] & (co < cout)
                    gs = torch.where(gok, gf[vl.clamp(max=total - 1)[:, None],
                                             vow.clamp(max=wo - 1)[:, None],
                                             co.clamp(max=cout - 1)[None, :]], 0.0)
                    a = torch.zeros(28, k_seg, 8)  # the 28th tap: the zero row
                    a[:27] = staged[(kv // sw)[None, :], (taps // 3)[:, None], a_rows]
                    for k0 in range(0, k_seg, 16):  # one mma per k16 step
                        acc += (a[:, k0:k0 + 16].double().transpose(1, 2)
                                @ gs[k0:k0 + 16].double()).float()
                ci, cc = ch[ch < cin], co[co < cout]
                for tap in range(27):
                    part[s, (tap * cin + ci)[:, None], cc[None, :]] = \
                        acc[tap][:len(ci), :len(cc)]
    dw = part[0]
    for s in range(1, plan.splits):  # the split-K sum's fixed order
        dw = dw + part[s]
    return dw.reshape(3, 3, 3, cin, cout)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(x_shape, cin, cout, pad_lo, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*x_shape, cin).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(*_outputs(x_shape, pad_lo), cout).astype(np.float32))
    return x, g.bfloat16()


@pytest.fixture(scope="module")
def jax_wgrad():
    """JAX's f32 weight gradient of the stride-2 3^3 conv, pads (pad_lo, 1)
    on D and (1, 1) on H and W, jitted per shape."""
    def dw(x, w, g, pad_lo):
        def conv(w):
            return jax.lax.conv_general_dilated(
                x, w, (2, 2, 2), ((pad_lo, 1), (1, 1), (1, 1)),
                dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
                precision=jax.lax.Precision.HIGHEST)
        return jax.vjp(conv, w)[1](g)[0]
    return jax.jit(dw, static_argnums=3)


@pytest.mark.parametrize("pad_lo", [1, 0])
@pytest.mark.parametrize("cin,cout", PAIRS)
def test_emulated_decomposition_matches_reference_and_jax(cin, cout, pad_lo, jax_wgrad):
    """Two input lines a segment (Wo 9 in lines of 16), ragged D and H, 4
    splits of a few segments each."""
    x_shape = (2, 7, 5, 17)
    x, g = _inputs(x_shape, cin, cout, pad_lo, seed=cin * 31 + cout + pad_lo)
    plan = W.narrow_plan(tuple(x.shape), cout, 4, pad_lo)
    assert plan.splits > 1 and plan.lines == 4
    got = emulate_narrow_form(x, g, plan, pad_lo)
    assert _rel(got, W.s2_wgrad_reference(x, g, pad_lo)) < F32
    want = jax_wgrad(jnp.asarray(x.float().numpy()), jnp.zeros((3, 3, 3, cin, cout)),
                     jnp.asarray(g.float().numpy()), pad_lo)
    assert _rel(got, np.asarray(want)) < F32


def test_emulated_decomposition_two_blocks_of_a_long_line():
    """Wo 150 in two x-blocks of 128 (lines of 128 voxels, one a segment),
    two N tiles of 24 (Cout 40), three chunks (Cin 17)."""
    x, g = _inputs((1, 3, 2, 300), 17, 40, 1, seed=5)
    plan = W.narrow_plan(tuple(x.shape), 40, 2)
    assert (plan.ow_blocks, plan.n_tiles, plan.nt, plan.chunks) == (2, 2, 3, 3)
    assert _rel(emulate_narrow_form(x, g, plan), W.s2_wgrad_reference(x, g)) < F32


def test_kernel_form_sends_ragged_bf16_calls_to_narrow():
    for cin, cout in [(c, o) for c in CHANNELS for o in CHANNELS]:
        x = torch.zeros(1, 4, 4, 4, cin, dtype=torch.bfloat16)
        g = torch.zeros(1, 2, 2, 2, cout, dtype=torch.bfloat16)
        want = "wgmma" if cin % 8 == 0 and cout % 8 == 0 else "narrow"
        assert W.kernel_form(x, g) == want
        assert W.kernel_form(x.float(), g.float()) == "tf32x3"
    # a slice one element into its storage is off 16-byte alignment
    x = torch.zeros(1 + 4 * 4 * 4 * 16, dtype=torch.bfloat16)[1:].view(1, 4, 4, 4, 16)
    assert W.kernel_form(x, torch.zeros(1, 2, 2, 2, 16, dtype=torch.bfloat16)) == "narrow"


def test_cpu_bf16_calls_take_the_plain_version_and_count_no_launch():
    W.reset_launches()
    x, g = _inputs((1, 5, 4, 6), 3, 5, 1, seed=1)
    assert torch.equal(W.s2_wgrad(x, g), W.s2_wgrad_reference(x, g))
    assert W.LAUNCHES["s2_wgrad"] == 0 and not W.FORM_LAUNCHES


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _cuda_inputs(device, x_shape, cin, cout, pad_lo=1, seed=7, offset=0):
    x, g = _inputs(x_shape, cin, cout, pad_lo, seed)
    x = x.to(device)
    if offset:
        store = torch.empty(offset + x.numel(), dtype=x.dtype, device=device)
        x = store[offset:].view(x.shape).copy_(x)
    return x, g.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,cin,cout,pad_lo,offset", [
    ((1, 128, 128, 128), 4, 16, 1, 0), ((1, 128, 128, 128), 4, 4, 1, 0),
    ((2, 7, 5, 3), 1, 17, 1, 0), ((1, 9, 13, 17), 3, 12, 1, 0), ((3, 11, 6, 9), 12, 3, 1, 0),
    ((1, 5, 4, 150), 16, 1, 1, 0), ((2, 10, 13, 17), 17, 4, 0, 0), ((1, 9, 13, 17), 4, 16, 1, 1),
    ((1, 16, 16, 16), 64, 96, 1, 1), ((1, 6, 5, 300), 3, 40, 0, 0)])
def test_cuda_narrow_form_matches_plain(cuda_device, x_shape, cin, cout, pad_lo, offset):
    x, g = _cuda_inputs(cuda_device, x_shape, cin, cout, pad_lo, offset=offset)
    W.reset_launches()
    got = W.s2_wgrad(x, g, pad_lo)
    torch.cuda.synchronize()
    assert dict(W.FORM_LAUNCHES) == {("s2_wgrad", "narrow"): 1}
    assert _rel(got.cpu(), W.s2_wgrad_reference(x, g, pad_lo).cpu()) < F32


@pytest.mark.cuda
def test_cuda_narrow_form_is_bit_reproducible(cuda_device):
    """Split-K partials are summed in a fixed order: two calls agree to the bit."""
    x, g = _cuda_inputs(cuda_device, (1, 128, 128, 128), 4, 16, seed=8)
    assert W.narrow_plan(tuple(x.shape), 16, SMS).splits > 1
    first = W.s2_wgrad(x, g)
    second = W.s2_wgrad(x, g)
    torch.cuda.synchronize()
    assert torch.equal(first, second)

"""Host-side logic of the narrow form of the 3x3x3 conv (``ops/conv3d_kernel.py``).

The CUDA kernel (``ops/kernels/conv3d_narrow.cu``) takes its tiling from
``narrow_plan`` and its B operand from ``pack_narrow``: the m16n8k16 B
fragments of ``narrow_weight``, the weight in the kernel's K order (below 16
input channels the taps folded into K, tap * CS + c; from 16 up (chunk, tap,
k16)). These tests hold the plan and the packing by index, and evaluate the
conv in plain torch the way the kernel orders it (the input staged with its
halo and channel padding, the A rows gathered in K order, times the B matrix
unpacked from the fragments) against ``conv3d_reference`` at f32. The
``cuda`` tests of the kernel itself are in ``test_torch_conv3d_tiles.py``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet3d_tpu_torch.ops import conv3d_kernel as K

# (Cin, Cout): the sites (3 -> 3, 16 -> 3, 3 -> 16, 32 -> 4, 1 -> 32, 1 -> 8),
# odd and even Cin below 16, 16 and 32 (one chunk), 40 and 64 (two chunks),
# Cout past one 64-wide N block
CHANNELS = [(3, 3), (16, 3), (3, 16), (32, 4), (1, 32), (1, 8), (6, 12), (8, 5),
            (15, 1), (16, 70), (40, 5), (64, 3), (6, 70)]


def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """The (ksteps * 16, n_blocks * nt * 8) B matrix of ``pack_narrow``'s
    fragments: lane n * 4 + q, element 2 * kh8 + p is row 8 * kh8 + 2q + p,
    column j * 8 + n."""
    nb, s, nt = packed.shape[:3]
    return (packed.view(nb, s, nt, 8, 4, 2, 2).permute(1, 5, 4, 6, 0, 2, 3)
            .reshape(s * 16, nb * nt * 8))


def _k_order_conv(x: torch.Tensor, w: torch.Tensor, pads=K.SAME) -> torch.Tensor:
    """The conv as the narrow kernel computes it, in f32: x zero-padded by
    the D pads and one voxel on H and W (the staged halo), its channels
    zero-padded to the staged width, each output voxel's A row gathered in
    the plan's K order and multiplied by the unpacked B fragments."""
    n, d_in, h, wd, cin = x.shape
    cout = w.shape[4]
    d = K.out_depth(x, pads)
    plan = K.narrow_plan((d, h, wd), cin, cout)
    width = plan.cs if plan.fold else plan.chunks * plan.kh * 16
    xp = F.pad(x.float(), (0, width - cin, 1, 1, 1, 1, *pads))
    taps = [xp[:, dz:dz + d, dy:dy + h, dx:dx + wd].reshape(-1, width)
            for dz in range(3) for dy in range(3) for dx in range(3)]
    if plan.fold:
        a = torch.cat(taps, 1)                      # k = tap * CS + c
    else:
        a = torch.cat([t[:, (c * plan.kh + half) * 16:(c * plan.kh + half + 1) * 16]
                       for c in range(plan.chunks) for t in taps
                       for half in range(plan.kh)], 1)
    a = F.pad(a, (0, plan.ksteps * 16 - a.shape[1]))
    b = _unpack(K.pack_narrow(w.float(), plan))
    return (a @ b)[:, :cout].reshape(n, d, h, wd, cout)


@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_narrow_plan_by_index(cin, cout):
    spatial = (9, 13, 35)
    plan = K.narrow_plan(spatial, cin, cout)
    assert plan.fold == (cin < 16)
    if plan.fold:
        # the taps folded into K: CS = Cin rounded up to even, K = 27 * CS to 16
        assert (plan.cs, plan.kh, plan.chunks) == (cin + cin % 2, 0, 1)
        assert plan.ksteps == -(-27 * plan.cs // 16)
    else:
        # 16 or 32 channels a chunk, rows of 24 or 40 (48 or 80 bytes: an odd
        # number of 16-byte units, so eight ldmatrix rows hit eight bank groups)
        assert plan.kh == (1 if cin <= 16 else 2)
        assert plan.cs == plan.kh * 16 + 8 and (plan.cs * 2 // 16) % 2 == 1
        assert plan.chunks * plan.kh * 16 >= cin > (plan.chunks - 1) * plan.kh * 16
        assert plan.ksteps == plan.chunks * 27 * plan.kh
    assert plan.cs % 2 == 0 and plan.cs >= min(cin, 16)
    # N: 8-wide tiles, the fewest per block that hold Cout up to 32, then 64
    assert plan.nt in (1, 2, 4, 8)
    tiles = -(-cout // 8)
    assert plan.nt == min(8, 1 << (tiles - 1).bit_length())
    assert (plan.n_blocks - 1) * plan.nt * 8 < cout <= plan.n_blocks * plan.nt * 8
    assert plan.bricks == (3, 2, 3)  # 4 x 8 x 16 bricks over 9 x 13 x 35


def test_narrow_plan_at_the_sites():
    """The 128^3 sites' plans: 3 -> 3 in 7 k16 steps (27 taps at 3 of 16
    channels before), 32 -> 4 in 54, one 8-wide N tile where Cout <= 8."""
    cube = (128, 128, 128)
    assert K.narrow_plan(cube, 3, 3) == K.NarrowPlan(True, 4, 0, 1, 7, 1, 1, (32, 16, 8))
    assert K.narrow_plan(cube, 3, 16) == K.NarrowPlan(True, 4, 0, 1, 7, 2, 1, (32, 16, 8))
    assert K.narrow_plan(cube, 1, 32) == K.NarrowPlan(True, 2, 0, 1, 4, 4, 1, (32, 16, 8))
    assert K.narrow_plan(cube, 16, 3) == K.NarrowPlan(False, 24, 1, 1, 27, 1, 1, (32, 16, 8))
    assert K.narrow_plan(cube, 32, 4) == K.NarrowPlan(False, 40, 2, 1, 54, 1, 1, (32, 16, 8))
    # 4096 blocks of 512 voxels at 128^3: 31 an SM of 132
    plan = K.narrow_plan(cube, 3, 3)
    assert np.prod(plan.bricks) * np.prod(K.NARROW_BRICK) == 128 ** 3


@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_narrow_weight_holds_w_in_k_order(cin, cout):
    rng = np.random.RandomState(cin * 100 + cout)
    w = torch.from_numpy(rng.randn(3, 3, 3, cin, cout).astype(np.float32))
    plan = K.narrow_plan((8, 8, 16), cin, cout)
    wk = K.narrow_weight(w, plan)
    assert tuple(wk.shape) == (plan.ksteps * 16, plan.n_blocks * plan.nt * 8)
    wt = w.reshape(27, cin, cout)
    hits = torch.zeros(27, cin, cout, dtype=torch.int64)
    for row in range(wk.shape[0]):
        if plan.fold:
            tap, c = divmod(row, plan.cs)
        else:
            s, k = divmod(row, 16)
            step, half = divmod(s, plan.kh)
            chunk, tap = divmod(step, 27)
            c = (chunk * plan.kh + half) * 16 + k
        if tap < 27 and c < cin:
            assert torch.equal(wk[row, :cout], wt[tap, c])
            hits[tap, c] += 1
        else:
            assert not wk[row].any()
    assert (hits == 1).all()  # every (tap, channel) once
    assert not wk[:, cout:].any()


@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_pack_narrow_lays_out_mma_b_fragments(cin, cout):
    rng = np.random.RandomState(cin + 7 * cout)
    w = torch.from_numpy(rng.randn(3, 3, 3, cin, cout).astype(np.float32)).bfloat16()
    plan = K.narrow_plan((8, 8, 16), cin, cout)
    packed = K.pack_narrow(w, plan)
    assert tuple(packed.shape) == (plan.n_blocks, plan.ksteps, plan.nt, 32, 4)
    assert packed.is_contiguous() and packed.dtype == torch.bfloat16
    wk = K.narrow_weight(w, plan)
    last = (plan.n_blocks - 1, plan.ksteps - 1, plan.nt - 1)
    for nb, s, j in ((0, 0, 0), last, (0, plan.ksteps // 2, plan.nt // 2)):
        for lane in (0, 5, 14, 31):
            n, q = divmod(lane, 4)
            rows = [s * 16 + 2 * q, s * 16 + 2 * q + 1, s * 16 + 2 * q + 8, s * 16 + 2 * q + 9]
            col = (nb * plan.nt + j) * 8 + n
            assert torch.equal(packed[nb, s, j, lane], wk[rows, col])
    assert torch.equal(_unpack(packed), wk)


@pytest.mark.parametrize("shape,cin,cout,pads", [
    ((1, 5, 9, 18), 3, 3, (1, 1)), ((2, 4, 8, 17), 16, 3, (1, 1)),
    ((1, 6, 7, 16), 3, 16, (1, 1)), ((1, 4, 9, 16), 32, 4, (1, 1)),
    ((2, 3, 5, 20), 1, 32, (1, 1)), ((1, 5, 6, 16), 6, 70, (1, 1)),
    ((1, 4, 5, 16), 40, 5, (1, 1)), ((1, 6, 8, 16), 3, 4, (0, 1)),
    ((1, 6, 8, 16), 16, 3, (1, 0)), ((2, 5, 6, 16), 6, 12, (2, 1)),
    ((1, 5, 6, 16), 32, 4, (1, 2))])
def test_k_order_evaluation_matches_the_reference(shape, cin, cout, pads):
    """The kernel's K order, padding and fragments give the conv: f32, to sum
    order (1e-5 of the largest output)."""
    rng = np.random.RandomState(sum(shape) + cin + cout)
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin))
                         .astype(np.float32))
    got = _k_order_conv(x, w, pads)
    want = K.conv3d_reference(x, w, pads)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_kernel_form_sends_misaligned_bf16_to_narrow():
    """A bf16 x at 2-byte alignment (a slice at an odd offset) takes the
    narrow form even where its channel counts suit the wgmma form; f32 the
    tf32x3_narrow form."""
    base = torch.zeros(1 + 4 * 4 * 16 * 16, dtype=torch.bfloat16)
    x = base[1:].view(1, 4, 4, 16, 16)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w = torch.zeros(3, 3, 3, 16, 16, dtype=torch.bfloat16)
    assert K.kernel_form(x, w) == "narrow"
    assert K.kernel_form(base[:-1].view(1, 4, 4, 16, 16), w) == "wgmma"
    xf = torch.zeros(1 + 4 * 4 * 16 * 16)[1:].view(1, 4, 4, 16, 16)
    assert K.kernel_form(xf, w.float()) == "tf32x3_narrow"

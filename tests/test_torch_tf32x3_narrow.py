"""Host-side logic of the f32 narrow form of the 3x3x3 conv
(``tf32x3_narrow``: ``ops/kernels/conv3d_narrow.cu`` instantiated for f32,
m16n8k8 TF32 products in 3xTF32).

The kernel takes its tiling from ``narrow_plan(..., torch.float32)`` and its
B operand from ``pack_narrow``: each lane's TF32 high and low parts of rows
q and q + 4 of ``narrow_weight``, the weight in the kernel's K order (below
16 input channels the taps folded into K, tap * Cin + c; from 16 up (chunk
of 16 channels, tap, k8 step)). These tests hold the plan and the packing by
index, and evaluate the conv in plain torch the way the kernel orders it: the
input staged with its halo and channel padding, the A rows gathered in K
order and split into TF32 hi and lo as the kernel splits them, the three
products lo*hi, hi*lo and hi*hi per k8 step, in TAP mode each chunk's sum
added into the total; against ``conv3d_reference`` (f32) and against the
JAX package's Pallas kernel in interpret mode. The ``cuda`` tests run the
kernel on a GPU and skip without one.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unet3d_tpu.ops.pallas.conv3d_kernel import pallas_conv3d

from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops.conv3d import flip_io

F32 = torch.float32
# (Cin, Cout): the sites (3 -> 3, 3 -> 16), one channel, odd and even Cin
# below 16 (the taps folded), 16 and 40 (one and three 16-channel chunks),
# Cout past one 32-wide N block
CHANNELS = [(3, 3), (3, 16), (1, 8), (1, 32), (6, 12), (15, 1), (7, 33), (16, 3),
            (16, 70), (40, 5), (6, 70)]


def _unpack(packed: torch.Tensor):
    """(hi, lo): the (ksteps * 8, n_blocks * nt * 8) B matrices of an f32
    plan's fragments: lane n * 4 + q, element 2 * part + half is row
    8 s + 4 half + q of part (hi, lo), column j * 8 + n."""
    nb, s, nt = packed.shape[:3]
    parts = (packed.view(nb, s, nt, 8, 4, 2, 2).permute(5, 1, 6, 4, 0, 2, 3)
             .reshape(2, s * 8, nb * nt * 8))
    return parts[0], parts[1]


def _k_order_rows(x: torch.Tensor, plan, pads):
    """Each output voxel's A row in the plan's K order, f32: x zero-padded by
    the D pads and one voxel on H and W (the staged halo), its channels
    zero-padded to the staged width."""
    n, d_in, h, wd, cin = x.shape
    d = d_in - 2 + pads[0] + pads[1]
    width = plan.cs if plan.fold else plan.chunks * plan.kh * plan.kd
    xp = F.pad(x.float(), (0, width - cin, 1, 1, 1, 1, *pads))
    taps = [xp[:, dz:dz + d, dy:dy + h, dx:dx + wd].reshape(-1, width)
            for dz in range(3) for dy in range(3) for dx in range(3)]
    if plan.fold:
        a = torch.cat(taps, 1)                      # k = tap * CS + c
    else:
        a = torch.cat([t[:, (c * plan.kh + half) * plan.kd:(c * plan.kh + half + 1) * plan.kd]
                       for c in range(plan.chunks) for t in taps
                       for half in range(plan.kh)], 1)
    return F.pad(a, (0, plan.ksteps * plan.kd - a.shape[1])), (n, d, h, wd)


def _tf32x3_conv(x: torch.Tensor, w: torch.Tensor, pads=K.SAME) -> torch.Tensor:
    """The conv as the tf32x3_narrow kernel computes it: A split into TF32
    hi and lo (``tf32_split``, the kernel's cvt.rna), B unpacked from the
    fragments, the three products of each k8 step (the products of TF32
    values and their sums in f64, where the tensor cores' own sums differ
    from f32 by their rounding alone), in TAP mode each chunk's sum added
    into the total; rounded to f32 once."""
    cout = w.shape[4]
    plan = K.narrow_plan((K.out_depth(x, pads), *x.shape[2:4]), x.shape[4], cout, F32)
    a, out_shape = _k_order_rows(x, plan, pads)
    ahi, alo = K.tf32_split(a)
    bhi, blo = _unpack(K.pack_narrow(w.float(), plan))
    ahi, alo, bhi, blo = (t.double() for t in (ahi, alo, bhi, blo))
    chunk_k = a.shape[1] if plan.fold else 27 * plan.kh * plan.kd
    y = torch.zeros(a.shape[0], bhi.shape[1], dtype=torch.float64)
    for k0 in range(0, a.shape[1], chunk_k):
        k = slice(k0, k0 + chunk_k)
        y += alo[:, k] @ bhi[k] + ahi[:, k] @ blo[k] + ahi[:, k] @ bhi[k]
    return y[:, :cout].float().reshape(*out_shape, cout)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_f32_narrow_plan_by_index(cin, cout):
    spatial = (9, 13, 35)
    plan = K.narrow_plan(spatial, cin, cout, F32)
    assert plan.kd == 8 and plan.fold == (cin < 16)
    if plan.fold:
        # the taps folded into K: CS = Cin (one f32 a 32-bit word), K = 27 * CS to 8
        assert (plan.cs, plan.kh, plan.chunks) == (cin, 0, 1)
        assert plan.ksteps == -(-27 * cin // 8)
    else:
        # 16 channels a chunk, two k8 steps a tap, rows of 20 floats (80
        # bytes: an odd number of 16-byte units, so eight ldmatrix rows hit
        # eight bank groups)
        assert (plan.kh, plan.cs) == (2, 20) and (plan.cs * 4 // 16) % 2 == 1
        assert plan.chunks * 16 >= cin > (plan.chunks - 1) * 16
        assert plan.ksteps == plan.chunks * 27 * 2
    # N: 8-wide tiles, the fewest per block that hold Cout up to 32, then 32
    tiles = -(-cout // 8)
    assert plan.nt == min(4, 1 << (tiles - 1).bit_length())
    assert plan.n_blocks == -(-tiles // plan.nt)
    assert plan.bricks == tuple(-(-s // b) for s, b in zip(spatial, K.NARROW_BRICK))


@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_f32_plan_covers_every_voxel_tap_and_channel_once(cin, cout):
    """Each (tap, input channel) is exactly one row of the K order, each
    output channel exactly one column of one (N block, tile); the rows and
    columns past them are zero; the bricks cover every voxel once."""
    spatial = (9, 13, 35)
    plan = K.narrow_plan(spatial, cin, cout, F32)
    w = torch.arange(1, 27 * cin * cout + 1, dtype=torch.float64).reshape(3, 3, 3, cin, cout)
    wk = K.narrow_weight(w, plan)
    assert wk.shape == (plan.ksteps * 8, plan.n_blocks * plan.nt * 8)
    values = wk[wk != 0]
    assert sorted(values.tolist()) == list(range(1, 27 * cin * cout + 1))
    assert bool((wk[:, cout:] == 0).all())
    brick = np.array(K.NARROW_BRICK)
    starts = np.stack(np.meshgrid(*[np.arange(b) * s for b, s in zip(plan.bricks, brick)],
                                  indexing="ij"), -1).reshape(-1, 3)
    covered = np.zeros(spatial, int)
    for z, y, x in starts:
        covered[z:z + brick[0], y:y + brick[1], x:x + brick[2]] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_pack_narrow_f32_round_trips_with_zeros_past_cin_and_cout(cin, cout):
    rng = np.random.RandomState(cin * 100 + cout)
    w = torch.from_numpy(rng.randn(3, 3, 3, cin, cout).astype(np.float32))
    plan = K.narrow_plan((8, 8, 16), cin, cout, F32)
    packed = K.pack_narrow(w, plan)
    assert packed.shape == (plan.n_blocks, plan.ksteps, plan.nt, 32, 4)
    hi, lo = _unpack(packed)
    want = K.narrow_weight(w, plan)
    assert torch.equal(hi, K.tf32_split(want)[0]) and torch.equal(lo, K.tf32_split(want)[1])
    # hi is TF32 (low 13 bits zero) and hi + lo recovers w to 2^-22
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all())
    assert bool(((hi.double() + lo.double() - want.double()).abs()
                 <= 2.0 ** -22 * want.double().abs()).all())
    if plan.fold:  # the rows past 27 * Cin
        assert bool((hi[27 * cin:] == 0).all() and (lo[27 * cin:] == 0).all())
    assert bool((hi[:, cout:] == 0).all() and (lo[:, cout:] == 0).all())


@pytest.mark.parametrize("shape,cin,cout,pads", [
    ((2, 5, 7, 19), 3, 3, K.SAME), ((1, 6, 9, 17), 3, 16, K.SAME),
    ((1, 5, 6, 18), 1, 33, K.SAME), ((2, 4, 5, 9), 7, 12, (0, 1)),
    ((1, 5, 6, 17), 16, 3, (1, 0)), ((1, 4, 5, 9), 3, 16, (2, 1)),
    ((1, 4, 3, 18), 40, 5, (1, 2)), ((1, 3, 4, 5), 15, 70, K.SAME)])
def test_tf32x3_k_order_evaluation_matches_the_reference(shape, cin, cout, pads):
    rng = np.random.RandomState(sum(shape) + cin + cout)
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin))
                         .astype(np.float32))
    got = _tf32x3_conv(x, w, pads)
    want = K.conv3d_reference(x, w, pads)
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-6


def test_tf32x3_k_order_evaluation_matches_the_pallas_kernel():
    """3 -> 3 channels, and the input gradient of a 16 -> 3
    conv (3 -> 16 on the flipped weight), against the JAX package's Pallas
    conv in interpret mode (f32)."""
    rng = np.random.RandomState(3)
    for cin, cout in ((3, 3), (3, 16)):
        x = rng.randn(1, 4, 8, 16, cin).astype(np.float32)
        w = (rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = pallas_conv3d(jnp.asarray(x), jnp.asarray(w))
        got = _tf32x3_conv(torch.from_numpy(x), torch.from_numpy(w))
        assert _rel(got, want) < 1e-5


def test_kernel_form_sends_other_f32_calls_to_tf32x3_narrow():
    for cin in (1, 3, 6, 15, 33):
        assert K.kernel_form(torch.zeros(1, 4, 4, 4, cin),
                             torch.zeros(3, 3, 3, cin, 16)) == "tf32x3_narrow"
    # Cin a multiple of 4 at 4-byte alignment (a slice one element in)
    x = torch.zeros(1 + 4 * 4 * 4 * 8)[1:].view(1, 4, 4, 4, 8)
    assert K.kernel_form(x, torch.zeros(3, 3, 3, 8, 16)) == "tf32x3_narrow"
    assert K.kernel_form(torch.zeros(1, 4, 4, 4, 8), torch.zeros(3, 3, 3, 8, 16)) == "tf32x3"
    # the bf16 plan of the same shape is the m16n8k16 one
    assert K.narrow_plan((4, 4, 4), 3, 3).kd == 16
    assert K.narrow_plan((4, 4, 4), 3, 3, F32).kd == 8


def test_cpu_calls_take_the_plain_version_and_count_no_launch():
    K.reset_launches()
    x, w = torch.randn(1, 4, 5, 6, 3), torch.randn(3, 3, 3, 3, 3)
    assert torch.equal(K.conv3x3x3(x, w), K.conv3d_reference(x, w))
    assert not any(K.LAUNCHES.values()) and not K.FORM_LAUNCHES


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _stats_rel(y, s1, s2) -> float:
    """The statistics against an f64 sum of the kernel's own y."""
    yd = y.double()
    return max(float((s1 - yd.sum((1, 2, 3))).abs().max() / yd.abs().sum((1, 2, 3)).max()),
               float((s2 - (yd * yd).sum((1, 2, 3))).abs().max()
                     / (yd * yd).sum((1, 2, 3)).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout,pads,offset", [
    ((1, 128, 128, 128), 3, 3, K.SAME, 0), ((1, 128, 128, 128), 3, 16, K.SAME, 0),
    ((2, 13, 21, 30), 1, 1, K.SAME, 0), ((2, 13, 21, 30), 6, 12, K.SAME, 0),
    ((2, 13, 21, 30), 15, 70, K.SAME, 0), ((2, 13, 21, 30), 16, 4, K.SAME, 1),
    ((2, 13, 21, 30), 33, 40, K.SAME, 1), ((2, 13, 21, 30), 3, 3, (0, 1), 0),
    ((2, 13, 21, 30), 17, 3, (1, 0), 0), ((2, 13, 21, 30), 3, 16, (2, 1), 0),
    ((2, 13, 21, 30), 32, 4, (1, 2), 1)])
def test_cuda_tf32x3_narrow_matches_the_plain_f32_versions(cuda_device, shape, cin, cout,
                                                           pads, offset):
    """All three variants and the input gradient, in the tf32x3_narrow form,
    within 1e-5 of the plain f32 version on y and 1e-4 on the statistics."""
    gen = torch.Generator(device=cuda_device).manual_seed(cin * 1000 + cout)
    x = torch.randn(*shape, cin, device=cuda_device, generator=gen)
    if offset:
        store = torch.empty(offset + x.numel(), device=cuda_device)
        x = store[offset:].view(x.shape).copy_(x)
    w = torch.randn(3, 3, 3, cin, cout, device=cuda_device, generator=gen) / (27 * cin) ** 0.5
    inv = torch.rand(shape[0], cin, device=cuda_device, generator=gen) + 0.5
    shift = torch.randn(shape[0], cin, device=cuda_device, generator=gen) * 0.3
    K.reset_launches()
    y = K.conv3x3x3(x, w, pads)
    ys, s1, s2 = K.conv3x3x3_with_stats(x, w, pads)
    yb, b1, b2 = K.conv3x3x3_block_with_stats(x, w, inv, shift, pads=pads)
    torch.cuda.synchronize()
    assert dict(K.FORM_LAUNCHES) == {("conv", "tf32x3_narrow"): 1,
                                     ("conv_stats", "tf32x3_narrow"): 1,
                                     ("block_stats", "tf32x3_narrow"): 1}
    # the plain versions on an aligned copy (cuDNN faults on an f32 x 4 bytes
    # off 16-byte alignment)
    xr = x.clone()
    want = K.conv3d_reference(xr, w, pads)
    assert _rel(y.cpu(), want.cpu()) < 1e-5 and _rel(ys.cpu(), want.cpu()) < 1e-5
    assert _stats_rel(ys, s1, s2) < 1e-4
    want_b = K.conv3d_block_with_stats_reference(xr, w, inv, shift, pads=pads)
    assert _rel(yb.cpu(), want_b[0].cpu()) < 1e-5
    assert _stats_rel(yb, b1, b2) < 1e-4
    if pads == K.SAME and cin % 4:
        g = torch.randn(*y.shape, device=cuda_device, generator=gen)
        dx = K.conv3x3x3(g, flip_io(w))  # Cout as Cin: tf32x3 or tf32x3_narrow by Cout
        assert _rel(dx.cpu(), K.conv3d_reference(g, flip_io(w)).cpu()) < 1e-5

"""The f32 form of the 3x3x3 conv on the tensor cores in 3xTF32
(``ops/kernels/conv3d_tf32x3.cu``) and the port's f32 precision policy.

On the CPU: the TF32 split (``tf32_round`` rounds as ``cvt.rna.tf32.f32``
does, against an independent float64 rounding; hi + lo recovers f32 values
to 2^-22), the arithmetic the kernel follows (hi*hi + hi*lo + lo*hi summed in
f64 lies within 2e-6 of an f64 conv), the tiling (``tf32_plan``) and packing
(``pack_tf32``) that the kernel reads, and the routing of f32 calls. The
``cuda`` tests hold the kernel against the plain f32 version at the
SegResNetVAE decoder's and the DynUNet's f32 sites and at ragged shapes, and
the f32 paths under torch's default TF32 flags against the full-f32 plain
path; they skip without a GPU.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops.conv3d import flip_io
from unet3d_tpu_torch.utils.device import full_f32

SMEM_PER_BLOCK = 232448  # bytes a block of an H100 can use
SMEM_PER_SM = 233472     # bytes an H100 SM holds, 1024 reserved per block
F32_MAX = float(np.finfo(np.float32).max)


def _rna_tf32(v: np.ndarray) -> np.ndarray:
    """f32 values rounded to 10 mantissa bits, to nearest with ties away
    from zero, in float64 arithmetic (an independent spelling of the rule)."""
    v = v.astype(np.float64)
    mag = np.abs(v)
    _, exp = np.frexp(np.where(mag > 0, mag, 1.0))  # mag = m * 2^exp, m in [0.5, 1)
    step = np.ldexp(1.0, np.maximum(exp - 1, -126) - 10)  # subnormals: 2^-136
    out = np.sign(v) * np.floor(mag / step + 0.5) * step
    with np.errstate(over="ignore"):  # beyond the f32 maximum: inf, as cvt.rna gives
        return np.where(np.isinf(v), v, out).astype(np.float32)


def _edge_values() -> np.ndarray:
    tiny = np.finfo(np.float32).tiny  # 2^-126, the smallest normal
    bits = np.array([0x3F801000, 0x3F802FFF, 0x3F803000, 0x3FFFF000, 0x00001000,
                     0x00003000, 0x7F7FEFFF, 0x7F7FF000], np.uint32)
    at_ties = bits.view(np.float32)  # low 13 bits at, below and above 0x1000
    return np.concatenate([
        [0.0, -0.0, 1.0, -1.0, tiny, -tiny, tiny / 3, 1e-40, -3e-42, 1.4e-45,
         1e30, -1e30, 3.0e38, -3.3e38, np.inf, -np.inf],
        at_ties, -at_ties]).astype(np.float32)


def test_tf32_round_is_round_to_nearest_away():
    rng = np.random.RandomState(0)
    v = np.concatenate([rng.randn(4096) * 10.0 ** rng.randint(-40, 38, 4096),
                        _edge_values()]).astype(np.float32)
    hi = K.tf32_round(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(hi, _rna_tf32(v))
    assert not (hi.view(np.uint32) & 0x1FFF).any()  # low 13 mantissa bits zero
    assert (np.signbit(hi) == np.signbit(v)).all()
    # a tie rounds away from zero; the largest finite values round to inf
    tie = np.array([0x3F801000], np.uint32).view(np.float32)
    assert K.tf32_round(torch.from_numpy(tie)).numpy().view(np.uint32)[0] == 0x3F802000
    top = np.array([F32_MAX, -F32_MAX], np.float32)
    np.testing.assert_array_equal(K.tf32_round(torch.from_numpy(top)).numpy(),
                                  [np.inf, -np.inf])


def test_tf32_split_recovers_f32_to_2_pow_minus_22():
    rng = np.random.RandomState(1)
    v = np.concatenate([rng.randn(4096) * 10.0 ** rng.randint(-44, 37, 4096),
                        _edge_values()]).astype(np.float32)
    v = v[np.isfinite(v) & (np.abs(v) < 3.39e38)]  # hi overflows above (rna)
    hi, lo = (t.numpy() for t in K.tf32_split(torch.from_numpy(v)))
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    err = np.abs(v.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    # 2^-137: half the TF32 step of subnormals, where lo runs out of bits
    assert (err <= np.maximum(2.0 ** -22 * np.abs(v.astype(np.float64)), 2.0 ** -137)).all()
    # lo is at most half of hi's step, plus one TF32 subnormal step
    assert (np.abs(lo.astype(np.float64)) <= 2.0 ** -11 * np.abs(v) + 2.0 ** -136).all()
    zeros = K.tf32_split(torch.tensor([0.0, -0.0]))
    assert all(float(t.abs().max()) == 0.0 for t in zeros)


def _conv64(x, w):
    """f64 3x3x3 SAME conv of NDHWC x, DHWIO w."""
    y = F.conv3d(x.double().permute(0, 4, 1, 2, 3), w.double().permute(4, 3, 0, 1, 2),
                 padding=1)
    return y.permute(0, 2, 3, 4, 1)


@pytest.mark.parametrize("shape,cin,cout", [((1, 6, 5, 7), 32, 16), ((2, 4, 6, 5), 12, 8)])
def test_three_tf32_products_hold_f32_accuracy(shape, cin, cout):
    """The kernel's arithmetic, emulated: the three TF32 products hi*hi +
    hi*lo + lo*hi summed in f64 lie within 2e-6 (relative to the largest
    output) of the f64 conv; one TF32 product (hi*hi) alone does not."""
    rng = np.random.RandomState(cin + cout)
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin)).astype(np.float32))
    (xh, xl), (wh, wl) = K.tf32_split(x), K.tf32_split(w)
    want = _conv64(x, w)
    three = _conv64(xl, wh) + _conv64(xh, wl) + _conv64(xh, wh)
    scale = float(want.abs().max())
    assert float((three - want).abs().max()) / scale < 2e-6
    assert float((_conv64(xh, wh) - want).abs().max()) / scale > 1e-4


# (D, H, W), Cin, Cout: SegResNetVAE's f32 decoder sites, the DynUNet's f32
# sites and input gradients, ragged volumes and channel counts
PLANS = [
    ((128, 128, 128), 32, 32), ((64, 64, 64), 64, 64), ((32, 32, 32), 128, 128),
    ((128, 128, 128), 4, 64), ((128, 128, 128), 64, 64), ((128, 128, 128), 128, 64),
    ((128, 128, 128), 64, 128), ((64, 64, 64), 96, 96), ((64, 64, 64), 192, 96),
    ((4, 4, 4), 384, 384), ((8, 8, 8), 512, 256), ((9, 12, 20), 36, 96),
    ((5, 7, 33), 4, 4), ((7, 9, 20), 4, 7), ((3, 5, 17), 200, 320), ((5, 7, 9), 8, 16),
]


def _block_rows(plan, spatial):
    """(z, y, x) of every row of every block along the volume, and whether
    it lies inside, decoded as the kernel decodes blockIdx and rows."""
    bz, by, bx = plan.brick
    nz, ny, nx = plan.bricks
    r = np.arange(bz * by * bx)
    rz, ry, rx = r // (bx * by), (r // bx) % by, r % bx
    blocks = np.arange(nz * ny * nx)
    x0 = (blocks % nx) * bx
    y0 = ((blocks // nx) % ny) * by
    z0 = (blocks // (nx * ny)) * bz
    coords = np.stack([z0[:, None] + rz, y0[:, None] + ry, x0[:, None] + rx], -1)
    return coords, (coords < np.array(spatial)).all(-1)


@pytest.mark.parametrize("spatial,cin,cout", PLANS)
def test_tf32_plan_covers_every_voxel_and_channel_once(spatial, cin, cout):
    plan = K.tf32_plan(spatial, cin, cout)
    bz, by, bx, bn, m_tiles, _, halos, _ = K.TF32_CONFIGS[plan.config]
    assert (bz, by, bx) == plan.brick and bn == plan.bn
    assert halos == 2 or plan.chunks == 1  # one halo buffer holds one chunk only
    assert bz * by * bx == 2 * m_tiles * 64  # two warpgroups of 64-row tiles
    coords, inside = _block_rows(plan, spatial)
    hits = np.zeros(spatial, np.int64)
    np.add.at(hits, tuple(coords[inside].T), 1)
    assert (hits == 1).all()
    channels = np.zeros(plan.n_tiles * plan.bn, np.int64)
    for t in range(plan.n_tiles):
        channels[t * plan.bn:(t + 1) * plan.bn] += 1
    assert (channels[:cout] == 1).all() and plan.n_tiles * plan.bn - cout < plan.bn
    assert plan.chunks * K.TF32_CHUNK >= cin > (plan.chunks - 1) * K.TF32_CHUNK
    # one N tile up to 128 channels (V's 32-channel sites a 32-wide one)
    assert plan.bn <= K.TF32_MAX_BN and (plan.n_tiles == 1) == (cout <= K.TF32_MAX_BN)
    if cout <= 64:
        assert plan.bn == next(c[3] for c in K.TF32_CONFIGS if c[3] >= cout)


@pytest.mark.parametrize("config", range(len(K.TF32_CONFIGS)))
def test_tf32_configs_fit_one_block(config):
    """The kernel's static_asserts, mirrored: halo buffers, the hi + lo B
    ring and the alignment slack fit a block's shared memory as many times
    as the blocks per SM; the f32 output tile and the statistics fit the
    buffers they reuse."""
    bz, by, bx, bn, m_tiles, stages, halos, blocks = K.TF32_CONFIGS[config]
    halo = -(-(bz + 2) * (by + 2) * (bx + 2) * 128 // 1024) * 1024
    ring = stages * 2 * bn * 128
    smem = halos * halo + ring + 1024
    assert smem <= SMEM_PER_BLOCK and blocks * (smem + 1024) <= SMEM_PER_SM
    assert bz * by * bx * (4 * bn + 32) <= halos * halo
    assert 2 * 8 * bn * 4 <= ring
    assert bn % 8 == 0 and bn <= K.TF32_MAX_BN and bx % 8 == 0 and stages >= 3


def _unpack(packed, cin, cout):
    """hi and lo DHWIO weights of ``pack_tf32``'s tiles."""
    n_tiles, chunks, _, _, bn, ck = packed.shape
    w = packed.permute(3, 2, 1, 5, 0, 4).reshape(2, 27, chunks * ck, n_tiles * bn)
    return w[:, :, :cin, :cout].reshape(2, 3, 3, 3, cin, cout)


@pytest.mark.parametrize("cin,cout,bn", [(32, 32, 32), (64, 64, 64), (128, 128, 128),
                                         (4, 7, 8), (36, 96, 96), (200, 320, 128)])
def test_pack_tf32_round_trips_and_lays_out_k_major_tiles(cin, cout, bn):
    rng = np.random.RandomState(cin + cout)
    w = torch.from_numpy(rng.randn(3, 3, 3, cin, cout).astype(np.float32))
    packed = K.pack_tf32(w, bn)
    chunks, n_tiles = -(-cin // 32), -(-cout // bn)
    assert tuple(packed.shape) == (n_tiles, chunks, 27, 2, bn, 32) and packed.is_contiguous()
    hi, lo = K.tf32_split(w)
    assert torch.equal(_unpack(packed, cin, cout), torch.stack([hi, lo]))
    err = (w.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * w.double().abs()).all())
    for t, c, tap, part, n, k in ((0, 0, 0, 0, 0, 0), (n_tiles - 1, chunks - 1, 26, 1, bn - 1, 31),
                                  (0, chunks - 1, 13, 1, 5, 3)):
        ci, co = c * 32 + k, t * bn + n
        want = 0.0
        if ci < cin and co < cout:
            want = float((hi, lo)[part][tap // 9, (tap // 3) % 3, tap % 3, ci, co])
        assert float(packed[t, c, tap, part, n, k]) == want


def test_kernel_form_routes_f32_by_cin():
    w = torch.zeros(3, 3, 3, 64, 7)
    assert K.kernel_form(torch.zeros(1, 4, 4, 4, 64), w) == "tf32x3"
    assert K.kernel_form(torch.zeros(1, 4, 4, 4, 4), torch.zeros(3, 3, 3, 4, 4)) == "tf32x3"
    for cin in (1, 2, 6, 33):
        assert K.kernel_form(torch.zeros(1, 4, 4, 4, cin),
                             torch.zeros(3, 3, 3, cin, 32)) == "tf32x3_narrow"
    # a view 8 bytes into its storage has no 16-byte rows
    x = torch.zeros(1 * 4 * 4 * 4 * 64 + 2)[2:].view(1, 4, 4, 4, 64)
    assert K.kernel_form(x, torch.zeros(3, 3, 3, 64, 32)) == "tf32x3_narrow"


def test_full_f32_is_a_no_op_off_the_card():
    before = (torch.backends.cudnn.conv.fp32_precision,
              torch.backends.cuda.matmul.fp32_precision)
    with full_f32(torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)):
        inside = (torch.backends.cudnn.conv.fp32_precision,
                  torch.backends.cuda.matmul.fp32_precision)
    assert inside == before


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _stats_rel(y, s1, s2) -> float:
    """The statistics against an f64 sum of the kernel's own y."""
    yd = y.double()
    return max(float((s1 - yd.sum((1, 2, 3))).abs().max() / yd.abs().sum((1, 2, 3)).max()),
               float((s2 - (yd * yd).sum((1, 2, 3))).abs().max()
                     / (yd * yd).sum((1, 2, 3)).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", [
    # SegResNetVAE's decoder (up2, up1, up0) and the DynUNet's f32 sites
    ((1, 128, 128, 128), 32, 32), ((1, 64, 64, 64), 64, 64), ((1, 32, 32, 32), 128, 128),
    ((1, 128, 128, 128), 4, 64), ((1, 128, 128, 128), 64, 64),
    ((1, 128, 128, 128), 128, 64), ((1, 64, 64, 64), 96, 96), ((1, 64, 64, 64), 192, 96),
    ((1, 4, 4, 4), 384, 384),
    # ragged: volumes off the brick, two items straddling a brick, 4 channels
    ((1, 9, 12, 20), 36, 96), ((2, 5, 7, 33), 4, 4), ((2, 7, 9, 20), 4, 7),
    ((1, 3, 5, 17), 200, 320), ((2, 6, 9, 18), 128, 64), ((2, 9, 6, 20), 32, 32)])
def test_cuda_tf32x3_matches_the_plain_f32_versions(cuda_device, shape, cin, cout):
    """All three variants, forward and input gradient (the conv on the
    flipped, io-swapped weight), within 1e-5 of the plain f32 version on y
    and 1e-4 on the statistics, every call in the tf32x3 form but a dx of
    Cout 7 (the tf32x3_narrow form)."""
    gen = torch.Generator(device=cuda_device).manual_seed(cin * 1000 + cout)
    x = torch.randn(*shape, cin, device=cuda_device, generator=gen)
    w = torch.randn(3, 3, 3, cin, cout, device=cuda_device, generator=gen) / (27 * cin) ** 0.5
    g = torch.randn(*shape, cout, device=cuda_device, generator=gen)
    inv = torch.rand(shape[0], cin, device=cuda_device, generator=gen) + 0.5
    shift = torch.randn(shape[0], cin, device=cuda_device, generator=gen) * 0.3
    K.reset_launches()
    y = K.conv3x3x3(x, w)
    dx = K.conv3x3x3(g, flip_io(w))
    ys, s1, s2 = K.conv3x3x3_with_stats(x, w)
    yb, b1, b2 = K.conv3x3x3_block_with_stats(x, w, inv, shift)
    torch.cuda.synchronize()
    # the dx takes Cout as its Cin: no multiple of 4 goes to the narrow form
    dx_form = "tf32x3" if cout % 4 == 0 else "tf32x3_narrow"
    assert sorted(K.FORM_LAUNCHES.elements()) == sorted([
        ("conv", "tf32x3"), ("conv", dx_form), ("conv_stats", "tf32x3"),
        ("block_stats", "tf32x3")])
    assert _rel(y, K.conv3d_reference(x, w)) < 1e-5
    assert _rel(dx, K.conv3d_reference(g, flip_io(w))) < 1e-5
    assert _rel(ys, K.conv3d_reference(x, w)) < 1e-5
    assert _stats_rel(ys, s1, s2) < 1e-4
    want_b = K.conv3d_block_with_stats_reference(x, w, inv, shift)
    assert _rel(yb, want_b[0]) < 1e-5
    assert _stats_rel(yb, b1, b2) < 1e-4


def _rel_l2(got, want) -> float:
    num = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(got, want))
    den = sum(float(b.double().square().sum()) for b in want)
    return (num / den) ** 0.5


@pytest.mark.cuda
def test_cuda_f32_paths_stay_full_f32_under_torch_default_tf32_flags(cuda_device):
    """With cuDNN's TF32 on (torch's default), an f32 SegResNetVAE train
    step's gradients and an f32 stride-2 conv (forward and gradients) match
    the full-f32 plain path within 1e-5 relative L2 (TF32 would be ~1e-3),
    and each of the kernel path and the plain path matches itself run with
    TF32 off. The flags found are restored."""
    from unet3d_tpu_torch.models import layers
    from unet3d_tpu_torch.models.layers import init_parameters
    from unet3d_tpu_torch.models.registry import create_model
    from unet3d_tpu_torch.ops.conv3d import _pads, conv3d, conv3d_torch
    from unet3d_tpu_torch.train.losses import DiceLoss
    from unet3d_tpu_torch.train.step import forward_loss, noise_generator

    model = create_model("SegResNetVAE", input_image_size=[32, 32, 32], init_filters=8,
                         in_channels=4, out_channels=3, blocks_down=[1, 2, 2],
                         blocks_up=[1, 1], vae_nz=16, smallest_filters=4)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(cuda_device)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 32, 32, 32, 4).astype(np.float32)).to(cuda_device)
    y = torch.from_numpy((rng.rand(1, 32, 32, 32, 3) > 0.5).astype(np.float32)).to(cuda_device)
    xs = torch.from_numpy(rng.randn(2, 16, 16, 16, 24).astype(np.float32)).to(cuda_device)
    ws = torch.from_numpy((rng.randn(3, 3, 3, 24, 40) / 25).astype(np.float32)).to(cuda_device)
    criterion = DiceLoss(sigmoid=True)
    params = list(model.parameters())

    def grads():
        loss = forward_loss(model, criterion, x, y, False, noise_generator(model, 0))
        return torch.autograd.grad(loss, params)

    def stride2():
        leaf_x, leaf_w = xs.clone().requires_grad_(), ws.clone().requires_grad_()
        out = conv3d(leaf_x, leaf_w, (2, 2, 2))
        return (out.detach(), *torch.autograd.grad(out.square().sum(), (leaf_x, leaf_w)))

    def plain(xx, ww, strides=(1, 1, 1), padding="SAME"):
        return conv3d_torch(xx, ww, tuple(strides), _pads(padding, ww.shape[:3]))

    legacy = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        got_grads, got_s2 = grads(), stride2()
        real, layers.conv3d = layers.conv3d, plain
        try:
            got_plain = grads()
        finally:
            layers.conv3d = real
        assert torch.backends.cudnn.allow_tf32  # the port restored the flags
        # the reference: the plain path with TF32 off by the caller
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        want_kernels = grads()
        real, layers.conv3d = layers.conv3d, plain
        try:
            want_grads = grads()
        finally:
            layers.conv3d = real
        want_s2 = stride2()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = legacy
    assert _rel_l2(got_grads, want_grads) < 1e-5
    # each path against itself with TF32 off: the policy alone
    assert _rel_l2(got_grads, want_kernels) < 1e-5
    assert _rel_l2(got_plain, want_grads) < 1e-5
    for a, b in zip(got_s2, want_s2):
        assert _rel_l2([a], [b]) < 1e-5

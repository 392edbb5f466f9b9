"""Host-side logic of the wgmma form of the 3x3x3 conv (``ops/conv3d_kernel.py``).

The CUDA kernel (``ops/kernels/conv3d_wgmma.cu``) takes its tiling from
``wgmma_plan`` and its B operand from ``pack_weight``; these tests hold both
on the CPU: every output voxel and channel is owned by exactly one block
row, ragged volumes included, and the packed weight holds the DHWIO weight
in the kernel's (n tile, chunk, tap, BN, 64) order. The ``cuda`` test runs
the kernel at ragged shapes against the plain version and skips without a GPU.
"""
import numpy as np
import pytest
import torch

from unet3d_tpu_torch.ops import conv3d_kernel as K

# (D, H, W), Cin, Cout: the DynUNet's bf16 sites at 128^3, ragged volumes,
# SegResNet's 32-channel level 0, the transformers' decoders and the BasicUNets
PLANS = [
    ((128, 128, 128), 64, 64), ((128, 128, 128), 128, 64), ((128, 128, 128), 64, 128),
    ((64, 64, 64), 96, 96), ((64, 64, 64), 192, 96), ((16, 16, 16), 256, 256),
    ((8, 8, 8), 512, 256), ((4, 4, 4), 384, 384), ((128, 128, 128), 4, 64),
    ((9, 12, 20), 64, 96),
    ((9, 12, 20), 96, 192), ((5, 7, 33), 64, 64), ((3, 5, 17), 200, 320),
    # the Myronenko family's bf16 sites narrower than a 64-wide tile
    ((128, 128, 128), 4, 32), ((128, 128, 128), 32, 32),
    # UNETR's (feature 16) and SwinUNETR's (feature 48) UnetResBlock sites
    # and their input gradients: Cout 16 and 48 in a 64-wide tile, Cin 48 a
    # part-filled chunk, Cin 768 twelve chunks at 4^3
    ((128, 128, 128), 4, 16), ((128, 128, 128), 16, 16), ((128, 128, 128), 32, 16),
    ((64, 64, 64), 32, 32), ((128, 128, 128), 16, 32),
    ((128, 128, 128), 4, 48), ((128, 128, 128), 48, 48), ((128, 128, 128), 96, 48),
    ((64, 64, 64), 96, 48), ((32, 32, 32), 192, 96), ((4, 4, 4), 768, 768),
    ((128, 128, 128), 48, 96), ((64, 64, 64), 48, 96), ((32, 32, 32), 96, 192),
    # BasicUNet's and BasicUNetPlusPlus's UpCats: Cout 32 at 128^3 from the
    # concatenated 64, 96, 128 and 160 channels (96 and 160 part-filled
    # chunks), the input gradient 32 -> 64, 256 -> 128 at 16^3
    ((128, 128, 128), 64, 32), ((128, 128, 128), 96, 32), ((128, 128, 128), 128, 32),
    ((128, 128, 128), 160, 32), ((128, 128, 128), 32, 64), ((16, 16, 16), 256, 128),
]
SMEM_PER_BLOCK = 232448  # bytes a block of an H100 can use
SMEM_PER_SM = 233472     # bytes an H100 SM holds, 1024 reserved per block


def _block_rows(plan, spatial):
    """(z, y, x) of every row of every block along the volume, -1 where the
    row lies outside it, decoded as the kernel decodes blockIdx and rows."""
    bz, by, bx = plan.brick
    nz, ny, nx = plan.bricks
    r = np.arange(bz * by * bx)
    rz, ry, rx = r // (bx * by), (r // bx) % by, r % bx
    blocks = np.arange(nz * ny * nx)
    x0 = (blocks % nx) * bx
    y0 = ((blocks // nx) % ny) * by
    z0 = (blocks // (nx * ny)) * bz
    coords = np.stack([z0[:, None] + rz, y0[:, None] + ry, x0[:, None] + rx], -1)
    inside = (coords < np.array(spatial)).all(-1)
    return coords, inside


def _unpack_weight(packed, cin, cout):
    """The DHWIO weight of ``pack_weight``'s tiles."""
    n_tiles, chunks, _, bn, _ = packed.shape
    w = packed.permute(2, 1, 4, 0, 3).reshape(27, chunks * 64, n_tiles * bn)
    return w[:, :cin, :cout].reshape(3, 3, 3, cin, cout)


@pytest.mark.parametrize("spatial,cin,cout", PLANS)
def test_wgmma_plan_covers_every_voxel_and_channel_once(spatial, cin, cout):
    plan = K.wgmma_plan(spatial, cin, cout)
    bz, by, bx, bn, m_tiles, stages, halos, _ = K.WGMMA_CONFIGS[plan.config]
    assert (bz, by, bx) == plan.brick and bn == plan.bn
    assert halos == 2 or plan.chunks == 1  # one halo buffer holds one chunk only
    assert bz * by * bx == 2 * m_tiles * 64  # two warpgroups of 64-row tiles
    assert plan.bricks == tuple(-(-n // b) for n, b in zip(spatial, plan.brick))
    coords, inside = _block_rows(plan, spatial)
    hits = np.zeros(spatial, np.int64)
    np.add.at(hits, tuple(coords[inside].T), 1)
    assert (hits == 1).all()
    channels = np.zeros(plan.n_tiles * plan.bn, np.int64)
    for t in range(plan.n_tiles):
        channels[t * plan.bn:(t + 1) * plan.bn] += 1
    assert (channels[:cout] == 1).all() and plan.n_tiles * plan.bn - cout < plan.bn
    assert plan.chunks * K.CHUNK >= cin > (plan.chunks - 1) * K.CHUNK
    # BN = Cout up to 256, so one staged input brick serves every channel
    assert plan.n_tiles == 1 or cout > 256


@pytest.mark.parametrize("config", range(len(K.WGMMA_CONFIGS)))
def test_wgmma_configs_fit_one_block(config):
    """The halo buffers, the B ring and the 1024-byte alignment slack fit a
    block's shared memory, as many times as the blocks per SM; the output
    tile and the statistics fit the buffers they reuse (the kernel's
    static_asserts, mirrored)."""
    bz, by, bx, bn, m_tiles, stages, halos, blocks = K.WGMMA_CONFIGS[config]
    halo = -(-(bz + 2) * (by + 2) * (bx + 2) * 128 // 1024) * 1024
    ring = stages * bn * 128
    smem = halos * halo + ring + 1024
    assert smem <= SMEM_PER_BLOCK and blocks * (smem + 1024) <= SMEM_PER_SM
    assert bz * by * bx * (2 * bn + 16) <= halos * halo
    assert 2 * 8 * bn * 4 <= ring
    assert bn % 8 == 0 and bn <= 256 and bx % 8 == 0 and stages >= 3 and halos in (1, 2)
    assert (bn * 8) % 256 == 0  # B tile groups split evenly over 256 threads


@pytest.mark.parametrize("cin,cout,bn", [
    (64, 64, 64), (96, 96, 96), (96, 192, 192), (128, 64, 64), (24, 40, 64),
    (384, 384, 192), (200, 320, 192)])
def test_pack_weight_round_trips_and_lays_out_k_major_tiles(cin, cout, bn):
    rng = np.random.RandomState(cin + cout)
    w = torch.from_numpy(rng.randn(3, 3, 3, cin, cout).astype(np.float32)).bfloat16()
    packed = K.pack_weight(w, bn)
    chunks, n_tiles = -(-cin // 64), -(-cout // bn)
    assert tuple(packed.shape) == (n_tiles, chunks, 27, bn, 64) and packed.is_contiguous()
    assert torch.equal(_unpack_weight(packed, cin, cout), w)
    for t, c, tap, n, k in ((0, 0, 0, 0, 0), (n_tiles - 1, chunks - 1, 26, bn - 1, 63),
                            (0, chunks - 1, 13, 5, 7)):
        ci, co = c * 64 + k, t * bn + n
        want = w[tap // 9, (tap // 3) % 3, tap % 3, ci, co] if ci < cin and co < cout else 0
        assert float(packed[t, c, tap, n, k]) == float(want)


def test_kernel_form_by_dtype_and_channels():
    w = torch.zeros(3, 3, 3, 64, 64)
    assert K.kernel_form(torch.zeros(1, 4, 4, 4, 64), w) == "tf32x3"
    assert K.kernel_form(torch.zeros(1, 4, 4, 4, 64, dtype=torch.bfloat16),
                         w.bfloat16()) == "wgmma"
    assert K.kernel_form(torch.zeros(1, 4, 4, 4, 4, dtype=torch.bfloat16),
                         torch.zeros(3, 3, 3, 4, 64, dtype=torch.bfloat16)) == "wgmma"
    assert K.kernel_form(torch.zeros(1, 4, 4, 4, 6, dtype=torch.bfloat16),
                         torch.zeros(3, 3, 3, 6, 64, dtype=torch.bfloat16)) == "wmma"
    assert K.kernel_form(torch.zeros(1, 4, 4, 4, 64, dtype=torch.bfloat16),
                         torch.zeros(3, 3, 3, 64, 12, dtype=torch.bfloat16)) == "wmma"


def test_cpu_calls_count_no_form():
    K.reset_launches()
    x = torch.randn(1, 4, 4, 4, 8, dtype=torch.bfloat16)
    K.conv3x3x3_with_stats(x, torch.randn(3, 3, 3, 8, 8, dtype=torch.bfloat16))
    assert not K.FORM_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", [
    ((1, 9, 12, 20), 64, 96), ((1, 9, 12, 20), 96, 192), ((2, 5, 7, 33), 64, 64),
    ((1, 9, 12, 20), 64, 128), ((2, 6, 9, 18), 128, 64), ((1, 3, 5, 17), 200, 320),
    ((2, 7, 9, 20), 4, 64), ((1, 9, 12, 20), 36, 96)])
def test_cuda_wgmma_form_matches_plain_versions_at_ragged_shapes(shape, cin, cout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(*shape, cin).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    inv = torch.from_numpy(rng.rand(shape[0], cin).astype(np.float32) + 0.5).to(dev)
    shift = torch.from_numpy(rng.randn(shape[0], cin).astype(np.float32) * 0.3).to(dev)
    K.reset_launches()
    cases = ((K.conv3x3x3(x, w), K.conv3d_reference(x, w)),
             (K.conv3x3x3_with_stats(x, w), K.conv3d_with_stats_reference(x, w)),
             (K.conv3x3x3_block_with_stats(x, w, inv, shift),
              K.conv3d_block_with_stats_reference(x, w, inv, shift)))
    torch.cuda.synchronize()
    for got, want in cases:
        got_y, want_y = (got, want) if isinstance(got, torch.Tensor) else (got[0], want[0])
        rel = float((got_y.float() - want_y.float()).abs().max() / want_y.float().abs().max())
        assert rel < 1e-2  # f32 accumulation on both sides, one bf16 rounding
        if not isinstance(got, torch.Tensor):
            yd = got_y.double()
            assert float((got[1] - yd.sum((1, 2, 3))).abs().max()) <= 1e-4 * float(
                yd.abs().sum((1, 2, 3)).max())
            assert float((got[2] - (yd * yd).sum((1, 2, 3))).abs().max()) <= 1e-4 * float(
                (yd * yd).sum((1, 2, 3)).max())
    assert dict(K.FORM_LAUNCHES) == {("conv", "wgmma"): 1, ("conv_stats", "wgmma"): 1,
                                     ("block_stats", "wgmma"): 1}

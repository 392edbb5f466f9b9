"""Host-side logic of the wgmma form of the Winograd-DH conv
(``ops/winograd_kernel.py``).

The CUDA kernel (``ops/kernels/winograd_wgmma.cu``) takes its tiling from
``wgmma_plan`` and its transformed weight from ``pack_u2``. These tests hold
them on the CPU: every output voxel and channel belongs to exactly one block
(the five Winograd sites of the BraTS DynUNet and ragged shapes), a block
fits the card's shared memory and a warpgroup's accumulators its registers,
and the packed U2 unpacks to ``transform_weights_dh`` exactly. A plain-torch
emulation of the kernel's decomposition (32-channel chunks in order, each
chunk's window D-transformed and then H-transformed in the working dtype, the
16 points' products over (tap, channel) read from the packed U2 in f32 and
folded with A^T's signs after each chunk) equals ``winograd_reference`` and
the Pallas kernel in interpret mode, within 1e-4 in f32 and 4e-3 in bf16
relative to the largest |y| (the same products summed in another order; in
bf16 a flipped rounding of the store). The ``cuda`` tests run the kernel on a
GPU and skip without one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet3d_tpu.ops.pallas import winograd_kernel as jax_wino

from unet3d_tpu_torch.ops import winograd_kernel as W

SMEM_PER_BLOCK = 232448  # bytes a block of an H100 can use
TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-3}

# x (N, D, H, W), Cin, Cout: the Winograd sites of the BraTS DynUNet at 128^3
# (forward with statistics; the input gradients), then ragged shapes: W not a
# multiple of BW, H / 2 not a multiple of BHT, Cout not a multiple of BN,
# Cin 96 and 24, N = 2
SITES = [((1, 64, 64, 64), 96, 96), ((1, 64, 64, 64), 192, 96),
         ((1, 128, 128, 128), 128, 64), ((1, 64, 64, 64), 96, 192)]
RAGGED = [((1, 6, 10, 40), 96, 72), ((2, 4, 6, 17), 24, 40), ((2, 8, 18, 33), 128, 200),
          ((1, 2, 2, 3), 8, 8), ((1, 4, 20, 70), 40, 96)]


def _blocks(plan, x_shape):
    """(item, depth tile, H tile group, W tile, N tile) of every block, in the
    kernel's decoding of blockIdx.x (N tile fastest)."""
    n, d = x_shape[:2]
    grid = (n, d // 2, plan.h_tiles, plan.w_tiles, plan.n_tiles)
    return np.stack(np.unravel_index(np.arange(np.prod(grid)), grid), axis=1)


@pytest.mark.parametrize("x_shape,cin,cout", SITES + RAGGED)
def test_wgmma_plan_covers_every_voxel_and_channel_once(x_shape, cin, cout):
    plan = W.wgmma_plan(x_shape + (cin,), cout)
    assert plan[1:6] == W.WGMMA_CONFIGS[plan.config]
    n, d, h, w = x_shape
    # voxels: a block stores output rows (2 td + od, 2 (th0 + t) + oh, w0 + c)
    # of its 4 (od, oh) tiles of BHT x BW positions, masked at H and W
    blocks = _blocks(plan, x_shape)
    spatial = blocks[blocks[:, 4] == 0]
    od, oh, t, c = np.meshgrid(np.arange(2), np.arange(2), np.arange(plan.bht),
                               np.arange(plan.bw), indexing="ij")
    z = 2 * spatial[:, 1, None] + od.ravel()
    y = 2 * (spatial[:, 2, None] * plan.bht + t.ravel()) + oh.ravel()
    x = spatial[:, 3, None] * plan.bw + c.ravel()
    item = np.broadcast_to(spatial[:, 0, None], z.shape)
    ok = (y < h) & (x < w)
    hits = np.zeros((n, d, h, w), np.int64)
    np.add.at(hits, (item[ok], z[ok], y[ok], x[ok]), 1)
    assert (hits == 1).all()
    # channels: N tile nt stores nt * BN .. + BN, masked at Cout; no tile empty
    cols = np.zeros(plan.n_tiles * plan.bn, np.int64)
    for nt in range(plan.n_tiles):
        cols[nt * plan.bn:(nt + 1) * plan.bn] += 1
    assert (cols[:cout] == 1).all() and (plan.n_tiles - 1) * plan.bn < cout
    # chunks: every input channel in one chunk
    assert (plan.chunks - 1) * plan.ck < cin <= plan.chunks * plan.ck


def test_wgmma_plan_at_the_brats_sites():
    """Cout 64 and 192 take 64-wide N tiles (one and three), Cout 96 two of
    48; Cin 96, 128, 192 run as 3, 4, 6 whole 32-channel chunks."""
    plans = [W.wgmma_plan(s + (cin,), cout) for s, cin, cout in SITES]
    assert [(p.bn, p.n_tiles, p.chunks) for p in plans] == [
        (48, 2, 3), (48, 2, 6), (64, 1, 4), (64, 3, 3)]
    assert [(p.h_tiles, p.w_tiles) for p in plans] == [(8, 2), (8, 2), (16, 4), (8, 2)]


@pytest.mark.parametrize("config", W.WGMMA_CONFIGS)
def test_wgmma_configs_fit_one_block(config):
    """Two raw windows, the slab ring and the alignment slack fit a block's
    shared memory; a warpgroup's one point product and four output tiles
    (5 BN / 2 f32 a thread) stay within 160 registers; the ring holds the
    slabs from the current point to the one loaded three points ahead (seven
    at most: a point's six k16 steps span 1.5 slabs)."""
    bht, bw, bn, ck, stages = config
    window = 4 * (2 * bht + 2) * (bw + 2) * ck * 2  # 4 D rows x H x W rows of CK
    assert 2 * window + stages * bn * 128 + 1024 <= SMEM_PER_BLOCK
    assert 5 * bn // 2 <= 160 and bn % 16 == 0
    assert bht * bw == 2 * 64 and bw % 8 == 0  # two warpgroups of 64 positions
    assert window % 1024 == 0 and 4 * bht * bw * (2 * bn + 16) <= 2 * window
    lead = 3
    span = max((6 * (g + lead) + 5) // 4 - (6 * g) // 4 + 1 for g in range(8))
    assert stages >= span == 7
    assert 3 * W.POINTS * ck % W.SLAB_K == 0


def unpack_u2(packed: torch.Tensor, plan, cin: int, cout: int) -> torch.Tensor:
    """The (48, Cin, Cout) U2 that ``packed`` holds: row p * 3 + dx of point p
    and tap dx, channel chunk c * CK + k, output channel nt * BN + n, read
    from slab (p * 3 + dx) // 2, half (p * 3 + dx) % 2 of each 64 K values."""
    u = torch.zeros(48, plan.chunks * plan.ck, plan.n_tiles * plan.bn, dtype=packed.dtype)
    for pd in range(48):
        for c in range(plan.chunks):
            for nt in range(plan.n_tiles):
                half = packed[nt, c, pd // 2, :, (pd % 2) * plan.ck:(pd % 2 + 1) * plan.ck]
                u[pd, c * plan.ck:(c + 1) * plan.ck, nt * plan.bn:(nt + 1) * plan.bn] = half.T
    return u[:, :cin, :cout], u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(24, 40), (96, 72), (8, 8), (128, 64)])
def test_packed_u2_unpacks_to_transform_weights_dh(cin, cout, dtype):
    rng = np.random.RandomState(cin + cout)
    w = torch.from_numpy(rng.randn(3, 3, 3, cin, cout).astype(np.float32)).to(dtype)
    plan = W.wgmma_plan((1, 4, 4, 4, cin), cout)
    packed = W.pack_u2(w, plan)
    assert packed.is_contiguous() and packed.dtype == dtype
    assert tuple(packed.shape) == (plan.n_tiles, plan.chunks, 24, plan.bn, W.SLAB_K)
    got, padded = unpack_u2(packed, plan, cin, cout)
    assert torch.equal(got, W.transform_weights_dh(w, dtype))
    assert not padded[:, cin:].any() and not padded[:, :, cout:].any()


def emulate_wgmma_form(x: torch.Tensor, w: torch.Tensor, plan) -> torch.Tensor:
    """y as the wgmma form computes it, in plain torch: the working dtype of
    x for the transforms, f32 products and folds."""
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    hp, wp = 2 * plan.bht * plan.h_tiles, plan.bw * plan.w_tiles
    cp = plan.chunks * plan.ck
    # the blocks' windows: zero outside the volume and past Cin
    xp = torch.zeros(n, d + 2, hp + 2, wp + 2, cp, dtype=x.dtype)
    xp[:, 1:d + 1, 1:h + 1, 1:wd + 1, :cin] = x
    _, u2 = unpack_u2(W.pack_u2(w, plan), plan, cin, cout)
    u2 = u2.float()
    out = [[torch.zeros(n, d // 2, hp // 2, wp, u2.shape[-1]) for _ in range(2)]
           for _ in range(2)]
    for c in range(plan.chunks):  # chunks in order
        raw = xp[..., c * plan.ck:(c + 1) * plan.ck]
        rows_d = [raw[:, k:k + d:2] for k in range(4)]
        for jd in range(4):
            vd = W._transform(rows_d, jd)                   # rounded to x's dtype
            rows_h = [vd[:, :, k:k + hp:2] for k in range(4)]
            for jh in range(4):
                v = W._transform(rows_h, jh).float()        # rounded, then f32
                p = jd * 4 + jh
                prod = sum(v[:, :, :, dx:dx + wp] @ u2[p * 3 + dx, c * plan.ck:(c + 1) * plan.ck]
                           for dx in range(3))
                for od in range(2):                         # the fold, per chunk
                    for oh in range(2):
                        sign = W._AT[od][jd] * W._AT[oh][jh]
                        if sign:
                            out[od][oh] = out[od][oh] + sign * prod
    y = torch.stack([torch.stack(out[od], dim=3) for od in range(2)], dim=2)
    y = y.reshape(n, d, hp, wp, -1)
    return y[:, :, :h, :wd, :cout].to(x.dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _case(shape, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, cin).astype(np.float32)
    k = (rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    return x, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout", [((2, 4, 6, 17), 24, 40), ((1, 2, 10, 40), 96, 72),
                                            ((1, 4, 4, 6), 40, 8)])
def test_emulated_decomposition_matches_reference(shape, cin, cout, dtype):
    x, k = _case(shape, cin, cout, seed=sum(shape) + cin)
    tx, tk = torch.from_numpy(x).to(dtype), torch.from_numpy(k).to(dtype)
    plan = W.wgmma_plan(tuple(tx.shape), cout)
    got = emulate_wgmma_form(tx, tk, plan)
    assert got.dtype == dtype and tuple(got.shape) == shape + (cout,)
    assert _rel(got.float(), W.winograd_reference(tx, tk).float()) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_decomposition_matches_pallas_kernel(dtype):
    """Two chunks, two N tiles, H / 2 = 4 in one H tile group, W 12 of 32."""
    x, k = _case((1, 4, 8, 12), 40, 72, seed=3)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = jax_wino._winograd_batched(jnp.asarray(x, jdt), jnp.asarray(k, jdt), interpret=True)
    tx, tk = torch.from_numpy(x).to(dtype), torch.from_numpy(k).to(dtype)
    plan = W.wgmma_plan(tuple(tx.shape), 72)
    assert plan.chunks == 2 and plan.n_tiles == 2
    got = emulate_wgmma_form(tx, tk, plan)
    assert _rel(got.float(), jnp.asarray(want, jnp.float32)) < TOL[dtype]


def test_kernel_form_by_dtype_and_channels():
    x, w = torch.zeros(1, 4, 4, 4, 96), torch.zeros(3, 3, 3, 96, 96)
    assert W.kernel_form(x, w) == "tf32x3"
    assert W.kernel_form(x.bfloat16(), w.bfloat16()) == "wgmma"
    assert W.kernel_form(torch.zeros(1, 4, 4, 4, 5, dtype=torch.bfloat16),
                         torch.zeros(3, 3, 3, 5, 96, dtype=torch.bfloat16)) == "wmma"
    assert W.kernel_form(x.bfloat16(), torch.zeros(3, 3, 3, 96, 12,
                                                   dtype=torch.bfloat16)) == "wmma"


def test_cpu_calls_count_no_launch_and_no_form():
    W.reset_launches()
    x = torch.randn(1, 4, 4, 4, 8, dtype=torch.bfloat16)
    w = torch.randn(3, 3, 3, 8, 8, dtype=torch.bfloat16)
    W.winograd3x3x3(x, w)
    W.winograd3x3x3_with_stats(x, w)
    assert W.LAUNCHES == {"winograd": 0, "winograd_stats": 0} and not W.FORM_LAUNCHES


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stats_rel(y, s1, s2):
    yd = y.double()
    return max(float((s1 - yd.sum((1, 2, 3))).abs().max() / yd.abs().sum((1, 2, 3)).max()),
               float((s2 - (yd * yd).sum((1, 2, 3))).abs().max()
                     / (yd * yd).sum((1, 2, 3)).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 4, 6, 17), 24, 40), ((1, 6, 10, 40), 96, 72), ((2, 8, 18, 33), 128, 200),
    ((1, 16, 16, 16), 96, 96), ((1, 16, 16, 16), 192, 96), ((1, 32, 32, 32), 128, 64),
    ((1, 16, 16, 16), 96, 192)])
def test_cuda_wgmma_form_matches_plain(cuda_device, shape, cin, cout):
    """Ragged shapes and the BraTS sites' channel counts at 16^3-32^3: y
    within 1e-2 of the plain version (a flipped rounding of the store), the
    statistics within 1e-4 of an f64 sum of the kernel's own y (f32 atomics)."""
    x, k = _case(shape, cin, cout, seed=7)
    tx = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    tk = torch.from_numpy(k).to(cuda_device, torch.bfloat16)
    W.reset_launches()
    y = W.winograd3x3x3(tx, tk)
    ys, s1, s2 = W.winograd3x3x3_with_stats(tx, tk)
    torch.cuda.synchronize()
    assert dict(W.FORM_LAUNCHES) == {("winograd", "wgmma"): 1, ("winograd_stats", "wgmma"): 1}
    want = W.winograd_reference(tx, tk).cpu()
    assert _rel(y.float().cpu(), want.float()) < 1e-2
    assert _rel(ys.float().cpu(), want.float()) < 1e-2
    assert _stats_rel(ys.cpu(), s1.cpu(), s2.cpu()) < 1e-4


@pytest.mark.cuda
def test_cuda_channels_off_the_wgmma_form_take_wmma(cuda_device):
    x, k = _case((1, 4, 8, 20), 5, 96, seed=9)
    tx = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    tk = torch.from_numpy(k).to(cuda_device, torch.bfloat16)
    W.reset_launches()
    y = W.winograd3x3x3(tx, tk)
    torch.cuda.synchronize()
    assert dict(W.FORM_LAUNCHES) == {("winograd", "wmma"): 1}
    assert _rel(y.float().cpu(), W.winograd_reference(tx, tk).float().cpu()) < 1e-2

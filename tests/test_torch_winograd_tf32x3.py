"""Host-side logic of the f32 form of the Winograd-DH conv (``tf32x3``:
``ops/kernels/winograd_tf32x3.cu``, wgmma TF32 products in 3xTF32).

The kernel takes its tiling from ``winograd_kernel.tf32_plan`` and its
transformed weight from ``pack_u2_tf32``. These tests hold them on the CPU:
every output voxel and channel belongs to exactly one block and every input
channel to one chunk (the Winograd sites of the BraTS DynUNet, ragged Cin
and Cout), a block fits the card's shared memory and its ring the slabs in
flight, and the packed hi and lo slabs unpack to the TF32 split of
``transform_weights_dh`` (hi + lo within 2^-22 of f32). A plain-torch
emulation of the kernel's arithmetic (16-channel chunks in order, each
chunk's window D- then H-transformed in f32, each value split into TF32 hi
and lo, each point's products lo*hi + hi*lo + hi*hi over (tap, channel)
summed in f64 (the tensor cores' sums differ from them by their rounding
alone), rounded to f32 and folded with A^T's signs in f32 after each chunk)
equals ``winograd_reference`` and the Pallas kernel in interpret mode within
1e-5 relative to the largest |y|. The ``cuda`` tests run the kernel on a GPU
and skip without one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.ops.pallas import winograd_kernel as jax_wino

from unet3d_tpu_torch.ops import winograd_kernel as W
from unet3d_tpu_torch.ops.conv3d_kernel import tf32_round, tf32_split

SMEM_PER_BLOCK = 232448  # bytes a block of an H100 can use
F32 = 1e-5

# x (N, D, H, W), Cin, Cout: the Winograd sites of the BraTS DynUNet at 128^3,
# then ragged shapes and channel counts (Cin 1, 5, 24, 40; Cout 1, 7, 40, 72, 200)
SITES = [((1, 64, 64, 64), 96, 96), ((1, 64, 64, 64), 192, 96),
         ((1, 128, 128, 128), 128, 64), ((1, 64, 64, 64), 96, 192)]
RAGGED = [((1, 6, 10, 40), 5, 7), ((2, 4, 6, 17), 24, 40), ((2, 8, 18, 33), 128, 200),
          ((1, 2, 2, 3), 1, 1), ((1, 4, 20, 70), 40, 72)]


def _blocks(plan, x_shape):
    """(item, depth tile, H tile group, W tile, N tile) of every block, in the
    kernel's decoding of blockIdx.x (N tile fastest)."""
    n, d = x_shape[:2]
    grid = (n, d // 2, plan.h_tiles, plan.w_tiles, plan.n_tiles)
    return np.stack(np.unravel_index(np.arange(np.prod(grid)), grid), axis=1)


@pytest.mark.parametrize("x_shape,cin,cout", SITES + RAGGED)
def test_tf32_plan_covers_every_voxel_and_channel_once(x_shape, cin, cout):
    plan = W.tf32_plan(x_shape + (cin,), cout)
    assert plan[1:6] == W.TF32_CONFIGS[plan.config][:5]
    n, d, h, w = x_shape
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
    cols = np.zeros(plan.n_tiles * plan.bn, np.int64)
    for nt in range(plan.n_tiles):
        cols[nt * plan.bn:(nt + 1) * plan.bn] += 1
    assert (cols[:cout] == 1).all() and (plan.n_tiles - 1) * plan.bn < cout
    assert (plan.chunks - 1) * plan.ck < cin <= plan.chunks * plan.ck


def test_tf32_plan_at_the_brats_sites():
    """Cout 96 takes two N tiles of 48, Cout 192 four, Cout 64 two of 32;
    Cin 96, 192, 128 run as 6, 12, 8 chunks of 16."""
    plans = [W.tf32_plan(s + (cin,), cout) for s, cin, cout in SITES]
    assert [(p.bn, p.n_tiles, p.chunks) for p in plans] == [
        (48, 2, 6), (48, 2, 12), (32, 2, 8), (48, 4, 6)]


def _ring_span(lead):
    return max((6 * (g + lead) + 5) // 4 - (6 * g) // 4 + 1 for g in range(8))


@pytest.mark.parametrize("config", W.TF32_CONFIGS)
def test_tf32_configs_fit_one_block(config):
    """Two raw windows of 16 f32 channels, the ring of (hi, lo) slab pairs
    and the alignment slack fit a block's shared memory; the ring holds the
    slab pairs from the current point to the one loaded LEAD points ahead;
    the output tile (4 x 128 rows of BN f32 + 16 bytes) fits the windows."""
    bht, bw, bn, ck, stages, lead = config
    window = 4 * (2 * bht + 2) * (bw + 2) * ck * 4
    assert window == 87040 and ck * 4 == 64  # the bf16 form's 64-byte rows
    pair = 2 * bn * 128
    assert 2 * window + stages * pair + 1024 <= SMEM_PER_BLOCK
    assert stages >= _ring_span(lead) and lead >= 1
    assert bn % 16 == 0 and bn <= 48 and pair % 1024 == 0
    assert 4 * bht * bw * (4 * bn + 16) <= 2 * window
    assert 3 * W.POINTS * ck % W.TF32_SLAB_K == 0


def unpack_u2_tf32(packed: torch.Tensor, plan, cin: int, cout: int):
    """The (2, 48, Cin, Cout) hi and lo parts that ``packed`` holds: K value
    32 s + k of chunk c (slab s) is point-and-tap row (32 s + k) // 16,
    channel c * 16 + (32 s + k) % 16."""
    parts = torch.zeros(2, 48, plan.chunks * plan.ck, plan.n_tiles * plan.bn)
    for nt in range(plan.n_tiles):
        for c in range(plan.chunks):
            for s in range(packed.shape[2]):
                for k in range(W.TF32_SLAB_K):
                    kk = s * W.TF32_SLAB_K + k
                    pd, ch = kk // plan.ck, c * plan.ck + kk % plan.ck
                    parts[:, pd, ch, nt * plan.bn:(nt + 1) * plan.bn] = packed[nt, c, s, :, :, k]
    return parts[:, :, :cin, :cout], parts


@pytest.mark.parametrize("cin,cout", [(5, 7), (24, 40), (40, 72)])
def test_packed_u2_tf32_unpacks_to_the_split_of_transform_weights_dh(cin, cout):
    rng = np.random.RandomState(cin + cout)
    w = torch.from_numpy(rng.randn(3, 3, 3, cin, cout).astype(np.float32))
    plan = W.tf32_plan((1, 4, 4, 4, cin), cout)
    packed = W.pack_u2_tf32(w, plan)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    assert tuple(packed.shape) == (plan.n_tiles, plan.chunks, 24, 2, plan.bn, W.TF32_SLAB_K)
    (hi, lo), padded = unpack_u2_tf32(packed, plan, cin, cout)
    u = W.transform_weights_dh(w, torch.float32)
    assert torch.equal(hi, tf32_round(u)) and torch.equal(lo, tf32_round(u - hi))
    for part in (hi, lo):  # TF32 values: the low 13 bits of f32 zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (u.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * u.double().abs()).all()
    assert not padded[:, :, cin:].any() and not padded[:, :, :, cout:].any()


def emulate_tf32x3_form(x: torch.Tensor, w: torch.Tensor, plan) -> torch.Tensor:
    """y as the tf32x3 form computes it, in plain torch (see the module note)."""
    n, d, h, wd, cin = x.shape
    hp, wp = 2 * plan.bht * plan.h_tiles, plan.bw * plan.w_tiles
    cp, ck = plan.chunks * plan.ck, plan.ck
    xp = torch.zeros(n, d + 2, hp + 2, wp + 2, cp)
    xp[:, 1:d + 1, 1:h + 1, 1:wd + 1, :cin] = x
    (_, _), parts = unpack_u2_tf32(W.pack_u2_tf32(w, plan), plan, cin, w.shape[-1])
    uhi, ulo = parts[0].double(), parts[1].double()
    out = [[torch.zeros(n, d // 2, hp // 2, wp, parts.shape[-1]) for _ in range(2)]
           for _ in range(2)]
    for c in range(plan.chunks):  # chunks in order
        raw = xp[..., c * ck:(c + 1) * ck]
        rows_d = [raw[:, k:k + d:2] for k in range(4)]
        for jd in range(4):
            vd = W._transform(rows_d, jd)                       # f32
            rows_h = [vd[:, :, k:k + hp:2] for k in range(4)]
            for jh in range(4):
                v = W._transform(rows_h, jh)                    # f32
                p = jd * 4 + jh
                prod = 0.0
                for dx in range(3):
                    ahi, alo = (t.double() for t in tf32_split(v[:, :, :, dx:dx + wp].contiguous()))
                    bhi, blo = (t[p * 3 + dx, c * ck:(c + 1) * ck] for t in (uhi, ulo))
                    prod = prod + alo @ bhi + ahi @ blo + ahi @ bhi
                prod = prod.float()                             # the point's accumulator
                for od in range(2):                             # the fold, per chunk, f32
                    for oh in range(2):
                        sign = W._AT[od][jd] * W._AT[oh][jh]
                        if sign:
                            out[od][oh] = out[od][oh] + sign * prod
    y = torch.stack([torch.stack(out[od], dim=3) for od in range(2)], dim=2)
    return y.reshape(n, d, hp, wp, -1)[:, :, :h, :wd, :w.shape[-1]]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _case(shape, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, cin).astype(np.float32)
    k = (rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    return x, k


@pytest.mark.parametrize("shape,cin,cout", [((2, 4, 6, 17), 24, 40), ((1, 2, 10, 40), 5, 7),
                                            ((1, 4, 4, 6), 40, 72), ((1, 2, 2, 3), 1, 1)])
def test_emulated_decomposition_matches_reference(shape, cin, cout):
    x, k = _case(shape, cin, cout, seed=sum(shape) + cin)
    tx, tk = torch.from_numpy(x), torch.from_numpy(k)
    plan = W.tf32_plan(tuple(tx.shape), cout)
    got = emulate_tf32x3_form(tx, tk, plan)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape + (cout,)
    assert _rel(got, W.winograd_reference(tx, tk)) < F32


@pytest.fixture(scope="module")
def pallas_winograd():
    return jax.jit(lambda x, k: jax_wino._winograd_batched(x, k, interpret=True))


def test_emulated_decomposition_matches_pallas_kernel(pallas_winograd):
    """Three chunks (Cin 40), two N tiles of 48 (Cout 72), H / 2 = 4 in one
    H tile group, W 12 of 32."""
    x, k = _case((1, 4, 8, 12), 40, 72, seed=3)
    want = pallas_winograd(jnp.asarray(x), jnp.asarray(k))
    tx, tk = torch.from_numpy(x), torch.from_numpy(k)
    plan = W.tf32_plan(tuple(tx.shape), 72)
    assert plan.chunks == 3 and plan.n_tiles == 2
    got = emulate_tf32x3_form(tx, tk, plan)
    assert _rel(got, np.asarray(want)) < F32


def test_kernel_form_sends_every_f32_call_to_tf32x3():
    for cin, cout in ((96, 96), (5, 7), (1, 1), (128, 200)):
        x, w = torch.zeros(1, 4, 4, 4, cin), torch.zeros(3, 3, 3, cin, cout)
        assert W.kernel_form(x, w) == "tf32x3"
    # any alignment: a slice one element into its storage
    x = torch.zeros(1 + 4 * 4 * 4 * 8)[1:].view(1, 4, 4, 4, 8)
    assert W.kernel_form(x, torch.zeros(3, 3, 3, 8, 8)) == "tf32x3"
    xb = torch.zeros(1 + 4 * 4 * 4 * 8, dtype=torch.bfloat16)[1:].view(1, 4, 4, 4, 8)
    assert W.kernel_form(xb, torch.zeros(3, 3, 3, 8, 8).bfloat16()) == "wgmma"  # bf16's form


def test_cpu_f32_calls_take_the_plain_version_and_count_no_launch():
    W.reset_launches()
    x, w = torch.randn(1, 4, 4, 6, 5), torch.randn(3, 3, 3, 5, 7)
    assert torch.equal(W.winograd3x3x3(x, w), W.winograd_reference(x, w))
    y, s1, s2 = W.winograd3x3x3_with_stats(x, w)
    assert torch.equal(y, W.winograd_reference(x, w))
    assert W.LAUNCHES == {"winograd": 0, "winograd_stats": 0} and not W.FORM_LAUNCHES


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout,offset", [
    ((2, 4, 6, 17), 24, 40, 0), ((1, 6, 10, 40), 5, 7, 0), ((2, 8, 18, 33), 128, 200, 0),
    ((1, 4, 6, 33), 12, 20, 1), ((1, 16, 16, 16), 96, 96, 0), ((1, 16, 16, 16), 192, 96, 0),
    ((1, 32, 32, 32), 128, 64, 0), ((1, 16, 16, 16), 96, 192, 0)])
def test_cuda_tf32x3_form_matches_plain(cuda_device, shape, cin, cout, offset):
    """Ragged, misaligned (x one element into its storage) and the BraTS
    sites' channel counts: y within 1e-5 of the plain version, the
    statistics within 1e-4 of an f64 sum of the kernel's own y."""
    x, k = _case(shape, cin, cout, seed=7)
    tx = torch.from_numpy(x).to(cuda_device)
    if offset:
        store = torch.empty(offset + tx.numel(), device=cuda_device)
        tx = store[offset:].view(tx.shape).copy_(tx)
    tk = torch.from_numpy(k).to(cuda_device)
    W.reset_launches()
    y = W.winograd3x3x3(tx, tk)
    ys, s1, s2 = W.winograd3x3x3_with_stats(tx, tk)
    torch.cuda.synchronize()
    assert dict(W.FORM_LAUNCHES) == {("winograd", "tf32x3"): 1, ("winograd_stats", "tf32x3"): 1}
    want = W.winograd_reference(tx.clone(), tk).cpu()
    assert _rel(y.cpu(), want) < F32 and _rel(ys.cpu(), want) < F32
    yd = ys.double().cpu()
    assert float((s1.cpu() - yd.sum((1, 2, 3))).abs().max()
                 / yd.abs().sum((1, 2, 3)).max()) < 1e-4
    assert float((s2.cpu() - (yd * yd).sum((1, 2, 3))).abs().max()
                 / (yd * yd).sum((1, 2, 3)).max()) < 1e-4

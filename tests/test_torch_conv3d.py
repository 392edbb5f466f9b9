"""The port's conv ops against the JAX package's Pallas kernels and XLA convs.

On the CPU the port's 3x3x3 wrappers run their plain versions; these tests
hold those against the JAX kernels they replace, run in Pallas interpret mode
(conv3d_kernel, block_kernel) or with ``interpret=True`` (the Winograd stats
kernel). The same numpy inputs go to both sides. The ``cuda`` tests hold the
CUDA kernels against the plain versions on a GPU and skip without one.

Tolerances, relative to the largest |output|: 1e-5 in f32 (sum order only),
5e-3 in bf16 (both accumulate in f32 and round once; a different sum order
can flip one bf16 rounding, 2^-8 relative).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unet3d_tpu.ops.conv3d import conv3d_xla
from unet3d_tpu.ops.pallas.block_kernel import pallas_block_conv3d
from unet3d_tpu.ops.pallas.conv3d_kernel import _conv_batched
from unet3d_tpu.ops.pallas.winograd_kernel import _winograd_batched_stats

from unet3d_tpu_torch.ops import conv3d_kernel as kernels
from unet3d_tpu_torch.ops.conv3d import (conv3d, conv3d_block_with_stats,
                                         conv3d_with_stats)

# (n, d, h, w), cin, cout, dtype
CASES = [
    ((1, 4, 16, 16), 8, 8, "float32"),
    ((2, 6, 8, 16), 4, 8, "bfloat16"),   # batch > 1, both depth edges
    ((1, 4, 8, 16), 4, 16, "float32"),   # the DynUNet input conv's Cin = 4
]
TOL = {"float32": 1e-5, "bfloat16": 5e-3}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(shape, cin, cout, seed=0):
    rng = np.random.RandomState(seed)
    n = shape[0]
    x = rng.randn(*shape, cin).astype(np.float32)
    w = (rng.randn(3, 3, 3, cin, cout) * 0.1).astype(np.float32)
    scale = (rng.rand(cin) + 0.5).astype(np.float32)
    shift = (rng.randn(cin) * 0.3).astype(np.float32)
    return x, w, scale, shift, n


def _both(a, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    t = torch.from_numpy(a).to(_TORCH[dtype])
    return t, jnp.asarray(a, _JAX[dtype])


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape,cin,cout,dtype", CASES)
def test_conv_matches_pallas_conv3d_kernel(shape, cin, cout, dtype):
    x, w, _, _, _ = _inputs(shape, cin, cout)
    tx, jx = _both(x, dtype)
    tw, jw = _both(w, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = _conv_batched(jx, jw)
    got = conv3d(tx, tw)
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) < TOL[dtype]
    assert _rel(kernels.conv3d_reference(tx, tw), want) < TOL[dtype]


@pytest.mark.parametrize("shape,cin,cout,dtype", CASES)
def test_conv_stats_matches_winograd_stats_kernel(shape, cin, cout, dtype):
    """y and the f32 (sum, sum_sq) per (item, channel). The Winograd kernel
    transforms its bf16 input in bf16, so in bf16 only y's rounding-level
    agreement is asserted; the statistics are held at 1e-5 in f32, where both
    sides sum the same values in another order."""
    x, w, _, _, _ = _inputs(shape, cin, cout, seed=1)
    tx, jx = _both(x, dtype)
    tw, jw = _both(w, dtype)
    want_y, want_stats = _winograd_batched_stats(jx, jw, interpret=True)
    y, s1, s2 = conv3d_with_stats(tx, tw)
    tol = TOL[dtype] if dtype == "float32" else 2e-2
    assert _rel(y, want_y) < tol
    if dtype == "float32":
        want_stats = np.asarray(want_stats)
        assert _rel(s1, want_stats[:, 0]) < 1e-5
        assert _rel(s2, want_stats[:, 1]) < 1e-5
    # the statistics are those of y as rounded to its dtype
    yf = y.double()
    np.testing.assert_allclose(s1.numpy(), yf.sum((1, 2, 3)).numpy(), rtol=1e-5,
                               atol=1e-5 * float(yf.abs().sum((1, 2, 3)).max()))
    np.testing.assert_allclose(s2.numpy(), (yf * yf).sum((1, 2, 3)).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("shape,cin,cout,dtype", CASES)
def test_block_stats_matches_pallas_block_kernel(shape, cin, cout, dtype):
    """conv(lrelu(x * scale + shift)) with the activation zero-padded. The JAX
    kernel takes a per-channel affine; the port's is per (item, channel), so
    the same (C,) values are broadcast over the batch."""
    x, w, scale, shift, n = _inputs(shape, cin, cout, seed=2)
    tx, jx = _both(x, dtype)
    tw, jw = _both(w, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_block_conv3d(jx, jw, jnp.asarray(scale), jnp.asarray(shift))
    inv = torch.from_numpy(np.tile(scale, (n, 1)))
    sh = torch.from_numpy(np.tile(shift, (n, 1)))
    y, s1, s2 = conv3d_block_with_stats(tx, tw, inv, sh)
    assert _rel(y, want) < TOL[dtype]
    # statistics against sums of the JAX output; in bf16 the two outputs may
    # differ by a flipped rounding here and there, hence 1e-4
    want_f = _np(want).astype(np.float64)
    stats_tol = {"float32": 1e-5, "bfloat16": 1e-4}[dtype]
    assert _rel(s1, want_f.sum((1, 2, 3))) < stats_tol
    assert _rel(s2, (want_f * want_f).sum((1, 2, 3))) < stats_tol


@pytest.mark.parametrize("spatial", [(8, 8, 8), (7, 9, 6)])
def test_stride2_conv_matches_xla_explicit_pads(spatial):
    """Stride-2 convs go to F.conv3d with symmetric k//2 pads: the same as
    conv3d_xla with ((1,1),)*3, not XLA's strided SAME (lo 0, hi 1)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, *spatial, 5).astype(np.float32)
    w = (rng.randn(3, 3, 3, 5, 7) * 0.1).astype(np.float32)
    want = conv3d_xla(jnp.asarray(x), jnp.asarray(w), (2, 2, 2), ((1, 1),) * 3)
    got = conv3d(torch.from_numpy(x), torch.from_numpy(w), (2, 2, 2), "SAME")
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) < 1e-5
    y, s1, s2 = conv3d_with_stats(torch.from_numpy(x), torch.from_numpy(w), (2, 2, 2))
    want_f = np.asarray(want, np.float64)
    np.testing.assert_allclose(s1.numpy(), want_f.sum((1, 2, 3)), rtol=1e-4, atol=1e-4)


def test_wrappers_reject_bad_operands():
    x = torch.zeros(1, 4, 4, 4, 3)
    with pytest.raises(ValueError):
        kernels.conv3x3x3(x, torch.zeros(3, 3, 3, 4, 2))
    with pytest.raises(TypeError):
        kernels.conv3x3x3(x.double(), torch.zeros(3, 3, 3, 3, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.conv3x3x3_block_with_stats(x, torch.zeros(3, 3, 3, 3, 2),
                                           torch.zeros(3), torch.zeros(3))


def test_cpu_tensors_take_the_plain_path_without_launching():
    kernels.reset_launches()
    x, w, scale, shift, n = _inputs((1, 4, 8, 8), 4, 8)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    kernels.conv3x3x3(tx, tw)
    kernels.conv3x3x3_with_stats(tx, tw)
    kernels.conv3x3x3_block_with_stats(tx, tw, torch.ones(1, 4), torch.zeros(1, 4))
    assert kernels.LAUNCHES == {"conv": 0, "conv_stats": 0, "block_stats": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cin,cout,dtype", CASES + [
    ((1, 5, 7, 9), 6, 70, "float32"), ((1, 4, 4, 4), 384, 384, "bfloat16")])
def test_cuda_kernels_match_plain_versions(cuda_device, shape, cin, cout, dtype):
    x, w, scale, shift, n = _inputs(shape, cin, cout)
    tx = torch.from_numpy(x).to(cuda_device, _TORCH[dtype])
    tw = torch.from_numpy(w).to(cuda_device, _TORCH[dtype])
    inv = torch.from_numpy(np.tile(scale, (n, 1))).to(cuda_device)
    sh = torch.from_numpy(np.tile(shift, (n, 1))).to(cuda_device)
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    before = dict(kernels.LAUNCHES)
    assert _rel(kernels.conv3x3x3(tx, tw).cpu(),
                kernels.conv3d_reference(tx, tw).cpu()) < tol
    for got, want in ((kernels.conv3x3x3_with_stats(tx, tw),
                       kernels.conv3d_with_stats_reference(tx, tw)),
                      (kernels.conv3x3x3_block_with_stats(tx, tw, inv, sh),
                       kernels.conv3d_block_with_stats_reference(tx, tw, inv, sh))):
        assert _rel(got[0].cpu(), want[0].cpu()) < tol
        yf = got[0].double()
        # f32 atomics: the statistics agree with a float64 sum of the kernel's
        # own output to f32 rounding of the partial sums
        assert float((got[1] - yf.sum((1, 2, 3))).abs().max()) <= 1e-4 * float(
            yf.abs().sum((1, 2, 3)).max())
        assert float((got[2] - (yf * yf).sum((1, 2, 3))).abs().max()) <= 1e-4 * float(
            (yf * yf).sum((1, 2, 3)).max())
    assert all(kernels.LAUNCHES[k] == before[k] + 1 for k in before)

"""The port's NDHWC resize against the JAX package's ``ops/interpolate.py``.

Every mode (nearest, nearest-exact, trilinear with and without
align_corners), up and down, on odd sizes, in f32 and bf16: the nearest
modes keep the dtype and pick the same voxels (exact), the linear modes
agree within 1e-6 in f32 and return f32 for a bf16 input, as the JAX lerp's
f32 weight makes it. The default mode is trilinear in both packages.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet3d_tpu.ops import interpolate as jax_interp

from unet3d_tpu_torch.ops import interpolate

F32 = 1e-6
CASES = [((5, 6, 7), (10, 12, 14)), ((9, 8, 5), (4, 8, 11)), ((3, 3, 3), (7, 3, 1))]


def _x(shape, channels=3, seed=0):
    return np.random.RandomState(seed).randn(2, *shape, channels).astype(np.float32)


@pytest.mark.parametrize("mode,align_corners", [
    ("nearest", False), ("nearest-exact", False), ("trilinear", False),
    ("trilinear", True)])
@pytest.mark.parametrize("spatial,out", CASES)
def test_resize_matches_jax_f32(mode, align_corners, spatial, out):
    x = _x(spatial)
    want = np.asarray(jax_interp.resize_ndhwc(jnp.asarray(x), out, mode=mode,
                                              align_corners=align_corners))
    got = interpolate.resize_ndhwc(torch.from_numpy(x), out, mode=mode,
                                   align_corners=align_corners)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if mode.startswith("nearest"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=F32, rtol=F32)


@pytest.mark.parametrize("mode", ["nearest", "nearest-exact", "trilinear"])
def test_resize_dtype_rule_matches_jax_bf16(mode):
    """nearest keeps bf16; trilinear returns f32 from a bf16 input, and the
    values agree with JAX's (both lerp the same bf16 samples in f32)."""
    x = _x((5, 6, 7))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_interp.resize_ndhwc(xj, (10, 12, 14), mode=mode)
    got = interpolate.resize_ndhwc(torch.from_numpy(x).to(torch.bfloat16), (10, 12, 14),
                                   mode=mode)
    want_dtype = torch.bfloat16 if mode.startswith("nearest") else torch.float32
    assert str(want.dtype) == str(want_dtype).replace("torch.", "")
    assert got.dtype == want_dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=F32, rtol=F32)


def test_unchanged_axes_cast_nothing():
    """An axis of unchanged size is skipped: a bf16 input of the target size
    stays bf16 through the linear mode, as in JAX."""
    x = torch.randn(1, 4, 4, 4, 2).to(torch.bfloat16)
    assert interpolate.resize_ndhwc(x, (4, 4, 4)).dtype == torch.bfloat16
    assert jax_interp.resize_ndhwc(jnp.zeros((1, 4, 4, 4, 2), jnp.bfloat16),
                                   (4, 4, 4)).dtype == jnp.bfloat16


@pytest.mark.parametrize("mode,align_corners", [("trilinear", False), ("trilinear", True),
                                                ("nearest", False)])
def test_upsample_matches_jax(mode, align_corners):
    x = _x((3, 5, 4), channels=2, seed=1)
    want = np.asarray(jax_interp.upsample_ndhwc(jnp.asarray(x), 2, mode, align_corners))
    got = interpolate.upsample_ndhwc(torch.from_numpy(x), 2, mode, align_corners)
    assert tuple(got.shape) == want.shape == (2, 6, 10, 8, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=F32, rtol=F32)


def test_default_mode_is_trilinear_as_in_jax():
    for fn in ("resize_ndhwc", "upsample_ndhwc"):
        ours = inspect.signature(getattr(interpolate, fn)).parameters
        theirs = inspect.signature(getattr(jax_interp, fn)).parameters
        assert ours["mode"].default == theirs["mode"].default == "trilinear"
        assert ours["align_corners"].default is theirs["align_corners"].default is False
    x = _x((3, 4, 5))
    np.testing.assert_allclose(
        interpolate.resize_ndhwc(torch.from_numpy(x), (6, 8, 10)).numpy(),
        np.asarray(jax_interp.resize_ndhwc(jnp.asarray(x), (6, 8, 10))), atol=F32, rtol=F32)


def test_resize_gradient_matches_jax():
    """The linear resize's input gradient (index-add of the lerp weights)."""
    import jax
    x = _x((3, 5, 4), channels=2, seed=2)
    g = np.random.RandomState(3).randn(2, 6, 9, 8, 2).astype(np.float32)
    _, pull = jax.vjp(lambda v: jax_interp.resize_ndhwc(v, (6, 9, 8)), jnp.asarray(x))
    (want,) = pull(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(interpolate.resize_ndhwc(tx, (6, 9, 8)), tx,
                                 torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

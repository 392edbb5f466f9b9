"""The port's contour helpers, metrics and flip TTA against the JAX package.

Contours and the surface proxy are exact (boolean); Dice within 1e-6; flip
TTA through the port's DynUNet and the sliding-window inferer equals the
mean of the four forwards on flipped inputs, flipped back, within 1e-6 (f32),
and the JAX function with the same forward (the port's, called through
numpy) gives the same average.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet3d_tpu.ops import one_hot as jax_one_hot
from unet3d_tpu.predict.volumetric import predictions_with_tta as jax_tta
from unet3d_tpu.train import metrics as jax_metrics

from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import one_hot
from unet3d_tpu_torch.predict.sliding_window import build_inferer
from unet3d_tpu_torch.predict.volumetric import make_forward, predictions_with_tta
from unet3d_tpu_torch.train import metrics


def _masks(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape) > 0.4


@pytest.mark.parametrize("shape", [(9, 8, 7), (2, 6, 5, 4), (1, 5, 1, 6)])
def test_contours_match_jax(shape):
    mask = _masks(shape, 3)
    for name in ("binary_erosion_3x3", "estimate_binary_contour"):
        got = getattr(one_hot, name)(mask)
        want = np.asarray(getattr(jax_one_hot, name)(jnp.asarray(mask)))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_one_hot_contours_match_jax():
    enc = _masks((3, 8, 7, 6), 4).astype(np.uint8)
    got = one_hot.add_one_hot_encoding_contours(enc)
    want = np.asarray(jax_one_hot.add_one_hot_encoding_contours(jnp.asarray(enc)))
    assert got.shape == (6, 8, 7, 6) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kwargs", [{}, dict(threshold=None), dict(threshold=0.3, smooth=1.0),
                                    dict(axis=(1, 2, 3))])
def test_dice_matches_jax(kwargs):
    rng = np.random.RandomState(5)
    pred = rng.rand(2, 6, 5, 4, 3).astype(np.float32)
    target = (rng.rand(2, 6, 5, 4, 3) > 0.5).astype(np.float32)
    got = metrics.dice_score(pred, target, **kwargs)
    want = np.asarray(jax_metrics.dice_score(jnp.asarray(pred), jnp.asarray(target), **kwargs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(metrics.mean_dice(pred, target, **kwargs)),
                               float(jax_metrics.mean_dice(jnp.asarray(pred),
                                                           jnp.asarray(target), **kwargs)),
                               rtol=1e-6)


def test_surface_error_matches_jax():
    rng = np.random.RandomState(6)
    pred = rng.rand(8, 7, 6, 2).astype(np.float32)
    target = (rng.rand(8, 7, 6, 2) > 0.5).astype(np.float32)
    got = metrics.hausdorff_like_surface_error(pred, target)
    want = jax_metrics.hausdorff_like_surface_error(jnp.asarray(pred), jnp.asarray(target))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(metrics.hausdorff_like_surface_error(target, target)) == 0.0


def test_flip_tta_is_the_mean_of_the_flipped_forwards():
    net = create_model("DynUNet", in_channels=2, out_channels=3,
                       strides=[[1, 1, 1], [2, 2, 2]], filters=[4, 8],
                       kernel_size=[[3, 3, 3]] * 2, upsample_kernel_size=[[2, 2, 2]])
    init_parameters(net, torch.Generator().manual_seed(9))
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 12, 10, 8, 2).astype(np.float32))
    inferer = build_inferer("SlidingWindowInferer", roi_size=[8, 8, 8], sw_batch_size=2,
                            overlap=0.5, mode="gaussian")
    forward = make_forward(net)
    got = predictions_with_tta(net, x, inferer=inferer)
    runs = [inferer(x, forward)]
    for axis in (1, 2, 3):
        runs.append(torch.flip(inferer(torch.flip(x, dims=(axis,)), forward), dims=(axis,)))
    want = torch.stack(runs).mean(0)
    assert got.shape == (1, 12, 10, 8, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    # the JAX function, handed the same forward and inferer, averages alike
    port_run = lambda z: inferer(torch.from_numpy(np.array(z)), forward).numpy()
    jax_out = jax_tta(None, None, jnp.asarray(x.numpy()), forward=port_run)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out), rtol=1e-6, atol=1e-6)
    one_axis = predictions_with_tta(None, x, forward=forward, flip_axes=((2,),))
    np.testing.assert_allclose(
        one_axis.numpy(), ((forward(x) + torch.flip(forward(torch.flip(x, dims=(2,))),
                                                    dims=(2,))) / 2).numpy(), rtol=1e-6,
        atol=1e-6)


def test_device_memory_and_profiler_trace_on_the_cpu(tmp_path, capsys):
    """Without a GPU the memory report is empty and prints nothing; the
    profiler hook writes a Chrome trace of the block, and records nothing
    without a directory."""
    from unet3d_tpu_torch.train import meters
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the report is not empty")
    assert meters.device_memory_stats() == {}
    meters.print_device_memory()
    assert capsys.readouterr().out == ""
    with meters.profiler_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with meters.profiler_trace(None):
        pass

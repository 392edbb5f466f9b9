"""The port's Winograd-DH conv and the UNET3D_TPU_CONV=winograd strategy
against the JAX package.

On the CPU the wrappers run their plain versions; these tests hold them
against the JAX Pallas kernels run with ``interpret=True`` (or under
``force_tpu_interpret_mode``), on the shapes of tests/test_winograd.py. The
same numpy inputs go to both sides. Tolerances, relative to the largest
|output|:

* f32: 1e-4, as tests/test_winograd.py holds the JAX kernel (sum order);
* bf16, plain version against the JAX kernel: 4e-3, one bf16 rounding of the
  largest output (both round the input transforms at the same points and
  accumulate in f32, but in another order, which can flip a rounding);
* bf16, Winograd against the direct conv: 2e-2, the two extra roundings of
  the transformed input ("~1 extra bit", the JAX kernel's own note);
* gradients: 5e-4, as tests/test_winograd.py holds the JAX VJP.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unet3d_tpu.ops.pallas import winograd_kernel as jax_wino

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d as conv_ops
from unet3d_tpu_torch.ops import winograd_kernel as wino
from unet3d_tpu_torch.ops.conv3d_kernel import conv3d_reference

from test_torch_grad import jax_vjp

SHAPES = [(1, 8, 16, 12, 5, 7), (2, 4, 8, 8, 3, 4), (1, 6, 8, 10, 8, 8),
          (1, 4, 32, 16, 4, 6)]
TOL = {"float32": 1e-4, "bfloat16": 4e-3}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
MODEL_KWARGS = dict(in_channels=2, out_channels=3, spatial_dims=3,
                    strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2]], filters=[4, 8, 16],
                    kernel_size=[[3, 3, 3]] * 3, upsample_kernel_size=[[2, 2, 2]] * 2)


def _case(n, d, h, w, c, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d, h, w, c)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, c, co)).astype(np.float32)
    return x, k


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_winograd_matches_the_pallas_kernels(shape, dtype):
    n, d, h, w, c, co = shape
    x, k = _case(*shape)
    jx, jk = jnp.asarray(x, _JAX[dtype]), jnp.asarray(k, _JAX[dtype])
    tx, tk = torch.from_numpy(x).to(_TORCH[dtype]), torch.from_numpy(k).to(_TORCH[dtype])
    want = jax_wino._winograd_batched(jx, jk, interpret=True)
    got = wino.winograd3x3x3(tx, tk)
    y, s1, s2 = wino.winograd3x3x3_with_stats(tx, tk)
    assert got.dtype == _TORCH[dtype] and tuple(got.shape) == (n, d, h, w, co)
    assert _rel(got, want) < TOL[dtype]
    assert _rel(y, want) < TOL[dtype]
    if shape in SHAPES[:2]:  # the stats kernel's interpret run is slow: two shapes
        want_y, want_stats = jax_wino._winograd_batched_stats(jx, jk, interpret=True)
        assert _rel(y, want_y) < TOL[dtype]
        # the statistics of y as rounded, against the JAX kernel's, which sums
        # its own rounded y in another order
        want_stats = np.asarray(want_stats, np.float64)
        assert _rel(s1, want_stats[:, 0]) < 1e-4
        assert _rel(s2, want_stats[:, 1]) < 1e-4
    yf = y.double()
    np.testing.assert_allclose(s2.numpy(), (yf * yf).sum((1, 2, 3)).numpy(), rtol=1e-5)
    # and both Winograd forms against the direct conv
    direct = conv3d_reference(tx, tk)
    assert _rel(got, direct) < {"float32": 1e-4, "bfloat16": 2e-2}[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transform_weights_matches_jax(dtype):
    _, k = _case(1, 2, 2, 2, 5, 7, seed=3)
    got = wino.transform_weights_dh(torch.from_numpy(k), _TORCH[dtype])
    want = jax_wino.transform_weights_dh(jnp.asarray(k), _JAX[dtype])
    assert tuple(got.shape) == (48, 5, 7)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("x_shape", [
    (1, 64, 64, 64, 96), (1, 64, 64, 64, 64), (1, 32, 64, 64, 192),
    (2, 128, 128, 128, 128), (1, 63, 64, 65, 96), (1, 4, 4, 4, 384)])
def test_gate_matches_winograd_profitable(x_shape):
    assert wino.winograd_profitable(x_shape) == jax_wino.winograd_profitable(x_shape)


def test_gate_shape_rules():
    """The shape part of the JAX winograd_available (its TPU-only checks
    aside): 3^3, stride 1, pads of 1, D and H even; any W."""
    ok = ((1, 1),) * 3
    assert wino.winograd_shape_ok((1, 8, 16, 7, 4), (3, 3, 3, 4, 5), (1, 1, 1), ok)
    assert not wino.winograd_shape_ok((1, 7, 16, 16, 4), (3, 3, 3, 4, 5), (1, 1, 1), ok)
    assert not wino.winograd_shape_ok((1, 8, 15, 16, 4), (3, 3, 3, 4, 5), (1, 1, 1), ok)
    assert not wino.winograd_shape_ok((1, 8, 16, 16, 4), (3, 3, 3, 4, 5), (2, 2, 2), ok)
    assert not wino.winograd_shape_ok((1, 8, 16, 16, 4), (1, 1, 1, 4, 5), (1, 1, 1),
                                      ((0, 0),) * 3)


@pytest.fixture
def low_gate(monkeypatch):
    """Both gates' thresholds lowered so a 16^3 DynUNet has Winograd sites:
    C >= 8 at >= 8^3 voxels, as C >= 96 at >= 64^3 in the BraTS net."""
    for module in (wino, jax_wino):
        monkeypatch.setattr(module, "_MIN_WINOGRAD_CHANNELS", 8)
        monkeypatch.setattr(module, "_MIN_WINOGRAD_VOXELS", 8 ** 3)
    monkeypatch.setenv("UNET3D_TPU_CONV", "winograd")


def _spy(monkeypatch):
    """Record (wrapper, input shape) of every 3x3x3 stride-1 conv dispatch."""
    calls = []
    for name in ("conv3x3x3", "conv3x3x3_with_stats", "conv3x3x3_block_with_stats",
                 "winograd3x3x3", "winograd3x3x3_with_stats"):
        fn = getattr(conv_ops, name)

        def spy(x, *args, _fn=fn, _name=name):
            calls.append((_name, tuple(x.shape)))
            return _fn(x, *args)
        monkeypatch.setattr(conv_ops, name, spy)
    return calls


@pytest.fixture(scope="module")
def networks():
    # imported here: the GPU machine has jax but not flax, and runs the cuda
    # test of this file
    from flax.traverse_util import flatten_dict
    from unet3d_tpu.models.registry import create_model as jax_create_model
    model = jax_create_model("DynUNet", **MODEL_KWARGS)
    x0 = jnp.zeros((1, 16, 16, 16, 2), jnp.float32)
    variables = jax.jit(lambda r: model.init(r, x0, False))(jax.random.PRNGKey(2))
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}
    port = load_jax_variables(create_model("DynUNet", **MODEL_KWARGS), flat).eval()
    x = np.random.RandomState(4).randn(1, 16, 16, 16, 2).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: model.apply(variables, v, False))(jnp.asarray(x)))
    return port, x, want


def test_strategy_routes_the_jax_gates_sites(networks, low_gate, monkeypatch):
    """Forward: exactly the stride-1 3^3 convs whose input passes the JAX gate
    run winograd_stats (conv1 sites directly, conv2 sites on the materialised
    activation); backward: dx is Winograd where the cotangent passes it."""
    port, x, _ = networks
    calls = _spy(monkeypatch)
    tx = torch.from_numpy(x)
    monkeypatch.delenv("UNET3D_TPU_CONV")
    port(tx)
    default_sites = [s for _, s in calls]
    assert {n for n, _ in calls} == {"conv3x3x3_with_stats", "conv3x3x3_block_with_stats"}
    calls.clear()
    monkeypatch.setenv("UNET3D_TPU_CONV", "winograd")
    y = port(tx)
    forward = list(calls)
    assert [s for _, s in forward] == default_sites  # same sites, same order

    def jax_gate(shape):
        return jax_wino.winograd_profitable(shape) and shape[1] % 2 == 0 and shape[2] % 2 == 0
    picked = [s for n, s in forward if n == "winograd3x3x3_with_stats"]
    assert picked == [s for s in default_sites if jax_gate(s)]
    # the four BraTS-like sites: downsample0.conv2, upsample0.conv1/conv2, upsample1.conv1
    assert picked == [(1, 8, 8, 8, 8), (1, 8, 8, 8, 16), (1, 8, 8, 8, 8), (1, 16, 16, 16, 8)]
    assert sum(n == "conv3x3x3_with_stats" for n, _ in forward) == 1  # input conv1
    assert sum(n == "conv3x3x3_block_with_stats" for n, _ in forward) == 3
    calls.clear()
    y.sum().backward()
    dx = [(n, s) for n, s in calls]
    assert sorted(n for n, _ in dx).count("winograd3x3x3") == 3
    # every dx of a stride-1 conv but the input conv1's: 7 of them
    assert len(dx) == 7 and all(n in ("winograd3x3x3", "conv3x3x3") for n, _ in dx)
    assert all(jax_gate(s) == (n == "winograd3x3x3") for n, s in dx)


def test_strategy_forward_matches_jax(networks, low_gate):
    port, x, want = networks
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("with_stats", [False, True])
def test_strategy_gradients_match_jax_winograd(low_gate, with_stats):
    """A gate-passing conv under the strategy: forward through Winograd, dx
    through Winograd (the cotangent has 8 channels at 8^3), dw by the plain
    weight gradient; against jax.grad of the JAX Winograd conv, whose dx runs
    the Pallas kernel in interpret mode."""
    x, k = _case(1, 8, 8, 8, 8, 8, seed=5)
    k = k * 0.1
    rng = np.random.RandomState(6)
    gy = rng.randn(1, 8, 8, 8, 8).astype(np.float32)
    gs = rng.randn(2, 1, 8).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        if with_stats:
            _, (want_dx, want_dw) = jax_vjp(jax_wino.winograd_conv3d_stats, (x, k),
                                            (gy, gs[0], gs[1]))
        else:
            _, (want_dx, want_dw) = jax_vjp(jax_wino.winograd_conv3d, (x, k), gy)
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    wino.reset_launches()
    if with_stats:
        out = conv_ops.conv3d_with_stats(tx, tk)
        cot = (torch.from_numpy(gy), torch.from_numpy(gs[0]), torch.from_numpy(gs[1]))
    else:
        out, cot = conv_ops.conv3d(tx, tk), torch.from_numpy(gy)
    dx, dw = torch.autograd.grad(out, (tx, tk), cot)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=5e-4, rtol=5e-4)
    assert wino.LAUNCHES == {"winograd": 0, "winograd_stats": 0}  # CPU: plain path


@pytest.mark.parametrize("value", ["xla", "decomp2d", "pallas", "Winograd"])
def test_unknown_strategy_raises(monkeypatch, value):
    monkeypatch.setenv("UNET3D_TPU_CONV", value)
    x, w = torch.zeros(1, 4, 4, 4, 2), torch.zeros(1, 1, 1, 2, 3)
    with pytest.raises(ValueError, match=value):
        conv_ops.conv3d(x, w)


def test_empty_strategy_is_unset(monkeypatch):
    monkeypatch.setenv("UNET3D_TPU_CONV", "")
    assert conv_ops.conv_strategy() is None


def test_wrappers_raise_without_a_kernel_and_check_shapes():
    x = torch.empty(1, 4, 4, 4, 3, device="meta")
    w = torch.empty(3, 3, 3, 3, 4, device="meta")
    before = dict(wino.LAUNCHES)
    with pytest.raises(RuntimeError, match="no kernel"):
        wino.winograd3x3x3(x, w)
    with pytest.raises(RuntimeError, match="no kernel"):
        wino.winograd3x3x3_with_stats(x, w)
    assert wino.LAUNCHES == before
    # H must be even; D need not (the D-halo mode's odd output D), and the
    # D pads are the halo mode's 0..2
    with pytest.raises(ValueError, match="even"):
        wino.winograd3x3x3(torch.zeros(1, 4, 5, 4, 3), torch.zeros(3, 3, 3, 3, 4))
    assert wino.winograd3x3x3(torch.zeros(1, 5, 4, 4, 3), torch.zeros(3, 3, 3, 3, 4)).shape[1] == 5
    with pytest.raises(ValueError, match="pads"):
        wino.winograd3x3x3(torch.zeros(1, 4, 4, 4, 3), torch.zeros(3, 3, 3, 3, 4), (0, 3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4, 8, 20, 5, 7), (2, 6, 12, 34, 24, 70),
                                   (1, 8, 24, 40, 96, 96)])
def test_cuda_winograd_matches_plain(cuda_device, shape, dtype):
    """The kernel against its plain version on the card: 1e-5 in f32 (sum
    order), 1e-2 in bf16 (a flipped rounding of the store); statistics of
    the kernel's own output to f32 rounding of the atomics."""
    x, k = _case(*shape)
    tx = torch.from_numpy(x).to(cuda_device, _TORCH[dtype])
    tk = (torch.from_numpy(k) * 0.1).to(cuda_device, _TORCH[dtype])
    before = dict(wino.LAUNCHES)
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    assert _rel(wino.winograd3x3x3(tx, tk).cpu(), wino.winograd_reference(tx, tk).cpu()) < tol
    y, s1, s2 = wino.winograd3x3x3_with_stats(tx, tk)
    assert _rel(y.cpu(), wino.winograd_reference(tx, tk).cpu()) < tol
    yd = y.double()
    assert float((s1 - yd.sum((1, 2, 3))).abs().max()) <= 1e-4 * float(
        yd.abs().sum((1, 2, 3)).max())
    assert float((s2 - (yd * yd).sum((1, 2, 3))).abs().max()) <= 1e-4 * float(
        (yd * yd).sum((1, 2, 3)).max())
    assert all(wino.LAUNCHES[v] == before[v] + 1 for v in before)

"""Gradients of the port's conv Functions against the JAX package.

The same numpy inputs and cotangents go to both sides. On the CPU the port's
Functions run their plain bodies; the JAX side runs its Pallas kernels in
interpret mode (``pallas_conv3d``, ``s2_wgrad_pallas``) or with
``interpret=True`` (the Winograd stats kernel), or, for the block, the plain
XLA composition the JAX model trains through. The ``cuda`` tests hold the
kernels' backward on a GPU against f32 torch autograd of the plain
composition and skip without one.

Tolerances, relative to the largest |gradient|: 1e-5 in f32 (sum order only);
on the card 1e-2 in bf16 (the cotangent and the flipped-weight conv round to
bf16 once each).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unet3d_tpu.ops.conv3d import conv3d_s2_pallas_wgrad, conv3d_xla
from unet3d_tpu.ops.pallas.conv3d_kernel import pallas_conv3d
from unet3d_tpu.ops.pallas.s2_wgrad_kernel import s2_wgrad_pallas
from unet3d_tpu.ops.pallas.winograd_kernel import winograd_conv3d_stats

from unet3d_tpu_torch.ops import s2_wgrad_kernel as wgrad
from unet3d_tpu_torch.ops.conv3d import (conv3d, conv3d_block_with_stats,
                                         conv3d_with_stats)

F32 = 1e-5


def _rel(got, want):
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a, requires_grad=True):
    return torch.from_numpy(a).requires_grad_(requires_grad)


def jax_vjp(fn, primals, cotangent):
    """``fn``'s value at ``primals`` and its VJP for ``cotangent``, as one
    jitted computation. Run op by op, the VJP dispatches XLA ops while an
    interpret-mode Pallas kernel's callbacks still run on XLA's threads, and
    the two can deadlock: the test then hangs instead of failing."""
    def value_and_vjp(p, c):
        y, pull = jax.vjp(fn, *p)
        return y, pull(c)
    return jax.jit(value_and_vjp)(tuple(map(jnp.asarray, primals)),
                                  jax.tree_util.tree_map(jnp.asarray, cotangent))


# --- 3x3x3 stride 1 -----------------------------------------------------------

@pytest.mark.parametrize("shape,cin,cout", [((1, 4, 8, 16), 4, 8),
                                            ((2, 4, 8, 16), 8, 4)])
def test_conv_vjp_matches_pallas_conv3d(shape, cin, cout):
    rng = np.random.RandomState(0)
    x, w = _rand(rng, *shape, cin), _rand(rng, 3, 3, 3, cin, cout, scale=0.1)
    g = _rand(rng, *shape, cout)
    with pltpu.force_tpu_interpret_mode():
        _, (want_dx, want_dw) = jax_vjp(pallas_conv3d, (x, w), g)
    tx, tw = _t(x), _t(w)
    dx, dw = torch.autograd.grad(conv3d(tx, tw), (tx, tw), torch.from_numpy(g))
    assert _rel(dx, want_dx) < F32
    assert _rel(dw, want_dw) < F32


def test_conv_stats_vjp_matches_winograd_stats_kernel():
    """The statistics cotangents fold into the conv's: gy + gs1 + 2 y gs2."""
    rng = np.random.RandomState(1)
    x, w = _rand(rng, 2, 4, 8, 8, 4), _rand(rng, 3, 3, 3, 4, 6, scale=0.1)
    gy, gs1, gs2 = _rand(rng, 2, 4, 8, 8, 6), _rand(rng, 2, 6), _rand(rng, 2, 6)
    with pltpu.force_tpu_interpret_mode():
        _, (want_dx, want_dw) = jax_vjp(winograd_conv3d_stats, (x, w), (gy, gs1, gs2))
    tx, tw = _t(x), _t(w)
    y, s1, s2 = conv3d_with_stats(tx, tw)
    dx, dw = torch.autograd.grad((y, s1, s2), (tx, tw),
                                 tuple(map(torch.from_numpy, (gy, gs1, gs2))))
    assert _rel(dx, want_dx) < F32
    assert _rel(dw, want_dw) < F32


def test_conv_without_input_gradient_skips_dx():
    """The input conv's x needs no gradient: only dw is computed."""
    rng = np.random.RandomState(2)
    x, w = _t(_rand(rng, 1, 4, 4, 4, 3), False), _t(_rand(rng, 3, 3, 3, 3, 5))
    y, s1, s2 = conv3d_with_stats(x, w)
    (s1.sum() + y.sum()).backward()
    assert x.grad is None and w.grad is not None


# --- the block conv: conv(lrelu(y * inv + shift)) ------------------------------

def _jax_block(y, inv, shift, w):
    z = jax.nn.leaky_relu(y * inv[:, None, None, None, :]
                          + shift[:, None, None, None, :], 0.01)
    out = conv3d_xla(z, w, (1, 1, 1), "SAME")
    return out, jnp.sum(out, axis=(1, 2, 3)), jnp.sum(out * out, axis=(1, 2, 3))


@pytest.mark.parametrize("shape,cin,cout", [((2, 4, 6, 8), 4, 8),
                                            ((1, 6, 4, 4), 8, 8)])
def test_block_vjp_matches_jax_composition(shape, cin, cout):
    rng = np.random.RandomState(3)
    n = shape[0]
    y, w = _rand(rng, *shape, cin), _rand(rng, 3, 3, 3, cin, cout, scale=0.1)
    inv = (rng.rand(n, cin) + 0.5).astype(np.float32)
    shift = _rand(rng, n, cin, scale=0.3)
    g = (_rand(rng, *shape, cout), _rand(rng, n, cout), _rand(rng, n, cout, scale=0.1))
    _, pull = jax.vjp(_jax_block, *map(jnp.asarray, (y, inv, shift, w)))
    want = pull(tuple(map(jnp.asarray, g)))
    tensors = [_t(a) for a in (y, inv, shift, w)]
    ty, tinv, tshift, tw = tensors
    out = conv3d_block_with_stats(ty, tw, tinv, tshift)
    got = torch.autograd.grad(out, tensors, tuple(map(torch.from_numpy, g)))
    for name, a, b in zip(("y", "inv", "shift", "w"), got, want):
        assert _rel(a, b) < F32, name


# --- 3x3x3 stride 2 and its weight gradient -----------------------------------

@pytest.mark.parametrize("shape", [(1, 8, 8, 16, 64, 8), (2, 4, 6, 8, 64, 16)])
def test_s2_wgrad_reference_matches_pallas_kernel(shape):
    """The shapes of tests/test_s2_wgrad.py (C = 64 fills the TPU kernel's
    128-lane (2, C) block)."""
    n, d, h, w, c, co = shape
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d, h, w, c)).astype(np.float32)
    g = rng.normal(size=(n, d // 2, h // 2, w // 2, co)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = s2_wgrad_pallas(jnp.asarray(x), jnp.asarray(g))
    got = wgrad.s2_wgrad(torch.from_numpy(x), torch.from_numpy(g))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, 3, c, co)
    assert _rel(got, want) < F32


def test_stride2_conv_vjp_matches_pallas_wgrad_conv():
    """Forward, dx and dw of the stride-2 conv against the JAX conv whose
    weight gradient runs the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 8, 16, 64)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 64, 8)) * 0.05).astype(np.float32)
    g = rng.normal(size=(1, 4, 4, 8, 8)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_y, (want_dx, want_dw) = jax_vjp(conv3d_s2_pallas_wgrad, (x, w), g)
    tx, tw = _t(x), _t(w)
    y = conv3d(tx, tw, (2, 2, 2))
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))
    assert _rel(y, want_y) < F32
    assert _rel(dx, want_dx) < F32
    assert _rel(dw, want_dw) < F32


@pytest.mark.parametrize("spatial", [(7, 9, 6), (4, 4, 4)])
def test_s2_wgrad_reference_takes_odd_sizes(spatial):
    """Odd D/H/W (Do = ceil(D / 2)), against jax.grad of the XLA conv."""
    rng = np.random.RandomState(4)
    x = _rand(rng, 2, *spatial, 5)
    g = _rand(rng, 2, *((s + 1) // 2 for s in spatial), 7)
    want = jax.grad(lambda w: jnp.sum(conv3d_xla(
        jnp.asarray(x), w, (2, 2, 2), ((1, 1),) * 3) * jnp.asarray(g)))(
            jnp.zeros((3, 3, 3, 5, 7), jnp.float32))
    assert _rel(wgrad.s2_wgrad(torch.from_numpy(x), torch.from_numpy(g)), want) < F32


def test_stride2_conv_vjp_takes_odd_sizes():
    """dx (cuDNN's transposed conv, sized from x) and dw of the stride-2 conv
    on an odd grid, against jax.vjp of the XLA conv with pads of 1."""
    rng = np.random.RandomState(5)
    x, w = _rand(rng, 2, 7, 9, 6, 5), _rand(rng, 3, 3, 3, 5, 7, scale=0.1)
    g = _rand(rng, 2, 4, 5, 3, 7)
    _, pull = jax.vjp(lambda a, b: conv3d_xla(a, b, (2, 2, 2), ((1, 1),) * 3),
                      jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = pull(jnp.asarray(g))
    tx, tw = _t(x), _t(w)
    dx, dw = torch.autograd.grad(conv3d(tx, tw, (2, 2, 2)), (tx, tw), torch.from_numpy(g))
    assert tuple(dx.shape) == x.shape
    assert _rel(dx, want_dx) < F32
    assert _rel(dw, want_dw) < F32


def test_s2_wgrad_rejects_bad_operands_and_other_devices():
    x = torch.zeros(1, 4, 4, 4, 3)
    with pytest.raises(ValueError):
        wgrad.s2_wgrad(x, torch.zeros(1, 4, 4, 4, 2))
    with pytest.raises(TypeError):
        wgrad.s2_wgrad(x, torch.zeros(1, 2, 2, 2, 2, dtype=torch.bfloat16))
    before = dict(wgrad.LAUNCHES)
    with pytest.raises(RuntimeError, match="no kernel"):
        wgrad.s2_wgrad(x.to("meta"), torch.empty(1, 2, 2, 2, 2, device="meta"))
    wgrad.s2_wgrad(x, torch.zeros(1, 2, 2, 2, 2))
    assert wgrad.LAUNCHES == before


@pytest.mark.parametrize("x_shape,cout,want", [
    ((1, 128, 128, 128, 4), 16, 373),  # UNet's first stride-2 conv: splits fill the card
    ((1, 16, 16, 16, 17), 17, 8),      # 16 segments: two a split
    ((1, 5, 7, 3, 3), 1, 1)])          # tiny: fewer than two segments a split
def test_split_k_follows_the_shape(x_shape, cout, want):
    """The split-K rule of the narrow bf16 form (``narrow_plan``): enough
    splits to give three blocks to each of 132 SMs, each at least two
    segments, every segment in exactly one split."""
    plan = wgrad.narrow_plan(x_shape, cout, 132)
    assert plan.splits == want
    assert (plan.splits - 1) * plan.per_split < plan.segments <= plan.splits * plan.per_split


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,cin,cout", [((1, 16, 16, 16), 64, 96),
                                            ((2, 7, 9, 6), 5, 7),
                                            ((1, 8, 8, 8), 256, 384)])
def test_cuda_s2_wgrad_matches_plain(cuda_device, shape, cin, cout, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(*shape, cin, device=cuda_device, generator=gen).to(_DT[dtype])
    g = torch.randn(shape[0], *((s + 1) // 2 for s in shape[1:]), cout,
                    device=cuda_device, generator=gen).to(_DT[dtype])
    before = wgrad.LAUNCHES["s2_wgrad"]
    got = wgrad.s2_wgrad(x, g)
    torch.cuda.synchronize()
    assert wgrad.LAUNCHES["s2_wgrad"] == before + 1
    # both sum the same bf16 products in f32, in another order
    assert _rel(got, wgrad.s2_wgrad_reference(x, g).cpu().numpy()) < 1e-5


def _plain_grads(kind, x, w, inv, shift, cotangents):
    """f32 torch autograd of the plain composition (cuDNN with TF32 off). The
    leaky ReLU takes slope 1 at 0, as the JAX reference (and the port) do;
    F.leaky_relu's backward takes the negative slope there."""
    x, w = x.float().requires_grad_(), w.float().requires_grad_()
    inputs = [x, w]
    z = x
    if kind == "block":
        inv, shift = inv.clone().requires_grad_(), shift.clone().requires_grad_()
        inputs += [inv, shift]
        u = x * inv[:, None, None, None, :] + shift[:, None, None, None, :]
        z = torch.where(u >= 0, u, u * 0.01)
    stride = 2 if kind == "stride2" else 1
    y = F.conv3d(z.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), stride=stride,
                 padding=1).permute(0, 2, 3, 4, 1)
    outs = (y,) if kind == "stride2" else (y, y.sum((1, 2, 3)), (y * y).sum((1, 2, 3)))
    return torch.autograd.grad(outs, inputs, [c.float() for c in cotangents])


def _function_grads(kind, x, w, inv, shift, cotangents):
    """The port's Function on the device the tensors lie on."""
    inputs = [t.clone().requires_grad_() for t in (x, w)]
    if kind == "block":
        inputs += [inv.clone().requires_grad_(), shift.clone().requires_grad_()]
        outs = conv3d_block_with_stats(*inputs)
    elif kind == "stats":
        outs = conv3d_with_stats(*inputs)
    else:
        outs = (conv3d(*inputs, (2, 2, 2)),)
    return torch.autograd.grad(outs, inputs, cotangents)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["stats", "block", "stride2"])
def test_cuda_backward_matches_plain(cuda_device, kind, dtype):
    """The kernels' backward against the same Function's plain bodies on the
    CPU (the bf16 rounding of the folded cotangent included) and, in f32,
    against torch autograd of the plain composition."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    dt = _DT[dtype]
    n, s, cin, cout = 2, 12, 16, 24

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device=cuda_device, generator=gen) * scale

    x = rand(n, s, s, s, cin).to(dt)
    w = rand(3, 3, 3, cin, cout, scale=0.1).to(dt)
    inv, shift = rand(n, cin).abs() + 0.5, rand(n, cin, scale=0.3)
    so = s // 2 if kind == "stride2" else s
    cot = [rand(n, so, so, so, cout).to(dt)]
    if kind != "stride2":
        cot += [rand(n, cout, scale=1e-2), rand(n, cout, scale=1e-3)]
    got = _function_grads(kind, x, w, inv, shift, cot)
    on_cpu = _function_grads(kind, *(t.cpu() for t in (x, w, inv, shift)),
                             [c.cpu() for c in cot])
    torch.cuda.synchronize()
    for a, b in zip(got, on_cpu):
        assert _rel(a, b.float().numpy()) < _TOL[dtype]
    if dtype == "float32":
        for a, b in zip(got, _plain_grads(kind, x, w, inv, shift, cot)):
            assert _rel(a, b.cpu().numpy()) < _TOL[dtype]

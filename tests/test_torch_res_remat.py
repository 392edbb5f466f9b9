"""The port's residual DynUNet, ``remat`` and gradient accumulation against
the JAX package.

The JAX DynUNet with ``res_block=True`` is initialised, its norm scales and
biases moved off their initial values (seeded numpy), saved with
``unet3d_tpu.train.checkpoint`` and loaded into the port; the same numpy
inputs go through both. Tolerances: relative L2 1e-5 on the f32 forward and
1e-4 on each f32 gradient (the instance norms of 16^3 voxels amplify the
packages' different sum orders), 2e-2 on the bf16 AMP forward (both round
activations to bf16, at different places), and the bf16 gradients as
``test_res_gradients_bf16_match_jax`` states. On the CPU ``remat`` recomputes
with the same plain ops in the same order, so its gradients are bit-equal to
those without it. ``grad_accum=2`` is held against the JAX step's scan: the
loss and the updated parameters of one SGD step within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train import checkpoint as jax_ckpt
from unet3d_tpu.train import losses as jax_losses
from unet3d_tpu.train import optim as jax_optim
from unet3d_tpu.train import step as jax_step
from unet3d_tpu.train.step import amp_cast

from unet3d_tpu_torch.convert import load_jax_variables, state_dict_to_flax
from unet3d_tpu_torch.models import dynunet
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d as conv_ops
from unet3d_tpu_torch.train import losses, optim, step
from unet3d_tpu_torch.train.checkpoint import load_checkpoint


MODEL_KWARGS = dict(
    in_channels=4, out_channels=3, spatial_dims=3,
    strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2]], filters=[8, 16, 32],
    kernel_size=[[3, 3, 3]] * 3, upsample_kernel_size=[[2, 2, 2]] * 2,
    res_block=True)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    model = jax_create_model("DynUNet", **MODEL_KWARGS)
    x0 = jnp.zeros((1, 16, 16, 16, 4), jnp.float32)
    variables = jax.jit(lambda r: model.init(r, x0, False))(jax.random.PRNGKey(1))
    rng = np.random.RandomState(5)
    flat = {}
    for key, value in _flat(variables).items():
        value = np.asarray(value, np.float32)
        if key.endswith("scale"):
            value = value + 0.3 * rng.randn(*value.shape).astype(np.float32)
        elif key.endswith("bias"):
            value = value + 0.1 * rng.randn(*value.shape).astype(np.float32)
        flat[key] = value
    path = str(tmp_path_factory.mktemp("res") / "model.npz")
    jax_ckpt.save_checkpoint(_variables(flat), path)
    x = rng.randn(2, 16, 16, 16, 4).astype(np.float32)
    labels = (rng.rand(2, 3, 16, 16, 16) > 0.5).astype(np.float32)
    return model, flat, path, x, labels


def _jax_vjp(fn, primals, cotangent):
    """``fn``'s VJP as one jitted computation, like ``test_torch_grad.jax_vjp``
    (an eager VJP can deadlock against interpret-mode kernels), for pytree
    primals."""
    def vjp(p, c):
        return jax.vjp(fn, *p)[1](c)
    return jax.jit(vjp)(primals, jnp.asarray(cotangent))


def _variables(flat):
    """A fresh JAX variable tree (the JAX train step donates its state)."""
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _port(path, **overrides):
    net = create_model("DynUNet", **{**MODEL_KWARGS, **overrides})
    return load_jax_variables(net, load_checkpoint(path), strict=True)


def test_res_block_tree_matches_jax(setup):
    """Every Flax parameter, the projections included, has its port
    counterpart of the same shape, and no other exists."""
    _, flat, _, _, _ = setup
    got = {k: tuple(v.shape) for k, v in
           state_dict_to_flax(create_model("DynUNet", **MODEL_KWARGS).state_dict()).items()}
    assert got == {k: v.shape for k, v in flat.items()}
    assert "params/input_block/conv3/kernel" in got  # 4 -> 8 channels: projected
    assert got["params/downsample0/conv3/kernel"] == (1, 1, 1, 8, 16)  # stride 2
    assert not any(k.startswith("params/upsample") and "conv3" in k for k in got)


def _jax_fn(model, amp):
    def fn(p, z):
        if amp:
            (v, z) = amp_cast({"params": p}, z)
            return model.apply(v, z, False).astype(jnp.float32)
        return model.apply({"params": p}, z, False)
    return fn


def _port_out(net, xt, amp):
    if amp:
        named = dict(net.named_parameters())
        return torch.func.functional_call(net, step.amp_cast(named),
                                          (xt.to(torch.bfloat16),)).float()
    return net(xt)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_res_forward_matches_jax(setup, amp):
    model, flat, path, x, _ = setup
    want = np.asarray(jax.jit(_jax_fn(model, amp))(_variables(flat)["params"],
                                                    jnp.asarray(x)))
    with torch.no_grad():
        got = _port_out(_port(path), torch.from_numpy(x), amp).numpy()
    assert got.shape == want.shape == (2, 16, 16, 16, 3)
    assert _rel(got, want) <= (2e-2 if amp else 1e-5)


def _gradients(setup, amp):
    """Both packages' gradients of the output against a seeded cotangent,
    w.r.t. every parameter (Flax keys) and the input."""
    model, flat, path, x, _ = setup
    cot = np.random.RandomState(6).randn(2, 16, 16, 16, 3).astype(np.float32)
    want_p, want_x = _jax_vjp(_jax_fn(model, amp),
                              (_variables(flat)["params"], jnp.asarray(x)), cot)
    want = _flat({"params": want_p})
    want["input"] = np.asarray(want_x, np.float32)
    net = _port(path)
    xt = torch.from_numpy(x).requires_grad_()
    (_port_out(net, xt, amp) * torch.from_numpy(cot)).sum().backward()
    got = {"params/" + k.replace(".", "/"): p.grad.numpy()
           for k, p in net.named_parameters()}
    got["input"] = xt.grad.numpy()
    return got, want


def _all(grads):
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


def test_res_gradients_f32_match_jax(setup):
    got, want = _gradients(setup, amp=False)
    assert got.keys() == want.keys()
    for key in want:
        assert _rel(got[key], want[key]) <= 1e-4, key


def test_res_gradients_bf16_match_jax(setup):
    """At this size bf16 rounding moves the gradients ~12% (relative L2 over
    all of them) from the f32 ones on either side, so the two packages' AMP
    gradients lie ~12% apart (as tests/test_torch_train.py measured for the
    basic block): over all parameters they must agree within 0.15, and the
    port's must lie no further from the f32 gradients than JAX's."""
    got, want = _gradients(setup, amp=True)
    f32, _ = _gradients(setup, amp=False)
    assert _rel(_all(got), _all(want)) < 0.15
    assert _rel(_all(got), _all(f32)) <= _rel(_all(want), _all(f32))


def _grads(net, x, y, amp):
    net.zero_grad(set_to_none=True)
    step.forward_loss(net, losses.DiceLoss(sigmoid=True),
                      x.to(torch.bfloat16) if amp else x, y, amp).backward()
    return {k: p.grad.clone() for k, p in net.named_parameters()}


@pytest.mark.parametrize("res_block", [False, True], ids=["basic", "res"])
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_remat_gradients_are_bit_equal(setup, amp, res_block):
    """remat recomputes each block from its input on the parameters the
    forward ran on: under AMP the bf16 copies, not the f32 masters the
    module holds again when the backward runs."""
    *_, path, x, labels = setup
    kwargs = dict(res_block=res_block, deep_supervision=True, deep_supr_num=1)
    plain = create_model("DynUNet", **{**MODEL_KWARGS, **kwargs})
    init_parameters(plain, torch.Generator().manual_seed(2))
    remat = create_model("DynUNet", **{**MODEL_KWARGS, **kwargs, "remat": True})
    remat.load_state_dict(plain.state_dict())
    xt = torch.from_numpy(x)
    y = torch.from_numpy(labels).permute(0, 2, 3, 4, 1).contiguous()
    want, got = _grads(plain, xt, y, amp), _grads(remat, xt, y, amp)
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], want[key]), key


def test_remat_runs_the_kernel_sites_again_in_the_backward(setup, monkeypatch):
    """Under remat, one training step calls the stats-epilogue and
    block-prologue convs twice as often as the forward does: the backward's
    recompute goes through the same kernels."""
    *_, path, x, labels = setup
    calls = {"conv_stats": 0, "block_stats": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(conv_ops, "conv3x3x3_with_stats",
                        counted("conv_stats", conv_ops.conv3x3x3_with_stats))
    monkeypatch.setattr(conv_ops, "conv3x3x3_block_with_stats",
                        counted("block_stats", conv_ops.conv3x3x3_block_with_stats))
    net = _port(path, remat=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        net(xt)
    forward = dict(calls)
    # input block conv1 and the two up-block conv1s; every block's conv2
    assert forward == {"conv_stats": 3, "block_stats": 5}
    calls.update(conv_stats=0, block_stats=0)
    y = torch.from_numpy(labels).permute(0, 2, 3, 4, 1).contiguous()
    step.forward_loss(net, losses.DiceLoss(sigmoid=True), xt, y, False).backward()
    assert calls == {k: 2 * v for k, v in forward.items()}
    assert isinstance(net.input_block, dynunet.UnetResBlock)
    assert isinstance(net.upsample0.conv_block, dynunet.UnetBasicBlock)
    assert not isinstance(net.upsample0.conv_block, dynunet.UnetResBlock)


def test_grad_accumulation_matches_jax_scan(setup):
    """grad_accum=2 on a batch of 2 against the JAX step's scan: the mean
    loss, the f32 gradients (SGD lr 1: p - p_after) and the parameters after
    one SGD update at lr 1e-2."""
    model, flat, path, x, labels = setup
    images = np.ascontiguousarray(np.moveaxis(x, -1, 1))
    results = {}
    for lr in (1.0, 1e-2):
        tx = jax_optim.build_optimizer("SGD", lr=lr)
        state = jax_step.create_train_state(_variables(flat), tx)
        before = _flat({"params": state.params})
        state, jloss = jax_step.make_train_step(
            model, jax_losses.DiceLoss(sigmoid=True), tx, grad_accum=2)(
                state, images, labels)
        after = _flat({"params": state.params})
        net = _port(path)
        opt = optim.build_optimizer("SGD", net.parameters(), lr=lr)
        loss = step.make_train_step(net, losses.DiceLoss(sigmoid=True), opt,
                                    grad_accum=2)(images, labels)
        got = state_dict_to_flax(net.state_dict())
        results[lr] = (float(jloss), float(loss), before, after, got)
    want_loss, loss, before, after, got = results[1.0]
    np.testing.assert_allclose(loss, want_loss, atol=1e-5)
    for key in after:
        assert _rel(before[key] - got[key], before[key] - after[key]) <= 1e-4, key
    want_loss, loss, _, after, got = results[1e-2]
    np.testing.assert_allclose(loss, want_loss, atol=1e-5)
    for key in after:
        np.testing.assert_allclose(got[key], after[key], atol=1e-5, err_msg=key)


def test_grad_accumulation_equals_the_full_batch_step(setup):
    """On the port alone: two microbatches give the full batch's mean loss
    and gradients (DiceLoss decomposes per sample), and a batch the count
    does not divide raises."""
    *_, path, x, labels = setup
    images = np.ascontiguousarray(np.moveaxis(x, -1, 1))
    grads, loss = [], []
    for accum in (1, 2):
        net = _port(path)
        opt = optim.build_optimizer("SGD", net.parameters(), lr=0.0)
        loss.append(float(step.make_train_step(net, losses.DiceLoss(sigmoid=True), opt,
                                               grad_accum=accum)(images, labels)))
        grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
    np.testing.assert_allclose(loss[1], loss[0], rtol=1e-6)
    for key in grads[0]:
        assert _rel(grads[1][key].numpy(), grads[0][key].numpy()) <= 1e-5, key
    net = _port(path)
    opt = optim.build_optimizer("SGD", net.parameters(), lr=0.0)
    with pytest.raises(ValueError, match="not divisible"):
        step.make_train_step(net, losses.DiceLoss(sigmoid=True), opt, grad_accum=3)(
            images, labels)


def test_compute_criterion_takes_tuples_like_jax():
    """A model's (output, *extras): scalar extras are added as auxiliary
    terms, other extras ignored, and a wants_extras criterion gets mu and
    logvar."""
    rng = np.random.RandomState(9)
    out = rng.randn(2, 4, 4, 4, 2).astype(np.float32)
    target = rng.rand(2, 4, 4, 4, 2).astype(np.float32)
    aux, mu, logvar = np.float32(0.37), rng.randn(2, 8).astype(np.float32), \
        0.1 * rng.randn(2, 8).astype(np.float32)
    cases = [
        (jax_losses.MSELoss(), losses.MSELoss(), (out, aux, mu)),
        (jax_losses.DiceLoss(sigmoid=True), losses.DiceLoss(sigmoid=True), (out,)),
        (jax_losses.VAELoss(beta=0.5), losses.VAELoss(beta=0.5), (out, mu, logvar)),
        (jax_losses.VAELoss(), losses.VAELoss(), (out,)),
    ]
    for jax_crit, crit, parts in cases:
        want = jax_step.compute_criterion(jax_crit, tuple(jnp.asarray(p) for p in parts),
                                          jnp.asarray(target))
        got = step.compute_criterion(crit, tuple(torch.from_numpy(np.asarray(p))
                                                 for p in parts), torch.from_numpy(target))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)

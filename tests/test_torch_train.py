"""The port's training path against the JAX package.

Seeded numpy parameters in the Flax tree's names and shapes (norm scale and
bias off their initial values, where bf16 does not hold them exactly) are
saved with ``unet3d_tpu.train.checkpoint`` and loaded into the port; the same
numpy batches go to both train steps and both training engines.

Tolerances: the f32 SGD step's loss, gradients and updated parameters at
atol 2e-4 / rtol 1e-3, as tests/test_torch_dynunet.py holds the f32 forward
(instance norms over 16^3 voxels, other sum orders); the bf16 AMP step as
``test_amp_step_matches_jax`` states (both round activations and cotangents to
bf16, at different places); the engine's CSV log over 3 Adam steps at rtol
1e-4 and its checkpoint within 2 lr per step (see the test); DiceLoss at 1e-6
in f32 and within bf16 rounding (1e-2) in bf16; the schedulers exactly.
"""
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.ops.interpolate import resize_ndhwc as jax_resize
from unet3d_tpu.train import checkpoint as jax_ckpt
from unet3d_tpu.train import losses as jax_losses
from unet3d_tpu.train import optim as jax_optim
from unet3d_tpu.train import step as jax_step
from unet3d_tpu.train import train as jax_train

from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                             build_scheduler_from_config,
                                             load_criterion_from_config)
from unet3d_tpu_torch.convert import (flax_to_state_dict, load_jax_variables,
                                      state_dict_to_flax)
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops.interpolate import resize_ndhwc
from unet3d_tpu_torch.train import losses, optim, step, train
from unet3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from unet3d_tpu_torch.utils.config import load_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KWARGS = dict(
    in_channels=4, out_channels=3, spatial_dims=3,
    strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2]], filters=[8, 16, 32],
    kernel_size=[[3, 3, 3]] * 3, upsample_kernel_size=[[2, 2, 2]] * 2,
    deep_supervision=True, deep_supr_num=1)
F32 = dict(atol=2e-4, rtol=1e-3)


class Loader:
    """In-memory loader: the same batches every epoch, with the protocol the
    engines use (iteration, ``len``, ``set_epoch``)."""

    def __init__(self, batches):
        self.batches = batches
        self.epochs = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    model = jax_create_model("DynUNet", **MODEL_KWARGS)
    rng = np.random.RandomState(7)
    flat = {}
    for key, p in create_model("DynUNet", **MODEL_KWARGS).state_dict().items():
        shape = tuple(p.shape)
        if key.endswith("kernel"):
            value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif key.endswith("scale"):
            value = 1.0 + 0.3 * rng.randn(*shape)
        else:
            value = 0.1 * rng.randn(*shape)
        flat["params/" + key.replace(".", "/")] = value.astype(np.float32)
    path = str(tmp_path_factory.mktemp("ckpt") / "model.npz")
    jax_ckpt.save_checkpoint(_variables(flat), path)
    images = rng.randn(2, 4, 16, 16, 16).astype(np.float32)
    labels = (rng.rand(2, 3, 16, 16, 16) > 0.5).astype(np.float32)
    return model, flat, path, images, labels


def _variables(flat):
    """A fresh JAX variable tree (the JAX train step donates its state)."""
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _port(path):
    model = create_model("DynUNet", **MODEL_KWARGS)
    return load_jax_variables(model, load_checkpoint(path))


def _jax_sgd_step(setup, amp):
    """JAX loss and gradients of one SGD step with lr 1: g = p - p_after."""
    model, flat, _, images, labels = setup
    tx = jax_optim.build_optimizer("SGD", lr=1.0)
    state = jax_step.create_train_state(_variables(flat), tx)
    before = _flat({"params": state.params})
    state, loss = jax_step.make_train_step(model, jax_losses.DiceLoss(sigmoid=True),
                                           tx, amp=amp)(state, images, labels)
    after = _flat({"params": state.params})
    return float(loss), {k: before[k] - after[k] for k in before}, after


def _port_sgd_step(setup, amp):
    *_, path, images, labels = setup
    net = _port(path)
    opt = optim.build_optimizer("SGD", net.parameters(), lr=1.0)
    loss = step.make_train_step(net, losses.DiceLoss(sigmoid=True), opt, amp=amp)(
        images, labels)
    grads = {"params/" + k.replace(".", "/"): p.grad.numpy()
             for k, p in net.named_parameters()}
    return float(loss), grads, state_dict_to_flax(net.state_dict())


def test_sgd_step_f32_matches_jax(setup):
    want_loss, want_grads, want_after = _jax_sgd_step(setup, amp=False)
    loss, grads, after = _port_sgd_step(setup, amp=False)
    np.testing.assert_allclose(loss, want_loss, **F32)
    assert set(grads) == set(want_grads)
    for key in grads:
        assert grads[key].dtype == np.float32
        np.testing.assert_allclose(grads[key], want_grads[key], err_msg=key, **F32)
        np.testing.assert_allclose(after[key], want_after[key], err_msg=key, **F32)


def _rel_l2(a, b, keys):
    a = np.concatenate([a[k].ravel() for k in keys])
    b = np.concatenate([b[k].ravel() for k in keys])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_amp_step_matches_jax(setup):
    """bf16 rounding moves every gradient of this small net by ~8% (relative
    L2 of each AMP step against the f32 step, on either side). The gradients
    of the two 1x1x1 heads' biases are sums over all voxels that XLA on the
    CPU accumulates in bf16 (~45% off the f32 gradient); torch accumulates in
    f32. So: the losses agree to 1e-3, the gradients of every other parameter
    to relative L2 0.15 (measured 0.074), and over all parameters the port's
    AMP gradient is no further from the f32 gradient than JAX's."""
    want_loss, want_grads, _ = _jax_sgd_step(setup, amp=True)
    loss, grads, _ = _port_sgd_step(setup, amp=True)
    _, f32_grads, _ = _port_sgd_step(setup, amp=False)
    assert abs(loss - want_loss) < 1e-3 * abs(want_loss)
    keys = sorted(grads)
    summed_in_bf16 = [k for k in keys if k.endswith("bias")
                      and ("output_block" in k or "deep_supervision_head" in k)]
    assert len(summed_in_bf16) == 2
    rest = [k for k in keys if k not in summed_in_bf16]
    assert _rel_l2(grads, want_grads, rest) < 0.15
    assert _rel_l2(grads, f32_grads, keys) <= _rel_l2(want_grads, f32_grads, keys)


def test_amp_forward_runs_on_bf16_copies_of_every_parameter(setup):
    """Norm scale and bias are rounded to bf16 before the forward, as the JAX
    step casts the whole parameter tree: the AMP loss equals, bit for bit,
    the loss of a bf16 copy of the model, and the gradients land on the f32
    masters."""
    *_, path, images, labels = setup
    net = _port(path)
    crit = losses.DiceLoss(sigmoid=True)
    x, y = step.prepare_batch(images, labels, torch.device("cpu"), amp=True)
    assert x.dtype == torch.bfloat16
    loss = step.forward_loss(net, crit, x, y, amp=True)
    with torch.no_grad():
        want = step.compute_criterion(crit, copy.deepcopy(net).to(torch.bfloat16)(
            x, train=True), y)
    assert torch.equal(loss.detach(), want)
    loss.backward()
    assert net.input_block.norm1.scale.dtype == torch.float32
    assert net.input_block.norm1.scale.grad.dtype == torch.float32
    assert float(net.input_block.norm1.scale.grad.abs().max()) > 0


def test_training_engines_agree_over_three_adam_steps(setup, tmp_path):
    """Both run_trainings: 3 epochs of one Adam step, a validation pass each,
    ReduceLROnPlateau; the CSV logs and the checkpoint files agree."""
    model, flat, path, images, labels = setup
    batches = [{"image": images, "label": labels}]
    crit_j = jax_losses.DiceLoss(sigmoid=True)
    tx = jax_optim.build_optimizer("Adam", lr=1e-3)
    state = jax_step.create_train_state(_variables(flat), tx)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_train.run_training(
        jax_step.make_train_step(model, crit_j, tx), jax_step.make_eval_step(model, crit_j),
        state, 3, Loader(batches), Loader(batches), str(tmp_path / "jax" / "log.csv"),
        str(tmp_path / "jax" / "model.npz"), save_best=True,
        scheduler=jax_optim.ReduceLROnPlateau(1e-3, patience=10, factor=0.5, min_lr=1e-8))

    net = _port(path)
    crit = losses.DiceLoss(sigmoid=True)
    opt = optim.build_optimizer("Adam", net.parameters(), lr=1e-3)
    loader = Loader(batches)
    train.run_training(
        step.make_train_step(net, crit, opt), step.make_eval_step(net, crit), net, opt,
        3, loader, Loader(batches), str(tmp_path / "port" / "log.csv"),
        str(tmp_path / "port" / "model.npz"), save_best=True,
        scheduler=optim.ReduceLROnPlateau(1e-3, patience=10, factor=0.5, min_lr=1e-8))

    want = train.read_training_log(str(tmp_path / "jax" / "log.csv"))
    got = train.read_training_log(str(tmp_path / "port" / "log.csv"))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1][1] < got[0][1]
    assert loader.epochs == [1, 2, 3]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    # Adam moves each parameter by ~lr * sign(g) a step; where g is ~0 the two
    # sides may step opposite ways, so the bound is 2 lr per step
    trained = _flat(jax_ckpt.load_checkpoint(str(tmp_path / "jax" / "model.npz")))
    for key, value in load_checkpoint(str(tmp_path / "port" / "model.npz")).items():
        np.testing.assert_allclose(value, trained[key], err_msg=key, atol=3 * 2 * 1e-3)


def test_checkpoint_the_port_writes_loads_in_jax(setup, tmp_path):
    model, _, path, images, _ = setup
    net = _port(path)
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(1.1)
    out = str(tmp_path / "model.npz")
    save_checkpoint(net, out)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    loaded = jax_ckpt.load_checkpoint(out)
    x = np.moveaxis(images, 1, -1)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, False))(loaded, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    np.testing.assert_allclose(got, want, **F32)
    # and in the port's own loader, bit for bit
    again = load_jax_variables(create_model("DynUNet", **MODEL_KWARGS), load_checkpoint(out))
    for (k, a), b in zip(net.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    assert set(flax_to_state_dict(state_dict_to_flax(net.state_dict()))) == set(
        net.state_dict())


def test_deep_supervision_train_forward_matches_jax(setup):
    model, flat, path, images, _ = setup
    x = np.ascontiguousarray(np.moveaxis(images, 1, -1))
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, True))(
        _variables(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = _port(path)(torch.from_numpy(x), train=True).numpy()
    assert got.shape == want.shape == (2, 2, 16, 16, 16, 3)
    np.testing.assert_allclose(got, want, **F32)


# --- losses -------------------------------------------------------------------

DICE_CASES = [dict(sigmoid=True), dict(softmax=True, include_background=False),
              dict(sigmoid=True, batch=True, squared_pred=True),
              dict(sigmoid=True, jaccard=True, reduction="sum"),
              dict(reduction="none")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", DICE_CASES)
def test_dice_loss_matches_jax(kwargs, dtype):
    rng = np.random.RandomState(11)
    pred = rng.randn(2, 6, 5, 4, 3).astype(np.float32)
    target = (rng.rand(2, 6, 5, 4, 3) > 0.5).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jl = jax_losses.DiceLoss(**kwargs)
    want, want_g = jax.value_and_grad(lambda p: jnp.sum(jl(p, jnp.asarray(target))))(
        jnp.asarray(pred, jdt))
    p = torch.from_numpy(pred).to(tdt).requires_grad_()
    got = losses.DiceLoss(**kwargs)(p, torch.from_numpy(target))
    got.sum().backward()
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach().sum()), float(want), rtol=tol, atol=tol)
    g, wg = p.grad.float().numpy(), np.asarray(want_g, np.float32)
    assert np.linalg.norm(g - wg) <= tol * np.linalg.norm(wg)


def test_deep_supervision_weighting_matches_jax():
    rng = np.random.RandomState(12)
    out = rng.randn(2, 3, 4, 4, 4, 2).astype(np.float32)
    target = (rng.rand(2, 4, 4, 4, 2) > 0.5).astype(np.float32)
    want = jax_step.compute_criterion(jax_losses.DiceLoss(sigmoid=True),
                                      jnp.asarray(out), jnp.asarray(target))
    got = step.compute_criterion(losses.DiceLoss(sigmoid=True), torch.from_numpy(out),
                                 torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_unported_names_raise():
    with pytest.raises(ValueError, match="ROADMAP"):
        losses.load_criterion("FocalLoss")
    with pytest.raises(ValueError, match="ROADMAP"):
        optim.build_optimizer("RMSprop", [torch.zeros(1, requires_grad=True)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        save_checkpoint(torch.nn.Linear(1, 1), "model.orbax")


def test_factories_read_the_brats_config():
    config = load_json(os.path.join(ROOT, "examples", "brats2020", "brats2020_config.json"))
    crit = load_criterion_from_config(config)
    assert isinstance(crit, losses.DiceLoss) and crit.sigmoid and crit.include_background
    opt = build_optimizer_from_config(config, [torch.zeros(2, requires_grad=True)])
    assert isinstance(opt, torch.optim.Adam) and optim.get_learning_rate(opt) == 1e-3
    sched = build_scheduler_from_config(config, optim.get_learning_rate(opt))
    assert isinstance(sched, optim.ReduceLROnPlateau)
    assert (sched.patience, sched.factor, sched.min_lr) == (10, 0.5, 1e-8)
    assert build_scheduler_from_config({}, 1e-3) is None
    optim.set_learning_rate(opt, 5e-4)
    assert optim.get_learning_rate(opt) == 5e-4


SCHEDULERS = [("StepLR", dict(step_size=3, gamma=0.5)),
              ("MultiStepLR", dict(milestones=[2, 5], gamma=0.1)),
              ("ExponentialLR", dict(gamma=0.9)),
              ("CosineAnnealingLR", dict(T_max=7, eta_min=1e-5)),
              ("PolynomialLR", dict(total_iters=6, power=2.0)),
              ("ReduceLROnPlateau", dict(patience=2, factor=0.5, cooldown=1, min_lr=1e-4)),
              ("LinearLR", dict(start_factor=0.25, total_iters=4)),
              ("ConstantLR", dict(factor=0.5, total_iters=3)),
              ("CosineAnnealingWarmRestarts", dict(T_0=3, T_mult=2))]


@pytest.mark.parametrize("name,kwargs", SCHEDULERS)
def test_schedulers_step_like_jax(name, kwargs):
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.8, 0.8, 0.81, 0.82, 0.83, 0.7, 0.7]
    ours = optim.build_scheduler(name, 1e-2, **kwargs)
    theirs = jax_optim.build_scheduler(name, 1e-2, **kwargs)
    assert ours.lr == theirs.lr
    for m in metrics:
        assert ours.step(m) == theirs.step(m)
        assert ours.lr == theirs.lr


@pytest.mark.parametrize("out", [(16, 16, 16), (7, 12, 5)])
def test_nearest_resize_matches_jax(out):
    x = np.random.RandomState(13).randn(2, 4, 6, 5, 3).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), out, mode="nearest"))
    np.testing.assert_array_equal(resize_ndhwc(torch.from_numpy(x), out).numpy(), want)


# --- the engine's bookkeeping, with scripted losses ---------------------------

SCRIPTS = {
    # val loss improves, stalls past the patience, training stops early
    "plateau": [0.9, 0.8, 0.85, 0.86, 0.7, 0.75, 0.76, 0.77, 0.78],
    # a NaN validation loss stops the next epoch
    "nan": [0.9, 0.8, 0.7, 0.75, 0.6, float("nan"), 0.5, 0.4],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_engine_bookkeeping_matches_jax(script, tmp_path):
    """CSV rows, scheduler replay on resume, early and NaN stops, and the
    checkpoint family (latest, best, every N, last N) against the JAX engine."""
    val = SCRIPTS[script]
    batches = [{"image": np.zeros((1, 1)), "label": np.zeros((1, 1))}] * 2
    kwargs = dict(early_stopping_patience=3, save_best=True, save_every_n_epochs=2,
                  save_last_n_models=2)

    def jax_run(n_epochs, directory, counter):
        def train_step(state, images, labels):
            counter[0] += 1
            return state, jnp.float32(1.0 / counter[0])

        def eval_step(state, images, labels):
            return jnp.float32(val[min(counter[0] // 2, len(val)) - 1])

        tx = jax_optim.build_optimizer("Adam", lr=1e-3)
        state = jax_step.create_train_state({"params": {"w": jnp.zeros(2)}}, tx)
        jax_train.run_training(
            train_step, eval_step, state, n_epochs, Loader(batches), Loader(batches[:1]),
            str(directory / "log.csv"), str(directory / "model.npz"),
            scheduler=jax_optim.ReduceLROnPlateau(1e-3, patience=1, factor=0.5), **kwargs)

    def port_run(n_epochs, directory, counter):
        def train_step(images, labels):
            counter[0] += 1
            return torch.tensor(1.0 / counter[0])

        def eval_step(images, labels):
            return torch.tensor(val[min(counter[0] // 2, len(val)) - 1])

        net = torch.nn.Linear(2, 1, bias=False)
        opt = optim.build_optimizer("Adam", net.parameters(), lr=1e-3)
        train.run_training(
            train_step, eval_step, net, opt, n_epochs, Loader(batches), Loader(batches[:1]),
            str(directory / "log.csv"), str(directory / "model.npz"),
            scheduler=optim.ReduceLROnPlateau(1e-3, patience=1, factor=0.5), **kwargs)
        return opt

    for run, name in ((jax_run, "jax"), (port_run, "port")):
        (tmp_path / name).mkdir()
        counter = [0]
        run(4, tmp_path / name, counter)     # first run
        counter[0] = 8                       # resume where the epochs left off
        run(len(val), tmp_path / name, counter)
    assert (open(tmp_path / "port" / "log.csv").read()
            == open(tmp_path / "jax" / "log.csv").read())
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    rows = train.read_training_log(str(tmp_path / "port" / "log.csv"))
    assert len(rows) < len(val)  # stopped early, one way or the other

"""The port's BatchNorm and the ``batch_stats`` collection against the JAX
package: ``layers.BatchNorm`` against ``flax.linen.BatchNorm``, the
running statistics through the train and eval steps, ``make_forward`` and
the checkpoints both ways.

Tolerances, relative L2: 1e-6 on the f32 BatchNorm forward (train and
eval) and on the running statistics after three updates; 1e-2 on a bf16
forward (bf16 rounding of the output). ``torch.nn.BatchNorm3d`` is shown to
land off Flax (it stores the unbiased variance and weights its momentum the
other way). The helpers at the end hold whole nets against their JAX
modules for ``test_torch_segresnet_ds.py`` and ``test_torch_monai_nets.py``.
"""
import contextlib
import copy
import functools
from unittest import mock

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train import checkpoint as jax_ckpt
from unet3d_tpu.train import losses as jax_losses
from unet3d_tpu.train import optim as jax_optim
from unet3d_tpu.train import step as jax_step

from unet3d_tpu_torch.convert import (flax_keys, flax_to_state_dict, load_jax_variables,
                                      model_variables, state_dict_to_flax)
from unet3d_tpu_torch.models import vnet as port_vnet
from unet3d_tpu_torch.models.layers import BatchNorm, init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.predict.sliding_window import build_inferer
from unet3d_tpu_torch.predict.volumetric import make_forward
from unet3d_tpu_torch.train import losses, optim, step
from unet3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from test_torch_myronenko import _all, _cast, _flat, _rel, _x

F32, F32_GRAD, BF16 = 1e-5, 1e-4, 2e-2
BN_F32, BN_BF16 = 1e-6, 1e-2
C = 6


def _flax_bn(momentum=0.9):
    return fnn.BatchNorm(use_running_average=None, momentum=momentum, epsilon=1e-5)


def _bn_variables(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"scale": (1 + 0.3 * rng.randn(C)).astype(np.float32),
                       "bias": (0.1 * rng.randn(C)).astype(np.float32)},
            "batch_stats": {"mean": (0.2 * rng.randn(C)).astype(np.float32),
                            "var": (1 + 0.5 * rng.rand(C)).astype(np.float32)}}


def _port_bn(variables, momentum=0.9):
    bn = BatchNorm(C, momentum=momentum)
    load_jax_variables(bn, _flat(variables), strict=True)
    return bn


def _bn_x(seed=1, shape=(2, 4, 5, 3, C)):
    # an offset mean: the E[x^2] - E[x]^2 variance has digits to lose
    return (1.5 + 2.0 * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batch_norm_matches_flax_f32(train):
    variables, x = _bn_variables(), _bn_x()
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    bn = _port_bn(variables)
    if train:
        want, updates = _flax_bn().apply(jv, jnp.asarray(x), use_running_average=False,
                                         mutable=["batch_stats"])
    else:
        want = _flax_bn().apply(jv, jnp.asarray(x), use_running_average=True)
    with torch.no_grad():
        got = bn(torch.from_numpy(x), train)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < BN_F32
    stats = {k: v.numpy() for k, v in bn.named_buffers()}
    expected = updates["batch_stats"] if train else variables["batch_stats"]
    for key in ("mean", "var"):
        assert _rel(stats[key], expected[key]) < BN_F32, key


@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_running_statistics_after_three_updates(momentum):
    """Three training forwards on three batches: Flax's ``ra = m ra + (1 -
    m) batch`` with the biased variance, once per forward."""
    variables = _bn_variables(3)
    bn = _port_bn(variables, momentum)
    state = jax.tree_util.tree_map(jnp.asarray, variables)
    for i in range(3):
        x = _bn_x(10 + i)
        _, updates = _flax_bn(momentum).apply(state, jnp.asarray(x), use_running_average=False,
                                              mutable=["batch_stats"])
        state = {"params": state["params"], "batch_stats": updates["batch_stats"]}
        with torch.no_grad():
            bn(torch.from_numpy(x), True)
    for key in ("mean", "var"):
        assert _rel(getattr(bn, key).numpy(), state["batch_stats"][key]) < BN_F32, key
    # one update is exactly the formula, the variance the biased one
    x = torch.from_numpy(_bn_x(20))
    before = bn.mean.clone(), bn.var.clone()
    with torch.no_grad():
        bn(x, True)
    flat = x.reshape(-1, C).double()
    for got, old, batch in zip((bn.mean, bn.var), before,
                               (flat.mean(0), flat.var(0, unbiased=False))):
        want = momentum * old.double() + (1 - momentum) * batch
        assert _rel(got.numpy(), want.numpy()) < BN_F32


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batch_norm_matches_flax_bf16(train):
    """bf16 AMP: in training the parameters are bf16 and the statistics f32
    (the train step casts only params), the normalisation in f32, the output
    bf16; in eval everything is bf16 (the inference cast covers batch_stats)
    and the normalisation runs in bf16 on bf16 running statistics."""
    variables, x = _bn_variables(4), _bn_x(5)
    bn = _port_bn(variables)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if train:
        jv = {"params": _cast(variables["params"]),
              "batch_stats": jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])}
        want, updates = _flax_bn().apply(jv, xb, use_running_average=False,
                                         mutable=["batch_stats"])
        params = {k: v.to(torch.bfloat16) for k, v in bn.named_parameters()}
        with torch.no_grad():
            got = functional_call(bn, params, (torch.from_numpy(x).to(torch.bfloat16), True))
        for key in ("mean", "var"):
            assert getattr(bn, key).dtype == torch.float32
            assert updates["batch_stats"][key].dtype == jnp.float32
            assert _rel(getattr(bn, key).numpy(), updates["batch_stats"][key]) < BN_F32
    else:
        want = _flax_bn().apply(_cast(variables), xb, use_running_average=True)
        with torch.no_grad():
            got = copy.deepcopy(bn).to(torch.bfloat16)(
                torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) < BN_BF16


def test_torch_batchnorm3d_is_not_flax():
    """``torch.nn.BatchNorm3d`` with torch's momentum 0.1 (the weight of the
    new value, Flax's 0.9) lands off Flax's running variance after three
    updates by the unbiased correction n / (n - 1); the port's does not."""
    variables = _bn_variables(6)
    bn = _port_bn(variables)
    ref = torch.nn.BatchNorm3d(C, momentum=0.1, eps=1e-5)
    with torch.no_grad():
        ref.running_mean.copy_(bn.mean)
        ref.running_var.copy_(bn.var)
    ref.train()
    state = jax.tree_util.tree_map(jnp.asarray, variables)
    shape = (2, 2, 2, 2, C)  # 16 values per channel: n / (n - 1) = 16 / 15
    for i in range(3):
        x = _bn_x(30 + i, shape)
        _, updates = _flax_bn().apply(state, jnp.asarray(x), use_running_average=False,
                                      mutable=["batch_stats"])
        state = {"params": state["params"], "batch_stats": updates["batch_stats"]}
        with torch.no_grad():
            bn(torch.from_numpy(x), True)
            ref(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    want = np.asarray(state["batch_stats"]["var"])
    assert _rel(bn.var.numpy(), want) < BN_F32
    assert _rel(ref.running_mean.numpy(), np.asarray(state["batch_stats"]["mean"])) < BN_F32
    assert _rel(ref.running_var.numpy(), want) > 1e-2


# --- checkpoints -------------------------------------------------------------

DS_KWARGS = dict(init_filters=4, in_channels=2, out_channels=3, blocks_down=[1, 1],
                 dsdepth=2)


@pytest.fixture(scope="module")
def ds():
    """A small SegResNetDS and its JAX variables, the statistics moved off
    their initial values."""
    x = _x(1, 8, 8, 8, 2, seed=2)
    jmod = jax_create_model("SegResNetDS", **DS_KWARGS)
    return jmod, bn_init(jmod, x)


def test_jax_checkpoint_with_batch_stats_loads_strictly_both_ways(ds, tmp_path):
    """A JAX ``.npz`` with ``params`` and ``batch_stats`` loads strictly into
    the port; the port writes each buffer under ``batch_stats/`` and its file
    loads strictly into the JAX model with equal arrays."""
    jmod, variables = ds
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(variables, path)
    flat = load_checkpoint(path)
    assert any(k.startswith("batch_stats/") for k in flat)
    model = load_jax_variables(create_model("SegResNetDS", **DS_KWARGS), flat, strict=True)
    assert model.down0_block0.norm1.mean.abs().sum() > 0
    ours = model_variables(model)
    assert set(ours) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(ours[key], value)
    out = str(tmp_path / "port.npz")
    save_checkpoint(model, out)
    loaded = jax_ckpt.load_into(variables, out, strict=True)
    for key, value in _flat(loaded).items():
        np.testing.assert_array_equal(value, flat[key])
    assert set(loaded) == {"params", "batch_stats"}


def test_strict_and_flexible_loads_of_batch_stats(ds):
    jmod, variables = ds
    flat = _flat(variables)
    model = create_model("SegResNetDS", **DS_KWARGS)
    key = "batch_stats/down1_block0/norm2/var"
    missing = {k: v for k, v in flat.items() if k != key}
    with pytest.raises(ValueError, match="missing.*norm2/var"):
        load_jax_variables(model, missing)
    # a buffer under params/ is a key of the other collection
    moved = dict(missing, **{"params/down1_block0/norm2/var": flat[key]})
    with pytest.raises(ValueError, match="extra"):
        load_jax_variables(model, moved)
    with pytest.raises(ValueError, match="extra"):
        load_jax_variables(model, dict(flat, **{"codebook/x/embedding": np.zeros(2)}))
    # non-strict: the statistics of another width are tiled and truncated,
    # the missing ones keep the model's, other collections are dropped
    init_parameters(model, torch.Generator().manual_seed(0))
    other = dict(missing, **{"batch_stats/up0_block0/norm1/mean": np.arange(2.0),
                             "codebook/x/embedding": np.zeros(2)})
    load_jax_variables(model, other, strict=False)
    assert torch.equal(model.down1_block0.norm2.var, torch.ones(8))
    assert model.up0_block0.norm1.mean.tolist() == [0.0, 1.0, 0.0, 1.0]
    np.testing.assert_array_equal(model.down0_block0.norm1.mean.numpy(),
                                  flat["batch_stats/down0_block0/norm1/mean"])


def test_flax_keys_of_each_collection(ds):
    _, variables = ds
    flat = _flat(variables)
    model = create_model("SegResNetDS", **DS_KWARGS)
    assert set(flax_keys(model)) == set(flat)
    sd = flax_to_state_dict(flat)
    assert set(sd) == set(model.state_dict())
    assert set(model_variables(model)) == set(flat)
    assert set(state_dict_to_flax(dict(model.named_parameters()))) == {
        k for k in flat if k.startswith("params/")}
    assert set(flax_to_state_dict({"codebook/x/embed": np.zeros(2)})) == {"x.embed"}
    with pytest.raises(ValueError, match="outside"):
        flax_to_state_dict({"intermediates/x/y": np.zeros(2)})
    assert flax_to_state_dict({"intermediates/x/y": np.zeros(2)}, strict=False) == {}


def test_init_parameters_sets_flax_buffer_and_prelu_init():
    model = create_model("UNet", in_channels=1, out_channels=2, channels=[4, 8],
                         strides=[2], norm="batch")
    for b in model.buffers():
        b.fill_(5.0)
    init_parameters(model, torch.Generator().manual_seed(0))
    assert torch.equal(model.down_0.norm0.mean, torch.zeros(4))
    assert torch.equal(model.down_0.norm0.var, torch.ones(4))
    assert torch.equal(model.down_0.act0.alpha, torch.full((1,), 0.25))
    model.register_buffer("other", torch.zeros(1))
    with pytest.raises(ValueError, match="buffer other"):
        init_parameters(model, torch.Generator())


# --- the steps and make_forward ------------------------------------------------


def test_make_forward_and_sliding_window_use_bf16_statistics(ds):
    """``make_forward(amp=True)`` runs on a bf16 copy with the running
    statistics cast too (the JAX ``amp_cast``), equal to the eval step's
    forward, directly and through the sliding window; eval updates nothing."""
    _, variables = ds
    model = load_jax_variables(create_model("SegResNetDS", **DS_KWARGS), _flat(variables))
    before = {k: v.clone() for k, v in model.named_buffers()}
    seen = []
    forward = make_forward(model, amp=True)
    x = torch.from_numpy(_x(1, 16, 16, 16, 2, seed=3))
    net = copy.deepcopy(model).to(torch.bfloat16)
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(m.mean.dtype))
             for m in net.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        want = net(x.to(torch.bfloat16)).float()
    assert seen and set(seen) == {torch.bfloat16}
    for h in hooks:
        h.remove()
    got = forward(x)
    assert torch.equal(got, want)
    inferer = build_inferer("SlidingWindowInferer", roi_size=[8, 8, 8], sw_batch_size=2,
                            overlap=0.5, mode="gaussian")
    windows = inferer(x, forward)
    assert windows.shape == got.shape and bool(torch.isfinite(windows).all())
    assert _rel(windows.numpy(), got.numpy()) < 0.5
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k
        assert v.dtype == torch.float32


def test_train_step_keeps_f32_statistics_and_eval_step_casts_them(ds):
    """Under AMP the train step's forward sees bf16 parameters and the
    model's f32 statistics, which it updates once per microbatch; the eval
    step's sees bf16 statistics and updates none."""
    _, variables = ds
    model = load_jax_variables(create_model("SegResNetDS", **DS_KWARGS), _flat(variables))
    seen = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(
                lambda m, a: seen.append((m.scale.dtype, m.mean.dtype, bool(a[1]) if
                                          len(a) > 1 else False)))
    images = np.random.RandomState(4).randn(2, 2, 8, 8, 8).astype(np.float32)
    labels = (np.random.RandomState(5).rand(2, 3, 8, 8, 8) > 0.5).astype(np.float32)
    before = {k: v.clone() for k, v in model.named_buffers()}
    calls = []
    real = BatchNorm.forward

    def counted(self, x, train=False):
        calls.append(train)
        return real(self, x, train)

    opt = optim.build_optimizer("SGD", model.parameters(), lr=0.1)
    with mock.patch.object(BatchNorm, "forward", counted):
        step.make_train_step(model, losses.DiceLoss(sigmoid=True), opt, amp=True,
                             grad_accum=2)(images, labels)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    assert calls == [True] * 2 * n_bn  # one update per BatchNorm per microbatch
    assert set(seen) == {(torch.bfloat16, torch.float32, True)}
    moved = {k for k, v in model.named_buffers() if not torch.equal(v, before[k])}
    assert moved == set(before)
    assert all(v.dtype == torch.float32 for v in model.buffers())
    seen.clear()
    after = {k: v.clone() for k, v in model.named_buffers()}
    out = step.make_eval_step(model, lambda o, y: o, amp=True)(images, labels)
    assert out.dtype == torch.bfloat16
    assert set(seen) == {(torch.bfloat16, torch.bfloat16, False)}
    for k, v in model.named_buffers():
        assert torch.equal(v, after[k]), k


# --- whole nets against their JAX modules (helpers for the net test files) ----

class _NoDropout(fnn.Module):
    rate: float = 0.0
    broadcast_dims: tuple = ()
    deterministic: bool = None

    @fnn.compact
    def __call__(self, x):
        return x


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while a module of whole nets runs: tier-1 runs six
    test processes on the CPU's cores, and each torch op spreading over all
    of them slows every process down. Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def no_dropout():
    """Both packages without their dropout, for the exact training path:
    VNet drops its skips at 0.5 in every training forward, and
    ``jax.random`` draws cannot be matched (the draws are held apart)."""
    with mock.patch.object(fnn, "Dropout", _NoDropout), \
            mock.patch.object(port_vnet, "channel_dropout", lambda x, *a, **k: x):
        yield


def bn_init(jmod, x, seed=0):
    """Seeded numpy variables in the names and shapes of ``jmod``'s tree for
    ``x`` (``jax.eval_shape`` of its init: a jitted init compiles for ~10 s
    on the CPU): kernels normal with variance 1 / fan-in, scales, biases,
    PReLU slopes and running statistics off their initial values."""
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    rng = np.random.RandomState(seed + 11)
    flat = {}
    for k, v in sorted(flatten_dict(shapes).items()):
        shape, leaf = v.shape, k[-1]
        if leaf == "kernel":
            value = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf in ("scale", "var"):
            value = 1.0 + (0.3 * rng.randn(*shape) if leaf == "scale" else 0.5 * rng.rand(*shape))
        elif leaf == "alpha":
            value = 0.25 + 0.05 * rng.randn(*shape)
        else:  # bias, mean
            value = 0.1 * rng.randn(*shape)
        flat[k] = jnp.asarray(value.astype(np.float32))
    return unflatten_dict(flat)


def _sgd_keeping_grads(lr):
    """Optax SGD at ``lr`` whose state is the last step's gradients: one
    compiled JAX train step gives the gradients and the updated variables."""

    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(lambda g: -lr * g, grads), grads

    return optax.GradientTransformation(init, update)


LR = 0.1
# XLA's CPU backend at optimisation level 1 (its default is 3) compiles the
# nets' programs faster and runs them about as fast (VNet's train step at
# levels 3, 2 and 1: tools/bn_f32_conditioning.py); the level changes code
# generation only
COMPILE = {"xla_backend_optimization_level": 1}


class Net:
    """A net of the JAX registry at a small size: its JAX module, variables
    (``bn_init``), input, two batches of its size (images and binary labels
    of ``out_channels``, or ``num_classes``, channels), the port module's
    constructor arguments, and each package's runs, kept for the file's
    other tests (each JAX compile takes seconds)."""

    def __init__(self, name, kwargs, shape, seed=0):
        self.name, self.kwargs = name, dict(kwargs)
        self.x = _x(*shape, seed=seed + 1)
        self.jmod = jax_create_model(name, **kwargs)
        with no_dropout():
            self.variables = bn_init(self.jmod, self.x, seed)
        self.flat = _flat(self.variables)
        rng = np.random.RandomState(seed + 3)
        n, *spatial = self.x.shape[:4]
        n_out = kwargs["out_channels"] if "out_channels" in kwargs else kwargs["num_classes"]
        self.batches = [(rng.randn(n, shape[-1], *spatial).astype(np.float32),
                         (rng.rand(n, n_out, *spatial) > 0.5).astype(np.float32))
                        for _ in range(2)]

    def fresh(self, dtype=np.float32):
        """A JAX variable tree of its own (the JAX train step donates it)."""
        return unflatten_dict({tuple(k.split("/")): jnp.asarray(v.astype(dtype))
                               for k, v in self.flat.items()})

    def port(self):
        model = create_model(self.name, **self.kwargs)
        return load_jax_variables(model, self.flat, strict=True).eval()

    def _forwards(self, dtype):
        """JAX's eval output, training output and the running statistics the
        training forward leaves, on variables and input in ``dtype``."""

        def forwards(v, x):
            tr, upd = self.jmod.apply(v, x, True, mutable=["batch_stats"])
            return self.jmod.apply(v, x), tr, upd.get("batch_stats", {})

        with no_dropout():
            ev, tr, stats = jax.jit(forwards, compiler_options=COMPILE)(
                self.fresh(dtype), jnp.asarray(self.x.astype(dtype)))
        return np.asarray(ev), np.asarray(tr), _flat({"batch_stats": stats})

    @functools.cached_property
    def jax_f32(self):
        return self._forwards(np.float32)

    @functools.cached_property
    def jax_f64(self):
        """``jax_f32`` on the variables in f64 under ``jax.enable_x64``: the
        exact value of the function both packages compute in f32, taken
        without the port."""
        with jax.enable_x64(True):
            return self._forwards(np.float64)

    @functools.lru_cache(maxsize=None)
    def steps(self, package, grad_accum, amp=False, n_steps=2):
        """``n_steps`` SGD steps (lr ``LR``, DiceLoss with sigmoid), each
        batch in ``grad_accum`` microbatches, through the port's
        ``make_train_step`` ("port"), JAX's (``train_step_body`` jitted at
        ``COMPILE``'s level, "jax") or JAX's on the variables in f64 under
        ``jax.enable_x64`` ("f64": the exact value of the step both packages
        take in f32, taken without the port; the step casts the batches to
        f32, which holds them exactly, and the Dice sums stay f32 in every
        package): (losses, the first step's gradients by torch key, the
        variables after)."""
        criterion = (losses if package == "port" else jax_losses).DiceLoss(sigmoid=True)
        if package == "port":
            model = self.port()
            opt = optim.build_optimizer("SGD", model.parameters(), lr=LR)
            run = step.make_train_step(model, criterion, opt, amp=amp, grad_accum=grad_accum)
            out = []
            with no_dropout():
                for images, labels in self.batches[:n_steps]:
                    loss = run(images, labels)
                    out.append((float(loss), {k: p.grad.numpy().copy()
                                              for k, p in model.named_parameters()}))
            return [loss for loss, _ in out], out[0][1], model_variables(model)
        x64 = package == "f64"
        with no_dropout(), jax.enable_x64(x64):
            tx = _sgd_keeping_grads(LR)
            state = jax_step.create_train_state(
                self.fresh(np.float64 if x64 else np.float32), tx)
            run = jax.jit(jax_step.train_step_body(self.jmod, criterion, tx, amp=amp,
                                                   grad_accum=grad_accum),
                          compiler_options=COMPILE)
            out = []
            for images, labels in self.batches[:n_steps]:
                state, loss = run(state, images, labels)
                out.append((float(loss), {k.replace("/", "."): v for k, v in
                                          _flat(state.opt_state).items()}))
            return ([loss for loss, _ in out], out[0][1],
                    _flat({"params": state.params, **state.extra_variables}))


def _amp_train(v):
    """The JAX train step's AMP variables: bf16 parameters, f32 statistics."""
    return {**v, "params": _cast(v["params"])}


def _stats(model):
    return {k: v for k, v in model_variables(model).items() if k.startswith("batch_stats/")}


def _check_f32(got, want, exact, what, bound=F32, lazy=True):
    """The port within ``bound`` of JAX's f32 result and of the f64 one
    (``exact``, a function giving JAX's f64 result, ``Net.jax_f64`` or the
    "f64" steps; with ``lazy`` computed only where the first check fails)
    or, where JAX's own distance from f64 is larger, no further from it than
    1.25 times JAX's and within twice that of JAX's, as
    ``test_torch_myronenko._check_grads`` holds gradients. The batch
    variance E[x^2] - E[x]^2 costs both packages digits where a BatchNorm
    sees few values a channel, and which lands nearer f64 is a matter of sum
    order (tools/bn_f32_conditioning.py reads each check's three distances
    on every net of these tests)."""
    if lazy and _rel(got, want) < bound:
        return
    exact = exact()
    jax_error = _rel(want, exact)
    assert _rel(got, exact) < max(bound, 1.25 * jax_error), (what, _rel(got, exact), jax_error)
    assert _rel(got, want) < max(bound, 2 * jax_error), (what, _rel(got, want), jax_error)


def check_forwards(n: Net) -> None:
    """Eval and train forwards in f32 against the JAX module (``_check_f32``
    for the training forward and the running statistics it leaves), and the
    variables both ways: the JAX tree loads strictly, the port's variables
    are the same keys and arrays. (The bf16 forwards: ``check_amp_eval_step``
    in eval, the AMP train steps in training.)"""
    ev, tr, stats = n.jax_f32
    model, x = n.port(), torch.from_numpy(n.x)
    ours = model_variables(model)
    assert set(ours) == set(n.flat) and all(np.array_equal(ours[k], n.flat[k]) for k in ours)
    net = copy.deepcopy(model)
    with torch.no_grad(), no_dropout():
        assert _rel(model(x).numpy(), ev) < F32
        got = net(x, train=True)
    assert tuple(got.shape) == tr.shape
    _check_f32(got.numpy(), tr, lambda: n.jax_f64[1], "train forward")
    keys = sorted(stats)
    assert set(_stats(net)) == set(keys)
    if keys:
        _check_f32(_all(_stats(net), keys), _all(stats, keys),
                   lambda: _all(n.jax_f64[2], keys), "statistics")


def check_grads(n: Net, amp: bool) -> None:
    """The first train step's gradients w.r.t. every parameter (DiceLoss,
    the step's own), as ``test_torch_myronenko._check_grads`` holds
    gradients: f32 as ``_check_f32`` at ``F32_GRAD`` (JAX's f64 step's the
    exact ones: AttentionUnet's f32 gradients lie 5.8e-3 from them in JAX
    and 1.8e-6 in the port, tools/bn_f32_conditioning.py); bf16 (the AMP step: bf16 copies of the parameters, f32
    statistics) no further from JAX's f32 gradients than 1.25 times JAX's
    own bf16 ones (two samples of the same rounding noise)."""
    _, want, _ = n.steps("jax", 1, amp)
    _, got, _ = n.steps("port", 1, amp)
    assert set(got) == set(want)
    keys = sorted(want)
    ours, theirs = _all(got, keys), _all(want, keys)
    if amp:
        ref = _all(n.steps("jax", 1)[1], keys)
        assert _rel(ours, ref) <= 1.25 * _rel(theirs, ref), (_rel(ours, ref), _rel(theirs, ref))
        return
    _check_f32(ours, theirs, lambda: _all(n.steps("f64", 1)[1], keys), "gradients", F32_GRAD)


def check_train_steps(n: Net, grad_accum: int, amp: bool = False) -> None:
    """Two SGD steps through both packages' ``make_train_step``: the losses
    (relative 1e-4; 1e-2 under AMP), then the parameters and the
    ``batch_stats`` after them, in f32 as ``_check_f32`` holds them (JAX's
    f64 steps' the exact ones), under AMP within ``BF16``; the statistics stay
    f32 under AMP in both. With 2 microbatches the second normalises with
    its own statistics and updates the averages the first left, as JAX's
    scan carries them."""
    want_losses, _, want = n.steps("jax", grad_accum, amp)
    got_losses, _, ours = n.steps("port", grad_accum, amp)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-2 if amp else 1e-4)
    assert set(ours) == set(want)
    for collection in ("params/", "batch_stats/"):
        keys = sorted(k for k in want if k.startswith(collection))
        if not keys:
            continue
        if amp:
            assert _rel(_all(ours, keys), _all(want, keys)) < BF16, collection
        else:
            _check_f32(_all(ours, keys), _all(want, keys),
                       lambda: _all(n.steps("f64", grad_accum)[2], keys), collection)
    assert all(want[k].dtype == np.float32 and ours[k].dtype == np.float32 for k in want)


def check_amp_eval_step(n: Net, dtype: torch.dtype = torch.bfloat16) -> None:
    """Both packages' AMP eval steps, whose forward runs on bf16 copies of
    the parameters and the running statistics, on ``n.x`` (a criterion that
    returns the output): outputs of ``dtype`` (bf16; f32 for the registration
    nets, whose resized heads and grids are f32 in both), the port's within
    ``BF16`` of JAX's
    f32 eval output or no further from it than 1.25 times JAX's bf16 one
    (two samples of the same rounding noise, as ``check_grads`` holds bf16)."""
    images = np.ascontiguousarray(np.moveaxis(n.x, -1, 1))
    state = jax_step.create_train_state(n.fresh(), jax_optim.build_optimizer("SGD", lr=0.1))
    want = jax_step.make_eval_step(n.jmod, lambda o, y: o, amp=True)(state, images, images)
    got = step.make_eval_step(n.port(), lambda o, y: o, amp=True)(images, images)
    assert got.dtype == dtype and str(want.dtype) == str(dtype).replace("torch.", "")
    ref = n.jax_f32[0]
    want = np.asarray(want.astype(jnp.float32))
    assert _rel(got.float().numpy(), ref) <= max(BF16, 1.25 * _rel(want, ref)), (
        _rel(got.float().numpy(), ref), _rel(want, ref))


def check_dtype_flow(n: Net, train: bool) -> None:
    """Under AMP every module's output dtype is Flax's (its captured
    intermediates): eval on bf16 parameters and statistics, training on
    bf16 parameters and f32 statistics."""
    x = n.x[:1]  # the dtypes do not depend on the batch
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    v = _amp_train(n.variables) if train else _cast(n.variables)
    with no_dropout():
        _, state = jax.eval_shape(lambda: n.jmod.apply(
            v, xb, train, capture_intermediates=True,
            mutable=["intermediates", "batch_stats"] if train else ["intermediates"]))
    # a module that returns a tuple (a ViT's tokens and states): its first array
    want = {".".join(p[:-1]) or "<model>": str(jax.tree_util.tree_leaves(value[0])[0].dtype)
            for p, value in flatten_dict(state["intermediates"]).items() if p[-1] == "__call__"}
    net = copy.deepcopy(n.port())
    got, handles = {}, []
    for name, module in net.named_modules():
        def hook(m, inp, o, name=name):
            o = o[0] if isinstance(o, tuple) else o
            got[name or "<model>"] = str(o.dtype).replace("torch.", "")
        handles.append(module.register_forward_hook(hook))
    params = {k: p.to(torch.bfloat16) for k, p in net.named_parameters()}
    if not train:
        params.update({k: b.to(torch.bfloat16) for k, b in net.named_buffers()})
    with torch.no_grad(), no_dropout():
        functional_call(net, params, (torch.from_numpy(x).to(torch.bfloat16),),
                        {"train": train})
    common = sorted(set(want) & set(got))
    assert len(common) >= 0.5 * len(want), (sorted(want), sorted(got))
    assert {k: got[k] for k in common} == {k: want[k] for k in common}

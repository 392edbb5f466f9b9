"""The port's ResNet / ResNeXt classifiers against the JAX package's, with the
JAX variables (``params`` and ``batch_stats``, every scale, bias and running
statistic moved off its initial value) carried across strictly; and the
``Classifier`` harness the other classifier files hold their nets with.

Structure: for ``ResNet`` and each of the seven factories the port's
parameter and ``batch_stats`` names and shapes are JAX's (``jax.eval_shape``
of its init: no compile), and that tree loads strictly. Numerics, at the
full widths (64 to 512 planes, 2048 channels after the bottlenecks) with
one block a stage on (4, 32^3, 2) inputs: a basic-block ResNet and a
bottleneck ResNeXt (4 groups of 8 per group: the grouped 3-cubed convs).
Each through one jitted JAX computation (``Classifier.jax``): the eval
forward, the training forward with the running statistics it leaves, and
the gradients of ``objective`` (the port's and JAX's ``CrossEntropyLoss`` on
one-hot targets, plus ``sum(e * g)`` of every further output) in f32 and
in bf16 AMP (bf16 parameters and input, f32 statistics, as the train steps
cast them), with the bf16 eval forward. Tolerances those of
``tests/test_torch_batchnorm.py``: f32 forwards 1e-5 and gradients 1e-4
relative L2, JAX's own distance from f64 allowed for (``_check_f32``); the
bf16 eval forward, gradients and statistics within 2e-2 of JAX's f32 ones
or no further from them than 1.25 times JAX's bf16 ones. Then two SGD
steps of the port's ``make_train_step`` against JAX's train step (the loss,
the parameters and the statistics after), and a JAX ``.npz`` loaded
strictly.
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
from flax.traverse_util import flatten_dict, unflatten_dict

from unet3d_tpu.models import resnet as jax_resnet
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train import checkpoint as jax_ckpt
from unet3d_tpu.train import losses as jax_losses
from unet3d_tpu.train import step as jax_step

from unet3d_tpu_torch.convert import flax_keys, load_jax_variables, model_variables
from unet3d_tpu_torch.models import layers, resnet
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.train import losses, optim, step
from unet3d_tpu_torch.train.checkpoint import load_checkpoint

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (BF16, COMPILE, F32, F32_GRAD, LR, _check_f32, _NoDropout,
                                  _sgd_keeping_grads, bn_init)
from test_torch_myronenko import _all, _cast, _flat, _rel, _x

# XLA without its excess precision: every bf16 op's result rounded, as the
# port's eager ops round it (with it XLA keeps f32 across fused chains)
EXACT_BF16 = dict(COMPILE, xla_allow_excess_precision=False)
RNGS = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
        "sample": jax.random.PRNGKey(2)}


def jax_tree_shapes(jmod, shape, **kwargs):
    """``{flat key: shape}`` of ``jmod``'s variables for an f32 input of
    ``shape`` (``jax.eval_shape``: traced, not compiled)."""
    tree = jax.eval_shape(lambda: jmod.init(RNGS, jnp.zeros(shape), **kwargs))
    return {"/".join(k): tuple(v.shape) for k, v in flatten_dict(tree).items()}


def check_structure(name, kwargs, shape, port_kwargs=None):
    """The port's ``name`` has JAX's variable names and shapes, every
    ``batch_stats`` key a buffer; a tree of those shapes loads strictly."""
    want = jax_tree_shapes(jax_create_model(name, **kwargs), shape)
    model = create_model(name, **kwargs, **(port_kwargs or {}))
    sd = model.state_dict()
    got = {k: tuple(sd[v].shape) for k, v in flax_keys(model).items()}
    assert got == want
    assert any(k.startswith("batch_stats/") for k in want) == bool(list(model.buffers()))
    load_jax_variables(model, {k: np.broadcast_to(np.float32(0.5), s) for k, s in want.items()},
                       strict=True)
    assert all(bool((t == 0.5).all()) for t in model.state_dict().values())


def torch_convs():
    """torch's own CPU convs for the port's f32 runs, not oneDNN's: a
    BatchNorm after a conv makes the loss invariant to the conv kernel's
    scale, so the kernel's gradient is orthogonal to the kernel and its f32
    sum cancels, and oneDNN's f32 weight gradient loses the digits (the
    ResNet stem's at batch 8: 5.4e-3 from f64, 3.5e-6 with torch's convs,
    JAX's 1.4e-5). Its bf16 convs stay oneDNN's (torch's own take ~20x as
    long)."""
    return torch.backends.mkldnn.flags(enabled=False)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


class Classifier:
    """A net at a small size: its JAX module and variables (``bn_init``),
    the port's constructor, an input, one-hot targets for the logits (or
    none: ``sum(out * g)`` then) and seeded cotangents for every further
    output; JAX's results, computed once (each JAX compile takes seconds).

    ``jax_kwargs`` / ``port_kwargs`` go to every forward (RegularizedResNet's
    ``sample=False``); ``no_noise`` patches both packages' dropout to the
    identity (the exact training path: ``jax.random`` cannot be matched).
    Without ``bf16_grads`` the bf16 checks hold the eval forward only (a
    deep net's JAX compile, EfficientNet's)."""

    def __init__(self, jmod, make_port, x, n_classes=None, seed=0, jax_kwargs=None,
                 port_kwargs=None, no_noise=(), bf16_grads=True):
        self.jmod, self.make_port, self.x = jmod, make_port, x
        self.bf16_grads = bf16_grads
        self.jax_kwargs, self.port_kwargs = jax_kwargs or {}, port_kwargs or {}
        self.no_noise = no_noise
        with self.quiet():
            self.variables = bn_init(jmod, x, seed)
            outs = jax.eval_shape(lambda: jmod.apply(self.variables, jnp.asarray(x),
                                                     **self.jax_kwargs))
        self.flat = _flat(self.variables)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        rng = np.random.RandomState(seed + 3)
        self.n_classes = n_classes
        if n_classes:
            self.y = np.eye(n_classes, dtype=np.float32)[rng.randint(n_classes, size=len(x))]
            outs = outs[1:]
        self.gs = [(rng.randn(*o.shape) / np.sqrt(np.prod(o.shape[1:]))).astype(np.float32)
                   for o in outs]

    @contextlib.contextmanager
    def quiet(self):
        """Both packages without their dropout, where ``no_noise`` names the
        port's dropout functions to patch."""
        with contextlib.ExitStack() as stack:
            if self.no_noise:
                stack.enter_context(mock.patch.object(fnn, "Dropout", _NoDropout))
                for module, name in self.no_noise:
                    stack.enter_context(mock.patch.object(module, name,
                                                          lambda x, *a, **k: x))
            yield

    def fresh(self, dtype=np.float32):
        return unflatten_dict({tuple(k.split("/")): jnp.asarray(v.astype(dtype))
                               for k, v in self.flat.items()})

    def port(self):
        model = self.make_port()
        return load_jax_variables(model, self.flat, strict=True).eval()

    def objective(self, out, xp, cast):
        """The cross entropy of the logits on the one-hot targets (without
        targets ``sum(out * g)``), plus ``sum(e * g)`` of every further
        output, in the dtype ``cast`` gives (f32, or f64 for JAX's exact
        run); ``xp`` the package (jnp / torch)."""
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        total = 0.0
        if self.n_classes:
            logits = cast(outs.pop(0))
            if xp is jnp:
                logp = jax.nn.log_softmax(logits, axis=-1)
            else:
                logp = torch.log_softmax(logits, dim=-1)
            y = self.y if xp is jnp else torch.from_numpy(self.y)
            total = -(y * logp).sum(-1).mean()
        for o, g in zip(outs, self.gs):
            total = total + (cast(o) * (g if xp is jnp else torch.from_numpy(g))).sum()
        return total

    def _jax(self, dtype, what):
        """JAX's results in ``dtype``, ``what`` of them: "forward" the eval
        and training forwards and the statistics; "grads" the training
        forward, statistics, loss and gradients; "all" those and the eval
        forward, and the bf16 eval forward and (with ``bf16_grads``) AMP
        training's gradients and statistics."""
        jmod, kw = self.jmod, self.jax_kwargs

        def run(v, x):
            params = v["params"]
            rest = {k: t for k, t in v.items() if k != "params"}

            def loss(p, amp):
                variables = {"params": _cast(p) if amp else p, **rest}
                xx = x.astype(jnp.bfloat16) if amp else x
                out, upd = jmod.apply(variables, xx, True, mutable=["batch_stats"], **kw)
                return (self.objective(out, jnp, lambda a: a.astype(x.dtype)),
                        (_first(out), upd.get("batch_stats", {})))

            out = {}
            if what != "grads":
                out["eval"] = _first(jmod.apply(v, x, **kw))
            if what == "forward":
                tr, upd = jmod.apply(v, x, True, mutable=["batch_stats"], **kw)
                out.update(train=_first(tr), stats=upd.get("batch_stats", {}))
                return out
            grad = jax.value_and_grad(loss, has_aux=True)
            (out["loss"], (out["train"], out["stats"])), out["grads"] = grad(params, False)
            if what == "all":
                if self.bf16_grads:
                    (_, (_, out["stats_bf16"])), out["grads_bf16"] = grad(params, True)
                out["eval_bf16"] = _first(jmod.apply(_cast(v), x.astype(jnp.bfloat16),
                                                     **kw)).astype(jnp.float32)
            return out

        with self.quiet():
            out = jax.jit(run, compiler_options=EXACT_BF16)(self.fresh(dtype),
                                                         jnp.asarray(self.x.astype(dtype)))
        for key in [k for k in out if k.startswith("stats")]:
            out[key] = _flat({"batch_stats": out[key]})
        for key in [k for k in out if k.startswith("grads")]:
            out[key] = {k.replace("/", "."): a for k, a in _flat(out[key]).items()}
        return {k: v if isinstance(v, dict) else np.asarray(v) for k, v in out.items()}

    @functools.cached_property
    def jax(self):
        return self._jax(np.float32, "all")

    @functools.cached_property
    def jax_f64_forward(self):
        """The forwards on f64 variables and input under ``jax.enable_x64``:
        the exact values both packages compute in f32."""
        with jax.enable_x64(True):
            return self._jax(np.float64, "forward")

    @functools.cached_property
    def jax_f64(self):
        """The f32 training's loss, gradients and statistics on f64
        variables and input: their exact values."""
        with jax.enable_x64(True):
            return self._jax(np.float64, "grads")

    def _port_train(self, amp):
        """The port's training forward on a copy (bf16 parameters and input
        under ``amp``, f32 buffers, as its AMP train step runs it): output,
        gradients by name, the statistics it leaves."""
        net = copy.deepcopy(self.port())
        params = dict(net.named_parameters())
        call = {k: p.to(torch.bfloat16) for k, p in params.items()} if amp else params
        x = torch.from_numpy(self.x)
        with self.quiet(), contextlib.nullcontext() if amp else torch_convs():
            out = functional_call(net, call, (x.to(torch.bfloat16) if amp else x,),
                                  {"train": True, **self.port_kwargs})
            self.objective(out, torch, lambda a: a.float()).backward()
        grads = {k: p.grad.numpy() for k, p in params.items()}
        stats = {k: v for k, v in model_variables(net).items() if k.startswith("batch_stats/")}
        return _first(out).detach().float().numpy(), grads, stats

    @functools.cached_property
    def port_f32(self):
        return self._port_train(False)

    @functools.cached_property
    def port_bf16(self):
        return self._port_train(True)


def check_forwards(c: Classifier) -> None:
    """The eval forward in f32 within ``F32`` of JAX's; the training forward
    and the running statistics it leaves by ``_check_f32`` (JAX's f64 run
    the exact value); the port's variables are the JAX tree's."""
    j = c.jax
    model = c.port()
    ours = model_variables(model)
    assert set(ours) == set(c.flat) and all(np.array_equal(ours[k], c.flat[k]) for k in ours)
    with torch.no_grad(), torch_convs():
        got = _first(model(torch.from_numpy(c.x), **c.port_kwargs)).numpy()
    assert got.shape == j["eval"].shape
    assert _rel(got, j["eval"]) < F32, _rel(got, j["eval"])
    tr, _, stats = c.port_f32
    _check_f32(tr, j["train"], lambda: c.jax_f64_forward["train"], "train forward")
    keys = sorted(j["stats"])
    assert sorted(stats) == keys
    if keys:
        _check_f32(_all(stats, keys), _all(j["stats"], keys),
                   lambda: _all(c.jax_f64_forward["stats"], keys), "statistics")


def check_grads_f32(c: Classifier) -> None:
    _, grads, _ = c.port_f32
    keys = sorted(c.jax["grads"])
    assert sorted(grads) == keys
    _check_f32(_all(grads, keys), _all(c.jax["grads"], keys),
               lambda: _all(c.jax_f64["grads"], keys), "gradients", F32_GRAD)


def check_bf16(c: Classifier) -> None:
    """The bf16 eval forward (bf16 parameters and statistics), the AMP
    training's gradients and the f32 statistics it leaves: within ``BF16``
    of JAX's f32 results or no further from them than 1.25 times JAX's bf16
    ones."""
    j = c.jax
    model = copy.deepcopy(c.port()).to(torch.bfloat16)
    with torch.no_grad():
        got = _first(model(torch.from_numpy(c.x).to(torch.bfloat16), **c.port_kwargs))
    assert got.dtype == torch.bfloat16 or got.dtype == torch.float32
    pairs = [("eval", got.float().numpy(), j["eval_bf16"], j["eval"])]
    _, grads, stats = c.port_bf16 if c.bf16_grads else (None, None, None)
    keys, skeys = sorted(j["grads"]), sorted(j["stats"])
    if c.bf16_grads:
        pairs.append(("gradients", _all(grads, keys), _all(j["grads_bf16"], keys),
                      _all(j["grads"], keys)))
    if skeys and c.bf16_grads:
        pairs.append(("statistics", _all(stats, skeys), _all(j["stats_bf16"], skeys),
                      _all(j["stats"], skeys)))
    for what, ours, theirs, ref in pairs:
        assert _rel(ours, ref) <= max(BF16, 1.25 * _rel(theirs, ref)), (
            what, _rel(ours, ref), _rel(theirs, ref))


# --- ResNet ------------------------------------------------------------------

NAMES = ("ResNet", "resnet_18", "resnet_34", "resnet_50", "resnet_101", "resnet_152",
         "resnext_50_32x4d", "resnext_101_32x8d")


@pytest.mark.parametrize("name", NAMES)
def test_structure_matches_jax(name):
    check_structure(name, dict(n_features=2, n_outputs=3), (1, 32, 32, 32, 2))


SHAPE = (4, 32, 32, 32, 2)
# the bottleneck ResNeXt: 4 groups of int(planes * 8 / 64) channels each
KWARGS = dict(layers=(1, 1, 1, 1), n_outputs=3, n_features=2, groups=4, width_per_group=8)


@functools.lru_cache(maxsize=None)
def _case():
    return Classifier(jax_resnet.ResNet(block=jax_resnet.Bottleneck, **KWARGS),
                      lambda: resnet.ResNet(block=resnet.Bottleneck, **KWARGS),
                      _x(*SHAPE, seed=1), 3)


def test_forwards_match_jax():
    check_forwards(_case())


def test_f32_gradients_match_jax():
    check_grads_f32(_case())


def test_bf16_forward_gradients_and_statistics_match_jax():
    check_bf16(_case())


def test_train_step_matches_jax():
    """One SGD step (CrossEntropyLoss on the one-hot targets of the ``(N,
    classes)`` logits) of the port's ``make_train_step`` against JAX's train
    step on the ResNeXt's batch: the loss and the statistics after as
    ``_check_f32`` holds them, the gradients as it holds gradients
    (``F32_GRAD``), JAX's f64 run of ``Classifier.jax`` the exact values
    (the same loss, gradients and statistics)."""
    c = _case()
    images = np.ascontiguousarray(np.moveaxis(c.x, -1, 1))
    tx = _sgd_keeping_grads(LR)
    state = jax_step.create_train_state(c.fresh(), tx)
    run = jax.jit(jax_step.train_step_body(c.jmod, jax_losses.CrossEntropyLoss(), tx),
                  compiler_options=COMPILE)
    state, want_loss = run(state, images, c.y)
    want = _flat({"params": state.params, **state.extra_variables})
    want_grads = {k.replace("/", "."): v for k, v in _flat(state.opt_state).items()}
    model = c.port()
    params = dict(model.named_parameters())
    step_fn = step.make_train_step(model, losses.CrossEntropyLoss(),
                                   optim.build_optimizer("SGD", params.values(), lr=LR))
    with torch_convs():
        loss = float(step_fn(images, c.y))
    ours = model_variables(model)
    assert set(ours) == set(want)
    exact = c.jax_f64
    _check_f32(np.array([loss]), np.array([float(want_loss)]),
               lambda: np.array([exact["loss"]]), "loss")
    keys = sorted(want_grads)
    _check_f32(_all({k: p.grad.numpy() for k, p in params.items()}, keys),
               _all(want_grads, keys), lambda: _all(exact["grads"], keys), "gradients",
               F32_GRAD)
    keys = sorted(k for k in want if k.startswith("batch_stats/"))
    _check_f32(_all(ours, keys), _all(want, keys), lambda: _all(exact["stats"], keys),
               "statistics")
    keys = sorted(k for k in want if k.startswith("params/"))
    np.testing.assert_allclose(_all(ours, keys),
                               _all(c.flat, keys) - LR * _all(_grads_by_flax(params), keys),
                               rtol=0, atol=1e-6)


def _grads_by_flax(params):
    return {f"params/{k.replace('.', '/')}": p.grad.numpy() for k, p in params.items()}


def test_jax_checkpoint_loads_strictly(tmp_path):
    """The JAX package's ``.npz`` of the ResNeXt (``params`` and
    ``batch_stats``) loads strictly into the port, every array equal."""
    c = _case()
    path = str(tmp_path / "resnext.npz")
    jax_ckpt.save_checkpoint(c.variables, path)
    flat = load_checkpoint(path)
    model = load_jax_variables(c.make_port(), flat, strict=True)
    ours = model_variables(model)
    assert set(ours) == set(flat) and any(k.startswith("batch_stats/") for k in flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(ours[key], value)


def test_stem_pool_pads_are_minus_infinity():
    """The stem's max-pool pads with -inf (Flax's ``nn.max_pool`` with
    explicit pads): an all-negative input keeps its values at the border."""
    x = -1.0 - torch.rand(1, 4, 4, 4, 2)
    y = layers.max_pool(x, (3, 3, 3), (2, 2, 2), (1, 1, 1))
    assert bool((y < 0).all())
    want = jax.jit(lambda v: fnn.max_pool(v, (3, 3, 3), strides=(2, 2, 2),
                                          padding=((1, 1),) * 3))(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))

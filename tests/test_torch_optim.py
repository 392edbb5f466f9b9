"""The port's optimizers against the JAX package's optax chains.

Each optimizer of ``unet3d_tpu.train.optim.build_optimizer`` takes 6 updates
of the same parameters with the same seeded gradients (tensors whose
gradients differ in scale by 1e4) in both packages; the parameters must
agree within 1e-5 absolute after every update. RMSprop is the trap: torch's
class adds ``eps`` outside the square root, and its result differs from
optax's by more than that.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

from unet3d_tpu.train import optim as jax_optim

from unet3d_tpu_torch.train import optim

CASES = [
    ("Adam", {}), ("Adam", dict(weight_decay=0.1, betas=(0.8, 0.99))),
    ("AdamW", {}), ("AdamW", dict(weight_decay=0.05, eps=1e-6)),
    ("SGD", {}), ("SGD", dict(momentum=0.9)),
    ("SGD", dict(momentum=0.9, nesterov=True, weight_decay=0.01)),
    ("RMSprop", {}), ("RMSprop", dict(momentum=0.9, alpha=0.9)),
    ("Adagrad", {}), ("Adagrad", dict(initial_accumulator_value=0.1, eps=1e-8)),
    ("Adadelta", {}), ("Adadelta", dict(rho=0.8, weight_decay=0.1)),
    ("Adamax", {}), ("Adamax", dict(weight_decay=0.1)),
    ("NAdam", {}), ("NAdam", dict(weight_decay=0.1, momentum_decay=5e-3)),
    ("RAdam", {}), ("RAdam", dict(weight_decay=0.1)),
]
IDS = [f"{name}-{i}" for i, (name, _) in enumerate(CASES)]
SHAPES = {"a.kernel": (3, 4), "a.bias": (4,), "b.scale": (5,)}
SCALES = {"a.kernel": 1.0, "a.bias": 1e-3, "b.scale": 10.0}
N_STEPS, LR = 6, 1e-2


def initial_params(seed=31):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def gradients(n_steps=N_STEPS, seed=32):
    rng = np.random.RandomState(seed)
    return [{k: (SCALES[k] * rng.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(n_steps)]


def _nested(flat):
    """Dotted names as the nested tree of a Flax model's parameters."""
    return unflatten_dict({tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()})


def jax_run(name, kwargs, params, grads, tx=None, state=None):
    """The parameters (by dotted name) after each optax update, the final
    state and tx; the parameters as a nested tree, as a model's are."""
    tx = tx or jax_optim.build_optimizer(name, lr=LR, **kwargs)
    params = _nested(params)
    state = tx.init(params) if state is None else state
    history = []
    for g in grads:
        updates, state = tx.update(_nested(g), state, params)
        params = optax.apply_updates(params, updates)
        history.append({".".join(k): np.asarray(v)
                        for k, v in flatten_dict(params).items()})
    return history, state, tx


def port_params(params):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}


def port_run(opt, tensors, grads):
    history = []
    for g in grads:
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        history.append({k: p.detach().numpy().copy() for k, p in tensors.items()})
    return history


@pytest.mark.parametrize("name,kwargs", CASES, ids=IDS)
def test_optimizer_matches_optax(name, kwargs):
    params, grads = initial_params(), gradients()
    want, _, _ = jax_run(name, kwargs, params, grads)
    tensors = port_params(params)
    opt = optim.build_optimizer(name, list(tensors.values()), lr=LR, **kwargs)
    got = port_run(opt, tensors, grads)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=0,
                                       err_msg=f"{name} {kwargs} step {i + 1} {k}")
    assert opt.update_count == N_STEPS


def test_torch_rmsprop_is_not_optax_rmsprop():
    """The reason RMSprop is written here: torch.optim.RMSprop (eps outside
    the square root) leaves the optax result by more than the tolerance."""
    params, grads = initial_params(), gradients()
    want, _, _ = jax_run("RMSprop", dict(momentum=0.9), params, grads)
    tensors = port_params(params)
    got = port_run(torch.optim.RMSprop(list(tensors.values()), lr=LR, alpha=0.99, eps=1e-8,
                                       momentum=0.9), tensors, grads)
    worst = max(np.abs(got[-1][k] - want[-1][k]).max() for k in SHAPES)
    assert worst > 1e-4


def test_names_kwargs_and_errors_follow_jax():
    tensors = list(port_params(initial_params()).values())
    for name in ("adam", "ADAMW", "Sgd"):  # any case
        optim.build_optimizer(name, tensors)
    assert {type(optim.build_optimizer(n, tensors)).__name__.lower()
            for n, _ in CASES} == {n.lower() for n, _ in CASES}
    for module, args in ((optim, (tensors,)), (jax_optim, ())):
        with pytest.raises(TypeError, match="amsgrad"):
            module.build_optimizer("Adam", *args, amsgrad=True)
        with pytest.raises(TypeError, match="weight_decay"):
            module.build_optimizer("RMSprop", *args, weight_decay=0.1)
        with pytest.raises(TypeError, match="lr_decay"):
            module.build_optimizer("Adagrad", *args, lr_decay=0.1)
        with pytest.raises(ValueError, match="not supported"):
            module.build_optimizer("LBFGS", *args)
    group = optim.build_optimizer("AdamW", tensors).param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == \
        (1e-3, (0.9, 0.999), 1e-8, 1e-2)

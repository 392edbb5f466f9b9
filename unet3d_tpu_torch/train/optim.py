"""Optimizers (the optax chains of the JAX package) and LR schedulers
(host-side, torch-named).

Counterpart of ``unet3d_tpu/train/optim.py``: the nine names it resolves,
with its keyword arguments, defaults and ``TypeError`` on any other keyword.
Where a ``torch.optim`` class computes the same update as the optax chain
(Adam and its L2 weight decay, AdamW's decoupled decay, SGD with momentum and
Nesterov, Adadelta, Adamax, and NAdam, whose torch form the JAX package
copies) the port uses that class. RMSprop, Adagrad and RAdam are written
here, because torch's classes differ from optax: optax's RMSprop and Adagrad
add ``eps`` inside the square root (torch outside) and apply RMSprop's
momentum after the learning rate, and optax's RAdam adds ``eps`` to the
bias-corrected root and rectifies from rho >= 5. Every optimizer counts its
updates (``update_count``, the count of optax's ``inject_hyperparams``),
which the optimizer-state file keeps (``train/checkpoint.py``).

The schedulers are the JAX package's host-side state machines, copied as
they are: call ``step(metric)`` once per epoch, then write ``.lr`` into the
optimizer with ``set_learning_rate``.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import torch


class _Counted:
    """Counts the optimizer's updates, as optax's ``inject_hyperparams``
    does."""

    update_count = 0

    def step(self, closure=None):
        loss = super().step(closure)
        self.update_count += 1
        return loss


class Adam(_Counted, torch.optim.Adam):
    pass


class AdamW(_Counted, torch.optim.AdamW):
    pass


class SGD(_Counted, torch.optim.SGD):
    pass


class Adadelta(_Counted, torch.optim.Adadelta):
    pass


class Adamax(_Counted, torch.optim.Adamax):
    pass


class NAdam(_Counted, torch.optim.NAdam):
    pass


class _Elementwise(_Counted, torch.optim.Optimizer):
    """An optimizer whose update is computed parameter by parameter, in f32,
    in the order of the optax expressions; ``_update(p, g, state, group)``
    returns the update to add to the parameter."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    self._init_state(p, state, group)
                g = p.grad
                if group.get("weight_decay", 0.0):
                    g = g + group["weight_decay"] * p
                p.add_(self._update(p, g, state, group))
        self.update_count += 1
        return loss


class RMSprop(_Elementwise):
    """optax.rmsprop: nu = decay nu + (1 - decay) g^2, u = -lr g / sqrt(nu +
    eps), then (with momentum) trace = u + momentum trace."""

    def __init__(self, params, lr: float = 1e-3, alpha: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    def _init_state(self, p, state, group):
        state["nu"] = torch.zeros_like(p)
        if group["momentum"]:
            state["trace"] = torch.zeros_like(p)

    def _update(self, p, g, state, group):
        decay = group["alpha"]
        state["nu"] = (1 - decay) * g ** 2 + decay * state["nu"]
        u = -group["lr"] * (torch.rsqrt(state["nu"] + group["eps"]) * g)
        if group["momentum"]:
            state["trace"] = u + group["momentum"] * state["trace"]
            u = state["trace"]
        return u


class Adagrad(_Elementwise):
    """optax.adagrad: s = s + g^2, u = -lr g / sqrt(s + eps) where s > 0."""

    def __init__(self, params, lr: float = 1e-3, eps: float = 1e-10,
                 initial_accumulator_value: float = 0.0):
        super().__init__(params, dict(lr=lr, eps=eps,
                                      initial_accumulator_value=initial_accumulator_value))

    def _init_state(self, p, state, group):
        state["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])

    def _update(self, p, g, state, group):
        s = g * g + state["sum_of_squares"]
        state["sum_of_squares"] = s
        scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
        return -group["lr"] * (scale * g)


class RAdam(_Elementwise):
    """optax.radam: Adam's moments, bias-corrected; from rho_t >= 5 the
    rectified ``r m / (sqrt(v) + eps)``, before it the first moment alone."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _init_state(self, p, state, group):
        state["step"] = 0
        state["mu"] = torch.zeros_like(p)
        state["nu"] = torch.zeros_like(p)

    def _update(self, p, g, state, group):
        b1, b2 = group["betas"]
        state["mu"] = (1 - b1) * g + b1 * state["mu"]
        state["nu"] = (1 - b2) * g ** 2 + b2 * state["nu"]
        state["step"] += 1
        # the schedule in f32, as optax evaluates it
        t = torch.tensor(state["step"], dtype=torch.float32)
        b2t = torch.tensor(b2, dtype=torch.float32) ** t
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = ro_inf - 2 * t * b2t / (1 - b2t)
        mu_hat = state["mu"] / float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        if float(ro) >= 5.0:
            nu_hat = state["nu"] / float(1 - b2t)
            r = float(torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                 / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)))
            mu_hat = r * mu_hat / (torch.sqrt(nu_hat) + group["eps"])
        return -group["lr"] * mu_hat


_ADAM = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
# name -> (class, the keyword arguments the JAX package takes, its defaults)
_OPTIMIZERS = {
    "adam": (Adam, _ADAM),
    "adamw": (AdamW, dict(_ADAM, weight_decay=1e-2)),
    "sgd": (SGD, dict(momentum=0.0, nesterov=False, weight_decay=0.0)),
    "rmsprop": (RMSprop, dict(alpha=0.99, eps=1e-8, momentum=0.0)),
    "adagrad": (Adagrad, dict(eps=1e-10, initial_accumulator_value=0.0)),
    "adadelta": (Adadelta, dict(rho=0.9, eps=1e-6, weight_decay=0.0)),
    "adamax": (Adamax, _ADAM),
    "nadam": (NAdam, dict(_ADAM, momentum_decay=4e-3)),
    "radam": (RAdam, _ADAM),
}


def build_optimizer(optimizer_name: str, params: Iterable, lr: float = 1e-3,
                    **kwargs) -> torch.optim.Optimizer:
    """torch.optim names (any case) -> optimizer over ``params``, with the
    JAX package's keyword arguments and defaults."""
    name = optimizer_name.lower()
    if name not in _OPTIMIZERS:
        raise ValueError(f"Optimizer {optimizer_name} is not supported")
    cls, defaults = _OPTIMIZERS[name]
    if name == "adagrad" and kwargs.pop("lr_decay", 0.0):
        raise TypeError("Adagrad lr_decay is not supported on this backend")
    options = {k: kwargs.pop(k, v) for k, v in defaults.items()}
    if kwargs:
        raise TypeError(f"Unsupported kwargs for {optimizer_name}: {sorted(kwargs)}")
    if "betas" in options:
        options["betas"] = tuple(options["betas"])
    return cls(params, lr=lr, **options)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class Scheduler:
    """Base: call ``step(metric)`` once per epoch AFTER the epoch (torch order);
    read ``.lr`` for the LR to use next epoch."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr
        self.last_epoch = 0

    def step(self, metric: Optional[float] = None):
        self.last_epoch += 1
        self.lr = self._compute_lr()
        return self.lr

    def _compute_lr(self) -> float:
        return self.lr


class StepLR(Scheduler):
    def __init__(self, base_lr: float, step_size: int, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def _compute_lr(self):
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))


class MultiStepLR(Scheduler):
    def __init__(self, base_lr: float, milestones, gamma: float = 0.1):
        super().__init__(base_lr)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def _compute_lr(self):
        n = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * (self.gamma ** n)


class ExponentialLR(Scheduler):
    def __init__(self, base_lr: float, gamma: float):
        super().__init__(base_lr)
        self.gamma = gamma

    def _compute_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class CosineAnnealingLR(Scheduler):
    def __init__(self, base_lr: float, T_max: int, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.T_max = T_max
        self.eta_min = eta_min

    def _compute_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)


class PolynomialLR(Scheduler):
    def __init__(self, base_lr: float, total_iters: int = 5, power: float = 1.0):
        super().__init__(base_lr)
        self.total_iters = total_iters
        self.power = power

    def _compute_lr(self):
        t = min(self.last_epoch, self.total_iters)
        return self.base_lr * (1 - t / self.total_iters) ** self.power


class ReduceLROnPlateau(Scheduler):
    """torch semantics: reduce LR by ``factor`` after ``patience`` epochs without
    improvement (rel threshold 1e-4), with cooldown and min_lr."""

    needs_metric = True

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0, min_lr: float = 0.0,
                 eps: float = 1e-8):
        super().__init__(base_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.eps = eps
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, metric):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return metric < self.best * (1.0 - self.threshold)
            return metric < self.best - self.threshold
        if self.threshold_mode == "rel":
            return metric > self.best * (1.0 + self.threshold)
        return metric > self.best + self.threshold

    def step(self, metric: Optional[float] = None):
        self.last_epoch += 1
        if metric is None:
            return self.lr
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr


class LinearLR(Scheduler):
    """torch LinearLR: factor ramps start_factor -> end_factor over total_iters."""

    def __init__(self, base_lr: float, start_factor: float = 1.0 / 3,
                 end_factor: float = 1.0, total_iters: int = 5):
        super().__init__(base_lr)
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters
        self.lr = base_lr * start_factor

    def _compute_lr(self):
        t = min(self.last_epoch, self.total_iters)
        factor = (self.start_factor
                  + (self.end_factor - self.start_factor) * t / self.total_iters)
        return self.base_lr * factor


class ConstantLR(Scheduler):
    """torch ConstantLR: lr * factor until total_iters, then base lr."""

    def __init__(self, base_lr: float, factor: float = 1.0 / 3,
                 total_iters: int = 5):
        super().__init__(base_lr)
        self.factor = factor
        self.total_iters = total_iters
        self.lr = base_lr * factor

    def _compute_lr(self):
        return self.base_lr * (self.factor if self.last_epoch < self.total_iters
                               else 1.0)


class CosineAnnealingWarmRestarts(Scheduler):
    """torch semantics with whole-epoch steps: restart every T_i epochs where
    T_{i+1} = T_i * T_mult."""

    def __init__(self, base_lr: float, T_0: int, T_mult: int = 1,
                 eta_min: float = 0.0):
        super().__init__(base_lr)
        if T_0 <= 0 or T_mult < 1:
            raise ValueError("CosineAnnealingWarmRestarts requires T_0 > 0, T_mult >= 1")
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min

    def _compute_lr(self):
        e = self.last_epoch
        if self.T_mult == 1:
            t_cur = e % self.T_0
            t_i = self.T_0
        else:
            n = int(math.log(e / self.T_0 * (self.T_mult - 1) + 1, self.T_mult))
            t_cur = e - self.T_0 * (self.T_mult ** n - 1) // (self.T_mult - 1)
            t_i = self.T_0 * self.T_mult ** n
        return (self.eta_min + (self.base_lr - self.eta_min)
                * (1 + math.cos(math.pi * t_cur / t_i)) / 2)


SCHEDULER_REGISTRY = {
    "StepLR": StepLR,
    "MultiStepLR": MultiStepLR,
    "ExponentialLR": ExponentialLR,
    "CosineAnnealingLR": CosineAnnealingLR,
    "PolynomialLR": PolynomialLR,
    "ReduceLROnPlateau": ReduceLROnPlateau,
    "LinearLR": LinearLR,
    "ConstantLR": ConstantLR,
    "CosineAnnealingWarmRestarts": CosineAnnealingWarmRestarts,
}


def build_scheduler(scheduler_name: str, base_lr: float, **kwargs) -> Scheduler:
    if scheduler_name not in SCHEDULER_REGISTRY:
        raise ValueError(f"Scheduler {scheduler_name} is not supported")
    return SCHEDULER_REGISTRY[scheduler_name](base_lr, **kwargs)

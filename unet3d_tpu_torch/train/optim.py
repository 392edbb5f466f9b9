"""Optimizers (``torch.optim``) and LR schedulers (host-side, torch-named).

Counterpart of ``unet3d_tpu/train/optim.py``. Adam and SGD are the
``torch.optim`` classes with torch's defaults, which the JAX package copies;
the other names it resolves raise until they are ported (ROADMAP.md). The
schedulers are the JAX package's host-side state machines, copied as they are:
call ``step(metric)`` once per epoch, then write ``.lr`` into the optimizer
with ``set_learning_rate``.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

_OPTIMIZERS = {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}


def build_optimizer(optimizer_name: str, params: Iterable, lr: float = 1e-3,
                    **kwargs) -> torch.optim.Optimizer:
    """torch.optim names (any case) -> optimizer over ``params``."""
    name = optimizer_name.lower()
    if name not in _OPTIMIZERS:
        raise ValueError(f"Optimizer {optimizer_name} is not ported yet; ported: "
                         "Adam, SGD (see ROADMAP.md)")
    return _OPTIMIZERS[name](params, lr=lr, **kwargs)


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

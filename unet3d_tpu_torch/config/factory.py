"""Config-section -> object factories: the subset the prediction and training
paths need.

Counterparts of ``build_or_load_model_from_config``,
``load_criterion_from_config``, ``build_optimizer_from_config``,
``build_scheduler_from_config``, ``build_inferer_from_config`` and
``get_activation_from_config`` in ``unet3d_tpu/config/factory.py``; the JSON
schema is the same.
"""
from __future__ import annotations

import logging
import os
from typing import Iterable, Optional

import torch

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.predict.sliding_window import build_inferer
from unet3d_tpu_torch.train.checkpoint import load_checkpoint
from unet3d_tpu_torch.train.losses import load_criterion
from unet3d_tpu_torch.train.optim import build_optimizer, build_scheduler
from unet3d_tpu_torch.utils.config import get_kwargs, in_config


def build_or_load_model_from_config(config, model_filename: Optional[str],
                                    device: torch.device, strict: bool = True,
                                    seed: int = 0) -> torch.nn.Module:
    """Create the configured model, initialise it from a ``torch.Generator``
    seeded with ``seed``, load ``model_filename`` (a JAX ``.npz``) when it
    exists, and return it on ``device`` in eval mode."""
    model_cfg = config["model"]
    model = create_model(model_cfg["name"], **get_kwargs(model_cfg))
    init_parameters(model, torch.Generator().manual_seed(seed))
    if model_filename and os.path.exists(model_filename):
        logging.info("Loading model weights from %s (strict=%s)", model_filename, strict)
        load_jax_variables(model, load_checkpoint(model_filename), strict=strict)
    return model.to(device).eval()


def load_criterion_from_config(config):
    return load_criterion(config["loss"]["name"], loss_kwargs=get_kwargs(config["loss"]))


def build_optimizer_from_config(config, params: Iterable) -> torch.optim.Optimizer:
    """The ``optimizer`` section's optimizer over ``params`` (its ``lr``
    defaults to 1e-3)."""
    return build_optimizer(config["optimizer"]["name"], params,
                           **get_kwargs(config["optimizer"]))


def build_scheduler_from_config(config, base_lr: float):
    """The ``scheduler`` section's scheduler, or None without one."""
    if "scheduler" not in config:
        return None
    section = config["scheduler"]
    return build_scheduler(section["name"], base_lr, **get_kwargs(section))


def build_inferer_from_config(config):
    """The ``inference`` section's inferer, or None when it names none (it may
    carry only the ``amp`` extension key)."""
    section = config["inference"]
    if "name" not in section:
        return None
    return build_inferer(section["name"], **get_kwargs(section, skip_keys=("amp",)))


def get_activation_from_config(config):
    """The sigmoid/softmax flag of the loss section."""
    for activation in ("sigmoid", "softmax"):
        if in_config(activation, config["loss"], False):
            return activation
    return None

"""Config-section -> object factories: the subset the prediction and training
paths need.

Counterparts of the machine config (``add_machine_config_to_parser``,
``get_machine_config``), ``check_hierarchy``, ``load_filenames`` /
``load_filenames_from_config``, ``dataset_kwargs_from_config``,
``build_inference_loaders_from_config``, ``build_or_load_model_from_config``,
``load_criterion_from_config``, ``build_optimizer_from_config``,
``build_scheduler_from_config``, ``build_inferer_from_config`` and
``get_activation_from_config`` in ``unet3d_tpu/config/factory.py``; the JSON
schema is the same.
"""
from __future__ import annotations

import logging
import os
from typing import Iterable, Optional

import numpy as np
import torch

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.data.loader import build_loader
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.predict.sliding_window import build_inferer
from unet3d_tpu_torch.train.checkpoint import load_checkpoint
from unet3d_tpu_torch.train.losses import load_criterion
from unet3d_tpu_torch.train.optim import build_optimizer, build_scheduler
from unet3d_tpu_torch.utils.config import get_kwargs, in_config, load_json


def add_machine_config_to_parser(parser):
    """The JAX CLI's machine flags. ``--ngpus`` above 1 and ``--mesh`` are
    refused by the CLIs until multi-GPU is ported."""
    parser.add_argument("--machine_config_filename", required=False,
                        help="JSON configuration file containing the number of "
                             "devices and threads available for model training.")
    parser.add_argument("--nthreads", default=1, type=int,
                        help="Number of data-pipeline threads (default = 1).")
    parser.add_argument("--ngpus", default=1, type=int,
                        help="Number of accelerator devices to use for training. "
                             "Ignored if machine_config_filename is set.")
    parser.add_argument("--pin_memory", action="store_true", default=False)
    parser.add_argument("--mesh", required=False,
                        help="Device-mesh layout for multi-device runs, e.g. "
                             "'data2,space4'. Not ported yet: the port runs on "
                             "one GPU.")


def get_machine_config(namespace):
    """The machine config file, or the flags; ``--mesh`` wins over the file."""
    if getattr(namespace, "machine_config_filename", None):
        print("MP Config: ", namespace.machine_config_filename)
        config = load_json(namespace.machine_config_filename)
    else:
        config = {"n_workers": namespace.nthreads,
                  "n_gpus": namespace.ngpus,
                  "pin_memory": namespace.pin_memory}
    if getattr(namespace, "mesh", None):
        config["mesh"] = namespace.mesh
    return config


def check_hierarchy(config):
    """``labels`` + ``setup_label_hierarchy`` -> nested suffix groups
    ([2, 1, 4] -> [[2, 1, 4], [1, 4], [4]]); True when it expanded them."""
    label_hierarchy = False
    if in_config("labels", config["dataset"]) and in_config("setup_label_hierarchy",
                                                            config["dataset"]):
        config["dataset"].pop("setup_label_hierarchy")
        labels = config["dataset"].pop("labels")
        new_labels = []
        while len(labels):
            new_labels.append(labels)
            labels = labels[1:]
        config["dataset"]["labels"] = new_labels
        label_hierarchy = True
    if "setup_label_hierarchy" in config["dataset"]:
        config["dataset"].pop("setup_label_hierarchy")
    return label_hierarchy


def load_filenames(filenames):
    """An inline list, or a ``.npy`` file of one."""
    if isinstance(filenames, list):
        return filenames
    if ".npy" in str(filenames):
        return np.load(filenames, allow_pickle=True).tolist()
    raise RuntimeError(f"Could not load filenames: {filenames}")


def load_filenames_from_config(config):
    for key in config:
        if "_filenames" in key:
            config[key] = load_filenames(config[key])


def dataset_kwargs_from_config(config):
    return get_kwargs(config["dataset"], ["name", "training", "validation", "verbose"])


def build_inference_loaders_from_config(config, dataset_class, system_config):
    """A loader for every ``X_filenames`` key except training, as [loader, X]."""
    loaders = []
    inference_kwargs = in_config("validation", config["dataset"], {})
    batch_size = in_config("validation_batch_size", config["training"], 1) \
        if "training" in config else 1
    for key in config:
        if "_filenames" in key and key.split("_filenames")[0] not in ("training",):
            name = key.split("_filenames")[0]
            logging.info("Found inference filenames: %s (n=%d)", name, len(config[key]))
            dataset = dataset_class(filenames=config[key], **inference_kwargs,
                                    **dataset_kwargs_from_config(config))
            loader = build_loader(dataset, batch_size=batch_size, shuffle=False,
                                  num_workers=in_config("n_workers", system_config, 1))
            loaders.append([loader, name])
    return loaders


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

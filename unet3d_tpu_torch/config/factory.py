"""Config-section -> object factories (counterparts of
``unet3d_tpu/config/factory.py``; the JSON schema is the same): the machine
config, label-hierarchy expansion, cross-validation folds, the training,
validation and inference loaders, the model, criterion, optimizer, scheduler
and inferer, and the debug example dumps.
"""
from __future__ import annotations

import logging
import os
import warnings
from copy import deepcopy
from typing import Iterable, Optional

import numpy as np
import torch

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.data.image import Volume
from unet3d_tpu_torch.data.loader import build_loader
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.predict.sliding_window import build_inferer
from unet3d_tpu_torch.train.checkpoint import load_checkpoint
from unet3d_tpu_torch.train.losses import load_criterion
from unet3d_tpu_torch.train.optim import build_optimizer, build_scheduler
from unet3d_tpu_torch.utils.config import dump_json, get_kwargs, in_config, load_json


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


def setup_cross_validation(config, work_dir, n_folds, random_seed=25):
    """Shuffle ``training_filenames`` with a local ``RandomState(random_seed)``
    (the JAX CLI's shuffle, so the folds are the same) into ``n_folds`` equal
    folds, the last taking the remainder; writes ``fold{i}.json`` into
    ``work_dir`` and returns [[fold config, its filename], ...]."""
    filenames = config["training_filenames"]
    np.random.RandomState(random_seed).shuffle(filenames)
    val_step = int(len(filenames) / n_folds)
    fold_configs = []
    for fold_i in range(n_folds):
        val_start = val_step * fold_i
        if (fold_i + 1) == n_folds:
            training_filenames = filenames[:val_start]
            validation_filenames = filenames[val_start:]
        else:
            training_filenames = filenames[:val_start] + filenames[val_start + val_step:]
            validation_filenames = filenames[val_start:val_start + val_step]
        assert (len(validation_filenames) + len(training_filenames)) == len(filenames)
        config_filename = os.path.join(work_dir, f"fold{fold_i + 1}.json")
        fold_config = deepcopy(config)
        fold_config["training_filenames"] = training_filenames
        fold_config["validation_filenames"] = validation_filenames
        dump_json(fold_config, config_filename)
        fold_configs.append([fold_config, config_filename])
    return fold_configs


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


def transfer_dtype_from_config(config):
    """bf16 image and label batches under AMP, or when
    ``training.compact_transfer`` says so (it overrides the AMP default): the
    step casts images to bf16 anyway, and one-hot labels are exact in bf16.
    The loader ships them as torch tensors (numpy has no bf16)."""
    amp = bool(in_config("amp", config["training"], False))
    compact = in_config("compact_transfer", config["training"], None)
    if compact if compact is not None else amp:
        return {"image": torch.bfloat16, "label": torch.bfloat16}
    return None


def build_data_loaders_from_config(config, system_config, output_dir, dataset_class,
                                   metric_to_monitor="val_loss"):
    """The training loader (shuffled), the validation loader (None without
    ``validation_filenames``, and then the monitored metric falls back to
    ``loss``) and the metric; ``dataset.add_contours`` doubles
    ``n_outputs``; ``training.test_input`` writes that many transformed
    training samples under ``output_dir/data_loader_testing``."""
    if in_config("add_contours", config["dataset"], False):
        config["n_outputs"] = config.get("n_outputs", 0) * 2

    n_workers = in_config("n_workers", system_config, 1)
    batch_size = in_config("batch_size", config["training"], 1)
    validation_batch_size = in_config("validation_batch_size", config["training"], 1)
    prefetch_factor = in_config("prefetch_factor", config["training"], 1)
    test_input = in_config("test_input", config["training"], 1)

    training_kwargs = in_config("training", config["dataset"], {})
    validation_kwargs = in_config("validation", config["dataset"], {})
    dataset_kwargs = dataset_kwargs_from_config(config)
    transfer_dtype = transfer_dtype_from_config(config)
    collate = in_config("collate", config["training"], None)

    training_dataset = dataset_class(filenames=config["training_filenames"],
                                     **training_kwargs, **dataset_kwargs)
    training_loader = build_loader(training_dataset, batch_size=batch_size,
                                   shuffle=True, num_workers=n_workers,
                                   prefetch_factor=prefetch_factor,
                                   transfer_dtype=transfer_dtype, collate=collate)

    if test_input:
        write_dataset_examples(test_input, training_dataset,
                               output_dir=os.path.join(output_dir, "data_loader_testing"))

    if "validation_filenames" not in config:
        warnings.warn(RuntimeWarning("No 'validation_filenames' key found in config. "
                                     "Validation will not be run!"))
        validation_loader = None
        metric_to_monitor = "loss"
    else:
        validation_dataset = dataset_class(filenames=config["validation_filenames"],
                                           **validation_kwargs, **dataset_kwargs)
        validation_loader = build_loader(validation_dataset,
                                         batch_size=validation_batch_size,
                                         shuffle=False, num_workers=n_workers,
                                         prefetch_factor=prefetch_factor,
                                         transfer_dtype=transfer_dtype)
    return training_loader, validation_loader, metric_to_monitor


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


def model_input_shape_from_config(config, default_shape=(64, 64, 64)):
    """NDHWC input shape of one sample: the dataset's ``desired_shape`` and
    the model's input channels."""
    model_cfg = config["model"]
    channels = model_cfg.get("in_channels", model_cfg.get("n_features", 1))
    shape = in_config("desired_shape", config.get("dataset", {}), default_shape)
    return tuple(int(s) for s in shape) + (int(channels),)


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


def write_dataset_examples(n_test_cases, training_dataset, output_dir):
    """NIfTIs of the first ``n_test_cases`` transformed training samples,
    image and label, for debugging."""
    os.makedirs(output_dir, exist_ok=True)
    for index in range(min(n_test_cases, len(training_dataset))):
        item = training_dataset[index]
        src = item["source_filename"]
        src = src[0] if isinstance(src, (list, tuple)) else src
        base = os.path.basename(str(src)).split(".")[0]
        Volume(data=item["image"], affine=item["affine"]).to_filename(
            os.path.join(output_dir, f"input_test_{base}.nii.gz"))
        if "label" in item and np.asarray(item["label"]).ndim >= 3:
            Volume(data=item["label"], affine=item["affine"]).to_filename(
                os.path.join(output_dir, f"target_test_{base}.nii.gz"))

"""Training CLI (counterpart of ``unet3d_tpu/scripts/train.py``, same flags).

    python -m unet3d_tpu_torch.scripts.train --config_filename cfg.json \
        --output_dir out

Reads the JSON config (model / optimizer / loss / scheduler / dataset /
training / inference / cross_validation / ``*_filenames``), expands
cross-validation into ``fold{i}.json`` configs and trains each, or trains
the config as it is: the dataset's random stages on the host, batches
double-buffered onto the GPU from pinned memory (bf16 under AMP), the train
and eval steps of ``train/step.py`` through ``run_training``, into
``<output_dir>/<config name>/`` (``training_log.csv``, ``model.npz``,
``cache/``). Then it predicts every ``X_filenames`` group except training
into ``<work dir>/X/`` with the config's inferer and activation.

The model runs on the first CUDA GPU, which must be an sm_90 card
(``utils.device.require_cuda``; with none the CLI raises and never falls
back to the CPU); ``run`` / ``main`` take ``device="cpu"`` to run the plain
PyTorch path on purpose, as the tests do. Multi-GPU (``--ngpus > 1``,
``--mesh``), orbax checkpoints, gradient accumulation, ``remat`` and
``save_optimizer`` are not ported yet and raise.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import warnings

import torch

from unet3d_tpu_torch.config.factory import (add_machine_config_to_parser,
                                             build_data_loaders_from_config,
                                             build_inference_loaders_from_config,
                                             build_inferer_from_config,
                                             build_optimizer_from_config,
                                             build_or_load_model_from_config,
                                             build_scheduler_from_config, check_hierarchy,
                                             get_activation_from_config,
                                             get_machine_config,
                                             load_criterion_from_config,
                                             load_filenames_from_config,
                                             setup_cross_validation)
from unet3d_tpu_torch.data.dataset import load_dataset_class, validate_filenames
from unet3d_tpu_torch.data.prefetch import DevicePrefetcher
from unet3d_tpu_torch.predict.volumetric import volumetric_predictions
from unet3d_tpu_torch.train.optim import get_learning_rate
from unet3d_tpu_torch.train.step import (forward_loss, make_eval_step, make_train_step,
                                         prepare_batch)
from unet3d_tpu_torch.train.train import run_training
from unet3d_tpu_torch.utils.config import in_config, load_json
from unet3d_tpu_torch.utils.device import require_cuda


def parse_args(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_filename", required=True,
                        help="JSON configuration file specifying the parameters "
                             "for model training.")
    parser.add_argument("--output_dir", required=False,
                        help="Output directory where all the outputs will be saved. "
                             "Defaults to the directory of the configuration file.")
    parser.add_argument("--setup_crossval_only", action="store_true", default=False,
                        help="Only write the cross-validation configuration files.")
    parser.add_argument("--pretrained_model_filename", required=False,
                        help="If this filename exists prior to training, the model "
                             "will be loaded from the filename (a JAX-format .npz, "
                             "loaded by key).")
    parser.add_argument("--batch_size", type=int,
                        help="Override the batch size from the config file.")
    parser.add_argument("--debug", action="store_true", default=False,
                        help="Raises an error if a training file is not found, and "
                             "turns warnings into errors; default silently skips "
                             "missing files.")
    add_machine_config_to_parser(parser)
    parser.add_argument("--dry_run", action="store_true", default=False,
                        help="Validate the config without training: load one "
                             "batch through the real data pipeline, run one "
                             "forward and backward of the train step at the "
                             "config's shapes without an optimizer update, write "
                             "compile_report.json (shapes, dtypes, amp, peak "
                             "device memory) to the work dir, and exit.")
    parser.add_argument("--n_examples", type=int, default=1,
                        help="Number of example input/output pairs to write to "
                             "file for debugging purposes. (default = 1)")
    return parser.parse_args(args)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def dry_run_step(work_dir, training_loader, model, criterion, amp: bool,
                 device: torch.device) -> dict:
    """``--dry_run``: one batch through the real data pipeline, then one
    forward and backward of the train step at its shapes, the gradients
    dropped (no optimizer update). Writes ``compile_report.json`` with the
    JAX CLI's keys that have a meaning here; ``per_device_peak_gib`` is the
    device's peak allocated memory in the step (CUDA only)."""
    batch = next(iter(training_loader))
    images, labels = batch["image"], batch["label"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    x, y = prepare_batch(images, labels, device, amp)
    forward_loss(model, criterion, x, y, amp).backward()
    model.zero_grad(set_to_none=True)
    report = {
        "backend": device.type,
        "mesh": None,
        "images": [[int(s) for s in images.shape], _dtype_name(images.dtype)],
        "labels": [[int(s) for s in labels.shape], _dtype_name(labels.dtype)],
        "amp": bool(amp),
        "gradient_accumulation_steps": 1,
    }
    if cuda:
        torch.cuda.synchronize(device)
        report["per_device_peak_gib"] = round(
            torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    path = os.path.join(work_dir, "compile_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    logging.info("Dry run: train step ran OK -> %s", path)
    logging.info("Compile report: %s", json.dumps(report))
    return report


def _refuse_unported(config, system_config) -> None:
    n_devices = int(in_config("n_gpus", system_config, 1))
    if n_devices > 1 or in_config("mesh", system_config, None) is not None:
        raise NotImplementedError(
            "multi-device training (--ngpus > 1, --mesh) is not ported yet "
            "(see ROADMAP.md)")
    training = config.get("training", {})
    if in_config("checkpoint_backend", training, "npz") == "orbax":
        raise NotImplementedError("checkpoint_backend 'orbax' is not ported yet "
                                  "(see ROADMAP.md)")
    if int(in_config("gradient_accumulation_steps", training, 1)) > 1:
        raise NotImplementedError("gradient_accumulation_steps > 1 is not ported yet "
                                  "(see ROADMAP.md)")
    if in_config("remat", training, False):
        raise NotImplementedError("training.remat is not ported yet (see ROADMAP.md)")


def run(config_filename, output_dir, namespace, device=None):
    """Train one config (or each of its cross-validation folds) on
    ``device`` (default: the first CUDA GPU, see the module docstring).
    Returns, per trained config, a dict with its ``work_dir``, ``model``,
    loaders and written ``predictions`` (a list of them, one per fold, for a
    cross-validation config; the report for a dry run)."""
    logging.info("Config: %s", config_filename)
    config = load_json(config_filename)
    load_filenames_from_config(config)

    work_dir = os.path.join(output_dir, os.path.basename(config_filename).split(".")[0])
    logging.info("Work Dir: %s", work_dir)
    os.makedirs(work_dir, exist_ok=True)

    if "cross_validation" in config:
        cross_validation_config = config.pop("cross_validation")
        if isinstance(cross_validation_config, list):  # the sppin config wraps it
            cross_validation_config = cross_validation_config[0]
        folds = []
        for _config, _config_filename in setup_cross_validation(
                config, work_dir=work_dir,
                n_folds=in_config("n_folds", cross_validation_config,
                                  in_config("folds", cross_validation_config, 5)),
                random_seed=in_config("random_seed", cross_validation_config,
                                      in_config("seed", cross_validation_config, 25))):
            if not namespace.setup_crossval_only:
                logging.info("Running cross validation fold: %s", _config_filename)
                folds.append(run(_config_filename, work_dir, namespace, device=device))
            else:
                logging.info("Setup cross validation fold: %s", _config_filename)
        return folds

    system_config = get_machine_config(namespace)
    _refuse_unported(config, system_config)
    device = torch.device(device) if device is not None else require_cuda()

    if namespace.debug:
        config.setdefault("dataset", {})["verbose"] = True
        warnings.filterwarnings("error")
    if namespace.batch_size:
        warnings.warn(RuntimeWarning(
            "Overwriting the batch size from the configuration file (batch_size={}) "
            "to batch_size={}".format(config["training"]["batch_size"],
                                      namespace.batch_size)))
        config["training"]["batch_size"] = namespace.batch_size

    for key in list(config):
        if "_filenames" in key:
            config[key] = validate_filenames(config[key], raise_on_missing=namespace.debug)

    model_filename = os.path.join(work_dir, "model.npz")
    logging.info("Model: %s", model_filename)
    training_log_filename = os.path.join(work_dir, "training_log.csv")
    logging.info("Log: %s", training_log_filename)

    check_hierarchy(config)
    dataset_class = load_dataset_class(config["dataset"],
                                       cache_dir=os.path.join(work_dir, "cache"))
    if namespace.n_examples:
        config["training"]["test_input"] = namespace.n_examples

    training_loader, validation_loader, metric_to_monitor = \
        build_data_loaders_from_config(config, system_config, work_dir, dataset_class)

    pretrained = namespace.pretrained_model_filename
    pretrained = os.path.abspath(pretrained) if pretrained else model_filename
    model = build_or_load_model_from_config(config, pretrained, device, strict=False)
    criterion = load_criterion_from_config(config)
    optimizer = build_optimizer_from_config(config, model.parameters())
    scheduler = build_scheduler_from_config(config, get_learning_rate(optimizer))
    inferer = build_inferer_from_config(config) if "inference" in config else None
    amp = bool(in_config("amp", config["training"], False))

    if namespace.dry_run:
        return dry_run_step(work_dir, training_loader, model, criterion, amp, device)

    # batch i + 1 is prepared and copied to the device while step i runs
    training_loader = DevicePrefetcher(training_loader, device)
    if validation_loader is not None:
        validation_loader = DevicePrefetcher(validation_loader, device)

    training = config["training"]
    run_training(
        make_train_step(model, criterion, optimizer, amp=amp),
        make_eval_step(model, criterion, inferer=inferer, amp=amp), model, optimizer,
        n_epochs=in_config("n_epochs", training, 1000),
        training_loader=training_loader, validation_loader=validation_loader,
        training_log_filename=training_log_filename, model_filename=model_filename,
        metric_to_monitor=metric_to_monitor,
        early_stopping_patience=in_config("early_stopping_patience", training, None),
        save_best=in_config("save_best", training, True),
        save_every_n_epochs=in_config("save_every_n_epochs", training, None),
        save_last_n_models=in_config("save_last_n_models", training, None),
        scheduler=scheduler,
        samples_per_epoch=in_config("samples_per_epoch", training, None),
        training_iterations_per_epoch=in_config("training_iterations_per_epoch",
                                                training, 1),
        save_optimizer=bool(in_config("save_optimizer", training, False)))

    predictions = {}
    for _loader, _name in build_inference_loaders_from_config(
            config, dataset_class=dataset_class, system_config=system_config):
        predictions[_name] = volumetric_predictions(
            model, _loader, os.path.join(work_dir, _name),
            activation=get_activation_from_config(config),
            resample=in_config("resample", config["dataset"], False), inferer=inferer,
            amp=bool(in_config("amp", config.get("inference", {}), amp)),
            interpolation="trilinear")
    return {"work_dir": work_dir, "model": model, "training_loader": training_loader,
            "validation_loader": validation_loader, "predictions": predictions}


def main(args=None, device=None):
    """The CLI on ``args`` (default: ``sys.argv``), on ``device`` (default:
    the first CUDA GPU); returns what ``run`` returns. ``--debug``'s warnings
    filter ends with the call."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    namespace = parse_args(args)
    config_filename = os.path.abspath(namespace.config_filename)
    if namespace.output_dir:
        output_dir = os.path.abspath(namespace.output_dir)
    else:
        output_dir = os.path.dirname(config_filename)
    with warnings.catch_warnings():
        return run(config_filename, output_dir, namespace, device=device)


if __name__ == "__main__":
    main()

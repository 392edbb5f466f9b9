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
PyTorch path on purpose, as the tests do. ``training.remat`` recomputes
activations in the backward pass (each block of the net's root),
``training.gradient_accumulation_steps`` splits each batch into microbatches
with one optimizer update, and
``training.save_optimizer`` keeps the optimizer state across a resume, as in
the JAX CLI. Orbax checkpoints are not ported and raise.

``--ngpus N`` (the machine config's ``n_gpus``) or ``--mesh dataN`` trains
data-parallel, as the JAX CLI's ``data`` axis does: the same command starts
N processes, one per GPU over NCCL (gloo processes on the CPU under
``device="cpu"``; N is clamped to the visible GPUs), each taking its share
of every batch, with the JAX sharded step's global-batch semantics
(``parallel/mesh.py``); rank 0 writes the log and checkpoints, and each
rank predicts its share of the cases. ``--mesh data2,space2`` (any data x
space grid) also splits each volume's D planes over the space axis: the
ranks of a space line take the same items and each its D slab
(DynUNet and UNet3D only; another net raises). Under ``torchrun`` each
process is a rank and nothing is spawned; the machine config's
``coordinator_address``, ``n_nodes`` and ``node_rank`` join the nodes. A
``model`` mesh axis is not ported yet and raises; the batch size must
divide by the data axis, as in JAX, and by the data axis times
``training.gradient_accumulation_steps``, and the patch's depth
(``dataset.desired_shape``) by the space axis.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import warnings
from typing import Optional

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
from unet3d_tpu_torch.models.registry import MODEL_REGISTRY
from unet3d_tpu_torch.parallel import distributed, launch
from unet3d_tpu_torch.parallel.mesh import (check_space_form, make_mesh,
                                            make_sharded_eval_step, make_sharded_train_step,
                                            replicate_state, sharded_gradients)
from unet3d_tpu_torch.predict.volumetric import volumetric_predictions
from unet3d_tpu_torch.train.optim import get_learning_rate
from unet3d_tpu_torch.train.step import (accumulate_gradients, make_eval_step,
                                         make_train_step, noise_generator,
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
                 device: torch.device, grad_accum: int = 1, mesh=None) -> dict:
    """``--dry_run``: one batch through the real data pipeline, then the
    forwards and backwards of the train step at its shapes (``grad_accum``
    microbatches; with a data-parallel ``mesh`` each rank's share and the
    gradients' all-reduce), the gradients dropped (no optimizer update) and
    the running statistics the forwards updated put back. Rank 0 writes
    ``compile_report.json`` with the JAX CLI's keys that have a meaning
    here (``mesh`` the axis sizes, the global batch's shapes);
    ``per_device_peak_gib`` is the device's peak allocated memory in the
    step (CUDA only)."""
    batch = next(iter(training_loader))
    images, labels = batch["image"], batch["label"]
    n = batch.get("global_batch_size", images.shape[0])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    x, y = prepare_batch(images, labels, device, amp)
    buffers = [(b, b.clone()) for b in model.buffers()]
    if mesh is None:
        accumulate_gradients(model, criterion, x, y, amp, grad_accum, noise_generator(model))
    else:
        sharded_gradients(model, criterion, x, y, mesh, amp, grad_accum,
                          noise_generator(model), batch.get("whole_batch", False))
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        for b, before in buffers:
            b.copy_(before)
    report = {
        "backend": device.type,
        "mesh": dict(mesh.shape) if mesh is not None else None,
        "images": [[n, *map(int, images.shape[1:])], _dtype_name(images.dtype)],
        "labels": [[n, *map(int, labels.shape[1:])], _dtype_name(labels.dtype)],
        "amp": bool(amp),
        "gradient_accumulation_steps": int(grad_accum),
    }
    if cuda:
        torch.cuda.synchronize(device)
        report["per_device_peak_gib"] = round(
            torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    path = os.path.join(work_dir, "compile_report.json")
    if distributed.is_primary_host():
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
    distributed.barrier()
    logging.info("Dry run: train step ran OK -> %s", path)
    logging.info("Compile report: %s", json.dumps(report))
    return report


def _refuse_unported(config, system_config, device) -> Optional[launch.Plan]:
    """The parallel plan of the machine config (None: one device); a
    ``model`` mesh axis, a ``space`` axis under a net without a space form
    and orbax checkpoints raise."""
    run_plan = launch.plan(system_config, device)
    training = config.get("training", {})
    if in_config("checkpoint_backend", training, "npz") == "orbax":
        raise NotImplementedError("checkpoint_backend 'orbax' is not ported yet "
                                  "(see ROADMAP.md)")
    if run_plan is not None:
        model_class = MODEL_REGISTRY.get(config["model"]["name"])
        if model_class is not None:
            check_space_form(model_class, run_plan.mesh.get("space", 1))
        check_depth_divides(config, run_plan.mesh.get("space", 1))
    return run_plan


def check_depth_divides(config, space_axis: int) -> None:
    """The JAX CLI's check: the space axis divides the patch's depth
    (``dataset.desired_shape``)."""
    desired_shape = (config.get("dataset") or {}).get("desired_shape")
    if space_axis > 1 and desired_shape and int(desired_shape[0]) % space_axis:
        raise ValueError(
            f"desired_shape depth {desired_shape[0]} is not divisible by the mesh's "
            f"space axis ({space_axis}); pick a space size that divides the volume "
            "depth, or pad desired_shape")


def check_batch_divides(batch_size: int, data_axis: int, grad_accum: int = 1) -> None:
    """The JAX CLI's check, with its hint: the data axis divides the batch.
    Then the port's own: with ``grad_accum`` microbatches the data axis
    divides each microbatch too (rank r's share of each, as JAX's scan lays
    it out; a batch that did not divide would run whole on every rank)."""
    if batch_size % data_axis:
        hint = ""
        if batch_size and data_axis % batch_size == 0:
            hint = f" (e.g. --mesh data{batch_size},space{data_axis // batch_size})"
        raise ValueError(
            f"batch_size={batch_size} is not divisible by the mesh's "
            f"data axis ({data_axis}); pick a mesh whose data axis "
            f"divides the batch{hint}")
    if batch_size % (data_axis * grad_accum):
        raise ValueError(
            f"batch_size={batch_size} in gradient_accumulation_steps={grad_accum} "
            f"microbatches does not divide over the mesh's data axis ({data_axis}); "
            f"pick a batch size that {data_axis * grad_accum} divides, or fewer "
            f"microbatches")


def _train_rank(config_filename, output_dir, namespace):
    """One rank of a data-parallel run: ``run`` on the rank's device; what
    it wrote (the work dir, the rank's predictions by group, the dry run's
    report)."""
    result = run(config_filename, output_dir, namespace, device=distributed.rank_device())
    if not isinstance(result, dict) or "work_dir" not in result:
        return result
    return {"work_dir": result["work_dir"], "predictions": result["predictions"]}


def _grad_accum(config) -> int:
    return int(in_config("gradient_accumulation_steps", config["training"], 1))


def check_gradient_accumulation(criterion, grad_accum: int) -> None:
    """The JAX CLI's checks: averaging microbatch losses and gradients
    equals the full-batch step only for a mean-reduced criterion that
    decomposes per sample, so a ``batch=True`` criterion raises and another
    reduction warns."""
    if grad_accum <= 1:
        return
    if getattr(criterion, "batch", False):
        raise ValueError(
            "gradient_accumulation_steps > 1 is incompatible with a "
            "batch=True criterion: the loss couples samples across the "
            "batch axis, so microbatched accumulation changes the "
            "training objective. Set batch=False or disable accumulation.")
    if getattr(criterion, "reduction", "mean") != "mean":
        warnings.warn(RuntimeWarning(
            "gradient_accumulation_steps > 1 with reduction="
            f"'{criterion.reduction}': accumulated microbatch losses are "
            "averaged, which only matches the full-batch step for "
            "reduction='mean'."))


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
    run_plan = _refuse_unported(config, system_config, device or "cuda")
    if run_plan is not None and not distributed.is_initialized():
        if device is None:
            require_cuda()
        check_batch_divides(int(namespace.batch_size or config["training"]["batch_size"]),
                            run_plan.mesh.get("data", 1), _grad_accum(config))
        ranks = launch.launch(_train_rank, (config_filename, output_dir, namespace), run_plan,
                              device=device or "cuda")
        if not isinstance(ranks[0], dict) or "work_dir" not in ranks[0]:
            return ranks[0]
        return {"work_dir": ranks[0]["work_dir"],
                "world_size": math.prod(run_plan.mesh.values()),
                "predictions": {k: launch.interleave([r["predictions"][k] for r in ranks])
                                for k in ranks[0]["predictions"]}}
    mesh = make_mesh(run_plan.mesh) if run_plan is not None else None
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

    if mesh is not None:
        check_batch_divides(int(config["training"]["batch_size"]), mesh.size,
                            _grad_accum(config))
    training_loader, validation_loader, metric_to_monitor = \
        build_data_loaders_from_config(config, system_config, work_dir, dataset_class,
                                       mesh=mesh)

    pretrained = namespace.pretrained_model_filename
    pretrained = os.path.abspath(pretrained) if pretrained else model_filename
    training = config["training"]
    model = build_or_load_model_from_config(config, pretrained, device, strict=False,
                                            remat=bool(in_config("remat", training, False)))
    if mesh is not None:
        replicate_state(model, mesh)
    criterion = load_criterion_from_config(config)
    optimizer = build_optimizer_from_config(config, model.parameters())
    scheduler = build_scheduler_from_config(config, get_learning_rate(optimizer))
    inferer = build_inferer_from_config(config) if "inference" in config else None
    amp = bool(in_config("amp", training, False))
    grad_accum = _grad_accum(config)
    check_gradient_accumulation(criterion, grad_accum)

    if namespace.dry_run:
        return dry_run_step(work_dir, training_loader, model, criterion, amp, device,
                            grad_accum, mesh)

    # batch i + 1 is prepared and copied to the device while step i runs
    training_loader = DevicePrefetcher(training_loader, device)
    if validation_loader is not None:
        validation_loader = DevicePrefetcher(validation_loader, device)

    if mesh is None:
        train_step = make_train_step(model, criterion, optimizer, amp=amp,
                                     grad_accum=grad_accum)
        eval_step = make_eval_step(model, criterion, inferer=inferer, amp=amp)
    else:
        train_step = make_sharded_train_step(model, criterion, optimizer, mesh, amp=amp,
                                             grad_accum=grad_accum)
        eval_step = make_sharded_eval_step(model, criterion, mesh, inferer=inferer, amp=amp)
    run_training(
        train_step, eval_step, model, optimizer,
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
            interpolation="trilinear", mesh=mesh)
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

"""Inference CLI (counterpart of ``unet3d_tpu/scripts/predict.py``, same flags).

    python -m unet3d_tpu_torch.scripts.predict --config_filename cfg.json \
        --model_filename model.npz --output_directory out --group test

Runs the configured model, strictly loaded from a JAX-format ``.npz``
checkpoint, over the ``<group>_filenames`` cases through the config's dataset
(cached under ``<output_directory>/cache``) and writes one NIfTI per case into
``<output_directory>/predictions``, resampled back to the case's source grid
when the dataset resamples. The model runs on the first CUDA GPU, which must
be an sm_90 card (``utils.device.require_cuda``; with none the CLI raises and
never falls back to the CPU); ``run_inference`` / ``main`` take
``device="cpu"`` to run the plain PyTorch path on purpose, as the tests do.
``UNET3D_TPU_CONV=winograd`` routes the large stride-1 convs through the
Winograd-DH kernels (``ops/conv3d.py``).

``--ngpus N`` (``n_gpus``) predicts on N ranks, one process per GPU
(``parallel/launch.py``; gloo processes on the CPU under ``device="cpu"``),
laid out as JAX's CLI lays its devices (``predict_plan``): without a mesh
spec, or with one that has a ``space`` axis, on ``{"space": N}``, each
case's depth sharded over the ranks (the same case on every rank, rank 0
writing); with a pure data spec (``--mesh dataN``) in the data layout, rank
r predicting and writing the cases r, r + N, .... Either way the files are
the single-device run's. A net without a space form (any but DynUNet and
UNet3D) takes the data layout by default, with a log line (a divergence
from JAX's CLI, see ROADMAP.md), and raises on an explicit ``space`` axis;
a ``model`` axis raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Dict, Optional

import torch

from unet3d_tpu_torch.config.factory import (add_machine_config_to_parser,
                                             build_or_load_model_from_config,
                                             check_hierarchy,
                                             dataset_kwargs_from_config,
                                             get_machine_config)
from unet3d_tpu_torch.data.dataset import load_dataset_class
from unet3d_tpu_torch.data.loader import build_loader
from unet3d_tpu_torch.models.registry import MODEL_REGISTRY
from unet3d_tpu_torch.parallel import distributed, launch
from unet3d_tpu_torch.parallel.mesh import (check_space_form, has_space_form, make_mesh,
                                            parse_mesh_spec)
from unet3d_tpu_torch.predict.volumetric import volumetric_predictions
from unet3d_tpu_torch.scripts.segment import format_parser as format_segmentation_parser
from unet3d_tpu_torch.utils.config import in_config, load_json
from unet3d_tpu_torch.utils.device import require_cuda


def format_parser(parser=None, sub_command: bool = False):
    if parser is None:
        parser = argparse.ArgumentParser()
    parser.add_argument("--output_directory", required=True)
    if not sub_command:
        parser.add_argument("--config_filename", required=True)
        parser.add_argument("--model_filename", required=True)
        add_machine_config_to_parser(parser)
    parser.add_argument("--group", default="test",
                        help="Name of the group of filenames to make predictions on. "
                             "The default is 'test'.")
    parser.add_argument("--activation",
                        help="Apply an activation function to the outputs of the "
                             "model before writing to file.")
    format_segmentation_parser(parser, sub_command=True)
    return parser


def parse_args(args=None):
    return format_parser().parse_args(args)


def _predict_rank(config, output_directory, model_filename, group, activation,
                  system_config):
    """One rank of a data-parallel prediction: its written files."""
    return run_inference(config, output_directory, model_filename, group, activation,
                         system_config, device=distributed.rank_device())


def predict_plan(config, system_config, device) -> Optional[launch.Plan]:
    """JAX's predict CLI's layout of ``n_gpus`` devices (raised to a mesh
    spec's count): a pure data spec keeps the data layout; otherwise every
    rank goes on the ``space`` axis (an explicit spec's data axis too, as
    JAX builds ``make_mesh({"space": n})``). A net without a space form
    takes the data layout unless a ``space`` axis above 1 is asked for,
    which raises."""
    name = config["model"]["name"]
    model_class = MODEL_REGISTRY.get(name)
    spec = (system_config or {}).get("mesh")
    spec = parse_mesh_spec(spec) if spec is not None else None
    space = spec is None or "space" in spec
    if model_class is not None and spec is not None:
        check_space_form(model_class, spec.get("space", 1))
    on_space = space and model_class is not None and has_space_form(model_class)
    run_plan = launch.plan(system_config, device, "space" if on_space else "data")
    if run_plan is None:
        return None
    if on_space and spec is not None:
        world = run_plan.nprocs * int((system_config or {}).get("n_nodes") or 1)
        run_plan = dataclasses.replace(run_plan, mesh={"space": world})
    if space and not on_space and not distributed.is_initialized():
        logging.warning("%s has no form for the 'space' mesh axis: predicting on %s, each "
                        "rank its own cases (JAX's CLI shards each case's depth)", name,
                        run_plan.mesh)
    return run_plan


def train_predict_layout(name: str, spec, world: int) -> Dict[str, int]:
    """The mesh the train CLI predicts on after training on ``world`` ranks
    under the mesh ``spec`` (None: ``--ngpus`` alone), as JAX's train CLI
    re-lays its devices: whole-case prediction runs batch 1 per case, so a
    net with a space form predicts on ``{"space": world}``, each case's depth
    sharded, unless the spec names no ``space`` axis (an explicit data-only
    mesh), which keeps its layout. A net without a space form keeps the data
    layout, with a log line where JAX's CLI would shard the depth."""
    spec = parse_mesh_spec(spec) if spec is not None else None
    train = spec or {"data": world}
    if spec is not None and "space" not in spec:
        return train
    model_class = MODEL_REGISTRY.get(name)
    if model_class is not None and has_space_form(model_class):
        return {"space": world}
    if distributed.process_index() == 0:
        logging.warning("%s has no form for the 'space' mesh axis: predicting on %s, each "
                        "rank its own cases (JAX's CLI shards each case's depth)", name, train)
    return train


def run_inference(config, output_directory, model_filename, group, activation,
                  system_config, device=None):
    """The JAX ``run_inference`` on ``device`` when given, else the first
    CUDA GPU (``require_cuda``, which raises without one); on N ranks for a
    machine config of N devices (see the module docstring). Returns the
    written files in the loader's order."""
    if str(model_filename).endswith(".u3dexp"):
        raise NotImplementedError(
            f"{model_filename}: exported model artifacts are not ported yet "
            "(see ROADMAP.md)")
    run_plan = predict_plan(config, system_config, device or "cuda")
    if run_plan is not None and not distributed.is_initialized():
        if device is None:
            require_cuda()
        return launch.interleave(launch.launch(
            _predict_rank, (config, output_directory, model_filename, group, activation,
                            system_config), run_plan, device=device or "cuda"))
    mesh = make_mesh(run_plan.mesh) if run_plan is not None else None
    device = torch.device(device) if device is not None else require_cuda()
    logging.info("Output directory: %s", output_directory)
    work_dir = os.path.abspath(output_directory)
    check_hierarchy(config)
    cache_dir = os.path.join(work_dir, "cache")
    os.makedirs(cache_dir, exist_ok=True)
    dataset_class = load_dataset_class(config["dataset"], cache_dir=cache_dir)
    key = f"{group}_filenames"
    logging.info("Filenames key: %s", key)
    if key not in config:
        raise ValueError(f"Could not find key {key} in the configuration file. "
                         "Change the group ('--group' on commandline) to the name of "
                         "the group of filenames (e.g., 'validation' to use "
                         "'validation_filenames') that you want to predict.")

    inference_kwargs = in_config("validation", config["dataset"], {})
    batch_size = in_config("validation_batch_size", config.get("training", {}), 1)
    dataset = dataset_class(filenames=config[key], **inference_kwargs,
                            **dataset_kwargs_from_config(config))
    dataloader = build_loader(dataset, batch_size=batch_size, shuffle=False,
                              num_workers=in_config("n_workers", system_config, 1))

    logging.info("Model filename: %s", model_filename)
    model = build_or_load_model_from_config(config, model_filename, device, strict=True)
    prediction_dir = os.path.join(work_dir, "predictions")
    os.makedirs(prediction_dir, exist_ok=True)
    amp = bool(in_config("amp", config.get("inference", {}),
                         in_config("amp", config.get("training", {}), False)))
    return volumetric_predictions(model, dataloader, prediction_dir,
                                  activation=activation,
                                  resample=in_config("resample", config["dataset"], False),
                                  amp=amp, interpolation="trilinear", mesh=mesh)


def main(args=None, device=None):
    """The CLI on ``args`` (default: ``sys.argv``), on ``device`` (default:
    the first CUDA GPU, see ``run_inference``)."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    namespace = parse_args(args)
    logging.info("Config filename: %s", namespace.config_filename)
    config = load_json(namespace.config_filename)
    run_inference(config=config, output_directory=namespace.output_directory,
                  model_filename=namespace.model_filename, group=namespace.group,
                  activation=namespace.activation,
                  system_config=get_machine_config(namespace), device=device)


if __name__ == "__main__":
    main()

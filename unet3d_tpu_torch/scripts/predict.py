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
"""
from __future__ import annotations

import argparse
import logging
import os

import torch

from unet3d_tpu_torch.config.factory import (add_machine_config_to_parser,
                                             build_or_load_model_from_config,
                                             check_hierarchy,
                                             dataset_kwargs_from_config,
                                             get_machine_config)
from unet3d_tpu_torch.data.dataset import load_dataset_class
from unet3d_tpu_torch.data.loader import build_loader
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


def run_inference(config, output_directory, model_filename, group, activation,
                  system_config, device=None):
    """The JAX ``run_inference`` on one device: ``device`` when given, else
    the first CUDA GPU (``require_cuda``, which raises without one)."""
    if str(model_filename).endswith(".u3dexp"):
        raise NotImplementedError(
            f"{model_filename}: exported model artifacts are not ported yet "
            "(see ROADMAP.md)")
    n_devices = int(in_config("n_gpus", system_config, 1))
    if n_devices > 1 or in_config("mesh", system_config, None) is not None:
        raise NotImplementedError(
            "multi-device prediction (--ngpus > 1, --mesh) is not ported yet "
            "(see ROADMAP.md)")
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
                                  amp=amp, interpolation="trilinear")


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

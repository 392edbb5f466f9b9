"""Export a trained model as a serving artifact (counterpart of
``unet3d_tpu/scripts/export.py``, same flags).

    python -m unet3d_tpu_torch.scripts.export --config_filename cfg.json \
        --model_filename model.npz --output_filename model.u3dexp \
        [--activation sigmoid] [--batch_size N] [--amp] [--platforms cpu,cuda] \
        [--entry_layout ndhwc]

Builds the configured model, strictly loaded from a JAX-format ``.npz``
checkpoint, and writes the ``torch.export`` container of
``predict/export.py``, which ``load_exported``, ``scripts/predict.py`` (a
``--model_filename`` ending in ``.u3dexp``) and ``scripts/serve.py`` run
without the model code, the config or the checkpoint. The model is traced
on the first CUDA GPU (``utils.device.require_cuda``; with none the CLI
raises); ``main`` takes ``device="cpu"`` to export on the CPU, as the tests
do. ``UNET3D_TPU_CONV`` at export time is frozen into the artifact.
``--mesh`` (a multi-device artifact) raises ``NotImplementedError``: not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import logging

import torch

from unet3d_tpu_torch.config.factory import (build_or_load_model_from_config,
                                             get_activation_from_config,
                                             model_input_shape_from_config)
from unet3d_tpu_torch.parallel.mesh import parse_mesh_spec
from unet3d_tpu_torch.predict.export import export_forward, save_exported
from unet3d_tpu_torch.utils.config import load_json
from unet3d_tpu_torch.utils.device import require_cuda


def format_parser(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_filename", required=True)
    parser.add_argument("--model_filename", required=True)
    parser.add_argument("--output_filename", required=True)
    parser.add_argument("--activation", default=None,
                        help="Activation folded into the artifact (a name the predict "
                             "CLI takes). Default: inferred from the config's loss "
                             "(sigmoid/softmax), like the segment CLI.")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="Fix the batch dimension; default exports a dynamic batch.")
    parser.add_argument("--platforms", default=None,
                        help="Comma-separated devices the artifact is for, of 'cpu' and "
                             "'cuda'. Default: the device it is exported on.")
    parser.add_argument("--amp", action="store_true",
                        help="Run the exported graph in bfloat16 (f32 in/out).")
    parser.add_argument("--mesh", default=None,
                        help="A multi-device artifact over a mesh, e.g. 'space=4': not "
                             "ported yet, raises.")
    parser.add_argument("--entry_layout", default="ncdhw", choices=("ncdhw", "ndhwc"),
                        help="Artifact boundary layout: 'ncdhw' (channel-first, the "
                             "package's host convention; default) or 'ndhwc' "
                             "(channel-last, no moves inside the program).")
    return parser


def parse_args(args=None):
    return format_parser().parse_args(args)


def main(args=None, device=None):
    """The CLI on ``args`` (default: ``sys.argv``), tracing on ``device``
    (default: the first CUDA GPU). Returns the header written."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    namespace = parse_args(args)
    mesh = parse_mesh_spec(namespace.mesh) if namespace.mesh else None
    device = torch.device(device) if device is not None else require_cuda()
    config = load_json(namespace.config_filename)
    model = build_or_load_model_from_config(config, namespace.model_filename, device,
                                            strict=True)
    input_shape = model_input_shape_from_config(config)
    activation = namespace.activation or get_activation_from_config(config)
    platforms = namespace.platforms.split(",") if namespace.platforms else None
    logging.info("Exporting %s at input shape %s (activation=%s, amp=%s, platforms=%s, "
                 "entry_layout=%s) on %s", config["model"].get("name"), input_shape,
                 activation, namespace.amp, platforms or device.type,
                 namespace.entry_layout, device)
    exported = export_forward(model, input_shape, amp=namespace.amp, activation=activation,
                              batch_size=namespace.batch_size, platforms=platforms,
                              mesh=mesh, entry_layout=namespace.entry_layout)
    metadata = {"model": config["model"], "activation": activation,
                "amp": bool(namespace.amp), "entry_layout": namespace.entry_layout}
    header = save_exported(exported, namespace.output_filename, metadata=metadata)
    logging.info("Wrote %s (in=%s out=%s platforms=%s conv_strategy=%s)",
                 namespace.output_filename, header["in_avals"], header["out_avals"],
                 header["platforms"], header["conv_strategy"])
    return header


if __name__ == "__main__":
    main()

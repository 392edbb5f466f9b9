"""Whole-volume prediction: forward -> activation -> NIfTI.

Counterpart of ``unet3d_tpu/predict/volumetric.py``: a no-grad loop over a
loader's batches, an optional inferer (sliding window), a sigmoid/softmax
activation, and one NIfTI per case named after its source file. Resampling
back to the source grid waits for the port of ``ops/resample.py``.
"""
from __future__ import annotations

import copy
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from unet3d_tpu_torch.data.image import Volume
from unet3d_tpu_torch.utils.validation import validate_batch_item


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) host layout -> contiguous (B, D, H, W, C)."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def make_forward(model: torch.nn.Module, amp: bool = False) -> Callable:
    """Inference forward over NDHWC inputs.

    ``amp`` runs it in bfloat16 and returns f32: the parameters are cast to
    bf16 once, here, on a copy of the model (the f32 master stays as it is),
    and each input is cast per call."""
    net = copy.deepcopy(model).to(torch.bfloat16) if amp else model
    net.eval()

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if amp:
                return net(x.to(torch.bfloat16)).float()
            return net(x)

    return forward


def apply_activation(pred: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """None, or the config's sigmoid / softmax (over channels, the last axis)."""
    if activation is None:
        return pred
    if activation == "sigmoid":
        return torch.sigmoid(pred)
    if activation == "softmax":
        return torch.softmax(pred, dim=-1)
    raise ValueError(f"Unknown activation {activation}")


def _prediction_filename(prediction_dir: str, source) -> str:
    src = source[0] if isinstance(source, (list, tuple)) else source
    basename = os.path.basename(str(src))
    for ext in (".nii.gz", ".nii"):
        if basename.endswith(ext):
            basename = basename[: -len(ext)]
            break
    return os.path.join(prediction_dir, basename + ".nii.gz")


def volumetric_predictions(model: torch.nn.Module, dataloader,
                           prediction_dir: str,
                           activation: Optional[str] = None,
                           resample: bool = False,
                           inferer: Optional[Callable] = None,
                           amp: bool = False) -> List[str]:
    """Predict every case of ``dataloader`` on the model's device and write
    one NIfTI each; returns the filenames.

    Batches are dicts with ``image`` (B, C, D, H, W), ``affine`` (B, 4, 4) and
    ``source_filename``; ``amp`` runs the forward in bf16."""
    if resample:
        raise NotImplementedError(
            "resample=True needs the port of ops/resample.py (see ROADMAP.md)")
    os.makedirs(prediction_dir, exist_ok=True)
    forward = make_forward(model, amp=amp)
    device = next(model.parameters()).device
    written: List[str] = []
    for batch in dataloader:
        for key in ("image", "affine", "source_filename"):
            validate_batch_item(batch, key, context="volumetric prediction")
        x = to_ndhwc(torch.as_tensor(np.asarray(batch["image"])).to(device))
        pred = inferer(x, forward) if inferer is not None else forward(x)
        pred = apply_activation(pred.float(), activation)
        pred_host = pred.cpu().numpy()  # (B, D, H, W, C)
        for i in range(pred_host.shape[0]):
            item_pred = np.moveaxis(pred_host[i], -1, 0)  # (C, D, H, W)
            out_fn = _prediction_filename(prediction_dir, batch["source_filename"][i])
            Volume(data=item_pred, affine=np.asarray(batch["affine"][i])).to_filename(out_fn)
            written.append(out_fn)
    return written

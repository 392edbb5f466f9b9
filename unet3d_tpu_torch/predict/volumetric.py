"""Whole-volume prediction: forward -> activation -> resample-to-native -> NIfTI.

Counterpart of ``unet3d_tpu/predict/volumetric.py``: a no-grad loop over a
loader's batches, an optional inferer (sliding window), an activation, an
optional resample back to the source file's grid on the prediction's device,
and one NIfTI per case named after its source file.

Each written case is logged at INFO with the seconds spent waiting for its
batch (reading and preprocessing, when the loader runs in the caller's
thread), in the forward and activation, in the resample and in the write (a
batch's load and forward split evenly over its cases); the record carries
them as a dict in its ``case_seconds`` attribute.
"""
from __future__ import annotations

import copy
import inspect
import logging
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from unet3d_tpu_torch.data.image import Volume
from unet3d_tpu_torch.data.io import load_image
from unet3d_tpu_torch.ops.resample import resample_to_img
from unet3d_tpu_torch.utils.validation import validate_batch_item

logger = logging.getLogger(__name__)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) host layout -> contiguous (B, D, H, W, C)."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def inference_net(model: torch.nn.Module, amp: bool = False) -> torch.nn.Module:
    """The model in eval mode, under ``amp`` a bf16 copy of it (the f32
    master stays as it is)."""
    net = copy.deepcopy(model).to(torch.bfloat16) if amp else model
    return net.eval()


def make_forward(model: torch.nn.Module, amp: bool = False,
                 use_test: bool = False, mesh=None) -> Callable:
    """Inference forward over NDHWC inputs.

    ``amp`` runs it in bfloat16 and returns f32: the parameters are cast to
    bf16 once, here, on a copy of the model (the f32 master stays as it is),
    and each input is cast per call. ``use_test`` passes ``test=True`` to a
    forward that takes it (AutoImplantUNet's raw output). A tuple output (the
    VAE family's ``(out, mu, logvar)``) gives its first element. With a
    ``mesh`` that has a space axis, each call runs on this rank's D slab and
    returns the gathered output, or runs whole where the axis does not
    divide the input's D (the JAX version's ``mesh=`` dispatch;
    ``parallel/mesh.space_forward``)."""
    net = inference_net(model, amp)
    kwargs = ({"test": True} if use_test
              and "test" in inspect.signature(net.forward).parameters else {})

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            out = net(x.to(torch.bfloat16) if amp else x, **kwargs)
            if isinstance(out, tuple):
                out = out[0]
            return out.float() if amp else out

    if mesh is not None and mesh.space > 1:
        from unet3d_tpu_torch.parallel.mesh import check_space_form, space_forward
        check_space_form(model, mesh.space)
        return space_forward(forward, mesh)
    return forward


def _standardize(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.standardize`` over the last axis: variance as E[x^2] - E[x]^2
    clipped at 0, eps 1e-5."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0)
    return (x - mean) * torch.rsqrt(var + 1e-5)


# The names the JAX version resolves, ``jax.numpy`` first, then ``jax.nn``,
# with their defaults: the channel (last) axis for softmax, log_softmax, glu
# and standardize; gelu's tanh approximation; leaky_relu's slope 0.01.
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    # jax.numpy, elementwise
    "abs": torch.abs, "absolute": torch.abs, "negative": torch.neg,
    "sign": torch.sign, "square": torch.square, "sqrt": torch.sqrt,
    "cbrt": lambda x: torch.sign(x) * x.abs().pow(1.0 / 3.0),
    "reciprocal": torch.reciprocal, "exp": torch.exp, "exp2": torch.exp2,
    "expm1": torch.expm1, "log": torch.log, "log1p": torch.log1p, "log2": torch.log2,
    "log10": torch.log10, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arctan": torch.arctan, "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.arcsinh, "floor": torch.floor, "ceil": torch.ceil,
    "trunc": torch.trunc,
    # jax.nn
    "sigmoid": torch.sigmoid, "relu": torch.relu, "relu6": F.relu6,
    "softplus": F.softplus, "soft_sign": F.softsign, "silu": F.silu, "swish": F.silu,
    "log_sigmoid": F.logsigmoid, "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "hard_sigmoid": F.hardsigmoid, "hard_silu": F.hardswish, "hard_swish": F.hardswish,
    "hard_tanh": F.hardtanh, "elu": F.elu, "celu": F.celu, "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"), "glu": lambda x: F.glu(x, dim=-1),
    "mish": F.mish, "squareplus": lambda x: (x + torch.sqrt(x * x + 4.0)) / 2,
    "sparse_plus": lambda x: torch.where(
        x <= -1, torch.zeros_like(x), torch.where(x >= 1, x, (x + 1) ** 2 / 4)),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "standardize": _standardize,
}


def apply_activation(pred: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    """None, or a name of ``ACTIVATIONS``: the ``jax.numpy`` / ``jax.nn``
    names the JAX version takes, with its semantics. Any other name, torch's
    own spellings (``logsigmoid``, ``softsign``, ``hardtanh``) included,
    raises ``ValueError`` as the JAX version does for a name it lacks."""
    if activation is None:
        return pred
    fn = ACTIVATIONS.get(activation)
    if fn is None:
        raise ValueError(f"Unknown activation {activation}")
    return fn(pred)


def _prediction_filename(prediction_dir: str, source) -> str:
    src = source[0] if isinstance(source, (list, tuple)) else source
    basename = os.path.basename(str(src))
    for ext in (".nii.gz", ".nii"):
        if basename.endswith(ext):
            basename = basename[: -len(ext)]
            break
    return os.path.join(prediction_dir, basename + ".nii.gz")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def volumetric_predictions(model: Optional[torch.nn.Module], dataloader,
                           prediction_dir: str,
                           activation: Optional[str] = None,
                           resample: bool = False,
                           inferer: Optional[Callable] = None,
                           amp: bool = False,
                           interpolation: str = "trilinear", mesh=None,
                           forward: Optional[Callable] = None) -> List[str]:
    """Predict every case of ``dataloader`` on the model's device and write
    one NIfTI each; returns the filenames.

    With a data-parallel ``mesh`` of R ranks, rank r predicts and writes
    the cases r, r + R, ... of the loader (``DataLoader.rank_cases``); the
    ranks' files together are the single-device run's. On a space axis the
    ranks of a space line take the same cases and each forward (each of the
    inferer's windows) runs on their D slabs of it, the output gathered
    (``make_forward``'s ``mesh``); the line's rank 0 writes, and the others
    return no file names.

    Batches are dicts with ``image`` (B, C, D, H, W), ``affine`` (B, 4, 4) and
    ``source_filename``; ``amp`` runs the forward in bf16. ``resample`` maps
    each prediction back onto its source file's grid (``interpolation``)
    before it is written, with the source's affine.

    ``forward`` overrides ``model`` with a prebuilt NDHWC callable that has
    a ``device`` attribute, the inputs' device (the serving path passes an
    exported artifact's ``ExportedModel.ndhwc_forward()``, ``predict/export.py``);
    ``model`` may then be None, and ``amp`` is the artifact's own."""
    os.makedirs(prediction_dir, exist_ok=True)
    if mesh is not None and mesh.size > 1:
        dataloader = dataloader.rank_cases(mesh.rank, mesh.size)
    writer = mesh is None or mesh.space_rank == 0
    if forward is None:
        forward = make_forward(model, amp=amp, mesh=mesh)
        device = next(model.parameters()).device
    else:
        device = forward.device
    written: List[str] = []
    batches = iter(dataloader)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            return written
        t1 = time.perf_counter()
        for key in ("image", "affine", "source_filename"):
            validate_batch_item(batch, key, context="volumetric prediction")
        x = to_ndhwc(torch.as_tensor(np.asarray(batch["image"])).to(device))
        pred = inferer(x, forward) if inferer is not None else forward(x)
        pred = apply_activation(pred.float(), activation)  # (B, D, H, W, C)
        _sync(device)
        t2 = time.perf_counter()
        n_items = pred.shape[0]
        for i in range(n_items if writer else 0):
            t3 = time.perf_counter()
            item_pred = pred[i].permute(3, 0, 1, 2)  # (C, D, H, W)
            affine = np.asarray(batch["affine"][i])
            source = batch["source_filename"][i]
            if resample:
                original = load_image(source, reorder=False)
                item_pred = resample_to_img(item_pred, affine, original.affine,
                                            original.spatial_shape, mode=interpolation)
                affine = original.affine
            item_host = item_pred.cpu().numpy()
            t4 = time.perf_counter()
            out_fn = _prediction_filename(prediction_dir, source)
            Volume(data=item_host, affine=affine).to_filename(out_fn)
            t5 = time.perf_counter()
            written.append(out_fn)
            case = os.path.basename(out_fn)
            seconds = {"read_preprocess": (t1 - t0) / n_items,
                       "forward": (t2 - t1) / n_items, "resample": t4 - t3,
                       "write": t5 - t4}
            logger.info("%s: %s", case,
                        ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items()),
                        extra={"case_seconds": dict(seconds, case=case)})


def infer_subject_id(filename, all_filenames=None) -> str:
    """Subject id from the path component that differs across cases, else
    the file's parent directory name."""
    fn = filename[0] if isinstance(filename, (list, tuple)) else filename
    parts = os.path.normpath(str(fn)).split(os.sep)
    if all_filenames and len(all_filenames) > 1:
        others = [os.path.normpath(str(f[0] if isinstance(f, (list, tuple)) else f))
                  .split(os.sep) for f in all_filenames]
        for i, part in enumerate(parts):
            values = {o[i] for o in others if len(o) > i}
            if len(values) > 1:
                return part
    return parts[-2] if len(parts) >= 2 else parts[-1]


def predictions_with_tta(model: Optional[torch.nn.Module], x_ndhwc: torch.Tensor,
                         inferer: Optional[Callable] = None,
                         flip_axes=((1,), (2,), (3,)), amp: bool = False,
                         forward: Optional[Callable] = None) -> torch.Tensor:
    """Test-time flip averaging: the prediction of ``x_ndhwc`` and of each
    flip along ``flip_axes`` (flipped back), averaged. ``forward`` (default
    ``make_forward(model, amp)``) runs the model, through ``inferer`` when
    one is given; pass one prebuilt when calling repeatedly."""
    if forward is None:
        forward = make_forward(model, amp=amp)
    run = (lambda z: inferer(z, forward)) if inferer is not None else forward
    out = run(x_ndhwc)
    n = 1
    for axes in flip_axes:
        out = out + torch.flip(run(torch.flip(x_ndhwc, dims=axes)), dims=axes)
        n += 1
    return out / n

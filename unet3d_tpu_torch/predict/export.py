"""Ahead-of-time export of a model's inference forward for serving.

Counterpart of ``unet3d_tpu/predict/export.py``. The forward (entry layout,
AMP cast, model, first element of a tuple output, f32 cast, activation) is
captured by ``torch.export`` and written as one file that a serving process
loads and runs WITHOUT the model code, the config or the checkpoint: only
torch and this package, whose kernels the artifact's graph calls.

- One file: a magic of its own (``U3DTEX01``; a JAX StableHLO artifact,
  ``U3DEXP01``, does not load here), a u64 header length, a JSON header
  (avals, platforms, entry layout, conv strategy, torch version, the
  caller's model config, activation and AMP flag) and the
  ``torch.export.save`` payload.
- The hand kernels are graph nodes: every 3x3x3 stride-1 conv is one
  ``unet3d_tpu_torch::conv3x3x3*`` or ``::winograd3x3x3*`` operator
  (``ops/conv3d_kernel.py``, ``ops/winograd_kernel.py``), so the loaded
  program launches the kernels on a CUDA device and runs their plain
  versions on the CPU. ``UNET3D_TPU_CONV`` at export time is frozen into
  the graph (the header's ``conv_strategy``), as in a JAX artifact.
- Dynamic batch by default (the example batch is 2, so the graph holds for
  any batch, 1 included); ``batch_size`` fixes it.
- ``platforms`` records the devices the artifact is meant for (``cpu``,
  ``cuda``); ``load_exported`` moves the program to its device, so one
  artifact runs on either.

The serving boundary is channel-first ``(B, C, D, H, W)`` float32 in and
out, or channel-last with ``entry_layout="ndhwc"``. An f32 artifact runs
under the port's f32 policy (``utils/device.full_f32``): the exported graph
holds the cuDNN and cuBLAS nodes but not the policy's scope, which
``ExportedModel.__call__`` enters around the whole program.
"""
from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

# importing the kernel modules registers the operators the graphs call
from unet3d_tpu_torch.ops import conv3d_kernel, winograd_kernel  # noqa: F401
from unet3d_tpu_torch.ops.conv3d import conv_strategy
from unet3d_tpu_torch.parallel import distributed
from unet3d_tpu_torch.predict.volumetric import (ACTIVATIONS, apply_activation,
                                                 inference_net, to_ndhwc)
from unet3d_tpu_torch.utils.device import as_tensor, full_f32, require_cuda

MAGIC = b"U3DTEX01"
JAX_MAGIC = b"U3DEXP01"  # unet3d_tpu's StableHLO container
FORMAT = "unet3d_tpu_torch.export"
VERSION = 1
ENTRY_LAYOUTS = ("ncdhw", "ndhwc")
PLATFORMS = ("cpu", "cuda")


class ServingForward(torch.nn.Module):
    """The exported forward: ``entry_layout`` in, the net (bf16 under
    ``amp``), the first element of a tuple output, f32, the activation,
    ``entry_layout`` out."""

    def __init__(self, net: torch.nn.Module, amp: bool, activation: Optional[str],
                 entry_layout: str):
        super().__init__()
        self.net, self.amp, self.activation = net, amp, activation
        self.ndhwc = entry_layout == "ndhwc"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.ndhwc else to_ndhwc(x)
        out = self.net(y.to(torch.bfloat16 if self.amp else torch.float32))
        if isinstance(out, tuple):  # the VAE family's (out, mu, logvar, ...)
            out = out[0]
        # f32 before the activation, as the predict path applies it
        out = apply_activation(out.float(), self.activation)
        return out if self.ndhwc else out.permute(0, 4, 1, 2, 3).contiguous()


@dataclasses.dataclass
class Exported:
    """An exported forward and what its header records."""
    program: torch.export.ExportedProgram
    in_avals: List[str]
    out_avals: List[str]
    platforms: List[str]
    entry_layout: str
    conv_strategy: Optional[str]
    activation: Optional[str]
    amp: bool


def _aval(value: torch.Tensor) -> str:
    """``float32[batch,4,128,128,128]``: a symbolic dim as ``batch``."""
    dims = ",".join(str(d) if isinstance(d, int) else "batch" for d in value.shape)
    return f"{str(value.dtype).replace('torch.', '')}[{dims}]"


def _platforms(platforms: Optional[Sequence[str]], device: torch.device) -> List[str]:
    names = [str(p) for p in platforms] if platforms is not None else [device.type]
    unknown = [p for p in names if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"platforms {unknown}: a torch artifact runs on {list(PLATFORMS)} "
                         "(a TPU artifact is the JAX package's unet3d-export)")
    return names


def export_forward(model: torch.nn.Module, input_shape: Sequence[int], *,
                   amp: bool = False, activation: Optional[str] = None,
                   batch_size: Optional[int] = None,
                   platforms: Optional[Sequence[str]] = None, mesh=None,
                   entry_layout: str = "ncdhw", device=None) -> Exported:
    """Export the inference forward of ``model`` as an ``Exported``.

    ``input_shape`` is ``(D, H, W, C_in)`` (the JAX package's convention); the
    program takes ``(B, C_in, D, H, W)`` float32, ``(B, D, H, W, C_in)`` with
    ``entry_layout="ndhwc"``. ``batch_size=None`` exports a dynamic batch.
    The graph is traced on ``device`` (default: the model's; a copy of the
    model is moved there when it differs), with fake tensors: nothing runs.
    ``platforms`` (default: ``device``'s type) is recorded in the header; a
    ``mesh``, or a run inside a data or space axis above 1, raises
    ``NotImplementedError``: a multi-device artifact is not ported yet
    (ROADMAP.md)."""
    if entry_layout not in ENTRY_LAYOUTS:
        raise ValueError(f"entry_layout must be 'ncdhw' or 'ndhwc', got {entry_layout!r}")
    if activation is not None and activation not in ACTIVATIONS:
        raise ValueError(f"Unknown activation {activation}")
    if mesh is not None or distributed.space_size() > 1 or distributed.data_size() > 1:
        raise NotImplementedError(
            "a multi-device (mesh) artifact is not ported to unet3d_tpu_torch yet (see "
            "ROADMAP.md): export on one device")
    model_device = next(model.parameters()).device
    device = torch.device(device) if device is not None else model_device
    platforms = _platforms(platforms, device)
    if device != model_device:
        model = copy.deepcopy(model).to(device)
    forward = ServingForward(inference_net(model, amp), amp, activation, entry_layout)
    d, h, w, c_in = (int(s) for s in input_shape)
    example_batch = 2 if batch_size is None else int(batch_size)  # 0 and 1 specialise
    shape = ((example_batch, d, h, w, c_in) if entry_layout == "ndhwc"
             else (example_batch, c_in, d, h, w))
    dynamic = None if batch_size is not None else ({0: torch.export.Dim("batch")},)
    with torch.no_grad():
        program = torch.export.export(forward, (torch.zeros(shape, device=device),),
                                      dynamic_shapes=dynamic)
    program.example_inputs = None  # a batch of zeros: not worth saving
    (outputs,) = [n.args[0] for n in program.graph.nodes if n.op == "output"]
    return Exported(program, [_aval(_user_input(program))],
                    [_aval(n.meta["val"]) for n in outputs], platforms, entry_layout,
                    conv_strategy(), activation, bool(amp))


def _user_input(program: torch.export.ExportedProgram) -> torch.Tensor:
    """The (fake) tensor the program was traced with as its input."""
    (value,) = [n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"
                and n.name in program.graph_signature.user_inputs]
    return value


def save_exported(exported: Exported, path: str,
                  metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write the single-file container: magic | u64 header length | JSON
    header | ``torch.export.save`` payload, through a temporary file that
    replaces ``path``. Returns the header written (``metadata`` last, so the
    caller's keys win)."""
    payload = io.BytesIO()
    torch.export.save(exported.program, payload)
    header = {"format": FORMAT, "version": VERSION, "in_avals": exported.in_avals,
              "out_avals": exported.out_avals, "platforms": exported.platforms,
              "nr_devices": 1, "entry_layout": exported.entry_layout,
              "conv_strategy": exported.conv_strategy, "activation": exported.activation,
              "amp": exported.amp, "torch": torch.__version__, **(metadata or {})}
    blob = json.dumps(header, sort_keys=True).encode()
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        f.write(payload.getbuffer())
    os.replace(tmp, path)
    return header


class ExportedModel:
    """A loaded artifact on ``device``: ``__call__`` takes a numpy array or a
    tensor in the entry layout and returns an f32 tensor on ``device``."""

    def __init__(self, program: torch.export.ExportedProgram, metadata: Dict[str, Any],
                 device: torch.device):
        self.program, self.metadata, self.device = program, metadata, device
        self._module = program.module()
        # the input shape, None for a symbolic dim
        self._dims = tuple(d if isinstance(d, int) else None
                           for d in _user_input(program).shape)

    def __call__(self, x) -> torch.Tensor:
        x = as_tensor(x)
        if x.is_complex() or x.dtype == torch.bool:
            raise TypeError(f"input of dtype {x.dtype}: the artifact takes real float32")
        if x.dim() != len(self._dims) or any(
                d is not None and d != n for d, n in zip(self._dims, x.shape)):
            raise ValueError(f"input of shape {tuple(x.shape)}: the artifact takes "
                             f"{self.metadata.get('in_avals')}")
        x = x.to(self.device, torch.float32)
        with torch.no_grad(), full_f32(x):
            return self._module(x)

    def ndhwc_forward(self) -> Callable:
        """The ``make_forward`` convention (NDHWC in and out, ``device``
        the artifact's), for ``volumetric_predictions`` and the inferers: the
        artifact itself for an ``ndhwc`` entry layout, else an adapter whose
        NCDHW view of the input the program's own move to NDHWC copies
        nothing for."""
        if self.metadata.get("entry_layout") == "ndhwc":
            return self

        def forward(x_ndhwc: torch.Tensor) -> torch.Tensor:
            return to_ndhwc(self(x_ndhwc.permute(0, 4, 1, 2, 3)))

        forward.device = self.device
        return forward


def load_exported(path: str, device=None) -> ExportedModel:
    """Load a container written by ``save_exported`` onto ``device``: the
    first CUDA GPU by default (``require_cuda``, which raises without one),
    the CPU only when asked. A JAX artifact and any other file raise
    ``ValueError``."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(f"{path} is a JAX StableHLO artifact (unet3d-export); export it "
                             "again with unet3d-torch-export")
        if magic != MAGIC:
            raise ValueError(f"{path} is not a unet3d_tpu_torch export artifact "
                             f"(bad magic {magic!r})")
        (length,) = struct.unpack("<Q", f.read(8))
        metadata = json.loads(f.read(length).decode())
        payload = f.read()
    if metadata.get("format") != FORMAT or metadata.get("version", 0) > VERSION:
        raise ValueError(f"{path}: format {metadata.get('format')!r} version "
                         f"{metadata.get('version')!r}, this package reads {FORMAT!r} up to "
                         f"version {VERSION}")
    device = torch.device(device) if device is not None else require_cuda()
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(torch.export.load(io.BytesIO(payload)), device)
    return ExportedModel(program, metadata, device)

"""Data-parallel training and evaluation over the processes' data axis
(counterpart of the ``data`` axis of ``unet3d_tpu/parallel/mesh.py``).

JAX lays a ``Mesh`` over the devices of one process and lets XLA SPMD run
the single-device step on the global batch, sharded. Here each GPU is a
process (``parallel/launch.py``) that holds a replica of the model and
takes its share of each global batch; the step keeps the JAX step's
function with two invariants:

- the mean over ranks of each rank's loss is the global batch's loss;
- the mean over ranks of each rank's gradients is the global gradient.

A per-item mean loss keeps both as it is. The places that reduce over the
batch axis keep them inside ``distributed.data_parallel``: BatchNorm sums
its statistics over the data axis (SyncBN, as Flax under SPMD), the
criteria that couple items sum their batch sums, a ``reduction="sum"``
criterion scales its share by the axis's size, and VQVAE's codebook sums
its counts. After the last microbatch's backward one all-reduce averages
the f32 gradients and the loss, in the parameters' order; every rank then
takes the same optimizer update. (DDP is not used: it wraps the module's
own forward, and the AMP step runs ``functional_call`` on bf16 copies of
the parameters, under remat's checkpoints too.)

Gradient accumulation splits the global batch into ``grad_accum``
contiguous microbatches and shards each over the data axis, as JAX's scan
does: rank r's share of microbatch m is the global items ``[m B/M + r
B/(M R), m B/M + (r + 1) B/(M R))`` (``local_items``). The train CLI
refuses a batch size that R x M does not divide. A batch that does not
divide all the same (an epoch's ragged last one) runs whole on every rank
and every rank keeps rank 0's gradients: one draw of the noise, as on one
device (JAX evaluates such a batch unsharded; its sharded train step
refuses one).

Only the ``data`` axis is ported: a ``space`` or ``model`` axis above 1
raises (see ROADMAP.md).
"""
from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import distributed as tdist

from unet3d_tpu_torch.parallel import distributed
from unet3d_tpu_torch.train.step import (accumulate_gradients, make_eval_step,
                                         noise_generator, prepare_batch)

MESH_AXES = ("data", "space", "model")


def parse_mesh_spec(spec) -> Dict[str, int]:
    """Normalize a user-facing mesh spec into ``{axis: size}``.

    Accepted forms (the machine-config ``"mesh"`` key and the ``--mesh`` CLI
    flag): a dict ``{"data": 2, "space": 4}`` or a string ``"data2,space4"``
    / ``"data=2,space=4"`` / ``"data:2"``. Axes come from ``data``,
    ``space`` and ``model``; sizes are positive ints; the order is kept."""
    if isinstance(spec, str):
        parsed = {}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            m = re.fullmatch(r"([a-zA-Z_]+)\s*[:=]?\s*(\d+)", part)
            if not m:
                raise ValueError(
                    f"Unparseable mesh axis {part!r} in mesh spec {spec!r}; "
                    "expected e.g. 'data2,space4'")
            parsed[m.group(1)] = int(m.group(2))
        spec = parsed
    if not isinstance(spec, dict) or not spec:
        raise ValueError(f"Mesh spec must be a non-empty dict or string, got {spec!r}")
    out = {}
    for axis, size in spec.items():
        if axis not in MESH_AXES:
            raise ValueError(f"Unknown mesh axis {axis!r}; supported: {MESH_AXES}")
        size = int(size)
        if size < 1:
            raise ValueError(f"Mesh axis {axis!r} needs a positive size, got {size}")
        out[str(axis)] = size
    return out


def refuse_unported_axes(spec: Dict[str, int]) -> None:
    """A ``space`` or ``model`` axis above 1 raises ``NotImplementedError``."""
    unported = {a: n for a, n in spec.items() if a != "data" and n > 1}
    if unported:
        raise NotImplementedError(
            f"mesh axes {unported} are not ported yet: the port shards the batch "
            "over the 'data' axis only (see ROADMAP.md)")


@dataclass(frozen=True)
class Mesh:
    """The port's mesh: the axis sizes in JAX's names (``{"data": R}``),
    this process's index on the data axis, and the axis's process group
    (None at one rank without a process group: every collective is then
    skipped)."""

    shape: Dict[str, int]
    rank: int
    group: Any = None

    @property
    def size(self) -> int:
        return self.shape.get("data", 1)


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh over the process group's ranks. Default: every rank on the
    ``data`` axis. The data axis must be the world size (one process per
    device); a ``space`` or ``model`` axis above 1 raises."""
    world = distributed.world_size()
    spec = parse_mesh_spec(axis_sizes) if axis_sizes is not None else {"data": world}
    refuse_unported_axes(spec)
    if spec.get("data", 1) != world:
        raise ValueError(f"Mesh needs {spec.get('data', 1)} devices, have {world}")
    group = tdist.group.WORLD if distributed.is_initialized() else None
    return Mesh(dict(spec), distributed.process_index(), group)


def local_items(n: int, mesh: Mesh, microbatches: int = 1) -> Optional[np.ndarray]:
    """Positions, in a global batch of ``n`` items, of this rank's share in
    the microbatch layout (see the module docstring); None when the data
    axis times ``microbatches`` does not divide ``n`` (the batch runs whole
    on every rank)."""
    per_micro = mesh.size * microbatches
    if n % per_micro:
        return None
    m, k = n // microbatches, n // per_micro
    return np.concatenate([np.arange(i * m + mesh.rank * k, i * m + (mesh.rank + 1) * k)
                           for i in range(microbatches)])


def shard_batch(batch, mesh: Mesh, microbatches: int = 1):
    """This rank's share of a host batch (numpy or tensor, the batch on
    axis 0, any rank: images and labels of every rank shard alike), or the
    batch as it is when it does not divide. A contiguous share (one
    microbatch) is a view, not a copy."""
    idx = local_items(len(batch), mesh, microbatches)
    if idx is None:
        return batch
    if np.array_equal(idx, np.arange(idx[0], idx[0] + len(idx))):
        return batch[idx[0]:idx[0] + len(idx)]
    if isinstance(batch, torch.Tensor):
        return batch[torch.as_tensor(idx, device=batch.device)]
    return np.asarray(batch)[idx]


def replicate_state(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer broadcast from rank 0 (the replicas start
    equal whatever each rank loaded)."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                tdist.broadcast(t.data, src=0, group=mesh.group)
    return model


def average_gradients(model: torch.nn.Module, loss: torch.Tensor, mesh: Mesh,
                      whole: bool = False) -> torch.Tensor:
    """One all-reduce of every parameter's gradient and the loss, in the
    parameters' order, divided by the data axis's size: the gradients and
    the loss of the global batch on every rank (returned: the loss). With
    ``whole`` (every rank ran the whole batch) one broadcast of rank 0's
    instead, so that each rank's own noise draws do not enter."""
    if mesh.group is None:
        return loss
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    dtype = grads[0].dtype if grads else loss.dtype
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads]
                     + [loss.detach().reshape(1).to(dtype)])
    if whole:
        tdist.broadcast(flat, src=0, group=mesh.group)
    else:
        tdist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1].to(loss.dtype)


def sharded_gradients(model: torch.nn.Module, criterion: Callable, x: torch.Tensor,
                      y: torch.Tensor, mesh: Mesh, amp: bool, grad_accum: int = 1,
                      rng: Optional[torch.Generator] = None, whole: bool = False):
    """The global batch's gradients in the parameters' ``.grad`` and its
    loss, from this rank's share ``x``, ``y`` (the whole batch with
    ``whole``, which then runs without the data axis's sums and keeps rank
    0's gradients)."""
    with distributed.data_parallel(None if whole else mesh):
        loss = accumulate_gradients(model, criterion, x, y, amp, grad_accum, rng)
    return average_gradients(model, loss, mesh, whole)


def rank_seed(seed: int, rank: int) -> int:
    """The noise seed of rank ``rank`` (rank 0 the single device's): each
    rank draws its own dropout masks and samples for its own items."""
    return seed + 1_000_003 * rank


def make_sharded_train_step(model: torch.nn.Module, criterion: Callable,
                            optimizer: torch.optim.Optimizer, mesh: Mesh,
                            amp: bool = False, grad_accum: int = 1,
                            seed: int = 0) -> Callable:
    """``step(images, labels, whole=False) -> loss``: this rank's share of a
    global batch (``shard_batch``'s, in the microbatch layout; the whole
    batch with ``whole``) through the forwards and backwards, the gradients
    and loss averaged over the data axis, one optimizer update; the loss
    returned is the global batch's. The first whole batch is logged: its
    work is repeated on every rank."""
    device = next(model.parameters()).device
    rng = noise_generator(model, rank_seed(seed, mesh.rank))
    logged = []

    def step(images, labels, whole: bool = False) -> torch.Tensor:
        if whole and mesh.size > 1 and not logged:
            logged.append(True)
            logging.warning("a training batch of %d items, which %d ranks x %d "
                            "microbatches do not divide, runs whole on every rank",
                            len(images), mesh.size, grad_accum)
        x, y = prepare_batch(images, labels, device, amp)
        optimizer.zero_grad(set_to_none=True)
        loss = sharded_gradients(model, criterion, x, y, mesh, amp, grad_accum, rng, whole)
        optimizer.step()
        return loss

    return step


def mean_loss(loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of every rank's ``loss``."""
    if mesh.group is None:
        return loss
    total = loss.detach().clone()
    tdist.all_reduce(total, group=mesh.group)
    return total / mesh.size


def make_sharded_eval_step(model: torch.nn.Module, criterion: Callable, mesh: Mesh,
                           inferer: Optional[Callable] = None,
                           amp: bool = False) -> Callable:
    """``step(images, labels, whole=False) -> loss``: ``make_eval_step`` on
    this rank's share, the criterion's batch sums over the data axis, and
    the global batch's loss on every rank (a batch the data axis does not
    divide is evaluated whole on every rank, as JAX's CLI falls back to the
    unsharded eval step)."""
    plain = make_eval_step(model, criterion, inferer=inferer, amp=amp)

    def step(images, labels, whole: bool = False) -> torch.Tensor:
        with distributed.data_parallel(None if whole else mesh):
            loss = plain(images, labels)
        return mean_loss(loss, mesh)

    return step

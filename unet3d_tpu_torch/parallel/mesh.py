"""Data- and space-parallel training, evaluation and prediction over the
processes' (data, space) grid (counterpart of ``unet3d_tpu/parallel/mesh.py``).

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

The ``space`` axis splits each volume's D planes into contiguous slabs,
one per rank of the axis, as JAX's ``make_sharded_forward`` /
``make_sharded_train_step`` shard D. World rank r sits at the row-major
coordinates of r over the spec's axes, in the spec's order (JAX reshapes
its devices by the axis sizes), and each axis has a process group per line
of the grid. Every rank of a space line takes the same items (the data
axis's share, with the same noise); the steps and the forward take them
whole, cut this rank's slab of D (``space_forward``), run the model inside
``distributed.space_parallel`` and gather the output on D before the
criterion, so every criterion runs as on one device; a batch whose D the
axis does not divide runs whole on every rank of the line, as JAX's
dispatch runs it unsharded. Inside, a level of the net is D-sharded where
its D divides by the axis, else replicated (JAX's ``activation_spec``;
``level_sharded``). The nets whose class sets ``SPACE_AXIS`` have that
form (``space_form_nets``: DynUNet, the Myronenko U-Nets and autoencoders,
SegResNet and SegResNetVAE, SegResNetDS, AttentionUnet and MONAI's UNet);
any other net on a space axis above 1 raises (see ROADMAP.md). The
gradients of every rank of the mesh are averaged
once: each rank's is its share times the space axis's size
(``parallel/distributed.py``). A ``model`` axis above 1 raises.
"""
from __future__ import annotations

import functools
import logging
import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import distributed as tdist

from unet3d_tpu_torch.parallel import distributed
from unet3d_tpu_torch.parallel.distributed import level_sharded
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
    """A ``model`` axis above 1 raises ``NotImplementedError``."""
    if spec.get("model", 1) > 1:
        raise NotImplementedError(
            f"mesh axis 'model' ({spec['model']}) is not ported yet: the port shards "
            "the 'data' and 'space' axes only (see ROADMAP.md)")


@dataclass(frozen=True)
class Mesh:
    """The port's mesh: the axis sizes in JAX's names (``{"data": R,
    "space": S}``), this process's index on the data axis and the data
    axis's process group, its index on the space axis and that axis's
    group, and the group of every rank of the mesh (the groups None at one
    rank without a process group, and an axis's None where it is 1 beside
    another axis: every collective of it is then skipped)."""

    shape: Dict[str, int]
    rank: int
    group: Any = None
    space_rank: int = 0
    space_group: Any = None
    world_group: Any = None

    @property
    def size(self) -> int:
        """The data axis's size."""
        return self.shape.get("data", 1)

    @property
    def space(self) -> int:
        """The space axis's size."""
        return self.shape.get("space", 1)

    @property
    def world(self) -> int:
        return self.size * self.space


def grid_coordinates(spec: Dict[str, int], rank: int) -> Dict[str, int]:
    """World rank ``rank``'s coordinates on the grid of ``spec``: row-major
    over the axes in the spec's order, as JAX's ``make_mesh`` reshapes the
    devices by the axis sizes."""
    return dict(zip(spec, (int(c) for c in np.unravel_index(rank, tuple(spec.values())))))


def _axis_group(spec: Dict[str, int], axis: str, rank: int):
    """This rank's process group along ``axis``: every line of the grid
    along it is made, in order, on every rank."""
    names = list(spec)
    grid = np.arange(math.prod(spec.values())).reshape(tuple(spec.values()))
    lines = np.moveaxis(grid, names.index(axis), -1).reshape(-1, spec[axis])
    mine = None
    for line in lines:
        group = distributed.group_of(line)
        if rank in line:
            mine = group
    return mine


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh over the process group's ranks. Default: every rank on the
    ``data`` axis. The axes' sizes must multiply to the world size (one
    process per device); a ``model`` axis above 1 raises."""
    world = distributed.world_size()
    spec = parse_mesh_spec(axis_sizes) if axis_sizes is not None else {"data": world}
    refuse_unported_axes(spec)
    n = math.prod(spec.values())
    if n != world:
        raise ValueError(f"Mesh needs {n} devices, have {world}")
    rank = distributed.process_index()
    coords = grid_coordinates(spec, rank)
    data, space = spec.get("data", 1), spec.get("space", 1)
    if not distributed.is_initialized():
        return Mesh(dict(spec), coords.get("data", 0), None, coords.get("space", 0))
    world_group = tdist.group.WORLD
    if space == 1:  # the data axis is the world
        return Mesh(dict(spec), coords.get("data", 0), world_group, 0, None, world_group)
    data_group = _axis_group(spec, "data", rank) if data > 1 else None
    space_group = _axis_group(spec, "space", rank)
    return Mesh(dict(spec), coords.get("data", 0), data_group, coords["space"], space_group,
                world_group)


def has_space_form(model) -> bool:
    """Whether a net (a module or its class) runs on D slabs of the space
    axis: its class sets ``SPACE_AXIS``."""
    cls = model if isinstance(model, type) else type(model)
    return bool(getattr(cls, "SPACE_AXIS", False))


def space_form_nets() -> list:
    """The registry's names whose net has a space form."""
    from unet3d_tpu_torch.models.registry import MODEL_REGISTRY
    return sorted(name for name, cls in MODEL_REGISTRY.items() if has_space_form(cls))


def check_space_form(model, space: int) -> None:
    """A net (a module or its class) without a space form on a space axis
    of ``space`` > 1 ranks raises."""
    if space > 1 and not has_space_form(model):
        name = model.__name__ if isinstance(model, type) else type(model).__name__
        raise NotImplementedError(
            f"the 'space' mesh axis is not ported yet for {name}: the nets that run "
            f"D-sharded are {', '.join(space_form_nets())} (see ROADMAP.md)")


def gather_output(out, mesh: Mesh):
    """A net's output gathered on D (D the fourth axis from the last: the
    deep-supervision stack's third); each tensor of a tuple."""
    if isinstance(out, tuple):
        return tuple(gather_output(o, mesh) for o in out)
    if isinstance(out, torch.Tensor) and out.dim() >= 5:
        return distributed.gather_d(out, out.dim() - 4, mesh)
    return out


def space_forward(fn: Callable, mesh: Optional[Mesh]) -> Callable:
    """``fn`` (an NDHWC forward) over ``mesh``'s space axis: each call cuts
    this rank's D slab of its input, runs ``fn`` on it inside
    ``distributed.space_parallel`` and gathers the output on D, so every
    rank of the axis returns the whole output. An input whose D the axis
    does not divide runs whole (JAX's dispatch runs it unsharded); off a
    space axis, ``fn`` itself."""
    if mesh is None or mesh.space == 1 or mesh.space_group is None:
        return fn

    @functools.wraps(fn)
    def run(x, *args, **kwargs):
        if x.dim() != 5 or not level_sharded(mesh, x.shape[1]):
            return fn(x, *args, **kwargs)
        with distributed.space_parallel(mesh):
            out = fn(distributed.slice_d(x, 1, mesh), *args, **kwargs)
        return gather_output(out, mesh)

    return run


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
    microbatch) is a view, not a copy. The share is whole on D: on a space
    axis the sharded steps cut this rank's D slab themselves, per forward
    (``space_forward``), so the loader, the prefetcher and the criterion
    see whole volumes."""
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
    if mesh.world_group is not None:
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                tdist.broadcast(t.data, src=0, group=mesh.world_group)
    return model


def average_gradients(model: torch.nn.Module, loss: torch.Tensor, mesh: Mesh,
                      whole: bool = False) -> torch.Tensor:
    """One all-reduce of every parameter's gradient and the loss over every
    rank of the mesh, in the parameters' order, divided by their number:
    the gradients and the loss of the global batch on every rank (returned:
    the loss). With ``whole`` (every rank ran the whole batch) one broadcast
    of rank 0's instead, so that each rank's own noise draws do not
    enter."""
    if mesh.world_group is None:
        return loss
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    dtype = grads[0].dtype if grads else loss.dtype
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads]
                     + [loss.detach().reshape(1).to(dtype)])
    if whole:
        tdist.broadcast(flat, src=0, group=mesh.world_group)
    else:
        tdist.all_reduce(flat, group=mesh.world_group)
        flat /= mesh.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1].to(loss.dtype)


def sharded_gradients(model: torch.nn.Module, criterion: Callable, x: torch.Tensor,
                      y: torch.Tensor, mesh: Mesh, amp: bool, grad_accum: int = 1,
                      rng: Optional[torch.Generator] = None, whole: bool = False):
    """The global batch's gradients in the parameters' ``.grad`` and its
    loss, from this rank's share ``x``, ``y`` (whole on D: the forward runs
    on this rank's slab, ``space_forward``; the whole batch with ``whole``,
    which then runs without the axes' sums and keeps rank 0's
    gradients)."""
    wrap = None if whole else functools.partial(space_forward, mesh=mesh)
    with distributed.data_parallel(None if whole else mesh):
        loss = accumulate_gradients(model, criterion, x, y, amp, grad_accum, rng, wrap)
    return average_gradients(model, loss, mesh, whole)


def rank_seed(seed: int, rank: int) -> int:
    """The noise seed of data rank ``rank`` (rank 0 the single device's):
    each rank draws its own dropout masks and samples for its own items, and
    the ranks of one space line, which hold the same items, draw alike."""
    return seed + 1_000_003 * rank


def make_sharded_train_step(model: torch.nn.Module, criterion: Callable,
                            optimizer: torch.optim.Optimizer, mesh: Mesh,
                            amp: bool = False, grad_accum: int = 1,
                            seed: int = 0) -> Callable:
    """``step(images, labels, whole=False) -> loss``: this rank's share of a
    global batch (``shard_batch``'s, in the microbatch layout, whole on D;
    the whole batch with ``whole``) through the forwards and backwards (on
    this rank's D slab on a space axis), the gradients and loss averaged
    over the mesh, one optimizer update; the loss returned is the global
    batch's. The first whole batch is logged: its work is repeated on every
    rank."""
    check_space_form(model, mesh.space)
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
    if mesh.world_group is None:
        return loss
    total = loss.detach().clone()
    tdist.all_reduce(total, group=mesh.world_group)
    return total / mesh.world


def make_sharded_eval_step(model: torch.nn.Module, criterion: Callable, mesh: Mesh,
                           inferer: Optional[Callable] = None,
                           amp: bool = False) -> Callable:
    """``step(images, labels, whole=False) -> loss``: ``make_eval_step`` on
    this rank's share (each forward, each of the inferer's windows, on this
    rank's D slab on a space axis: ``space_forward``), the criterion's batch
    sums over the data axis, and the global batch's loss on every rank (a
    batch the data axis does not divide is evaluated whole on every rank,
    as JAX's CLI falls back to the unsharded eval step)."""
    check_space_form(model, mesh.space)
    sharded = make_eval_step(model, criterion, inferer=inferer, amp=amp,
                             forward_wrapper=functools.partial(space_forward, mesh=mesh))
    whole_batch = make_eval_step(model, criterion, inferer=inferer, amp=amp)

    def step(images, labels, whole: bool = False) -> torch.Tensor:
        with distributed.data_parallel(None if whole else mesh):
            loss = (whole_batch if whole else sharded)(images, labels)
        return mean_loss(loss, mesh)

    return step


def make_sharded_forward(model: torch.nn.Module, mesh: Mesh, amp: bool = False) -> Callable:
    """The inference forward (``predict/volumetric.make_forward``) with the
    input's D sharded over ``mesh``'s space axis: every rank of the axis
    passes the whole NDHWC input and gets the whole output (JAX's
    ``make_sharded_forward``, whose output stays sharded, and the ``mesh=``
    dispatch of its ``make_forward``: an input whose D the axis does not
    divide runs unsharded)."""
    from unet3d_tpu_torch.predict.volumetric import make_forward

    return make_forward(model, amp=amp, mesh=mesh)

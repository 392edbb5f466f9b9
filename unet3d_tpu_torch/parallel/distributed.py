"""Process-group set-up from the machine config, and the collectives of the
data and space axes (counterpart of ``unet3d_tpu/parallel/distributed.py``).

One process per GPU: the JAX CLI is one process over N devices, the port
starts N processes (``parallel/launch.py``), each bound to its own device.
Machine-config keys (all optional; absent -> one node, no-op):

    {
      "coordinator_address": "10.0.0.1:8476",   # node 0's rendezvous
      "n_nodes": 4,                              # number of nodes
      "node_rank": 2                             # this node
    }

Run the same command on every node; world size = nodes x GPUs per node.
Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` in the
environment) each process is already one rank and joins with ``env://``.

The data axis's collectives are ``all_reduce`` and ``broadcast`` only, so
the same code runs on NCCL and on gloo (which runs both on CUDA tensors as
well). Inside ``data_parallel(mesh)`` (the sharded steps of
``parallel/mesh.py``) the places that reduce over the batch axis (BatchNorm's
statistics, the criteria that couple items, VQVAE's codebook sums) sum over
the data axis with ``sum_over_data``; outside it, and without a process
group, every helper here is the identity, so the single-device path runs as
it did.

The space axis splits one volume's D planes over its ranks: inside
``space_parallel(mesh)`` the model's NDHWC activations are slabs of
contiguous D planes (rank s of S holds planes [s D/S, (s + 1) D/S)), and the
ops that reach across D (``ops/conv3d``'s halo exchanges, the instance and
group norms' statistics, the trilinear upsample) read ``space_size()``; a
level the model runs whole on every rank of the axis (its D does not divide
by S) runs inside ``replicated()``, where ``space_size()`` is 1 again.
Every cross-rank operation keeps the data axis's convention: each rank's
gradient is its share of the global one times the axis's size, so one mean
of the gradients over every rank of the mesh gives the single-device
gradient. ``sum_over_space`` sums its cotangents back (``_SumOverAxis``),
``gather_d`` reduce-scatters them, ``slice_d``'s adjoint pads with zeros,
and the halo's (``parallel/halo.py``) adds each neighbour plane's cotangent
to the plane it was copied from. The space axis's collectives are
``all_reduce`` only too; a gather or a halo exchange all-reduces the bytes
of a zero buffer that each rank fills in its own place, which is exact in
any dtype.
"""
from __future__ import annotations

import contextlib
import logging
import os
from datetime import timedelta
from typing import Iterator, List, Optional, Sequence

import torch
from torch import distributed as tdist

_INITIALIZED = False
_DEVICE: Optional[torch.device] = None  # this rank's device, set by the launcher
_ACTIVE = None  # the mesh of the sharded step that is running, else None
_SPACE = None  # the mesh whose space axis D-shards the running forward, else None
_REPLICATED = False  # inside a level every rank of the space axis holds whole
_GROUPS: dict = {}  # process groups by their ranks, made once per process group


def torchrun_env() -> Optional[tuple]:
    """(rank, world size, local rank) when ``torchrun`` started this process."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", 0)))


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(system_config: Optional[dict], local_rank: int = 0,
                                 local_size: int = 1, backend: Optional[str] = None,
                                 init_method: Optional[str] = None,
                                 timeout: Optional[float] = None) -> bool:
    """Join the process group the machine config, ``torchrun`` or the
    launcher (``init_method``, its file store) asks for; this process is
    rank ``node_rank * local_size + local_rank`` of ``n_nodes *
    local_size``. Returns True when a group was joined. A second call is a
    no-op, and a one-node config without an ``init_method`` is one;
    ``n_nodes`` without ``coordinator_address`` raises. ``backend`` defaults
    to NCCL when CUDA is there, else gloo; a failing init raises, with no
    fallback to another backend."""
    global _INITIALIZED
    config = system_config or {}
    address, n_nodes, node_rank = (config.get("coordinator_address"), config.get("n_nodes"),
                                   config.get("node_rank"))
    env = torchrun_env()
    if env is None and init_method is None and address is None and not n_nodes:
        return False
    if _INITIALIZED:
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend}
    if env is not None:
        kwargs["init_method"] = "env://"
    else:
        if init_method is None and address is None:
            raise ValueError(
                "machine config sets n_nodes but no coordinator_address; "
                "multi-node launch needs the address of node 0 (host:port)")
        nodes, node = int(n_nodes or 1), int(node_rank or 0)
        kwargs.update(init_method=init_method or f"tcp://{address}",
                      world_size=nodes * local_size, rank=node * local_size + local_rank)
    if timeout is not None:
        kwargs["timeout"] = timedelta(seconds=timeout)
    logging.info("Joining the process group: %s", kwargs)
    tdist.init_process_group(**kwargs)
    _INITIALIZED = True
    return True


def leave_process_group() -> None:
    """Destroy the process group this process joined (a later
    ``maybe_initialize_distributed`` joins anew)."""
    global _INITIALIZED
    if is_initialized():
        tdist.destroy_process_group()
    _INITIALIZED = False
    _GROUPS.clear()
    set_rank_device(None)


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group): the one writer of
    checkpoints and logs is rank 0."""
    return tdist.get_rank() if is_initialized() else 0


def is_primary_host() -> bool:
    return process_index() == 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def rank_device() -> Optional[torch.device]:
    """The device ``parallel/launch.py`` bound this rank to (under
    ``torchrun``: the GPU of ``LOCAL_RANK``)."""
    return _DEVICE


def set_rank_device(device: Optional[torch.device]) -> None:
    global _DEVICE
    _DEVICE = None if device is None else torch.device(device)


def _collective_device() -> torch.device:
    """Where a scalar collective's tensor lives: NCCL takes CUDA tensors
    only, gloo takes the host's."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Every rank waits here for every other (an all-reduce of one value);
    a no-op without a process group."""
    if is_initialized():
        tdist.all_reduce(torch.zeros(1, device=_collective_device()))


def broadcast_floats(values: Sequence[Optional[float]]) -> List[Optional[float]]:
    """Rank 0's ``values`` (floats or None) on every rank, so every rank
    takes the same decisions from them."""
    if not is_initialized():
        return list(values)
    t = torch.tensor([[0.0 if v is None else float(v), v is None] for v in values],
                     dtype=torch.float64, device=_collective_device())
    tdist.broadcast(t, src=0)
    return [None if missing else v for v, missing in t.tolist()]


def group_of(ranks: Sequence[int]):
    """The process group of ``ranks`` (the world's own group when they are
    all of them). Every rank must ask for every group, in the same order,
    as ``torch.distributed.new_group`` needs; a group is made once."""
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) == world_size():
        return tdist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = tdist.new_group(list(ranks))
    return _GROUPS[ranks]


@contextlib.contextmanager
def data_parallel(mesh) -> Iterator[None]:
    """Inside the block the batch-axis reductions sum over ``mesh``'s data
    axis (None, or a mesh without a process group: the block changes
    nothing)."""
    global _ACTIVE
    before = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.group is not None else None
    try:
        yield
    finally:
        _ACTIVE = before


def data_size() -> int:
    """The data axis's size while a sharded step runs, else 1."""
    return _ACTIVE.size if _ACTIVE is not None else 1


class _SumOverAxis(torch.autograd.Function):
    """All-reduce (sum) over an axis's group whose backward all-reduces
    (sums) the cotangents: each rank's gradient is then the axis's size
    times its share of the global one, and the mean over ranks is the
    global gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        tdist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        tdist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis while a sharded step runs (autograd
    sums the cotangents back), else ``x`` itself."""
    if _ACTIVE is None:
        return x
    return _SumOverAxis.apply(x, _ACTIVE.group)


def mean_over_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the data axis while a sharded step runs (the mean
    of equal shares' means is the global mean), else ``x`` itself."""
    if _ACTIVE is None:
        return x
    return sum_over_data(x) / _ACTIVE.size


@contextlib.contextmanager
def space_parallel(mesh) -> Iterator[None]:
    """Inside the block the model's activations are D slabs over ``mesh``'s
    space axis (None, a space axis of 1, or a mesh without a process group:
    the block changes nothing)."""
    global _SPACE, _REPLICATED
    before = _SPACE, _REPLICATED
    active = mesh is not None and mesh.space > 1 and mesh.space_group is not None
    _SPACE, _REPLICATED = (mesh if active else None), False
    try:
        yield
    finally:
        _SPACE, _REPLICATED = before


@contextlib.contextmanager
def replicated(on: bool = True) -> Iterator[None]:
    """With ``on``, inside the block every rank of the space axis holds its
    tensors whole: ``space_size()`` is 1 and the ops run as on one device."""
    global _REPLICATED
    before = _REPLICATED
    _REPLICATED = before or on
    try:
        yield
    finally:
        _REPLICATED = before


def space_state() -> tuple:
    """The space axis's state, for ``restored_space`` (remat's recompute
    runs a block in the state its forward ran in)."""
    return _SPACE, _REPLICATED


@contextlib.contextmanager
def restored_space(state: tuple) -> Iterator[None]:
    global _SPACE, _REPLICATED
    before = _SPACE, _REPLICATED
    _SPACE, _REPLICATED = state
    try:
        yield
    finally:
        _SPACE, _REPLICATED = before


def space_mesh():
    """The mesh whose space axis D-shards the tensors of the running op,
    else None."""
    return None if _REPLICATED else _SPACE


def space_size() -> int:
    """The number of D slabs the running op's tensors are cut into (1 off
    the space axis or in a replicated level)."""
    mesh = space_mesh()
    return mesh.space if mesh is not None else 1


def space_rank() -> int:
    mesh = space_mesh()
    return mesh.space_rank if mesh is not None else 0


def sum_over_space(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the space axis while the tensors are D slabs
    (autograd sums the cotangents back), else ``x`` itself."""
    mesh = space_mesh()
    if mesh is None:
        return x
    return _SumOverAxis.apply(x, mesh.space_group)


def exact_all_reduce(buf: torch.Tensor, group) -> torch.Tensor:
    """``buf`` summed over ``group`` where each element is non-zero on one
    rank at most: its bytes are summed, which is exact in any dtype (an
    all-gather through the one collective every backend takes on CUDA
    tensors)."""
    tdist.all_reduce(buf.view(torch.uint8), group=group)
    return buf


class _GatherD(torch.autograd.Function):
    """The slabs of the space axis joined along ``axis``; the backward sums
    the cotangents over the axis (in f32) and keeps this rank's slab: a
    reduce-scatter."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        depth = x.shape[axis]
        shape = list(x.shape)
        shape[axis] = depth * mesh.space
        buf = x.new_zeros(shape)
        buf.narrow(axis, mesh.space_rank * depth, depth).copy_(x)
        return exact_all_reduce(buf, mesh.space_group)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        total = grad.float().contiguous()
        tdist.all_reduce(total, group=mesh.space_group)
        depth = total.shape[ctx.axis] // mesh.space
        return (total.narrow(ctx.axis, mesh.space_rank * depth, depth)
                .to(grad.dtype).contiguous(), None, None)


def gather_d(x: torch.Tensor, axis: int = 1, mesh=None) -> torch.Tensor:
    """The whole volume from this rank's D slab ``x`` (D at ``axis``) on
    every rank of ``mesh``'s space axis (default: the running op's); ``x``
    itself off the axis."""
    mesh = mesh if mesh is not None else space_mesh()
    if mesh is None or mesh.space == 1 or mesh.space_group is None:
        return x
    return _GatherD.apply(x.contiguous(), axis, mesh)


def level_sharded(mesh, depth: int) -> bool:
    """JAX's ``activation_spec`` rule on D: an activation of global depth
    ``depth`` is sharded over ``mesh``'s space axis where the axis divides
    it, else replicated."""
    return mesh is not None and mesh.space > 1 and depth % mesh.space == 0


def level_layout(depths: Sequence[int]) -> Optional[List[bool]]:
    """Whether each of a net's levels, of global depths ``depths``, is
    D-sharded on the running space axis (``level_sharded``); None off the
    axis."""
    mesh = space_mesh()
    if mesh is None:
        return None
    return [level_sharded(mesh, d) for d in depths]


def at_level(sharded: Optional[bool], fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` in a level's layout: whole on every rank
    (``replicated``) where the space axis does not shard the level (None:
    off the axis, as it is)."""
    if sharded is None or sharded:
        return fn(*args, **kwargs)
    with replicated():
        return fn(*args, **kwargs)


def on_whole(fn, x: torch.Tensor, sharded: Optional[bool], *args, **kwargs):
    """``fn(x, ...)`` on the whole volume on every rank of the space axis
    (``replicated``): x gathered on D first where its level is sharded
    (None: off the axis, ``fn`` as it is). The result stays whole."""
    if sharded is None:
        return fn(x, *args, **kwargs)
    if sharded:
        x = gather_d(x, 1)
    with replicated():
        return fn(x, *args, **kwargs)


def between_levels(fn, x: torch.Tensor, sharded_in: Optional[bool],
                   sharded_out: Optional[bool], *args, **kwargs):
    """``fn(x, ...)`` from a level of one layout to a level of another: on
    the slabs where both are sharded, else whole (``on_whole``), the result
    cut to this rank's slab where the next level is sharded."""
    if sharded_in is None or (sharded_in and sharded_out):
        return fn(x, *args, **kwargs)
    mesh = space_mesh()
    y = on_whole(fn, x, sharded_in, *args, **kwargs)
    return slice_d(y, 1, mesh) if sharded_out else y


def slice_d(x: torch.Tensor, axis: int = 1, mesh=None) -> torch.Tensor:
    """This rank's D slab of the whole volume ``x`` (D at ``axis``, which
    the space axis divides); its adjoint pads the cotangent with zeros."""
    mesh = mesh if mesh is not None else space_mesh()
    if mesh is None or mesh.space == 1:
        return x
    depth = x.shape[axis] // mesh.space
    return x.narrow(axis, mesh.space_rank * depth, depth).contiguous()

"""Process-group set-up from the machine config, and the collectives of the
data axis (counterpart of ``unet3d_tpu/parallel/distributed.py``).

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


class _SumOverData(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces (sums) the cotangents:
    each rank's gradient is then the data axis's size times its share of
    the global one, and the mean over ranks is the global gradient."""

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
    return _SumOverData.apply(x, _ACTIVE.group)


def mean_over_data(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the data axis while a sharded step runs (the mean
    of equal shares' means is the global mean), else ``x`` itself."""
    if _ACTIVE is None:
        return x
    return sum_over_data(x) / _ACTIVE.size

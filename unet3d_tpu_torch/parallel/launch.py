"""Start the ranks of a data- or space-parallel run: one process per GPU.

The JAX CLIs are one process over N devices; ``--ngpus N`` here starts N
processes of the same command (``launch``), each bound to its own device
(``cuda:local_rank``; the CPU under ``device="cpu"``, the ranks then gloo
processes, as the tests run them). They join one process group through a
file store in a fresh temporary directory (a machine config's
``coordinator_address`` across nodes; ``torchrun``'s environment when it
started the processes, and then nothing is spawned). A rank that raises
fails the run: the others are stopped and the exception reaches the
caller, so the CLI exits non-zero.
"""
from __future__ import annotations

import logging
import math
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.multiprocessing as mp

from unet3d_tpu_torch.parallel import distributed
from unet3d_tpu_torch.parallel.mesh import parse_mesh_spec, refuse_unported_axes


@dataclass(frozen=True)
class Plan:
    """A parallel run: processes on this node, the mesh spec (JAX's axis
    names; ``{"data": world size}`` by default) and the machine config."""

    nprocs: int
    mesh: Dict[str, int]
    system_config: Dict[str, Any]


def plan(system_config: Optional[dict], device, default_axis: str = "data") -> Optional[Plan]:
    """The JAX CLIs' rule: ``n_gpus`` devices, raised to a ``mesh`` spec's
    device count (the product of its axes: data x space); None for one
    device without a process group to join (the single-device path). On
    CUDA the count is clamped to the visible GPUs, as JAX clamps to
    ``jax.devices()``, with a log line. Without a spec every rank lies on
    ``default_axis``. A ``model`` axis above 1 raises."""
    config = dict(system_config or {})
    n = int(config.get("n_gpus") or 1)
    spec = config.get("mesh")
    if spec is not None:
        spec = parse_mesh_spec(spec)
        refuse_unported_axes(spec)
        n = max(n, math.prod(spec.values()))
    env = distributed.torchrun_env()
    n_nodes = int(config.get("n_nodes") or 1)
    if env is not None:
        return Plan(1, spec or {default_axis: env[1]}, config)
    if n <= 1 and n_nodes <= 1:
        return None
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        if n > visible:
            if not distributed.is_initialized():  # said once, before the ranks start
                logging.warning("%d GPUs asked for, %d visible: running on %d", n, visible,
                                visible)
            n = visible
    return Plan(n, spec or {default_axis: n * n_nodes}, config)


def _threads(nprocs: int) -> int:
    """Torch threads for each CPU rank: one or two, so ranks do not fight
    over the cores."""
    return max(1, min(2, (os.cpu_count() or 1) // max(nprocs, 1)))


def _bind(device: torch.device, local_rank: int, nprocs: int = 0) -> torch.device:
    """The rank's device: ``cuda:local_rank`` for a bare ``cuda``, the
    device itself when it names one (ranks sharing a card); a spawned CPU
    rank (``nprocs`` of them) takes few threads."""
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif nprocs:
        torch.set_num_threads(_threads(nprocs))
    distributed.set_rank_device(device)
    return device


def _rank_main(local_rank: int, fn: Callable, args: tuple, nprocs: int, device: str,
               backend: str, init_method: Optional[str], system_config: dict,
               results, timeout: Optional[float]) -> None:
    _bind(torch.device(device), local_rank, nprocs)
    distributed.maybe_initialize_distributed(system_config, local_rank, nprocs, backend,
                                             init_method, timeout)
    try:
        results.put((local_rank, fn(*args)))
    except BaseException:
        # the caller raises the first rank to exit, which may be a peer whose
        # collective broke off: each rank's own error goes to stderr
        logging.exception("rank %d failed", distributed.process_index())
        raise
    finally:
        distributed.leave_process_group()


def _check_backend(device: torch.device, nprocs: int, backend: Optional[str]) -> str:
    backend = backend or distributed.default_backend(device)
    if backend == "nccl" and device.type == "cuda" and device.index is not None and nprocs > 1:
        raise ValueError(f"{nprocs} ranks on {device}: NCCL takes one rank per GPU; "
                         "ranks that share a GPU need backend='gloo'")
    return backend


def launch(fn: Callable, args: tuple, run_plan: Plan, device="cuda",
           backend: Optional[str] = None, timeout: Optional[float] = None) -> List[Any]:
    """``fn(*args)`` on each rank of this node; returns each local rank's
    return value, in rank order (they must pickle). Under ``torchrun``, and
    for one rank on one node, the rank is this process (its process group
    left again after ``fn``); otherwise ``run_plan.nprocs`` processes are
    spawned. ``device`` ``"cuda"`` binds rank i to ``cuda:i``; a device
    with an index is shared by every rank (gloo only)."""
    device = torch.device(device)
    nprocs, config = run_plan.nprocs, run_plan.system_config
    backend = _check_backend(device, nprocs, backend)
    tmp = tempfile.mkdtemp(prefix="unet3d_dist_")
    remote = config.get("coordinator_address") is not None
    init_method = None if remote else f"file://{os.path.join(tmp, 'store')}"
    try:
        if nprocs == 1 and (distributed.torchrun_env() is not None
                            or int(config.get("n_nodes") or 1) == 1):
            env = distributed.torchrun_env()
            _bind(device, env[2] if env else 0)
            distributed.maybe_initialize_distributed(config, 0, 1, backend, init_method,
                                                     timeout)
            try:
                return [fn(*args)]
            finally:
                distributed.leave_process_group()
        ctx = mp.get_context("spawn")
        results = ctx.SimpleQueue()
        procs = mp.start_processes(
            _rank_main, args=(fn, args, nprocs, str(device), backend, init_method, config,
                              results, timeout),
            nprocs=nprocs, join=False, start_method="spawn")
        out: Dict[int, Any] = {}
        # read while the ranks run: a result larger than the pipe's buffer
        # blocks its rank until it is read
        while not procs.join(timeout=0.2):
            while not results.empty():
                rank, value = results.get()
                out[rank] = value
        while not results.empty():
            rank, value = results.get()
            out[rank] = value
        return [out[r] for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def interleave(per_rank: List[List[Any]]) -> List[Any]:
    """Per-rank lists of cases dealt round-robin (case i to rank i mod R)
    back in the global order."""
    out = []
    for i in range(max((len(v) for v in per_rank), default=0)):
        out.extend(v[i] for v in per_rank if i < len(v))
    return out


"""The D-halo exchange of the space axis (``parallel/distributed.py``).

JAX gets its halos from XLA SPMD, which inserts them around each conv of a
D-sharded volume (``unet3d_tpu/parallel/mesh.py``). Here a conv, a stride-2
conv or a trilinear upsample that reaches one plane past its slab calls
``exchange_halo`` first and then runs on the slab with its neighbours'
planes around it (the kernels' D-halo mode, ``ops/conv3d_kernel.py``).

The exchange is one ``all_reduce`` of a zero buffer of 2 S planes into
which each rank writes its first and last plane (bytes summed:
``distributed.exact_all_reduce``), as every collective of the port's axes is
one that NCCL and gloo both take on CUDA tensors. Its adjoint sends each
neighbour plane's cotangent back the same way and adds it to the plane it
was copied from.
"""
from __future__ import annotations

from typing import Tuple

import torch

from unet3d_tpu_torch.parallel.distributed import exact_all_reduce, space_mesh


def _planes(x: torch.Tensor, size: int) -> torch.Tensor:
    """A zero (size, 2, N, 1, H, W, C) buffer of x's dtype: [r, 0] for rank
    r's first plane, [r, 1] for its last."""
    return x.new_zeros((size, 2) + tuple(x[:, :1].shape))


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo: bool, hi: bool, mesh):
        rank, size = mesh.space_rank, mesh.space
        buf = _planes(x, size)
        buf[rank, 0] = x[:, :1]
        buf[rank, 1] = x[:, -1:]
        exact_all_reduce(buf, mesh.space_group)
        ctx.got = (lo and rank > 0, hi and rank < size - 1)
        ctx.mesh = mesh
        parts = ([buf[rank - 1, 1]] if ctx.got[0] else []) + [x] + (
            [buf[rank + 1, 0]] if ctx.got[1] else [])
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        rank, size = mesh.space_rank, mesh.space
        got_lo, got_hi = ctx.got
        depth = grad.shape[1] - got_lo - got_hi
        dx = grad[:, int(got_lo):int(got_lo) + depth].clone()
        buf = _planes(grad, size)
        if got_lo:  # the cotangent of rank - 1's last plane
            buf[rank - 1, 1] = grad[:, :1]
        if got_hi:  # the cotangent of rank + 1's first plane
            buf[rank + 1, 0] = grad[:, -1:]
        exact_all_reduce(buf, mesh.space_group)
        dx[:, :1] += buf[rank, 0]
        dx[:, -1:] += buf[rank, 1]
        return dx, None, None, None


def exchange_halo(x: torch.Tensor, lo: int = 1,
                  hi: int = 1) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """This rank's NDHWC slab ``x`` with the plane below it (``lo``) and the
    plane above it (``hi``) from its neighbours on the running space axis,
    and the D pads ``(pad_lo, pad_hi)``: the planes asked for that a rank at
    the volume's edge does not receive (zero planes stand for them). Off the
    space axis, ``x`` itself and pads ``(lo, hi)``."""
    mesh = space_mesh()
    if mesh is None:
        return x, (lo, hi)
    rank, size = mesh.space_rank, mesh.space
    pads = (int(lo and rank == 0), int(hi and rank == size - 1))
    return _Halo.apply(x.contiguous(), bool(lo), bool(hi), mesh), pads

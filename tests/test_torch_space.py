"""The port's space axis (``unet3d_tpu_torch/parallel/``: the D-sharded
forward and train step, the halo exchange, the kernels' D-halo mode) against
the JAX package's ``space`` axis.

Four gloo ranks on the CPU, spawned once for the file (``Ranks``; the
functions they run are at the top of this file, which imports no JAX, so a
rank never loads it), lay out ``{"space": 4}`` and ``{"data": 2, "space":
2}`` and run ``parallel.mesh.make_sharded_forward`` and one SGD step (lr
0.1, DiceLoss) of ``make_sharded_train_step``; JAX runs its
``make_sharded_forward`` / ``make_sharded_train_step`` on the 8-device CPU
mesh ``tests/conftest.py`` forces, at ``{"data": 2, "space": 4}`` as its own
tests do (``tests/test_parallel.py``), and its single-device step, all in
f32 from the same variables. The nets are the JAX tests': the flagship
6-level DynUNet with filters (2, 4, 4, 8, 8, 8) at 32^3 (at space4 levels
0-3 are D-sharded, 4-5 replicated) and ``UNet3D(base_width=2,
encoder_blocks=[1, 1])`` at 16^3 (its level-0 channel dropout taken out of
both packages: the draws cannot be matched). Tolerances are the JAX tests':
the forward within 1e-4, the loss within relative 1e-4, every parameter
after the step within 1e-5.

The halo exchange is held as an adjoint pair at 2 and 3 ranks, and each
kernel's plain D-halo version (``ops/conv3d_kernel``, ``ops/s2_wgrad_kernel``,
``ops/winograd_kernel``) and each halo autograd Function of ``ops/conv3d``
against the SAME conv of the whole volume, sliced, at every ``(pad_lo,
pad_hi)``. Under ``UNET3D_TPU_CONV=winograd``, with the gate lowered inside
the ranks (``WINOGRAD_GATE``) so that the 32^3 DynUNet has Winograd sites at
levels 0-2 and their input gradients, the ranks' D-sharded forward and step
are held against the same JAX runs (JAX's direct conv: Winograd-DH in f32 is
the same function), and the input gradient's gate is held to JAX's, judged
on the whole volume. The ``cuda`` tests hold each halo mode's kernel against
its plain version at the DynUNet's shapes in bf16 and f32 on the card.
"""
import functools
import os
import queue
import shutil
import tempfile
import traceback
from unittest import mock

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models.layers import MyronenkoLayer
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d as C
from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
from unet3d_tpu_torch.ops import winograd_kernel as WK
from unet3d_tpu_torch.parallel import distributed, launch
from unet3d_tpu_torch.parallel.halo import exchange_halo
from unet3d_tpu_torch.parallel.mesh import (Mesh, grid_coordinates, make_mesh,
                                            make_sharded_forward, make_sharded_train_step,
                                            shard_batch)
from unet3d_tpu_torch.scripts import predict
from unet3d_tpu_torch.scripts import train as train_cli
from unet3d_tpu_torch.train import losses

RANKS = 4
LR = 0.1
FORWARD_ATOL = 1e-4
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
SLICE = 1e-5  # a halo version against the whole volume's conv, of its largest value
FILTERS = (2, 4, 4, 8, 8, 8)
DYNUNET = dict(in_channels=2, out_channels=2, spatial_dims=3,
               strides=[[1, 1, 1]] + [[2, 2, 2]] * 5, filters=list(FILTERS),
               kernel_size=[[3, 3, 3]] * 6, upsample_kernel_size=[[2, 2, 2]] * 5,
               deep_supervision=False)
UNET3D = dict(n_features=1, base_width=2, encoder_blocks=[1, 1], n_outputs=2)
NETS = {"DynUNet": (DYNUNET, 32, 2), "UNet3D": (UNET3D, 16, 1)}  # kwargs, size, channels
SPECS = ("space4", "data2,space2")
# the Winograd gate inside the ranks: >= 4 input channels at >= 8^3 voxels
# of the whole volume (the BraTS net's 96 at 64^3), so the 32^3 DynUNet's
# 4-channel convs at levels 0-2 (32^3: the up-block's conv1 on the 2 + 2
# concatenation; 16^3, 8^3: every conv) and their input gradients pass
WINOGRAD_GATE = (4, 8 ** 3)


# -- the ranks' side: no JAX here -------------------------------------------

def _serve(rank, init_method, jobs, results):
    torch.set_num_threads(1)
    distributed.maybe_initialize_distributed({}, rank, RANKS, "gloo", init_method, timeout=120)
    try:
        while True:
            job = jobs.get()
            if job is None:
                return
            fn, args = job
            try:
                results.put((rank, True, fn(*args)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.leave_process_group()


class Ranks:
    """``RANKS`` spawned CPU processes in one gloo process group; ``run(fn,
    *args)`` runs ``fn`` on each and returns the results in rank order."""

    def __init__(self):
        ctx = mp.get_context("spawn")
        self.tmp = tempfile.mkdtemp(prefix="unet3d_space_")
        init = f"file://{os.path.join(self.tmp, 'store')}"
        self.jobs = [ctx.SimpleQueue() for _ in range(RANKS)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, args=(r, init, self.jobs[r], self.results),
                                  daemon=True) for r in range(RANKS)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args):
        self.submit(fn, *args)
        return self.collect()

    def submit(self, fn, *args):
        """``fn(*args)`` on each rank, without waiting (``collect``)."""
        for q in self.jobs:
            q.put((fn, args))

    def collect(self):
        """The results of the job ``submit`` gave, in rank order."""
        out = {}
        while len(out) < RANKS:
            try:
                rank, ok, value = self.results.get(timeout=300)
            except queue.Empty:
                raise RuntimeError("a rank did not answer") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        return [out[r] for r in range(RANKS)]

    def close(self):
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self.tmp, ignore_errors=True)


def port_model(name, flat):
    """The port's net with ``flat``'s variables, its channel dropout off."""
    model = load_jax_variables(create_model(name, **NETS[name][0]), flat, strict=True)
    for m in model.modules():
        if isinstance(m, MyronenkoLayer):
            m.dropout = None
    return model


def port_space(name, flat, spec, x, images, labels):
    """The sharded forward of ``x`` and one sharded SGD step on ``mesh``:
    (forward, loss, the variables after the step, the mesh's shape and this
    rank's coordinates)."""
    mesh = make_mesh(spec)
    model = port_model(name, flat)
    forward = make_sharded_forward(model, mesh)(torch.from_numpy(x)).numpy()
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    step = make_sharded_train_step(model, losses.DiceLoss(sigmoid=True), opt, mesh)
    loss = step(shard_batch(images, mesh), shard_batch(labels, mesh))
    return (forward, float(loss), model_variables(model), dict(mesh.shape),
            (mesh.rank, mesh.space_rank))


def port_space_winograd(flat, spec, x, images, labels):
    """``port_space`` of DynUNet under UNET3D_TPU_CONV=winograd with the
    gate lowered to ``WINOGRAD_GATE``, and the Winograd calls it made:
    (variant, D pads, output planes) of each."""
    calls = []

    def spy(fn, variant):
        def call(x, w, pads=K.SAME):
            out = fn(x, w, pads)
            y = out if variant == "winograd" else out[0]
            calls.append((variant, tuple(pads), y.shape[1]))
            return out
        return call

    with mock.patch.dict(os.environ, {"UNET3D_TPU_CONV": "winograd"}), \
            mock.patch.object(WK, "_MIN_WINOGRAD_CHANNELS", WINOGRAD_GATE[0]), \
            mock.patch.object(WK, "_MIN_WINOGRAD_VOXELS", WINOGRAD_GATE[1]), \
            mock.patch.object(C, "winograd3x3x3", spy(C.winograd3x3x3, "winograd")), \
            mock.patch.object(C, "winograd3x3x3_with_stats",
                              spy(C.winograd3x3x3_with_stats, "winograd_stats")):
        return port_space("DynUNet", flat, spec, x, images, labels) + (calls,)


def port_options_step(spec, images, labels):
    """One SGD step of DynUNet with residual blocks, deep supervision (two
    heads) and remat, sharded on ``spec`` and on one device (the rank's own
    single-device step on the whole batch): (losses, variables after)."""
    from unet3d_tpu_torch.models.layers import init_parameters
    from unet3d_tpu_torch.models.remat import whole_model_remat
    from unet3d_tpu_torch.train.step import make_train_step

    out = []
    for sharded in (True, False):
        model = create_model("DynUNet", **dict(DYNUNET, res_block=True, deep_supervision=True,
                                               deep_supr_num=2))
        init_parameters(model, torch.Generator().manual_seed(3))
        whole_model_remat(model)
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        criterion = losses.DiceLoss(sigmoid=True)
        if sharded:
            mesh = make_mesh(spec)
            step = make_sharded_train_step(model, criterion, opt, mesh)
            loss = step(shard_batch(images, mesh), shard_batch(labels, mesh))
        else:
            loss = make_train_step(model, criterion, opt)(images, labels)
        out.append((float(loss), model_variables(model)))
    return out


def halo_pair(size, seed):
    """<halo(x), g> and <x, halo^T(g)> on this rank of a space axis of
    ``size`` ranks (None off it), and its slab with the planes received."""
    group = distributed.group_of(range(size))
    rank = distributed.process_index()
    if rank >= size:
        return None
    mesh = Mesh({"space": size}, 0, None, rank, group, None)
    rng = np.random.RandomState(seed)
    whole = rng.randn(1, 3 * size, 2, 3, 2).astype(np.float32)
    x = torch.from_numpy(whole[:, 3 * rank:3 * rank + 3]).requires_grad_()
    with distributed.space_parallel(mesh):
        y, pads = exchange_halo(x, 1, 1)
    g = torch.from_numpy(np.random.RandomState(seed + 1 + rank).randn(*y.shape).astype(
        np.float32))
    (y * g).sum().backward()
    lo = 3 * rank - (1 - pads[0])
    return (float((y * g).sum()), float((x * x.grad).sum()),
            np.array_equal(y.detach().numpy(), whole[:, lo:lo + y.shape[1]]), pads)


# -- the tests' side ------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    pool = Ranks()
    yield pool
    pool.close()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("size", [2, 3])
def test_halo_is_an_adjoint_pair(ranks, size):
    """Summed over the ranks, <halo(x), g> = <x, halo^T(g)>; each rank
    receives its neighbours' planes (none past the volume's edges)."""
    got = [r for r in ranks.run(halo_pair, size, 5) if r is not None]
    assert len(got) == size
    forward, adjoint = sum(r[0] for r in got), sum(r[1] for r in got)
    np.testing.assert_allclose(forward, adjoint, rtol=1e-5)
    assert all(r[2] for r in got)
    assert [r[3] for r in got] == [(1, 0)] + [(0, 0)] * (size - 2) + [(0, 1)]


def _slab(pads, depth=8, start=2, stop=6):
    """(start, stop, first): a slab [start, stop) of a volume of ``depth``
    planes and the first plane of it with its halo, for D ``pads``: a pad
    of 1 puts the slab at that edge of the volume (both: the whole)."""
    if pads == (1, 1):
        return 0, depth, 0
    if pads[0]:
        start, stop = 0, stop - start
    if pads[1]:
        start, stop = depth - (stop - start), depth
    return start, stop, start - (1 - pads[0])


PADS = [(0, 0), (1, 0), (0, 1), (1, 1)]


@pytest.mark.parametrize("pads", PADS)
@pytest.mark.parametrize("variant", ["conv", "conv_stats", "block_stats"])
def test_plain_halo_conv_is_the_whole_volumes_slice(variant, pads):
    """Each variant's plain D-halo version on a slab with its halo planes
    equals the SAME conv of the whole volume, sliced (the statistics: the
    slice's), and so does each halo Function's forward and gradients."""
    rng = np.random.RandomState(3)
    whole = torch.from_numpy(rng.randn(2, 8, 5, 6, 4).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 4, 8).astype(np.float32) / 10)
    inv = torch.from_numpy(rng.rand(2, 4).astype(np.float32) + 0.5)
    shift = torch.from_numpy(rng.randn(2, 4).astype(np.float32))
    start, stop, first = _slab(pads)
    x = whole[:, first:stop + 1 - pads[1]]
    if variant == "block_stats":
        want = K.conv3d_block_with_stats_reference(whole, w, inv, shift)[0][:, start:stop]
        got = K.conv3x3x3_block_with_stats(x, w, inv, shift, pads=pads)
    else:
        want = K.conv3d_reference(whole, w)[:, start:stop]
        got = (K.conv3x3x3(x, w, pads) if variant == "conv"
               else K.conv3x3x3_with_stats(x, w, pads))
    y = got if variant == "conv" else got[0]
    scale = float(want.abs().max())
    np.testing.assert_allclose(y, want, atol=SLICE * scale, rtol=0)
    if variant != "conv":
        s1, s2 = K.instance_stats(want)
        np.testing.assert_allclose(got[1], s1, rtol=1e-5, atol=1e-5 * float(s1.abs().max()))
        np.testing.assert_allclose(got[2], s2, rtol=1e-5)
    # the autograd Function: forward and both gradients against the whole
    # volume's restricted to the slab's outputs
    g = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    xw, ww = whole.clone().requires_grad_(), w.clone().requires_grad_()
    xh, wh = x.clone().requires_grad_(), w.clone().requires_grad_()
    if variant == "block_stats":
        full = K.conv3d_block_with_stats_reference(xw, ww, inv, shift)[0]
        part = C._BlockConv3x3x3.apply(xh, wh, inv, shift, 0.01, pads)[0]
    else:
        full = K.conv3d_reference(xw, ww)
        part = C._Conv3x3x3.apply(xh, wh, variant == "conv_stats", False, pads)
        part = part if variant == "conv" else part[0]
    (full[:, start:stop] * g).sum().backward()
    (part * g).sum().backward()
    np.testing.assert_allclose(part.detach(), want, atol=SLICE * scale, rtol=0)
    dx = xw.grad[:, first:first + x.shape[1]]
    np.testing.assert_allclose(xh.grad, dx, atol=SLICE * float(dx.abs().max()), rtol=0)
    np.testing.assert_allclose(wh.grad, ww.grad, atol=SLICE * float(ww.grad.abs().max()),
                               rtol=0)


@pytest.mark.parametrize("start", [0, 2, 4])
def test_plain_halo_stride2_is_the_whole_volumes_slice(start):
    """The stride-2 conv of a slab (an even start and length) with the plane
    below it (``pad_lo`` 0; 1 at the volume's start, where there is none):
    forward, input gradient and ``s2_wgrad``'s plain halo version equal the
    whole volume's, sliced."""
    rng = np.random.RandomState(4)
    whole = torch.from_numpy(rng.randn(1, 8, 6, 5, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 8, 8).astype(np.float32) / 10)
    stop, pad_lo = start + 4, int(start == 0)
    x = whole[:, start - 1 + pad_lo:stop]
    g = torch.from_numpy(rng.randn(1, 2, 3, 3, 8).astype(np.float32))
    xw, ww = whole.clone().requires_grad_(), w.clone().requires_grad_()
    xh, wh = x.clone().requires_grad_(), w.clone().requires_grad_()
    full = C._Conv3x3x3Stride2.apply(xw, ww)
    part = C._Conv3x3x3Stride2.apply(xh, wh, pad_lo)
    want = full[:, start // 2:stop // 2]
    np.testing.assert_allclose(part.detach(), want.detach(),
                               atol=SLICE * float(want.detach().abs().max()), rtol=0)
    (want * g).sum().backward()
    (part * g).sum().backward()
    dx = xw.grad[:, start - 1 + pad_lo:stop]
    np.testing.assert_allclose(xh.grad, dx, atol=SLICE * float(dx.abs().max()), rtol=0)
    np.testing.assert_allclose(wh.grad, ww.grad, atol=SLICE * float(ww.grad.abs().max()),
                               rtol=0)
    dw = W.s2_wgrad(x, g, pad_lo)
    np.testing.assert_allclose(dw, ww.grad, atol=SLICE * float(ww.grad.abs().max()), rtol=0)


# (pads, slab start, slab stop) in a volume of 8 planes: every slab starts
# its output on an even plane of the volume, as a rank's does, so its D
# tiles are the volume's; (1, 2) and (2, 1) are the input gradient's pads at
# the volume's edges, their output D odd
WINO_SLABS = [((1, 0), 0, 5), ((0, 1), 3, 8), ((0, 0), 3, 7), ((1, 2), 0, 4), ((2, 1), 3, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", ["winograd", "winograd_stats"])
@pytest.mark.parametrize("pads,start,stop", WINO_SLABS)
def test_plain_halo_winograd_is_the_whole_volumes_slice(pads, start, stop, variant, dtype):
    """The plain D-halo Winograd-DH (both variants) on x planes [start,
    stop) equals ``winograd_reference`` of the whole volume with the planes
    outside the slab zeroed (the pads' zero planes), sliced to the halo
    output's planes: f32 within 1e-5 of the largest value; bf16 within one
    bf16 step of it (the same roundings; a tie of the store may flip). The
    statistics are the slice's."""
    rng = np.random.RandomState(5)
    whole = torch.from_numpy(rng.randn(2, 8, 6, 5, 12).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.randn(3, 3, 3, 12, 7).astype(np.float32) / 10).to(dtype)
    x = whole[:, start:stop]
    zeroed = torch.zeros_like(whole)
    zeroed[:, start:stop] = x
    first = start + 1 - pads[0]  # the volume's plane of the halo output's first
    depth = K.out_depth(x, pads)
    assert first % 2 == 0 and depth % 2 == (pads in ((1, 2), (2, 1)))
    want = WK.winograd_reference(zeroed, w)[:, first:first + depth]
    if variant == "winograd":
        y = WK.winograd3x3x3(x, w, pads)
    else:
        y, s1, s2 = WK.winograd3x3x3_with_stats(x, w, pads)
    atol = float(want.float().abs().max()) * (SLICE if dtype == torch.float32 else 2 ** -8)
    assert y.shape == want.shape and y.dtype == dtype
    np.testing.assert_allclose(y.float(), want.float(), atol=atol, rtol=0)
    if variant == "winograd_stats":
        t1, t2 = K.instance_stats(y)
        assert torch.equal(s1, t1) and torch.equal(s2, t2)


@pytest.mark.parametrize("with_stats", [False, True], ids=["winograd", "winograd_stats"])
@pytest.mark.parametrize("pads", PADS)
def test_halo_winograd_function_is_the_whole_volumes_slice(monkeypatch, pads, with_stats):
    """``_Conv3x3x3`` in the Winograd halo mode (the gate lowered to every
    shape, so its input gradient is Winograd too, with pads 2 - pad): its
    forward and both gradients against the whole volume's direct conv,
    restricted to the slab's outputs."""
    monkeypatch.setattr(WK, "_MIN_WINOGRAD_CHANNELS", 1)
    monkeypatch.setattr(WK, "_MIN_WINOGRAD_VOXELS", 1)
    calls = []
    monkeypatch.setattr(C, "winograd3x3x3",
                        lambda x, w, pads=K.SAME: calls.append(tuple(pads))
                        or WK.winograd3x3x3(x, w, pads))
    rng = np.random.RandomState(6)
    whole = torch.from_numpy(rng.randn(2, 8, 6, 5, 4).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 4, 8).astype(np.float32) / 10)
    start, stop, first = _slab(pads)
    x = whole[:, first:stop + 1 - pads[1]]
    xw, ww = whole.clone().requires_grad_(), w.clone().requires_grad_()
    xh, wh = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = K.conv3d_reference(xw, ww)[:, start:stop]
    part = C._Conv3x3x3.apply(xh, wh, with_stats, True, pads)
    part = part[0] if with_stats else part
    g = torch.from_numpy(rng.randn(*part.shape).astype(np.float32))
    (want * g).sum().backward()
    (part * g).sum().backward()
    assert calls[-1] == C.input_grad_pads(pads)
    np.testing.assert_allclose(part.detach(), want.detach(),
                               atol=SLICE * float(want.detach().abs().max()), rtol=0)
    dx = xw.grad[:, first:first + x.shape[1]]
    np.testing.assert_allclose(xh.grad, dx, atol=SLICE * float(dx.abs().max()), rtol=0)
    np.testing.assert_allclose(wh.grad, ww.grad, atol=SLICE * float(ww.grad.abs().max()),
                               rtol=0)


def test_input_gradient_pads_give_every_plane():
    """The input gradient's conv of a halo conv (pads 2 - pad) has as many
    planes as the halo'd input; the kernels' pads are 0, 1 or 2 and leave at
    least one output plane."""
    x = torch.zeros(1, 3, 2, 2, 4)
    w = torch.zeros(3, 3, 3, 4, 4)
    for pads in PADS:
        xh = torch.zeros(1, 5 - pads[0] - pads[1], 2, 2, 4)
        y = K.conv3x3x3(xh, w, pads)
        assert y.shape[1] == 3
        assert K.conv3x3x3(y, w, C.input_grad_pads(pads)).shape[1] == xh.shape[1]
    with pytest.raises(ValueError, match="pads"):
        K.conv3x3x3(x, w, (0, 3))
    with pytest.raises(ValueError, match="pads"):
        K.conv3x3x3(x[:, :1], w, (0, 0))
    with pytest.raises(ValueError, match="pad_lo"):
        W.s2_wgrad(x, torch.zeros(1, 2, 1, 1, 4), 2)


# -- against JAX ----------------------------------------------------------

def _inputs(name):
    _, size, channels = NETS[name]
    rng = np.random.RandomState(0)
    x = rng.rand(1, size, size, size, channels).astype(np.float32)
    images = rng.rand(2, channels, size, size, size).astype(np.float32)
    labels = (rng.rand(2, 2, size, size, size) > 0.5).astype(np.float32)
    return x, images, labels


@functools.lru_cache(maxsize=None)
def _flat_variables(name):
    from unet3d_tpu.models.registry import create_model as jax_create_model

    from test_torch_batchnorm import bn_init
    from test_torch_myronenko import _flat

    _, size, channels = NETS[name]
    jmod = jax_create_model(name, **NETS[name][0])
    return _flat(bn_init(jmod, np.zeros((1, size, size, size, channels), np.float32)))


@functools.lru_cache(maxsize=None)
def jax_runs(name):
    """JAX's ``make_sharded_forward`` over {"space": 4} (one item), and its
    SGD step single-device and sharded over {"data": 2, "space": 4}: (the
    forward, losses, variables after the step), f32."""
    import jax
    from jax.sharding import NamedSharding

    from unet3d_tpu.models.registry import create_model as jax_create_model
    from unet3d_tpu.parallel import mesh as jax_mesh
    from unet3d_tpu.train import losses as jax_losses
    from unet3d_tpu.train import step as jax_step

    from test_torch_batchnorm import _sgd_keeping_grads, no_dropout
    from test_torch_myronenko import _flat
    from test_torch_parallel import _tree

    jmod = jax_create_model(name, **NETS[name][0])
    flat = _flat_variables(name)
    x, images, labels = _inputs(name)
    tx = _sgd_keeping_grads(LR)
    criterion = jax_losses.DiceLoss(sigmoid=True)
    grid = jax_mesh.make_mesh({"data": 2, "space": 4})
    with no_dropout():
        fwd_mesh = jax_mesh.make_mesh({"data": 1, "space": 4})
        sharded = jax_mesh.make_sharded_forward(jmod, fwd_mesh)(
            jax_step.create_train_state(_tree(flat), tx),
            jax.device_put(x, NamedSharding(fwd_mesh, jax_mesh.ndhwc_batch_spec(fwd_mesh))))
        steps = []
        for run, shard in ((jax_step.make_train_step(jmod, criterion, tx), lambda a: a),
                           (jax_mesh.make_sharded_train_step(jmod, criterion, tx, grid),
                            functools.partial(jax_mesh.shard_batch, mesh=grid))):
            state = jax_step.create_train_state(_tree(flat), tx)
            state, loss = run(state, shard(images), shard(labels))
            steps.append((float(loss), _flat({"params": state.params})))
    return np.asarray(sharded), [s[0] for s in steps], [s[1] for s in steps]


@functools.lru_cache(maxsize=None)
def port_runs(ranks, name, spec):
    """The ranks' ``port_space``; JAX's runs of the net are made meanwhile."""
    ranks.submit(port_space, name, _flat_variables(name), spec, *_inputs(name))
    jax_runs(name)
    return ranks.collect()


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", list(NETS))
def test_space_forward_matches_jax(ranks, name, spec):
    """The port's D-sharded forward, gathered on every rank, against JAX's
    ``make_sharded_forward``."""
    got = port_runs(ranks, name, spec)
    want = jax_runs(name)[0]
    for forward, *_ in got:
        np.testing.assert_allclose(forward, want, atol=FORWARD_ATOL, rtol=0)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", list(NETS))
def test_space_step_matches_jax(ranks, name, spec):
    """One SGD step: the loss within relative 1e-4 and every parameter within
    1e-5 of JAX's single-device step and of its sharded step at {"data": 2,
    "space": 4}; every rank holds the same variables."""
    got = port_runs(ranks, name, spec)
    _, jax_losses_, jax_params = jax_runs(name)
    first = got[0]
    for loss in jax_losses_:
        np.testing.assert_allclose(first[1], loss, rtol=LOSS_RTOL)
    for want in jax_params:
        for key, value in want.items():
            np.testing.assert_allclose(first[2][key], value, atol=PARAM_ATOL, rtol=0,
                                       err_msg=key)
    for other in got[1:]:
        assert other[1] == first[1]
        assert all(np.array_equal(other[2][k], first[2][k]) for k in first[2])


def test_residual_deep_supervision_remat_step(ranks):
    """DynUNet's residual blocks, two deep-supervision heads (level 2's
    upsampled whole and cut to the output's slab where a level is
    replicated) and remat (each block's recompute in the layout it ran in)
    at space4 (levels 4-5 replicated): the sharded step equals the port's
    single-device step (loss within relative 1e-4, parameters within 1e-5)."""
    _, images, labels = _inputs("DynUNet")
    for (loss, after), (want_loss, want) in ranks.run(port_options_step, "space4", images,
                                                       labels):
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        for key, value in want.items():
            np.testing.assert_allclose(after[key], value, atol=PARAM_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("spec", SPECS)
def test_grid_is_row_major(ranks, spec):
    """World rank r sits at the row-major coordinates of r over the spec's
    axes, as JAX's ``make_mesh`` reshapes its devices."""
    got = port_runs(ranks, "UNet3D", spec)
    shape = got[0][3]
    assert shape == {"space4": {"space": 4}, "data2,space2": {"data": 2, "space": 2}}[spec]
    for r, result in enumerate(got):
        coords = grid_coordinates(shape, r)
        assert result[4] == (coords.get("data", 0), coords["space"])


# -- the plans and the refusals ---------------------------------------------

def _config(name):
    return {"model": {"name": name}, "dataset": {"desired_shape": [16, 16, 16]},
            "training": {"batch_size": 2}}


@pytest.mark.parametrize("name", ["DynUNet", "UNet3D", "SegResNet", "SegResNetVAE",
                                  "LabeledVariationalAutoEncoder", "SegResNetDS",
                                  "AttentionUnet", "UNet"])
def test_predict_cli_default_plan_is_the_space_axis(name):
    """``--ngpus N`` without a mesh spec lays the N ranks on ``{"space":
    N}``, as JAX's predict CLI does; a spec with a space axis takes every
    rank to it; a pure data spec keeps the data layout."""
    assert predict.predict_plan(_config(name), {"n_gpus": 4}, "cpu") == launch.Plan(
        4, {"space": 4}, {"n_gpus": 4})
    assert predict.predict_plan(_config(name), {"mesh": "data2,space2"}, "cpu").mesh == {
        "space": 4}
    assert predict.predict_plan(_config(name), {"mesh": "data2"}, "cpu").mesh == {"data": 2}
    assert predict.predict_plan(_config(name), {"n_gpus": 1}, "cpu") is None


def test_a_net_without_a_space_form_raises(caplog):
    """VNet has no space form: on an explicit space axis the CLIs and
    the sharded steps raise; the predict CLI's default takes the data
    layout, with a log line."""
    config = _config("VNet")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        predict.predict_plan(config, {"mesh": "space2"}, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_cli._refuse_unported(config, {"mesh": "data1,space2"}, "cpu")
    with caplog.at_level("WARNING"):
        assert predict.predict_plan(config, {"n_gpus": 2}, "cpu").mesh == {"data": 2}
    assert "no form for the 'space' mesh axis" in caplog.text
    model = create_model("VNet", in_channels=1, out_channels=1)
    mesh = Mesh({"space": 2}, 0, None, 0, object(), object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_sharded_train_step(model, losses.DiceLoss(), torch.optim.SGD(
            model.parameters(), lr=LR), mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_sharded_forward(model, mesh)


def test_train_cli_checks_the_patch_depth():
    """A patch whose depth the space axis does not divide raises before any
    rank starts, with the axis and the depth in the message."""
    config = dict(_config("DynUNet"), dataset={"desired_shape": [18, 16, 16]})
    with pytest.raises(ValueError, match=r"depth 18 .* space axis \(4\)"):
        train_cli._refuse_unported(config, {"mesh": "space4"}, "cpu")
    assert train_cli._refuse_unported(_config("DynUNet"), {"mesh": "data2,space2"},
                                      "cpu").mesh == {"data": 2, "space": 2}


@functools.lru_cache(maxsize=None)
def port_winograd_runs(ranks, spec):
    """The ranks' ``port_space_winograd``; JAX's runs are made meanwhile."""
    ranks.submit(port_space_winograd, _flat_variables("DynUNet"), spec, *_inputs("DynUNet"))
    jax_runs("DynUNet")
    return ranks.collect()


@pytest.mark.parametrize("spec", SPECS)
def test_space_winograd_matches_jax(ranks, spec):
    """Under UNET3D_TPU_CONV=winograd (the gate lowered, ``WINOGRAD_GATE``)
    DynUNet's D-sharded forward and SGD step run: the forward within 1e-4 of
    JAX's ``make_sharded_forward``, the loss within relative 1e-4 and every
    parameter within 1e-5 of JAX's single-device and sharded steps; the
    ranks ran Winograd-DH in its halo mode, forward (statistics too) and
    input gradient, an odd-D input gradient among them (pads (1, 2) or
    (2, 1) at the volume's edges)."""
    got = port_winograd_runs(ranks, spec)
    want, jax_losses_, jax_params = jax_runs("DynUNet")
    for forward, *_ in got:
        np.testing.assert_allclose(forward, want, atol=FORWARD_ATOL, rtol=0)
    first = got[0]
    for loss in jax_losses_:
        np.testing.assert_allclose(first[1], loss, rtol=LOSS_RTOL)
    for params in jax_params:
        for key, value in params.items():
            np.testing.assert_allclose(first[2][key], value, atol=PARAM_ATOL, rtol=0,
                                       err_msg=key)
    calls = [c for r in got for c in r[5]]
    halo = {(v, pads) for v, pads, _ in calls if pads != K.SAME}
    assert ("winograd_stats", (1, 0)) in halo and ("winograd_stats", (0, 1)) in halo
    assert {("winograd", (1, 2)), ("winograd", (2, 1))} <= halo
    assert any(v == "winograd" and depth % 2 for v, _, depth in calls)


def test_dx_gate_is_judged_on_the_whole_volume(monkeypatch):
    """The input gradient of a Winograd site on the space axis takes
    Winograd-DH where JAX's ``_dgrad`` gate passes on the whole volume's
    cotangent (the slab's D times the axis), though the slab alone fails
    it: the 64^3 level's dx at 128^3 on two ranks, here scaled to 8^3."""
    from unet3d_tpu.ops.pallas import winograd_kernel as jax_wino

    for module in (WK, jax_wino):
        monkeypatch.setattr(module, "_MIN_WINOGRAD_CHANNELS", 8)
        monkeypatch.setattr(module, "_MIN_WINOGRAD_VOXELS", 8 ** 3)
    routed = []
    monkeypatch.setattr(C, "winograd3x3x3",
                        lambda g, w, pads: routed.append(("winograd", g.shape[1] + sum(pads) - 2))
                        or WK.winograd3x3x3(g, w, pads))
    monkeypatch.setattr(C, "conv3x3x3",
                        lambda g, w, pads: routed.append(("conv", g.shape[1] + sum(pads) - 2))
                        or K.conv3x3x3(g, w, pads))
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(1, 5, 8, 8, 8).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.randn(3, 3, 3, 8, 8).astype(np.float32) / 10)
    slab, whole = (1, 4, 8, 8, 8), (1, 8, 8, 8, 8)
    assert jax_wino.winograd_profitable(whole) and not jax_wino.winograd_profitable(slab)
    for space, want in ((2, ("winograd", 5)), (1, ("conv", 5))):
        mesh = Mesh({"space": space}, 0, None, 0, object(), object())
        with distributed.space_parallel(mesh):
            y = C._Conv3x3x3.apply(x, w, False, True, (1, 0))
        assert tuple(y.shape) == slab
        y.sum().backward()
        assert routed[-1] == want


# -- on the card ----------------------------------------------------------

CUDA_SHAPES = [(64, 4, 64), (32, 64, 64), (16, 96, 128), (8, 128, 192), (4, 192, 256),
               (2, 256, 320), (1, 320, 320)]  # (local D, Cin, Cout): the DynUNet's levels


def _cuda_case(depth, cin, cout, dtype, pads, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hw = max(4, min(32, 2 * depth))
    x = torch.randn(1, depth + 2 - sum(pads), hw, hw, cin, device="cuda", generator=gen)
    w = torch.randn(3, 3, 3, cin, cout, device="cuda", generator=gen) / (27 * cin) ** 0.5
    inv = torch.rand(1, cin, device="cuda", generator=gen) + 0.5
    shift = torch.randn(1, cin, device="cuda", generator=gen)
    return x.to(dtype), w.to(dtype), inv, shift


def _rel_max(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _stats_err(y, s1, s2):
    """The kernel's statistics against an f64 sum of its own rounded y (the
    plain version's y rounds elsewhere in bf16)."""
    yd = y.double()
    return max(float((s1 - yd.sum((1, 2, 3))).abs().max() / yd.abs().sum((1, 2, 3)).max()),
               float((s2 - (yd * yd).sum((1, 2, 3))).abs().max()
                     / (yd * yd).sum((1, 2, 3)).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("variant", ["conv", "conv_stats", "block_stats"])
def test_cuda_halo_conv_kernels(variant, dtype):
    """Each conv variant's D-halo mode (every pads, and the input
    gradient's (2, 1), (1, 2), (2, 2)) against its plain version at the
    DynUNet's local shapes, D 64 down to 1 (y at phase 2's bounds; the
    statistics, as there, within 1e-4 of an f64 sum of the kernel's own
    y)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    bound = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for i, (depth, cin, cout) in enumerate(CUDA_SHAPES):
        for pads in PADS + [(2, 1), (1, 2), (2, 2)]:
            if depth + 2 - sum(pads) < 1:
                continue
            x, w, inv, shift = _cuda_case(depth, cin, cout, dtype, pads, i)
            if variant == "block_stats":
                got = K.conv3x3x3_block_with_stats(x, w, inv, shift, pads=pads)
                want = K.conv3d_block_with_stats_reference(x, w, inv, shift, pads=pads)
            elif variant == "conv_stats":
                got = K.conv3x3x3_with_stats(x, w, pads)
                want = K.conv3d_with_stats_reference(x, w, pads)
            else:
                got, want = (K.conv3x3x3(x, w, pads),), (K.conv3d_reference(x, w, pads),)
            assert got[0].shape == want[0].shape
            assert _rel_max(got[0], want[0]) < bound, (depth, cin, cout, pads)
            if variant != "conv":
                assert _stats_err(*got) < 1e-4, (depth, cin, cout, pads)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("variant", ["winograd", "winograd_stats"])
def test_cuda_halo_winograd_kernels(variant, dtype):
    """Winograd-DH's D-halo mode (every pads, the input gradient's (2, 1),
    (1, 2), (2, 2) among them: odd output D) against its plain version at
    the Winograd sites' channel counts on slabs of 1-34 planes, ragged
    channels and x one element off alignment too (y within phase 2's
    bounds, the statistics within 1e-4 of an f64 sum of the kernel's own
    y)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    bound = 1e-2 if dtype == torch.bfloat16 else 1e-5
    fn = WK.winograd3x3x3 if variant == "winograd" else WK.winograd3x3x3_with_stats
    gen = torch.Generator(device="cuda").manual_seed(11)
    for depth, hw, cin, cout, offset in [(32, 32, 96, 96, 0), (16, 16, 192, 96, 0),
                                          (8, 32, 128, 64, 0), (3, 16, 96, 192, 0),
                                          (1, 8, 100, 12, 0), (5, 10, 5, 7, 1)]:
        for pads in PADS + [(2, 1), (1, 2), (2, 2)]:
            d_in = depth + 2 - sum(pads)
            if d_in < 1:
                continue
            x = torch.randn(1, d_in, hw, hw + 3, cin, device="cuda", generator=gen).to(dtype)
            if offset:
                store = torch.empty(offset + x.numel(), dtype=dtype, device="cuda")
                x = store[offset:].view(x.shape).copy_(x)
            w = (torch.randn(3, 3, 3, cin, cout, device="cuda", generator=gen)
                 / (27 * cin) ** 0.5).to(dtype)
            WK.reset_launches()
            got = fn(x, w, pads)
            want = WK.winograd_reference(x.clone(), w, pads)
            y = got if variant == "winograd" else got[0]
            assert y.shape == want.shape and y.shape[1] == depth
            assert _rel_max(y, want) < bound, (depth, cin, cout, pads)
            if variant == "winograd_stats":
                assert _stats_err(*got) < 1e-4, (depth, cin, cout, pads)
            assert dict(WK.HALO_LAUNCHES) == ({} if pads == K.SAME else {(variant, pads): 1})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("pad_lo", [0, 1])
def test_cuda_s2_wgrad_halo(pad_lo, dtype):
    """``s2_wgrad`` with ``pad_lo`` 0 (the halo mode) and 1 against its plain
    version at the DynUNet's stride-2 sites on a slab (local D 64 down to
    2)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(7)
    for depth, cin, cout in [(64, 64, 96), (32, 96, 128), (16, 128, 192), (8, 192, 256),
                             (4, 256, 320), (2, 320, 320)]:
        hw = max(4, min(64, 2 * depth))
        x = torch.randn(1, depth + 1 - pad_lo, hw, hw, cin, device="cuda",
                        generator=gen).to(dtype)
        g = torch.randn(1, depth // 2, hw // 2, hw // 2, cout, device="cuda",
                        generator=gen).to(dtype)
        got = W.s2_wgrad(x, g, pad_lo)
        want = W.s2_wgrad_reference(x, g, pad_lo)
        assert _rel_max(got, want) < 1e-4, (depth, cin, cout)

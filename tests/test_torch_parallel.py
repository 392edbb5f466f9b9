"""The port's data-parallel slice (``unet3d_tpu_torch/parallel/``) against
the JAX package's ``data`` axis.

Two gloo ranks on the CPU, spawned once for the file (``Ranks``: each runs
the jobs this file sends it; the functions they run are at the top of this
file, which imports no JAX, so a rank never loads it), take one SGD step
(lr ``LR``) of ``parallel.mesh.make_sharded_train_step`` on their shares
of a global batch; JAX takes one of ``make_sharded_train_step`` on
``make_mesh({"data": 2})`` of the 8-device CPU mesh ``tests/conftest.py``
forces, its optimizer keeping the gradients. Small nets, 8^3: a DynUNet
(2 levels, widths 4 and 8) with DiceLoss in f32 and bf16 AMP and with
``batch=True``; SegResNetDS (BatchNorm) for the parameters and running
statistics, and with 2 microbatches at global batch 4 (each rank's share of
each microbatch); VQVAE's codebook; the eval step.

Tolerances: f32 at ``tests/test_torch_train.py``'s ``F32`` (atol 2e-4,
rtol 1e-3) on the loss, the gradients and every variable after the step;
bf16 AMP by that file's rules (the loss within 1e-3, the gradients but the
output head's bias, which XLA on the CPU sums in bf16, within relative L2
0.15, and no further from the f32 gradients than JAX's). The port's
sharded step against its single-device step on the global batch: each
tensor within 1e-5 of its largest value (sum orders differ). A control
shows the BatchNorm case has teeth: with the statistics' sum over the data
axis taken out, the running statistics leave the tolerance.
"""
import contextlib
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

from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.data.loader import DataLoader
from unet3d_tpu_torch.models import layers
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.models.remat import whole_model_remat
from unet3d_tpu_torch.parallel import distributed, launch
from unet3d_tpu_torch.parallel.mesh import (Mesh, local_items, make_mesh,
                                            make_sharded_eval_step, make_sharded_train_step,
                                            parse_mesh_spec, shard_batch)
from unet3d_tpu_torch.train import losses, optim, step
from unet3d_tpu_torch.train.train import epoch_training, epoch_validation

RANKS = 2
LR = 0.1
F32 = dict(atol=2e-4, rtol=1e-3)
SAME = 1e-5  # the sharded step against the single-device one, of each tensor's largest value
DYNUNET = dict(in_channels=2, out_channels=2, spatial_dims=3, strides=[[1, 1, 1], [2, 2, 2]],
               filters=[4, 8], kernel_size=[[3, 3, 3]] * 2, upsample_kernel_size=[[2, 2, 2]])
SEGRESNET_DS = dict(init_filters=4, in_channels=2, out_channels=2, blocks_down=[1, 1])
VQVAE = dict(in_channel=2, channel=8, n_res_block=1, n_res_channel=4, embed_dim=4, n_embed=16)
SIZE = 8


# -- the ranks' side: no JAX here -------------------------------------------

def _serve(rank, init_method, jobs, results):
    torch.set_num_threads(1)
    distributed.maybe_initialize_distributed({}, rank, RANKS, "gloo", init_method, timeout=120)
    try:
        while True:
            job = jobs.get()
            if job is None:
                return
            fn, args, kwargs = job
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.leave_process_group()


class Ranks:
    """``RANKS`` spawned CPU processes in one gloo process group; ``run(fn,
    *args)`` runs ``fn`` on each and returns the results in rank order, and
    raises with a rank's traceback when one fails."""

    def __init__(self):
        ctx = mp.get_context("spawn")
        self.tmp = tempfile.mkdtemp(prefix="unet3d_ranks_")
        init = f"file://{os.path.join(self.tmp, 'store')}"
        self.jobs = [ctx.SimpleQueue() for _ in range(RANKS)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, args=(r, init, self.jobs[r], self.results),
                                  daemon=True) for r in range(RANKS)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, **kwargs):
        for q in self.jobs:
            q.put((fn, args, kwargs))
        out = {}
        while len(out) < RANKS:
            try:
                rank, ok, value = self.results.get(timeout=180)
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


def port_step(spec, images, labels, sharded=True, sync_bn=True):
    """One SGD step of the port (sharded over the process group's ranks, or
    the single-device step on the whole batch): (loss, gradients by torch
    name, the variables after it by JAX key)."""
    model = load_jax_variables(create_model(spec["name"], **spec["kwargs"]), spec["flat"],
                               strict=True)
    whole_model_remat(model, spec.get("remat", False))
    criterion = losses.load_criterion(*spec["criterion"])
    opt = optim.build_optimizer("SGD", model.parameters(), lr=LR)
    amp, grad_accum = spec["amp"], spec["grad_accum"]
    if sharded:
        mesh = make_mesh()
        run = make_sharded_train_step(model, criterion, opt, mesh, amp=amp,
                                      grad_accum=grad_accum)
        images, labels = (shard_batch(a, mesh, grad_accum) for a in (images, labels))
    else:
        run = step.make_train_step(model, criterion, opt, amp=amp, grad_accum=grad_accum)
    unsynced = mock.patch.object(layers, "mean_over_data", lambda t: t)
    with contextlib.nullcontext() if sync_bn else unsynced:
        loss = run(images, labels)
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    return float(loss), grads, model_variables(model)


def port_eval(spec, images, labels, whole=False):
    model = load_jax_variables(create_model(spec["name"], **spec["kwargs"]), spec["flat"],
                               strict=True)
    mesh = make_mesh()
    run = make_sharded_eval_step(model, losses.load_criterion(*spec["criterion"]), mesh)
    if not whole:
        images, labels = shard_batch(images, mesh), shard_batch(labels, mesh)
    return float(run(images, labels, whole=whole))


def port_noisy_step(model_cfg, images, labels, sharded=True):
    """One SGD step of a net that draws dropout noise, on a batch every rank
    runs whole (``whole=True``), or the single-device step on it: (loss,
    the variables after it)."""
    config = {"model": dict(model_cfg), "dataset": {"desired_shape": list(images.shape[2:])}}
    model = build_or_load_model_from_config(config, None, torch.device("cpu"), seed=2)
    criterion = losses.DiceLoss(sigmoid=True)
    opt = optim.build_optimizer("SGD", model.parameters(), lr=LR)
    if sharded:
        run = functools.partial(make_sharded_train_step(model, criterion, opt, make_mesh()),
                                whole=True)
    else:
        run = step.make_train_step(model, criterion, opt)
    loss = run(images, labels)
    return float(loss), model_variables(model)


def rank_of_group():
    return distributed.process_index(), distributed.world_size(), make_mesh().shape


def mesh_of(spec):
    mesh = make_mesh(spec)
    return mesh.shape, mesh.rank, mesh.space_rank, mesh.space_group is not None


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


def _batch(n, channels, seed, size=SIZE):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 2, size, size, size).astype(np.float32),
            (rng.rand(n, channels, size, size, size) > 0.5).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _flat_variables(name):
    from unet3d_tpu.models.registry import create_model as jax_create_model

    from test_torch_batchnorm import bn_init
    from test_torch_myronenko import _flat
    from test_torch_vqvae import vq_variables

    kwargs = {"DynUNet": DYNUNET, "SegResNetDS": SEGRESNET_DS, "VQVAE": VQVAE}[name]
    jmod = jax_create_model(name, **kwargs)
    shape = (2, SIZE, SIZE, SIZE, 2)
    if name == "VQVAE":
        return vq_variables(jmod, shape)
    return _flat(bn_init(jmod, np.zeros(shape, np.float32)))


def spec_of(name, criterion=("DiceLoss", {"sigmoid": True}), amp=False, grad_accum=1):
    kwargs = {"DynUNet": DYNUNET, "SegResNetDS": SEGRESNET_DS, "VQVAE": VQVAE}[name]
    return {"name": name, "kwargs": kwargs, "flat": _flat_variables(name),
            "criterion": criterion, "amp": amp, "grad_accum": grad_accum}


def _tree(flat):
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def jax_sharded_step(spec, images, labels):
    """JAX's ``make_sharded_train_step`` on a data2 mesh, one SGD step."""
    from unet3d_tpu.models.registry import create_model as jax_create_model
    from unet3d_tpu.parallel import mesh as jax_mesh
    from unet3d_tpu.train import losses as jax_losses
    from unet3d_tpu.train import step as jax_step

    from test_torch_batchnorm import _sgd_keeping_grads
    from test_torch_myronenko import _flat

    jmod = jax_create_model(spec["name"], **spec["kwargs"])
    tx = _sgd_keeping_grads(LR)
    state = jax_step.create_train_state(_tree(spec["flat"]), tx)
    run = jax_mesh.make_sharded_train_step(
        jmod, jax_losses.load_criterion(*spec["criterion"]), tx,
        jax_mesh.make_mesh({"data": RANKS}), amp=spec["amp"], grad_accum=spec["grad_accum"])
    state, loss = run(state, images, labels)
    grads = {k.replace("/", "."): v for k, v in _flat(state.opt_state).items()}
    return float(loss), grads, _flat({"params": state.params, **state.extra_variables})


def _assert_same(got, want, what):
    """Each tensor within ``SAME`` of its largest value."""
    for key in want:
        scale = float(np.abs(want[key]).max()) or 1.0
        np.testing.assert_allclose(got[key], want[key], rtol=SAME, atol=SAME * scale,
                                   err_msg=f"{what} {key}")


def _assert_f32(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=f"{what} {key}", **F32)


def _rel_l2(a, b, keys):
    a = np.concatenate([np.asarray(a[k], np.float64).ravel() for k in keys])
    b = np.concatenate([np.asarray(b[k], np.float64).ravel() for k in keys])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _runs(ranks, case):
    """(the ranks' results, JAX's sharded step, the port's single-device
    step) of ``case``."""
    spec, (images, labels) = CASES[case]()
    return (ranks.run(port_step, spec, images, labels),
            jax_sharded_step(spec, images, labels),
            port_step(spec, images, labels, sharded=False))


CASES = {
    "dynunet_f32": lambda: (spec_of("DynUNet"), _batch(2, 2, 1)),
    "dynunet_bf16": lambda: (spec_of("DynUNet", amp=True), _batch(2, 2, 1)),
    "batch_dice": lambda: (spec_of("DynUNet", ("DiceLoss", {"sigmoid": True, "batch": True})),
                           _batch(2, 2, 2)),
    "batchnorm": lambda: (spec_of("SegResNetDS"), _batch(2, 2, 3)),
    "batchnorm_2_microbatches": lambda: (spec_of("SegResNetDS", grad_accum=2),
                                         _batch(4, 2, 4)),
    "vqvae": lambda: (spec_of("VQVAE", ("MSELoss", {})), (_batch(2, 2, 5)[0],) * 2),
}


@pytest.mark.parametrize("case", ["dynunet_f32", "batch_dice", "batchnorm",
                                  "batchnorm_2_microbatches", "vqvae"])
def test_sharded_step_matches_jax_f32(ranks, case):
    """Loss, gradients and every variable after the step (parameters,
    running statistics, codebook) against JAX's sharded step at ``F32`` and
    against the port's single-device step on the global batch; every rank
    holds the same variables."""
    (first, second), want, single = _runs(ranks, case)
    loss, grads, after = first
    np.testing.assert_allclose(loss, want[0], **F32)
    _assert_f32(grads, want[1], "gradient")
    _assert_f32(after, want[2], "variable")
    np.testing.assert_allclose(loss, single[0], rtol=SAME)
    _assert_same(grads, single[1], "gradient")
    _assert_same(after, single[2], "variable")
    assert second[0] == loss
    assert all(np.array_equal(second[2][k], after[k]) for k in after)
    collections = {k.split("/")[0] for k in after}
    assert collections == {"DynUNet": {"params"}, "SegResNetDS": {"params", "batch_stats"},
                           "VQVAE": {"params", "codebook"}}[CASES[case]()[0]["name"]]


def test_sharded_amp_step_matches_jax(ranks):
    """bf16 AMP by ``tests/test_torch_train.py``'s rules."""
    (first, _), want, _ = _runs(ranks, "dynunet_bf16")
    loss, grads, _ = first
    f32_grads = _runs(ranks, "dynunet_f32")[0][0][1]
    assert abs(loss - want[0]) < 1e-3 * abs(want[0])
    keys = sorted(grads)
    summed_in_bf16 = [k for k in keys if k.startswith("output_block") and k.endswith("bias")]
    assert len(summed_in_bf16) == 1
    rest = [k for k in keys if k not in summed_in_bf16]
    assert _rel_l2(grads, want[1], rest) < 0.15
    assert _rel_l2(grads, f32_grads, keys) <= _rel_l2(want[1], f32_grads, keys)


def test_sharded_step_under_remat(ranks):
    """Remat's recompute runs each block's BatchNorm, and its sum over the
    data axis, again inside the backward, in the same order on every rank,
    on the statistics of before: the sharded step of SegResNetDS with every
    block checkpointed equals the plain single-device step (gradients,
    parameters, running statistics updated once)."""
    spec, (images, labels) = CASES["batchnorm"]()
    (loss, grads, after), _ = ranks.run(port_step, dict(spec, remat=True), images, labels)
    _, _, single = _runs(ranks, "batchnorm")
    np.testing.assert_allclose(loss, single[0], rtol=SAME)
    _assert_same(grads, single[1], "gradient")
    _assert_same(after, single[2], "variable")


def test_batchnorm_control_without_the_statistics_sum(ranks):
    """The running statistics with each rank's own batch statistics (the
    sum over the data axis patched out) leave the tolerance that the synced
    step keeps."""
    spec, (images, labels) = CASES["batchnorm"]()
    _, _, want = jax_sharded_step(spec, images, labels)
    _, _, after = ranks.run(port_step, spec, images, labels, sync_bn=False)[0]
    stats = [k for k in want if k.startswith("batch_stats/")]
    assert stats
    with pytest.raises(AssertionError):
        _assert_f32({k: after[k] for k in stats}, {k: want[k] for k in stats}, "statistic")


@pytest.mark.parametrize("n", [4, 3], ids=["sharded", "whole"])
def test_eval_step_matches_jax(ranks, n):
    """The global batch's eval loss (DiceLoss with ``batch=True`` on
    SegResNetDS's running statistics) on every rank, against JAX's sharded
    eval step; a batch of 3 the data axis does not divide runs whole on
    every rank, against JAX's unsharded eval step, as its CLI falls back."""
    from unet3d_tpu.models.registry import create_model as jax_create_model
    from unet3d_tpu.parallel import mesh as jax_mesh
    from unet3d_tpu.train import losses as jax_losses
    from unet3d_tpu.train import optim as jax_optim
    from unet3d_tpu.train import step as jax_step

    spec = spec_of("SegResNetDS", ("DiceLoss", {"sigmoid": True, "batch": True}))
    images, labels = _batch(n, 2, 6)
    jmod = jax_create_model("SegResNetDS", **SEGRESNET_DS)
    state = jax_step.create_train_state(_tree(spec["flat"]), jax_optim.build_optimizer("SGD"))
    criterion = jax_losses.DiceLoss(sigmoid=True, batch=True)
    if n % RANKS:
        run = jax_step.make_eval_step(jmod, criterion)
    else:
        run = jax_mesh.make_sharded_eval_step(jmod, criterion, jax_mesh.make_mesh({"data": RANKS}))
    want = float(run(state, images, labels))
    got = ranks.run(port_eval, spec, images, labels, whole=bool(n % RANKS))
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, **F32)


BASIC_UNET = {"name": "BasicUNet", "in_channels": 2, "out_channels": 2,
              "features": [4, 4, 8, 8, 8, 4], "dropout": 0.2}


def test_a_whole_batch_keeps_rank_0s_noise(ranks):
    """A training batch that runs whole on every rank (each drawing its own
    dropout masks) takes rank 0's gradients and loss on every rank: one
    draw of the noise, the single device's step (rank 0's generator is
    seeded as the single device's), not the mean of two draws."""
    images, labels = _batch(2, 2, 8, size=16)
    got = ranks.run(port_noisy_step, BASIC_UNET, images, labels)
    want = port_noisy_step(BASIC_UNET, images, labels, sharded=False)
    assert got[0][0] == got[1][0]
    for key in want[1]:
        np.testing.assert_array_equal(got[1][1][key], got[0][1][key], err_msg=key)
    np.testing.assert_allclose(got[0][0], want[0], rtol=SAME)
    _assert_same(got[0][1], want[1], "variable")


def test_process_group_and_mesh(ranks):
    assert ranks.run(rank_of_group) == [(0, RANKS, {"data": RANKS}), (1, RANKS, {"data": RANKS})]


# -- the layout, the loader and the engine (no process group needed) -------

def test_local_items_follow_the_microbatch_layout():
    """Rank r's share of microbatch m is the global items [m B/M + r B/(M
    R), m B/M + (r + 1) B/(M R)); a batch R x M does not divide is whole."""
    meshes = [Mesh({"data": 2}, r) for r in range(2)]
    assert [list(local_items(8, m, 2)) for m in meshes] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert [list(local_items(4, m)) for m in meshes] == [[0, 1], [2, 3]]
    assert local_items(6, meshes[0], 2) is None and local_items(3, meshes[1]) is None
    labels = np.arange(8 * 3).reshape(8, 3)  # a classifier's (B, classes) targets
    np.testing.assert_array_equal(shard_batch(labels, meshes[1], 2), labels[[2, 3, 6, 7]])
    assert shard_batch(labels[:3], meshes[1]) is not None
    assert torch.equal(shard_batch(torch.arange(4), meshes[1]), torch.tensor([2, 3]))


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((1, 2, 2, 2), i, np.float32),
                "label": np.full((1, 2, 2, 2), -i, np.float32), "source_filename": f"c{i}"}


def test_loader_loads_each_ranks_share_of_the_same_order():
    """Every rank walks the shuffled global order and loads only its items
    of each batch (in the microbatch layout); the ragged last batch is
    whole; ``rank_cases`` deals cases round-robin."""
    single = DataLoader(_Items(7), batch_size=4, shuffle=True, seed=3)
    single.set_epoch(2)
    want = [b["image"][:, 0, 0, 0, 0].astype(int).tolist() for b in single]
    for r in range(2):
        mesh = Mesh({"data": 2}, r)
        loader = DataLoader(_Items(7), batch_size=4, shuffle=True, seed=3, num_workers=2,
                            share=functools.partial(local_items, mesh=mesh, microbatches=2))
        loader.set_epoch(2)
        batches = list(loader)
        assert [b["global_batch_size"] for b in batches] == [4, 3]
        assert [b["whole_batch"] for b in batches] == [False, True]
        assert batches[0]["image"][:, 0, 0, 0, 0].astype(int).tolist() == \
            [want[0][r], want[0][2 + r]]
        assert batches[0]["source_filename"] == [f"c{i}" for i in (want[0][r], want[0][2 + r])]
        assert batches[1]["image"][:, 0, 0, 0, 0].astype(int).tolist() == want[1]
        dealt = DataLoader(_Items(7), batch_size=2).rank_cases(r, 2)
        assert len(dealt) == len(list(dealt)) == 2
        assert [s for b in dealt for s in b["source_filename"]] == [f"c{i}" for i in
                                                                    range(r, 7, 2)]


class _Batches(list):
    def set_epoch(self, epoch):
        pass


def test_engine_weights_by_the_global_batch_and_passes_whole():
    """The engine averages a rank's global losses by each batch's global
    size and tells the step which batches run whole."""
    calls = []

    def fake_step(images, labels, whole=False):
        calls.append(whole)
        return torch.tensor(float(images.sum()))

    batches = _Batches([
        {"image": torch.ones(1), "label": None, "global_batch_size": 2, "whole_batch": False},
        {"image": torch.full((3,), 2.0), "label": None, "global_batch_size": 3,
         "whole_batch": True}])
    assert epoch_training(batches, fake_step, 1, print_freq=0) == pytest.approx(
        (1 * 2 + 6 * 3) / 5)
    assert epoch_validation(batches, fake_step, print_freq=0) == pytest.approx((2 + 18) / 5)
    assert calls == [False, True, False, True]


# -- the mesh spec and the process group's set-up --------------------------

def test_parse_mesh_spec_strings():
    assert parse_mesh_spec("data2,space4") == {"data": 2, "space": 4}
    assert parse_mesh_spec("data=2, space=4") == {"data": 2, "space": 4}
    assert parse_mesh_spec("space:8") == {"space": 8}
    assert list(parse_mesh_spec("space2,data4")) == ["space", "data"]


def test_parse_mesh_spec_dict_passthrough():
    assert parse_mesh_spec({"data": 2, "space": 4}) == {"data": 2, "space": 4}
    assert parse_mesh_spec({"data": "8"}) == {"data": 8}


@pytest.mark.parametrize("bad", ["batch2", "data0", "data", "", {"foo": 2}, {}])
def test_parse_mesh_spec_rejects(bad):
    with pytest.raises(ValueError):
        parse_mesh_spec(bad)


def test_parse_mesh_spec_is_jaxs():
    from unet3d_tpu.parallel.mesh import parse_mesh_spec as jax_parse
    for spec in ("data2,space4", "data=2, space=4", "model:3", {"data": "8"}):
        assert parse_mesh_spec(spec) == jax_parse(spec)


@pytest.mark.parametrize("spec", ["space2", "data1,space2", "model2"])
def test_unported_axes_raise(ranks, spec):
    """Only a ``model`` axis raises; a ``space`` axis plans its ranks and
    builds the (data, space) grid on them (one rank short of it, the mesh
    asks for the devices)."""
    if spec == "model2":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_mesh(spec)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            launch.plan({"n_gpus": 1, "mesh": spec}, "cpu")
        return
    shape = parse_mesh_spec(spec)
    assert launch.plan({"n_gpus": 1, "mesh": spec}, "cpu") == launch.Plan(
        2, shape, {"n_gpus": 1, "mesh": spec})
    with pytest.raises(ValueError, match="Mesh needs 2 devices, have 1"):
        make_mesh(spec)
    assert ranks.run(mesh_of, spec) == [(shape, 0, r, True) for r in range(RANKS)]


def test_mesh_needs_the_world_size():
    assert make_mesh() == Mesh({"data": 1}, 0, None)
    with pytest.raises(ValueError, match="Mesh needs 2 devices, have 1"):
        make_mesh({"data": 2})


def test_plan_follows_the_jax_cli(monkeypatch):
    assert launch.plan({"n_gpus": 1}, "cpu") is None
    assert launch.plan({"n_gpus": 3}, "cpu").nprocs == 3
    assert launch.plan({"n_gpus": 1, "mesh": "data2"}, "cpu").mesh == {"data": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    clamped = launch.plan({"n_gpus": 2}, "cuda")
    assert (clamped.nprocs, clamped.mesh) == (1, {"data": 1})


def test_two_ranks_on_one_gpu_need_gloo():
    with pytest.raises(ValueError, match="gloo"):
        launch.launch(print, (), launch.Plan(2, {"data": 2}, {}), device="cuda:0")


def test_a_failed_rank_fails_the_run(capfd):
    """One rank raises while the other waits in a collective: the launch
    raises the error of the first rank to exit (the failed one, or its peer
    whose collective broke off) and stops the other; each rank's error is on
    stderr."""
    with pytest.raises(mp.ProcessRaisedException):
        launch.launch(_fail_on_rank_1, (), launch.Plan(2, {"data": 2}, {}), device="cpu",
                      timeout=60)
    assert "rank 1 failed" in capfd.readouterr().err


def _fail_on_rank_1():
    if distributed.process_index() == 1:
        raise RuntimeError("rank 1 fails")
    distributed.barrier()


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(distributed, "_INITIALIZED", False)
    calls = []
    monkeypatch.setattr(distributed.tdist, "init_process_group",
                        lambda **kwargs: calls.append(kwargs))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    return calls


def test_single_host_is_noop(fresh):
    assert distributed.maybe_initialize_distributed(None) is False
    assert distributed.maybe_initialize_distributed({}) is False
    assert distributed.maybe_initialize_distributed({"n_gpus": 8, "n_workers": 4}) is False
    assert fresh == []


def test_full_spec_initializes(fresh):
    cfg = {"coordinator_address": "10.0.0.1:8476", "n_nodes": 4, "node_rank": 2}
    assert distributed.maybe_initialize_distributed(cfg, local_rank=1, local_size=2,
                                                    backend="nccl") is True
    assert fresh == [{"backend": "nccl", "init_method": "tcp://10.0.0.1:8476",
                      "world_size": 8, "rank": 5}]


def test_address_only_is_one_node(fresh):
    assert distributed.maybe_initialize_distributed(
        {"coordinator_address": "host0:1234"}, backend="gloo") is True
    assert fresh == [{"backend": "gloo", "init_method": "tcp://host0:1234",
                      "world_size": 1, "rank": 0}]


def test_second_call_is_noop(fresh):
    cfg = {"coordinator_address": "h:1", "n_nodes": 2, "node_rank": 0}
    assert distributed.maybe_initialize_distributed(cfg, backend="gloo") is True
    assert distributed.maybe_initialize_distributed(cfg, backend="gloo") is True
    assert len(fresh) == 1


def test_n_nodes_without_address_raises(fresh):
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.maybe_initialize_distributed({"n_nodes": 4})


def test_torchrun_environment_joins_by_env(fresh, monkeypatch):
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.torchrun_env() == (3, 4, 1)
    assert distributed.maybe_initialize_distributed({}, backend="gloo") is True
    assert fresh == [{"backend": "gloo", "init_method": "env://"}]
    assert launch.plan({"n_gpus": 1}, "cpu") == launch.Plan(1, {"data": 4}, {"n_gpus": 1})


def test_a_failed_init_raises(tmp_path):
    """No fallback to another backend: an init that fails raises, and the
    process stays outside any group."""
    with pytest.raises((ValueError, AssertionError)):  # torch's own check, by version
        distributed.maybe_initialize_distributed(
            {}, backend="no_such_backend", init_method=f"file://{tmp_path / 'store'}")
    assert not distributed.is_initialized() and not distributed._INITIALIZED


def test_primary_host_single_process():
    assert distributed.process_index() == 0
    assert distributed.is_primary_host()
    assert distributed.broadcast_floats([1.5, None]) == [1.5, None]
    distributed.barrier()


def test_helpers_are_the_identity_outside_a_sharded_step():
    x = torch.randn(3, requires_grad=True)
    assert distributed.sum_over_data(x) is x and distributed.mean_over_data(x) is x
    assert distributed.data_size() == 1
    with distributed.data_parallel(Mesh({"data": 1}, 0, None)):
        assert distributed.sum_over_data(x) is x


# -- on the card ----------------------------------------------------------

def _card_step(spec, images, labels, amp, sharded):
    device = distributed.rank_device() or torch.device("cuda", 0)
    model = load_jax_variables(create_model(spec["name"], **spec["kwargs"]), spec["flat"],
                               strict=True).to(device)
    opt = optim.build_optimizer("SGD", model.parameters(), lr=LR)
    criterion = losses.load_criterion(*spec["criterion"])
    if sharded:
        mesh = make_mesh()
        run = make_sharded_train_step(model, criterion, opt, mesh, amp=amp)
        images, labels = shard_batch(images, mesh), shard_batch(labels, mesh)
    else:
        run = step.make_train_step(model, criterion, opt, amp=amp)
    run(images, labels)
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def _card_spec():
    rng = np.random.RandomState(0)
    model = create_model("DynUNet", **dict(DYNUNET, filters=[16, 32]))
    flat = {}
    for k, p in model.state_dict().items():
        s = tuple(p.shape)
        value = (rng.randn(*s) / np.sqrt(np.prod(s[:-1])) if k.endswith("kernel")
                 else 1.0 + 0.3 * rng.randn(*s) if k.endswith("scale") else 0.1 * rng.randn(*s))
        flat["params/" + k.replace(".", "/")] = value.astype(np.float32)
    return {"name": "DynUNet", "kwargs": dict(DYNUNET, filters=[16, 32]), "flat": flat,
            "criterion": ("DiceLoss", {"sigmoid": True})}


def _update_gap(got, want, before):
    keys = sorted(want)
    return _rel_l2({k: got[k] - before[k] for k in keys},
                   {k: want[k] - before[k] for k in keys}, keys)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_card_world_size_one_over_nccl(amp):
    """(a) The sharded step at one rank over NCCL against the plain step,
    through the kernels, from the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    spec = _card_spec()
    images, labels = _batch(2, 2, 1, size=32)
    before = {k.replace("/", ".")[len("params."):]: v for k, v in spec["flat"].items()}
    want = _card_step(spec, images, labels, amp, sharded=False)
    got = launch.launch(_card_step, (spec, images, labels, amp, True),
                        launch.Plan(1, {"data": 1}, {}), device="cuda", backend="nccl")[0]
    assert _update_gap(got, want, before) < (2e-2 if amp else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_card_two_ranks_over_gloo(amp):
    """(b) Two ranks sharing the card over gloo, one item each, against the
    single-process batch-2 step: the parameter updates within phase 5's
    gradient bound (1e-4 f32, 2e-2 bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    spec = _card_spec()
    images, labels = _batch(2, 2, 1, size=32)
    before = {k.replace("/", ".")[len("params."):]: v for k, v in spec["flat"].items()}
    want = _card_step(spec, images, labels, amp, sharded=False)
    got = launch.launch(_card_step, (spec, images, labels, amp, True),
                        launch.Plan(2, {"data": 2}, {}), device="cuda:0", backend="gloo")
    for ranked in got:
        assert _update_gap(ranked, want, before) < (2e-2 if amp else 1e-4)

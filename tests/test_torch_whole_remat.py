"""Whole-model ``training.remat`` (``models/remat.py``: every block of the
net recomputed in the backward) against the JAX package's ``nn.remat`` of
the whole module, and against the port's own step without it.

- JAX: a small SegResNet built by each package's config factory with
  ``remat`` (JAX wraps the class in ``nn.remat``), the same seeded
  variables, one f32 SGD step of each package's train step on one batch:
  the loss, the gradients and the parameters after within relative L2 1e-5
  / 1e-4 / 1e-5.
- Bit-equal on the CPU (the recompute runs the same ops in the same order
  on the same values): one step's loss, gradients and the state it leaves
  (running statistics, codebook, the noise generator's state), remat against
  no remat, for a BatchNorm net (SegResNetDS: its blocks update running
  statistics), VQVAE in 2 microbatches (the codebook the second takes from
  the first), nets that draw noise (BasicUNet: dropout inside its blocks;
  SegResNetVAE: channel dropout and the VAE's sample), each in f32 and in
  bf16 AMP (the recompute must run on the bf16 copies the forward ran on,
  not the f32 masters the module holds again in the backward). A block that
  holds a codebook (VQVAE's root checkpointed as one block) is bit-equal too.
- The traps, each against a naive checkpoint that runs the recompute on the
  module's own buffers: the running statistics updated twice; the
  recompute reading the updated codebook (other codes, other gradients).
  The backward runs the blocks' FastConvs again; the peak of live tensors
  falls; without gradients the forward is the plain one.
- Every registered net builds with ``remat`` through the config factory
  (on the meta device: no memory, no init cost) with the ``state_dict`` keys
  it has without; DynUNet's blocks are its down, bottleneck and up blocks.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.config import factory as jax_factory
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train import losses as jax_losses
from unet3d_tpu.train import step as jax_step

from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models import layers
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import MODEL_REGISTRY, create_model
from unet3d_tpu_torch.models.remat import (checkpointed_blocks, remat_blocks, remat_class,
                                           whole_model_remat)
from unet3d_tpu_torch.models.vqvae2 import VQVAE as PortVQVAE
from unet3d_tpu_torch.train import losses, optim, step

import chip_smoke
from tools.remat_live_bytes import LiveBytes

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import COMPILE, LR, _sgd_keeping_grads, bn_init
from test_torch_graph import ADJ, REF
from test_torch_myronenko import _all, _flat, _rel, _x

SEGRESNET = {"name": "SegResNet", "init_filters": 8, "in_channels": 2, "out_channels": 3,
             "blocks_down": [1, 2], "blocks_up": [1]}


def _batch(shape=(2, 2, 16, 16, 16), out=3, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(*shape).astype(np.float32)
    labels = (rng.rand(shape[0], out, *shape[2:]) > 0.5).astype(np.float32)
    return images, labels


def test_remat_step_matches_jax_nn_remat():
    """One f32 SGD step of a SegResNet under ``training.remat``: the JAX
    factory wraps the class in ``nn.remat``, the port's recomputes it whole;
    the same variables and batch give the same loss, gradients and
    parameters."""
    config = {"model": dict(SEGRESNET), "dataset": {"desired_shape": [16, 16, 16]}}
    images, labels = _batch()
    x = np.ascontiguousarray(np.moveaxis(images, 1, -1))
    # the variables of the class without remat (nn.remat keeps the tree)
    seeded = bn_init(jax_create_model("SegResNet", **{k: v for k, v in SEGRESNET.items()
                                                      if k != "name"}), x[:1], seed=4)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_factory, "init_params", lambda *a, **k: seeded)
        jmod, variables = jax_factory.build_or_load_model_from_config(config, None, remat=True)
    assert type(jmod).__name__.startswith("Checkpoint")   # flax's nn.remat class
    flat = _flat(variables)
    tx = _sgd_keeping_grads(LR)
    state = jax_step.create_train_state(variables, tx)
    run = jax.jit(jax_step.train_step_body(jmod, jax_losses.DiceLoss(sigmoid=True), tx),
                  compiler_options=COMPILE)
    state, want_loss = run(state, jnp.asarray(images), jnp.asarray(labels))
    want = _flat({"params": state.params})
    want_grads = {k.replace("/", "."): v for k, v in _flat(state.opt_state).items()}
    model = build_or_load_model_from_config(config, None, torch.device("cpu"), remat=True)
    assert checkpointed_blocks(model)
    load_jax_variables(model, flat, strict=True)
    params = dict(model.named_parameters())
    step_fn = step.make_train_step(model, losses.DiceLoss(sigmoid=True),
                                   optim.build_optimizer("SGD", params.values(), lr=LR))
    loss = float(step_fn(images, labels))
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    keys = sorted(params)
    grads = {k: p.grad.numpy() for k, p in params.items()}
    assert _rel(_all(grads, keys), _all(want_grads, keys)) < 1e-4
    ours = model_variables(model)
    keys = sorted(want)
    assert _rel(_all(ours, keys), _all(want, keys)) < 1e-5


VQVAE = {"name": "VQVAE", "in_channel": 2, "channel": 8, "n_res_block": 1,
         "n_res_channel": 4, "embed_dim": 4, "n_embed": 16}
SEGRESNET_DS = {"name": "SegResNetDS", "init_filters": 8, "in_channels": 2,
                "out_channels": 3, "blocks_down": [1, 2]}
SEGRESNET_VAE = {"name": "SegResNetVAE", "input_image_size": [16, 16, 16],
                 "init_filters": 8, "in_channels": 2, "out_channels": 3,
                 "blocks_down": [1, 2], "blocks_up": [1], "vae_nz": 8,
                 "smallest_filters": 4, "dropout_prob": 0.2}
BASIC_UNET = {"name": "BasicUNet", "in_channels": 2, "out_channels": 3,
              "features": [8, 8, 16, 16, 32, 8], "dropout": 0.2}
DICE = lambda: losses.DiceLoss(sigmoid=True)  # noqa: E731
# (model section, criterion, microbatches, the state the step leaves)
CASES = {"SegResNetDS": (SEGRESNET_DS, DICE, 1, "running statistics"),
         "VQVAE": (VQVAE, losses.MSELoss, 2, "codebook"),
         "BasicUNet": (BASIC_UNET, DICE, 1, "noise generator"),
         "SegResNetVAE": (SEGRESNET_VAE, DICE, 1, "noise generator")}


def _step(model_cfg, criterion, accum, amp, remat, images, labels, model=None):
    """One step's forwards and backwards (``accumulate_gradients``) of the
    configured model (seed 2), or of ``model``: the model, the loss, the
    gradients, the buffers after and the noise generator's state after."""
    if model is None:
        config = {"model": dict(model_cfg), "dataset": {"desired_shape": [16, 16, 16]}}
        model = build_or_load_model_from_config(config, None, torch.device("cpu"), seed=2,
                                                remat=remat)
    rng = step.noise_generator(model, seed=7)
    x, y = step.prepare_batch(images, labels, torch.device("cpu"), amp)
    loss = step.accumulate_gradients(model, criterion(), x, y, amp, accum, rng)
    grads = {k: p.grad for k, p in model.named_parameters()}
    buffers = {k: b.clone() for k, b in model.named_buffers()}
    return model, loss, grads, buffers, (rng.get_state() if rng is not None else None)


def _assert_bit_equal(plain, remat, noise):
    assert torch.equal(plain[1], remat[1])
    assert plain[2].keys() == remat[2].keys()
    for key in plain[2]:
        assert remat[2][key].dtype == torch.float32
        assert torch.equal(plain[2][key], remat[2][key]), key
    assert plain[3].keys() == remat[3].keys()
    for key in plain[3]:
        assert torch.equal(plain[3][key], remat[3][key]), key
    if noise:
        assert torch.equal(plain[4], remat[4])


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_step_is_bit_equal(name, amp):
    model_cfg, criterion, accum, state = CASES[name]
    images, labels = _batch()
    labels = images if name == "VQVAE" else labels
    plain = _step(model_cfg, criterion, accum, amp, False, images, labels)
    remat = _step(model_cfg, criterion, accum, amp, True, images, labels)
    assert checkpointed_blocks(remat[0]) and not checkpointed_blocks(plain[0])
    assert bool(plain[3]) == (state in ("running statistics", "codebook"))
    _assert_bit_equal(plain, remat, state == "noise generator")


def _vqvae(root_remat):
    model = create_model("VQVAE", **{k: v for k, v in VQVAE.items() if k != "name"})
    init_parameters(model, torch.Generator().manual_seed(2))
    if root_remat:   # the codebook inside a checkpointed block: the root as one
        model.__class__ = remat_class(PortVQVAE)
    return model


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_a_block_holding_a_codebook_is_bit_equal(amp):
    """The EMA update inside a checkpointed block: the forward updates the
    codebook once, the recompute reads the codebook of before."""
    images, _ = _batch()
    plain = _step(None, losses.MSELoss, 2, amp, False, images, images, model=_vqvae(False))
    remat = _step(None, losses.MSELoss, 2, amp, True, images, images, model=_vqvae(True))
    assert checkpointed_blocks(remat[0]) == [""]
    _assert_bit_equal(plain, remat, False)


def _naive_checkpoint(model, args, kwargs):
    """A checkpoint whose recompute runs on the module's own buffers, as the
    forward left them (and updates them again)."""
    from torch.func import functional_call
    from torch.utils.checkpoint import checkpoint
    names, params = zip(*model.named_parameters())
    n = len(args)

    def run(*inputs):
        model._remat_running = True
        try:
            return functional_call(model, dict(zip(names, inputs[n:])), inputs[:n], kwargs)
        finally:
            model._remat_running = False

    return checkpoint(run, *args, *params, use_reentrant=False, preserve_rng_state=False)


def test_the_state_traps_show_against_a_naive_checkpoint(monkeypatch):
    """A checkpoint that recomputes on the module's buffers updates
    SegResNetDS's running statistics twice, and recomputes VQVAE's block on
    the updated codebook (other codes: other gradients); the remat's own
    checkpoint does neither (``test_remat_step_is_bit_equal``)."""
    from unet3d_tpu_torch.models import remat as remat_module
    images, labels = _batch()
    plain = _step(SEGRESNET_DS, DICE, 1, False, False, images, labels)
    vq_plain = _step(None, losses.MSELoss, 1, False, False, images, images, model=_vqvae(False))
    monkeypatch.setattr(remat_module, "_checkpointed", _naive_checkpoint)
    naive = _step(SEGRESNET_DS, DICE, 1, False, True, images, labels)
    assert torch.equal(plain[1], naive[1])
    assert any(not torch.equal(plain[3][k], naive[3][k]) for k in plain[3])
    vq_naive = _step(None, losses.MSELoss, 1, False, True, images, images, model=_vqvae(True))
    assert torch.equal(vq_plain[1], vq_naive[1])   # the same forward
    assert any(not torch.equal(vq_plain[2][k], vq_naive[2][k]) for k in vq_plain[2])


def _fast_conv_calls(monkeypatch):
    calls = []
    real = layers.conv3d
    monkeypatch.setattr(layers, "conv3d", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_remat_recomputes_the_blocks_and_lowers_the_peak(monkeypatch):
    """SegResNetVAE's step under remat runs its blocks' FastConvs again in
    the backward, each once (the step's calls without remat plus the
    blocks' forward calls, counted by ``chip_smoke.launches_in_blocks``),
    and the peak of live tensors in the step falls (the blocks keep their
    inputs alone); without gradients a remat model runs the plain forward."""
    images, labels = _batch(shape=(1, 2, 32, 32, 32))
    cfg = dict(SEGRESNET_VAE, input_image_size=[32, 32, 32])
    calls = _fast_conv_calls(monkeypatch)
    counts, in_blocks, peaks, evals = {}, {}, {}, {}
    x_eval = torch.from_numpy(np.moveaxis(images, 1, -1).copy())
    for remat in (False, True):
        model = build_or_load_model_from_config({"model": dict(cfg)}, None,
                                                torch.device("cpu"), seed=2, remat=remat)
        x, y = step.prepare_batch(images, labels, torch.device("cpu"), True)
        calls.clear()
        with LiveBytes() as live:
            with chip_smoke.launches_in_blocks(model, lambda: len(calls)) as blocks:
                loss = step.forward_loss(model, DICE(), x, y, True,
                                         step.noise_generator(model, 7))
            loss.backward()
        counts[remat], in_blocks[remat], peaks[remat] = len(calls), blocks[0], live.peak
        calls.clear()
        with torch.no_grad():
            model(x_eval)
        evals[remat] = len(calls)
    assert in_blocks[True] == in_blocks[False] > 0
    assert counts[True] == counts[False] + in_blocks[False]
    assert peaks[True] < 0.75 * peaks[False], peaks
    assert evals[True] == evals[False] > 0


REQUIRED = {"FCN": dict(hidden_layers_list=[8], n_inputs=10, n_outputs=3),
            "GraphCMR": dict(ref_vertices=REF, adjacency_matrix=ADJ),
            "LabeledVariationalAutoEncoder": dict(input_shape=[32, 32, 32]),
            "VariationalAutoEncoder": dict(input_shape=[32, 32, 32]),
            "RegularizedBasicResNet": dict(n_features=1),
            "RegularizedResNet": dict(n_outputs=2, input_shape=[32, 32, 32]),
            "ResNetWithDecoder1D": dict(n_fc_outputs=8, n_outputs=20),
            "SegResNetVAE": dict(input_image_size=[32, 32, 32])}
SPACES = ("TopologyConstruction", "TopologyInstance", "TopologySearch")


@pytest.mark.parametrize("name", sorted(set(MODEL_REGISTRY) - set(SPACES)))
def test_every_net_builds_with_remat_and_keeps_its_keys(name):
    """Through the config factory on the meta device: ``training.remat``
    gives every net its blocks (``remat_blocks``) checkpointed, DynUNet's
    down, bottleneck and up blocks among them (its ``remat`` reads so), with
    the ``state_dict`` keys and shapes of the net without remat."""
    config = {"model": {"name": name, **REQUIRED.get(name, {})},
              "dataset": {"desired_shape": [32, 32, 32]}}
    meta = torch.device("meta")
    with meta:
        plain = build_or_load_model_from_config(copy.deepcopy(config), None, meta)
        remat = build_or_load_model_from_config(copy.deepcopy(config), None, meta, remat=True)
    assert type(remat) is type(plain)
    blocks = {id(m) for m in remat_blocks(remat)}
    assert {id(m) for n, m in remat.named_modules() if n in checkpointed_blocks(remat)} \
        == blocks
    if name == "DynUNet":
        assert remat.remat and not plain.remat
        assert {n for n in checkpointed_blocks(remat)} == {
            "input_block", "downsample0", "downsample1", "downsample2", "downsample3",
            "bottleneck", *(f"upsample{i}" for i in range(5))}
    assert {k: v.shape for k, v in remat.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}


def test_whole_model_remat_keeps_the_classes_and_is_idempotent():
    """A block's remat class is a subclass of its class with its name; a
    second ``whole_model_remat`` changes nothing; a deep copy stays remat;
    the no-grad forward is the plain one."""
    kwargs = {k: v for k, v in SEGRESNET_DS.items() if k != "name"}
    model = create_model("SegResNetDS", **kwargs)
    init_parameters(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        x = torch.from_numpy(_x(1, 16, 16, 16, 2))
        want = model(x)
    block = remat_blocks(model)[0]
    cls = type(block)
    whole_model_remat(model)
    assert type(block).__mro__[1] is cls and type(block).__name__ == cls.__name__
    names = checkpointed_blocks(model)
    whole_model_remat(model)
    assert checkpointed_blocks(model) == names
    assert checkpointed_blocks(copy.deepcopy(model)) == names
    assert list(model.state_dict()) == list(create_model("SegResNetDS", **kwargs).state_dict())
    with torch.no_grad():
        assert torch.equal(model(x), want)

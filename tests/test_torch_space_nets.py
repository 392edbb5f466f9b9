"""The space axis for the SegResNet family, the Myronenko autoencoders and
the BatchNorm U-Nets (``unet3d_tpu_torch/models``: SegResNet, SegResNetVAE,
ConvolutionalAutoEncoder, VariationalAutoEncoder,
LabeledVariationalAutoEncoder, SegResNetDS, AttentionUnet, MONAI UNet)
against the JAX package's ``space`` axis, and the ops they reach across D:
BatchNorm's statistics over the slabs, the transposed convs, the resize of a
D slab and the refusals.

The rank pool is ``tests/test_torch_space.py``'s (four gloo CPU ranks
spawned once for the file; the functions they run are at the top of this
file, which imports no JAX), and so is the pattern: the ranks lay out
``{"space": 4}`` and ``{"data": 2, "space": 2}`` and run
``make_sharded_forward`` and one SGD step (lr 0.1) of
``make_sharded_train_step``; JAX runs its ``make_sharded_forward`` over
``{"space": 4}`` and its single-device and ``{"data": 2, "space": 4}``
steps, all in f32 from the same variables. The nets are cut to widths of
4-32 with four levels on 16 planes (``SHAPE``; three nets with larger H and
W, where JAX's own sharded and single-device steps agree), so at space4 the
2-plane level is replicated and the 4-plane one a slab of one plane; every
draw is taken out of the
comparison (no dropout, ``vae_default_std`` 0, the labelled VAE decoding
its mean through ``MuVAE``), and a separate test holds the sampled
SegResNetVAE and VAE steps on the axis against the port's own
single-device steps from the same seed. Tolerances are
``test_torch_space.py``'s: the forward within 1e-4, the loss within
relative 1e-4, every parameter and running statistic within 1e-5.
"""
import functools

import numpy as np
import pytest
import torch

from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models import layers as L
from unet3d_tpu_torch.models.decoder import MyronenkoDecoder
from unet3d_tpu_torch.models.layers import MyronenkoLayer, init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.models.variational import LabeledVariationalAutoEncoder
from unet3d_tpu_torch.ops.interpolate import resize_ndhwc
from unet3d_tpu_torch.parallel import distributed
from unet3d_tpu_torch.parallel.mesh import (Mesh, make_mesh, make_sharded_forward,
                                            make_sharded_train_step, shard_batch)
from unet3d_tpu_torch.scripts import predict
from unet3d_tpu_torch.train import losses
from unet3d_tpu_torch.train.step import make_train_step

from test_torch_space import (FORWARD_ATOL, LOSS_RTOL, LR, PARAM_ATOL, SLICE, SPECS,
                              _config, ranks)  # noqa: F401 (the module's rank pool)

SHAPE, CHANNELS = (16, 16, 16), 2
# 16 planes in four levels: at space4 the 2-plane level is replicated and
# the 4-plane one a slab of one plane; a net whose JAX steps, sharded and
# single-device, lie more than 1e-5 apart at 16^3 (f32 sums of few values:
# a BatchNorm's deepest statistics, PReLU's one slope, the variational
# layer's norm on the bottleneck) takes a larger H and W where they agree
# (AttentionUnet 3.2e-6, UNet 2.4e-7, the labelled VAE 6.8e-6)
WIDE, WIDER, TALL = (16, 32, 32), (16, 48, 48), (16, 32, 16)
LEVELS4 = dict(blocks_down=[1, 1, 1, 1], blocks_up=[1, 1, 1])
SEGRESNET = dict(init_filters=4, in_channels=CHANNELS, out_channels=2, **LEVELS4)
VAE = dict(SEGRESNET, input_image_size=list(SHAPE), vae_default_std=0.0, vae_nz=8,
           smallest_filters=4)
CODER = dict(n_features=CHANNELS, base_width=4, encoder_blocks=[1, 1, 1, 1],
             decoder_blocks=[1, 1, 1], n_outputs=2)
VARIATIONAL = dict(CODER, input_shape=list(SHAPE), n_reduced_latent_feature_maps=4,
                   vae_features=8)
BN_UNET = dict(in_channels=CHANNELS, out_channels=2, channels=[4, 8, 8, 16],
               strides=[2, 2, 2])
# name: (registry name, kwargs, criterion, input shape); "MuVAE" is the
# labelled VAE decoding its mean (sample=False) in both packages
NETS = {
    "SegResNet": ("SegResNet", SEGRESNET, "dice", SHAPE),
    "SegResNetVAE": ("SegResNetVAE", VAE, "dice", SHAPE),
    "MuVAE": ("LabeledVariationalAutoEncoder", dict(VARIATIONAL, input_shape=list(TALL)),
              "dice", TALL),
    "SegResNetDS": ("SegResNetDS", dict(init_filters=4, in_channels=CHANNELS, out_channels=2,
                                        blocks_down=[1, 1, 1, 1], dsdepth=2), "dice", SHAPE),
    "AttentionUnet": ("AttentionUnet", BN_UNET, "dice", WIDE),
    "UNet": ("UNet", dict(BN_UNET, num_res_units=1, norm="batch"), "dice", WIDER),
}
BN_NETS = ("SegResNetDS", "AttentionUnet", "UNet")
FORWARD_ONLY = {name: (name, kwargs, None, SHAPE) for name, kwargs in (
    ("ConvolutionalAutoEncoder", CODER), ("VariationalAutoEncoder", VARIATIONAL))}


class MuVAE(LabeledVariationalAutoEncoder):
    """The labelled VAE decoding its mean in training too (the exact path:
    ``jax.random``'s draws cannot be matched)."""

    def forward(self, x, train=False, sample=None, rng=None):
        return super().forward(x, train=train, sample=False, rng=rng)


def criterion(kind):
    return losses.VAELoss("MSELoss") if kind == "vae" else losses.DiceLoss(sigmoid=True)


# -- the ranks' side: no JAX here -------------------------------------------

def port_net(name, flat, dropout=False):
    """The port's net with ``flat``'s variables (its Myronenko layers'
    channel dropout off unless ``dropout``)."""
    registry_name, kwargs, _, _ = {**NETS, **FORWARD_ONLY}[name]
    model = MuVAE(**kwargs) if name == "MuVAE" else create_model(registry_name, **kwargs)
    load_jax_variables(model, flat, strict=True)
    for m in model.modules():
        if isinstance(m, MyronenkoLayer) and not dropout:
            m.dropout = None
    return model


def port_space(name, flat, spec, x, images, labels):
    """The sharded forward of ``x`` and one sharded SGD step on ``spec``:
    (forward, loss, the variables after the step)."""
    mesh = make_mesh(spec)
    model = port_net(name, flat)
    forward = make_sharded_forward(model, mesh)(torch.from_numpy(x)).numpy()
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    step = make_sharded_train_step(model, criterion(NETS[name][2]), opt, mesh)
    loss = step(shard_batch(images, mesh), shard_batch(labels, mesh))
    return forward, float(loss), model_variables(model)


def port_forward(name, flat, x):
    """The sharded forward of ``x`` on ``{"space": 4}``."""
    return make_sharded_forward(port_net(name, flat), make_mesh("space4"))(
        torch.from_numpy(x)).numpy()


def port_sampled_step(name, kwargs, images, labels):
    """One SGD step with the noise drawn (channel dropout 0.2, the latent's
    draw), on ``{"space": 4}`` and on one device (the rank's own, from the
    same seed): (losses, variables after)."""
    out = []
    for sharded in (True, False):
        model = create_model(name, **kwargs)
        init_parameters(model, torch.Generator().manual_seed(5))
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        kind = "vae" if "Variational" in name else "dice"
        if sharded:
            mesh = make_mesh("space4")
            step = make_sharded_train_step(model, criterion(kind), opt, mesh)
            loss = step(shard_batch(images, mesh), shard_batch(labels, mesh))
        else:
            loss = make_train_step(model, criterion(kind), opt)(images, labels)
        out.append((float(loss), model_variables(model)))
    return out


def _slab_mesh():
    mesh = make_mesh("space4")
    return mesh, mesh.space_rank


def _whole_and_slab(shape, seed, rank, offset=0.0):
    whole = np.random.RandomState(seed).randn(*shape).astype(np.float32) + offset
    depth = shape[1] // 4
    return torch.from_numpy(whole), torch.from_numpy(whole[:, rank * depth:(rank + 1) * depth])


def batch_norm_slabs():
    """BatchNorm in training on this rank's slab of a (2, 8, 3, 4, 5) volume
    on ``{"space": 4}`` and on the whole volume (one device, and inside
    ``replicated()`` on the axis): (slab output, whole output sliced,
    running mean / var after each, the replicated output and statistics,
    the whole volume's)."""
    mesh, rank = _slab_mesh()
    whole, slab = _whole_and_slab((2, 8, 3, 4, 5), 1, rank, offset=1.5)
    out = {}
    for key in ("slab", "whole", "replicated"):
        bn = L.BatchNorm(5)
        init_parameters(bn, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            bn.scale.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(generator=gen)
        if key == "whole":
            y = bn(whole, True)[:, 2 * rank:2 * rank + 2]
        else:
            with distributed.space_parallel(mesh), distributed.replicated(key == "replicated"):
                y = bn(slab if key == "slab" else whole, True)
        out[key] = (y.detach().numpy(), bn.mean.numpy().copy(), bn.var.numpy().copy())
    return out


def transposed_slabs(kind):
    """A transposed conv (``kind``: "overlap", MONAI's kernel 3, stride 2,
    output padding 1; "subpixel", kernel 2 stride 2) on this rank's slab of
    a (1, 8, 3, 4, 3) volume on ``{"space": 4}`` and on the whole volume:
    the slab output and the whole output's slice; the slab's input gradient
    and the whole's slice; this rank's kernel gradient and the whole's."""
    mesh, rank = _slab_mesh()
    whole, slab = _whole_and_slab((1, 8, 3, 4, 3), 2, rank)
    op = (1 if kind == "overlap" else 0)
    module = L.transposed_conv(3, 4, 3 if op else 2, 2, output_padding=op)
    init_parameters(module, torch.Generator().manual_seed(1))
    with torch.no_grad():
        module.bias.normal_(generator=torch.Generator().manual_seed(7))
    g = torch.from_numpy(np.random.RandomState(3).randn(1, 16, 6, 8, 4).astype(np.float32))
    whole.requires_grad_()
    y_whole = module(whole)
    (y_whole * g).sum().backward()
    want = (y_whole.detach()[:, 4 * rank:4 * rank + 4].numpy(),
            whole.grad[:, 2 * rank:2 * rank + 2].numpy(), module.kernel.grad.numpy().copy())
    module.zero_grad()
    slab.requires_grad_()
    with distributed.space_parallel(mesh):
        y = module(slab)
    (y * g[:, 4 * rank:4 * rank + 4]).sum().backward()
    return (y.detach().numpy(), slab.grad.numpy(), module.kernel.grad.numpy()), want


def resize_slabs(factor, mode):
    """``resize_ndhwc`` of this rank's slab of a (1, 8, 3, 2, 2) volume by
    ``factor`` on D (and H) on ``{"space": 4}``, and of the whole volume:
    (slab output, whole output's slice, the slab's input gradient, the
    whole's slice)."""
    mesh, rank = _slab_mesh()
    whole, slab = _whole_and_slab((1, 8, 3, 2, 2), 4, rank)
    out_whole = (8 * factor, 3 * factor, 2)
    d = 2 * factor
    g = torch.from_numpy(np.random.RandomState(5).randn(1, *out_whole, 2).astype(np.float32))
    whole.requires_grad_()
    y_whole = resize_ndhwc(whole, out_whole, mode)
    (y_whole * g).sum().backward()
    slab.requires_grad_()
    with distributed.space_parallel(mesh):
        y = resize_ndhwc(slab, (d, *out_whole[1:]), mode)
    (y * g[:, rank * d:(rank + 1) * d]).sum().backward()
    return (y.detach().numpy(), y_whole.detach()[:, rank * d:(rank + 1) * d].numpy(),
            slab.grad.numpy(), whole.grad[:, 2 * rank:2 * rank + 2].numpy())


# -- against JAX ----------------------------------------------------------

def _inputs(shape=SHAPE):
    rng = np.random.RandomState(0)
    x = rng.rand(1, *shape, CHANNELS).astype(np.float32)
    images = rng.rand(2, CHANNELS, *shape).astype(np.float32)
    labels = (rng.rand(2, 2, *shape) > 0.5).astype(np.float32)
    return x, images, labels


def _jax_module(name):
    from unet3d_tpu.models import variational as jax_variational
    from unet3d_tpu.models.registry import create_model as jax_create_model

    registry_name, kwargs, _, _ = {**NETS, **FORWARD_ONLY}[name]
    if name != "MuVAE":
        return jax_create_model(registry_name, **kwargs)

    class JaxMuVAE(jax_variational.LabeledVariationalAutoEncoder):
        def __call__(self, x, train=False, sample=None):
            return super().__call__(x, train=train, sample=False)

    return JaxMuVAE(**{k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()})


def _shape(name):
    return {**NETS, **FORWARD_ONLY}[name][3]


@functools.lru_cache(maxsize=None)
def _flat_variables(name):
    from test_torch_batchnorm import bn_init, no_dropout
    from test_torch_myronenko import _flat

    with no_dropout():
        return _flat(bn_init(_jax_module(name), _inputs(_shape(name))[0]))


@functools.lru_cache(maxsize=None)
def jax_forward(name):
    """JAX's ``make_sharded_forward`` over {"space": 4} (one item), f32."""
    import jax
    from jax.sharding import NamedSharding

    from unet3d_tpu.parallel import mesh as jax_mesh
    from unet3d_tpu.train import step as jax_step

    from test_torch_batchnorm import _sgd_keeping_grads, no_dropout
    from test_torch_parallel import _tree

    x = _inputs(_shape(name))[0]
    with no_dropout():
        mesh = jax_mesh.make_mesh({"data": 1, "space": 4})
        out = jax_mesh.make_sharded_forward(_jax_module(name), mesh)(
            jax_step.create_train_state(_tree(_flat_variables(name)), _sgd_keeping_grads(LR)),
            jax.device_put(x, NamedSharding(mesh, jax_mesh.ndhwc_batch_spec(mesh))))
    return np.asarray(out)


@functools.lru_cache(maxsize=None)
def jax_steps(name):
    """JAX's SGD step single-device and sharded over {"data": 2, "space":
    4}: (losses, variables after each, params and batch_stats), f32."""
    from unet3d_tpu.parallel import mesh as jax_mesh
    from unet3d_tpu.train import losses as jax_losses
    from unet3d_tpu.train import step as jax_step

    from test_torch_batchnorm import _sgd_keeping_grads, no_dropout
    from test_torch_myronenko import _flat
    from test_torch_parallel import _tree

    jmod = _jax_module(name)
    _, images, labels = _inputs(_shape(name))
    tx = _sgd_keeping_grads(LR)
    loss_fn = (jax_losses.VAELoss("MSELoss") if NETS[name][2] == "vae"
               else jax_losses.DiceLoss(sigmoid=True))
    grid = jax_mesh.make_mesh({"data": 2, "space": 4})
    out = []
    with no_dropout():
        for run, shard in ((jax_step.make_train_step(jmod, loss_fn, tx), lambda a: a),
                           (jax_mesh.make_sharded_train_step(jmod, loss_fn, tx, grid),
                            functools.partial(jax_mesh.shard_batch, mesh=grid))):
            state = jax_step.create_train_state(_tree(_flat_variables(name)), tx)
            state, loss = run(state, shard(images), shard(labels))
            out.append((float(loss), _flat({"params": state.params, **state.extra_variables})))
    return out


@functools.lru_cache(maxsize=None)
def port_runs(ranks, name, spec):  # noqa: F811 (the pool fixture)
    """The ranks' ``port_space``; JAX's runs of the net are made meanwhile."""
    ranks.submit(port_space, name, _flat_variables(name), spec, *_inputs(_shape(name)))
    jax_forward(name)
    jax_steps(name)
    return ranks.collect()


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", list(NETS))
def test_space_forward_matches_jax(ranks, name, spec):  # noqa: F811
    """The port's D-sharded forward, gathered on every rank, against JAX's
    ``make_sharded_forward``."""
    for forward, *_ in port_runs(ranks, name, spec):
        np.testing.assert_allclose(forward, jax_forward(name), atol=FORWARD_ATOL, rtol=0)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", list(NETS))
def test_space_step_matches_jax(ranks, name, spec):  # noqa: F811
    """One SGD step: the loss within relative 1e-4 and every parameter (and
    the BatchNorm nets' running statistics) within 1e-5 of JAX's
    single-device step and of its sharded step at {"data": 2, "space": 4};
    every rank holds the same variables."""
    got = port_runs(ranks, name, spec)
    first = got[0]
    for loss, want in jax_steps(name):
        np.testing.assert_allclose(first[1], loss, rtol=LOSS_RTOL)
        assert any(k.startswith("batch_stats/") for k in want) == (name in BN_NETS)
        for key, value in want.items():
            np.testing.assert_allclose(first[2][key], value, atol=PARAM_ATOL, rtol=0,
                                       err_msg=key)
    for other in got[1:]:
        assert other[1] == first[1]
        assert all(np.array_equal(other[2][k], first[2][k]) for k in first[2])


@pytest.mark.parametrize("name", list(FORWARD_ONLY))
def test_autoencoder_space_forward_matches_jax(ranks, name):  # noqa: F811
    """ConvolutionalAutoEncoder and VariationalAutoEncoder (the mean decoded
    in eval): one D-sharded forward at space4 against JAX's."""
    got = ranks.run(port_forward, name, _flat_variables(name), _inputs()[0])
    for forward in got:
        np.testing.assert_allclose(forward, jax_forward(name), atol=FORWARD_ATOL, rtol=0)


@pytest.mark.parametrize("name,kwargs", [
    ("SegResNetVAE", dict(VAE, vae_default_std=0.3, dropout_prob=0.2)),
    ("LabeledVariationalAutoEncoder", VARIATIONAL)], ids=["SegResNetVAE", "VAE"])
def test_sampled_step_matches_one_device(ranks, name, kwargs):  # noqa: F811
    """With the noise drawn (SegResNetVAE's channel dropout and latent draw,
    the VAE's level-0 channel dropout and latent sample), the D-sharded step
    at space4 equals the port's single-device step from the same seed: every
    rank of the line draws alike. Loss within relative 1e-4, parameters
    within 1e-5."""
    _, images, labels = _inputs()
    for (loss, after), (want_loss, want) in ranks.run(port_sampled_step, name, kwargs,
                                                       images, labels):
        np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
        for key, value in want.items():
            np.testing.assert_allclose(after[key], value, atol=PARAM_ATOL, rtol=0,
                                       err_msg=key)


# -- the ops --------------------------------------------------------------

def test_batch_norm_statistics_over_the_slabs(ranks):  # noqa: F811
    """On the axis BatchNorm's training statistics are the whole volume's
    (its output the whole volume's output, sliced; the running averages the
    whole's on every rank); inside ``replicated()`` it normalises the whole
    volume as one device does."""
    for got in ranks.run(batch_norm_slabs):
        want_y, want_mean, want_var = got["whole"]
        y, mean, var = got["slab"]
        np.testing.assert_allclose(y, want_y, atol=1e-5, rtol=0)
        np.testing.assert_allclose(mean, want_mean, atol=1e-6, rtol=0)
        np.testing.assert_allclose(var, want_var, atol=1e-6, rtol=0)
        y, mean, var = got["replicated"]
        assert y.shape[1] == 8
        np.testing.assert_allclose(mean, want_mean, atol=1e-6, rtol=0)
        np.testing.assert_allclose(var, want_var, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["overlap", "subpixel"])
def test_transposed_conv_slabs_are_the_whole_volumes(ranks, kind):  # noqa: F811
    """The overlapping transposed conv (kernel 3, stride 2, output padding
    1: the plane above from the halo, a zero plane at the volume's top) and
    the subpixel one (local) on each rank's slab, the volume's edges
    included, equal the whole volume's output sliced; the slab's input
    gradient is the whole's slice and the ranks' kernel gradients sum to
    the whole's (the adjoint)."""
    got = ranks.run(transposed_slabs, kind)
    for (y, dx, _), (want_y, want_dx, _) in got:
        np.testing.assert_allclose(y, want_y, atol=SLICE * np.abs(want_y).max(), rtol=0)
        np.testing.assert_allclose(dx, want_dx, atol=SLICE * np.abs(want_dx).max(), rtol=0)
    dw, want_dw = sum(r[0][2] for r in got), got[0][1][2]
    np.testing.assert_allclose(dw, want_dw, atol=SLICE * np.abs(want_dw).max(), rtol=0)


@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
@pytest.mark.parametrize("factor", [2, 4])
def test_resize_of_a_slab_is_the_whole_volumes(ranks, factor, mode):  # noqa: F811
    """``resize_ndhwc`` of a D slab by an integer factor (the neighbours'
    planes from the halo, the whole volume's coordinates) equals the whole
    volume's resize sliced, forward and input gradient, at every rank."""
    for y, want_y, dx, want_dx in ranks.run(resize_slabs, factor, mode):
        np.testing.assert_allclose(y, want_y, atol=1e-6, rtol=0)
        np.testing.assert_allclose(dx, want_dx, atol=1e-5, rtol=0)


def _fake_axis():
    """A space axis of 2 without a process group: enough to reach the
    refusals, which come before any collective."""
    return distributed.space_parallel(Mesh({"space": 2}, 0, None, 0, object(), object()))


def test_forms_without_a_space_form_raise():
    """On a space axis above 1 a conv that reads its neighbours' planes
    (``layers.Conv`` off its local form), a transposed conv other than the
    halo form, a resize by a non-integer factor and the decoders'
    odd-output transposed-conv upsampling raise naming ROADMAP.md: no
    slab-local result comes back. ``layers.Conv``'s local form and the
    same ops off the axis run."""
    x = torch.zeros(1, 4, 4, 4, 2)
    cases = [L.Conv(2, 2, 3, padding=1), L.Conv(2, 2, (3, 1, 1), padding=(1, 0, 0)),
             L.Conv(2, 2, 3, padding=2, dilation=2), L.Conv(2, 2, 1, strides=2),
             L.transposed_conv(2, 2, 3, 1), L.transposed_conv(2, 2, 3, 2)]
    for module in cases:
        init_parameters(module, torch.Generator().manual_seed(0))
        with _fake_axis(), pytest.raises(NotImplementedError, match="ROADMAP.md"):
            module(x)
        assert module(x).shape[0] == 1  # off the axis it runs
    local = L.Conv(2, 3, 1)
    init_parameters(local, torch.Generator().manual_seed(0))
    with _fake_axis():
        assert local(x).shape == (1, 4, 4, 4, 3)
    with _fake_axis(), pytest.raises(NotImplementedError, match="ROADMAP.md"):
        resize_ndhwc(x, (6, 4, 4))
    decoder = MyronenkoDecoder(2, base_width=2, layer_blocks=[1],
                               use_transposed_convolutions=True)
    with _fake_axis(), pytest.raises(NotImplementedError, match="ROADMAP.md"):
        decoder(x, levels=[True, True])


@pytest.mark.parametrize("name", ["VNet", "BasicUNet", "UNETR"])
def test_nets_without_a_space_form_still_raise(name):
    """VNet, the MONAI conv stacks and the transformers keep no space form:
    the sharded steps and forward raise naming ROADMAP.md, and the message
    lists the nets that run D-sharded."""
    model_class = predict.MODEL_REGISTRY[name]
    mesh = Mesh({"space": 2}, 0, None, 0, object(), object())
    from unet3d_tpu_torch.parallel.mesh import check_space_form
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as raised:
        check_space_form(model_class, mesh.space)
    for net in ("SegResNetVAE", "SegResNetDS", "AttentionUnet", "UNet"):
        assert net in str(raised.value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        predict.predict_plan(_config(name), {"mesh": "space2"}, "cpu")

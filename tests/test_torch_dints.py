"""The port's DiNTS, its topology spaces and its ops against the JAX
package's, with the JAX variables (``test_torch_batchnorm.bn_init``; the
architecture logits too) carried across strictly.

Retrain mode: ``channel_mul`` 0.25 (filters 4, 8, 16), 2 blocks, 3 depths
at 16^3, batch 2, one ``arch_code`` that runs all five ops (skip, 3^3 and
the three pseudo-3D pairs), both resizes and leaves depth 2 dark (no input
in either block: the decoder skips it). Search mode: ``TopologySearch``
with 2 blocks and 2 depths, all five ops on every edge weighted by
``softmax(log_alpha_c)`` and ``sigmoid(log_alpha_a)``. Tolerances,
relative L2, through ``tests/test_torch_batchnorm.py``'s helpers: eval and
training forwards 1e-5 in f32, 2e-2 in bf16 (the AMP eval step, JAX's own
bf16 distance allowed for); the first train step's gradients 1e-4 in f32,
against JAX and JAX's f64 evaluation with JAX's own error allowed for, and
the retrain net's bf16 gradients no further from JAX's f32 than 1.25x
JAX's own; two SGD steps through ``make_train_step`` 1e-5; every module's
output dtype under AMP as Flax's captured intermediates. The supernet's
bf16 weighting (the logits cast to bf16 under AMP, as every parameter, so
the sigmoid and softmax run in bf16) is held on the edge sums alone: JAX's
AMP train step of the supernet compiles for ~50 s on the CPU. Unit pins:
``head_up`` against Flax's ``nn.ConvTranspose`` (SAME, kernel = stride: the subpixel form, taps
flipped), the resize against ``jax.image.resize`` in f32 and bf16 (values
and dtype), ``TopologySearch``'s numpy analysis and decode against JAX's on
the same logits, the logits' initialisers, the raises, the ``.npz`` both
ways.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from unet3d_tpu.models import dints as jax_dints
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train import checkpoint as jax_ckpt

from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models import dints
from unet3d_tpu_torch.models.layers import SubpixelConvTranspose, init_parameters
from unet3d_tpu_torch.models.registry import NOT_YET_PORTED, create_model
from unet3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import (F32, Net, bn_init, check_amp_eval_step, check_dtype_flow,
                                  check_forwards, check_grads, check_train_steps)
from test_torch_myronenko import _flat, _rel, _x

SHAPE = (2, 16, 16, 16, 2)
# edges of 3 depths: 0: 0->0, 1: 1->0, 2: 0->1, 3: 1->1, 4: 2->1, 5: 1->2, 6: 2->2
ARCH = ([[1, 1, 1, 1, 1, 0, 0], [1, 0, 1, 1, 0, 0, 0]],
        [[0, 1, 2, 3, 4, 1, 1], [4, 1, 3, 2, 1, 1, 1]])
SPACE = dict(channel_mul=0.25, num_blocks=2, num_depths=3)
NETS = {
    "instance": dict(in_channels=2, num_classes=3, dints_space=dict(SPACE, arch_code=ARCH)),
    "search": dict(in_channels=2, num_classes=3,
                   dints_space=dict(SPACE, num_depths=2, search=True)),
}


@functools.lru_cache(maxsize=None)
def _net(key):
    return Net("DiNTS", NETS[key], SHAPE)


@pytest.mark.parametrize("key", sorted(NETS))
def test_forwards_match_jax(key):
    check_forwards(_net(key))


@pytest.mark.parametrize("key,amp", [("instance", False), ("instance", True), ("search", False)],
                         ids=["instance", "instance_bf16", "search"])
def test_gradients_match_jax(key, amp):
    check_grads(_net(key), amp)


@pytest.mark.parametrize("key", sorted(NETS))
def test_train_steps_match_jax(key):
    check_train_steps(_net(key), 1)


def test_amp_eval_step_matches_jax():
    check_amp_eval_step(_net("instance"))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", sorted(NETS))
def test_amp_dtype_flow_matches_jax(key, train):
    check_dtype_flow(_net(key), train)


def test_architecture_logits_train_under_amp():
    """The supernet's logits are root parameters; the AMP step runs the
    forward on their bf16 copies, as on every parameter, and both receive
    gradients."""
    n = _net("search")
    model = n.port()
    assert {"log_alpha_a", "log_alpha_c"} <= {k for k, _ in model.named_parameters()}
    seen = []
    real = dints._softmax

    def softmax(x):
        seen.append(x.dtype)
        return real(x)

    from unet3d_tpu_torch.train import losses, optim, step
    run = step.make_train_step(model, losses.DiceLoss(sigmoid=True),
                               optim.build_optimizer("SGD", model.parameters(), lr=0.1), amp=True)
    with mock.patch.object(dints, "_softmax", softmax):
        run(*n.batches[0])
    assert seen == [torch.bfloat16]
    for p in (model.log_alpha_a, model.log_alpha_c):
        assert p.dtype == torch.float32 and float(p.grad.abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_search_weighting_matches_jax(dtype):
    """The supernet's edge sums: ``sigmoid(log_alpha_a)`` times the
    ``softmax(log_alpha_c)``-weighted sum of the five ops' outputs, in the
    logits' dtype (bf16 under AMP, as in JAX's step): values, dtype and the
    logits' gradients (f32 1e-6, bf16 2e-2)."""
    rng = np.random.RandomState(12)
    log_a, log_c = rng.randn(2, 4), rng.randn(2, 4, 5)
    ys, g = rng.randn(4, 5, 6, 3), rng.randn(2, 6, 3)

    def edges(a, c, y, sigmoid, softmax):
        p_a, w_c = sigmoid(a), softmax(c)
        return [sum(p_a[b, e] * sum(w_c[b, e, op] * y[e, op] for op in range(5))
                    for e in range(4)) for b in range(2)]

    jd = jnp.dtype(dtype)

    def jax_loss(a, c):
        out = edges(a, c, jnp.asarray(ys, jd), jax.nn.sigmoid,
                    lambda v: jax.nn.softmax(v, axis=-1))
        return sum((o.astype(jnp.float32) * g[b]).sum() for b, o in enumerate(out)), out[0]

    (want, want_out), (want_a, want_c) = jax.jit(jax.value_and_grad(
        jax_loss, (0, 1), has_aux=True))(jnp.asarray(log_a, jd), jnp.asarray(log_c, jd))
    td = getattr(torch, dtype)
    a = torch.tensor(log_a, dtype=td, requires_grad=True)
    c = torch.tensor(log_c, dtype=td, requires_grad=True)
    out = edges(a, c, torch.tensor(ys, dtype=td), torch.sigmoid, dints._softmax)
    sum((o.float() * torch.from_numpy(g).float()[b]).sum() for b, o in enumerate(out)).backward()
    assert out[0].dtype == td and want_out.dtype == jd and a.grad.dtype == td
    bound = 1e-6 if dtype == "float32" else 2e-2
    assert _rel(out[0].float().detach().numpy(), np.asarray(want_out, np.float32)) < bound
    assert _rel(a.grad.float().numpy(), np.asarray(want_a, np.float32)) < bound
    assert _rel(c.grad.float().numpy(), np.asarray(want_c, np.float32)) < bound


def test_other_topologies_match_jax():
    """The default full topology (every edge conv_3x3x3) and a code whose
    depth 2 goes dark after block 0 and comes back in block 1 (its decoder
    head upsampled x4), eval forwards in f32."""
    dark_middle = ([[1, 1, 1, 1, 1, 0, 0], [1, 0, 1, 1, 0, 1, 0]], ARCH[1])
    for space in (SPACE, dict(SPACE, arch_code=dark_middle)):
        kwargs = dict(in_channels=2, num_classes=3, dints_space=space)
        x = _x(*SHAPE, seed=7)
        jmod = jax_create_model("DiNTS", **kwargs)
        variables = bn_init(jmod, x)
        want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
        model = load_jax_variables(create_model("DiNTS", **kwargs), _flat(variables))
        assert model.live == [True] * 3
        with torch.no_grad():
            assert _rel(model(torch.from_numpy(x)).numpy(), want) < F32
    assert _net("instance").port().live == [True, True, False]


def test_head_up_matches_flax_conv_transpose():
    """``head_up`` is Flax's ``nn.ConvTranspose((2, 2, 2), strides 2)`` with
    its default SAME padding and a bias: the subpixel form, taps flipped
    (forward and the gradients of the input, kernel and bias, f32)."""
    x = _x(2, 3, 4, 5, 6, seed=8)
    flax_up = fnn.ConvTranspose(4, (2, 2, 2), strides=(2, 2, 2))
    variables = bn_init(flax_up, x)
    g = _x(2, 6, 8, 10, 4, seed=9)

    def loss(v, xx):
        return (flax_up.apply(v, xx) * g).sum()

    out = jax.jit(flax_up.apply)(variables, jnp.asarray(x))
    want_v, want_x = jax.jit(jax.grad(loss, (0, 1)))(variables, jnp.asarray(x))
    up = SubpixelConvTranspose(6, 4, (2, 2, 2))
    load_jax_variables(up, _flat(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = up(xt)
    (got * torch.from_numpy(g)).sum().backward()
    assert got.shape == out.shape
    assert _rel(got.detach().numpy(), out) < 1e-6
    assert _rel(xt.grad.numpy(), want_x) < 1e-6
    assert _rel(up.kernel.grad.numpy(), want_v["params"]["kernel"]) < 1e-6
    assert _rel(up.bias.grad.numpy(), want_v["params"]["bias"]) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [2, 4])
def test_resize_matches_jax_image_resize(factor, dtype):
    """``jax.image.resize(..., "trilinear")`` upsampling: half-pixel centres,
    the weights renormalised at the edges (the edge value), the output in
    the input's dtype; f32 within 1e-6, bf16 within one rounding per axis."""
    x = _x(2, 3, 4, 5, 3, seed=10)
    shape = (2, 3 * factor, 4 * factor, 5 * factor, 3)
    want = jax.jit(lambda v: jax.image.resize(v, shape, method="trilinear"))(
        jnp.asarray(x, dtype))
    got = dints._resize(torch.from_numpy(x).to(getattr(torch, dtype)), factor)
    assert str(got.dtype) == f"torch.{dtype}" and want.dtype == jnp.dtype(dtype)
    bound = 1e-6 if dtype == "float32" else 8e-3
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < bound


def test_topology_search_analysis_matches_jax():
    """``get_prob_a``, ``get_topology_entropy``, ``get_ram_cost_usage`` and
    the Viterbi ``decode`` give JAX's values on the same logits; the decoded
    code builds a ``TopologyInstance`` in both."""
    rng = np.random.RandomState(11)
    for num_depths in (2, 3):
        space = dints.TopologySearch(num_blocks=4, num_depths=num_depths, channel_mul=0.5)
        jspace = jax_dints.TopologySearch(num_blocks=4, num_depths=num_depths, channel_mul=0.5)
        n_e = len(space.edges)
        assert space.edges == jspace.edges and space.filter_nums == jspace.filter_nums
        log_a = rng.randn(4, n_e).astype(np.float32)
        log_c = rng.randn(4, n_e, 5).astype(np.float32)
        np.testing.assert_array_equal(space.get_prob_a(log_a), jspace.get_prob_a(log_a))
        assert space.get_topology_entropy(log_a) == jspace.get_topology_entropy(log_a)
        for full in (False, True):
            assert (space.get_ram_cost_usage((1, 4, 96, 96, 96), log_a, full)
                    == jspace.get_ram_cost_usage((1, 4, 96, 96, 96), log_a, full))
        decoded = space.decode(log_a, log_c)
        assert decoded == jspace.decode(log_a, log_c)
        code_a, code_c, node_a = decoded
        instance = dints.TopologyInstance(arch_code=(code_a, code_c), num_blocks=4,
                                          num_depths=num_depths, channel_mul=0.5)
        assert instance.node_active == jax_dints.TopologyInstance(
            arch_code=(code_a, code_c), num_blocks=4, num_depths=num_depths,
            channel_mul=0.5).node_active
        assert [[int(v) for v in row] for row in instance.node_active] == node_a


def test_initialisers_and_checkpoint_both_ways(tmp_path):
    """``log_alpha_a`` zeros and ``log_alpha_c`` normal(1e-3), Flax's; a JAX
    ``.npz`` of the supernet (root ``params/log_alpha_*``) loads strictly
    into the port and the port's file into the JAX tree with equal arrays."""
    n = _net("search")
    model = create_model("DiNTS", **n.kwargs)
    init_parameters(model, torch.Generator().manual_seed(0))
    assert torch.equal(model.log_alpha_a, torch.zeros(2, 4))
    logits = model.log_alpha_c.detach().numpy()
    assert logits.shape == (2, 4, 5) and 0 < np.abs(logits).max() < 6e-3
    big = create_model("DiNTS", dints_space=dict(search=True))
    init_parameters(big, torch.Generator().manual_seed(1))
    assert abs(float(big.log_alpha_c.detach().std()) - 1e-3) < 2e-4
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(n.variables, path)
    flat = load_checkpoint(path)
    model = load_jax_variables(model, flat, strict=True)
    ours = model_variables(model)
    assert set(ours) == set(flat) and "params/log_alpha_c" in ours
    assert list(model.buffers()) == []
    out = str(tmp_path / "port.npz")
    save_checkpoint(model, out)
    loaded = jax_ckpt.load_into(n.variables, out, strict=True)
    for key, value in _flat(loaded).items():
        np.testing.assert_array_equal(value, flat[key])


def test_names_and_invalid_topologies_raise_in_both():
    for name in ("DiNTS", "TopologyInstance", "TopologySearch", "TopologyConstruction"):
        assert name not in NOT_YET_PORTED
    assert isinstance(create_model("TopologyConstruction"), dints.TopologyInstance)
    assert isinstance(create_model("TopologySearch", num_depths=2), dints.TopologySearch)
    assert len(create_model("TopologyInstance").edges) == 7
    default = create_model("DiNTS", in_channels=4, num_classes=3)
    assert sum(k.endswith("conv0.kernel") for k, _ in default.named_parameters()) == 42
    # an edge from a node that is dark after block 0
    bad = ([[1, 1, 1, 1, 1, 0, 0], [1, 0, 1, 1, 1, 0, 0]], ARCH[1])
    for module in (dints, jax_dints):
        with pytest.raises(ValueError, match="no active input path"):
            module.TopologyInstance(arch_code=bad, **SPACE)
        with pytest.raises(ValueError, match="no active edges"):
            module.TopologyInstance(arch_code=([[0] * 7, [1] * 7], ARCH[1]), **SPACE)
    x = np.zeros((1, 12, 16, 16, 2), np.float32)  # 12 is no multiple of 2**3
    with pytest.raises(ValueError, match="divisible"):
        create_model("DiNTS", **NETS["instance"])(torch.from_numpy(x))
    jmod = jax_create_model("DiNTS", **NETS["instance"])
    with pytest.raises(ValueError, match="divisible"):
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    with pytest.raises(NotImplementedError):
        create_model("DiNTS", spatial_dims=2)

"""The port's DynUNet and layers against the JAX package, with converted weights.

The JAX model is initialised, saved with ``unet3d_tpu.train.checkpoint``, and
loaded into the port through ``load_checkpoint`` + ``load_jax_variables``; the
same numpy input goes through both. Tolerances: f32 atol 2e-4 / rtol 1e-3 as
in tests/test_parity_dynunet.py (instance norms over 16^3 voxels, different
sum orders); bf16 AMP within relative L2 2e-2 (both round activations to bf16,
at different places); single layers 1e-5.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.models import layers as jax_layers
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.train.checkpoint import save_checkpoint
from unet3d_tpu.train.step import amp_cast

from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
from unet3d_tpu_torch.convert import flax_to_state_dict, load_jax_variables
from unet3d_tpu_torch.models import layers
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.predict.volumetric import make_forward
from unet3d_tpu_torch.train.checkpoint import load_checkpoint

MODEL_KWARGS = dict(
    in_channels=4, out_channels=3, spatial_dims=3,
    strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2]], filters=[8, 16, 32],
    kernel_size=[[3, 3, 3]] * 3, upsample_kernel_size=[[2, 2, 2]] * 2,
    deep_supervision=True, deep_supr_num=1)


def _flat(variables):
    from flax.traverse_util import flatten_dict
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}


@pytest.fixture(scope="module")
def jax_dynunet(tmp_path_factory):
    model = jax_create_model("DynUNet", **MODEL_KWARGS)
    x0 = jnp.zeros((1, 16, 16, 16, 4), jnp.float32)
    variables = jax.jit(lambda r: model.init(r, x0, False))(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("ckpt") / "model.npz")
    save_checkpoint(variables, path)
    apply = jax.jit(lambda v, x: model.apply(v, x, False))
    return model, variables, apply, path


@pytest.fixture(scope="module")
def x_in():
    return np.random.RandomState(0).randn(2, 16, 16, 16, 4).astype(np.float32)


def _port(path):
    model = create_model("DynUNet", **MODEL_KWARGS)
    load_jax_variables(model, load_checkpoint(path), strict=True)
    return model.eval()


def test_forward_f32_matches_jax(jax_dynunet, x_in):
    _, variables, apply, path = jax_dynunet
    want = np.asarray(apply(variables, jnp.asarray(x_in)))
    with torch.no_grad():
        got = _port(path)(torch.from_numpy(x_in)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_forward_amp_matches_jax(jax_dynunet, x_in):
    _, variables, apply, path = jax_dynunet
    vb, xb = amp_cast(variables, jnp.asarray(x_in))
    want = np.asarray(apply(vb, xb).astype(jnp.float32))
    got = make_forward(_port(path), amp=True)(torch.from_numpy(x_in))
    assert got.dtype == torch.float32
    got = got.numpy()
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 < 2e-2, rel_l2


def test_forward_runs_stride1_convs_through_the_fused_kernels(monkeypatch):
    """Every stride-1 3x3x3 conv feeds an instance norm: conv1 takes the stats
    epilogue (the up block on its concatenated skip join, as the JAX block
    does), conv2 the prologue; the plain conv kernel has no site here."""
    from unet3d_tpu_torch.ops import conv3d as conv_ops
    calls = {"conv": [], "conv_stats": [], "block_stats": []}
    for name, key in (("conv3x3x3", "conv"), ("conv3x3x3_with_stats", "conv_stats"),
                      ("conv3x3x3_block_with_stats", "block_stats")):
        def counted(x, *args, _fn=getattr(conv_ops, name), _key=key):
            calls[_key].append(x.shape[-1])
            return _fn(x, *args)
        monkeypatch.setattr(conv_ops, name, counted)
    model = create_model("DynUNet", **MODEL_KWARGS)
    init_parameters(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(torch.zeros(1, 16, 16, 16, 4))
    # input conv1, then the level-1 and level-0 up blocks' conv1 on the concat
    assert calls == {"conv": [], "conv_stats": [4, 32, 16],
                     "block_stats": [8, 16, 32, 16, 8]}


def test_build_from_config_loads_checkpoint(jax_dynunet, x_in):
    _, variables, apply, path = jax_dynunet
    config = {"model": {"name": "DynUNet", **json.loads(json.dumps(MODEL_KWARGS))}}
    model = build_or_load_model_from_config(config, path, torch.device("cpu"))
    assert not model.training
    want = np.asarray(apply(variables, jnp.asarray(x_in)))
    with torch.no_grad():
        got = model(torch.from_numpy(x_in)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_seeded_init_is_deterministic_and_lecun_scaled(tmp_path):
    config = {"model": {"name": "DynUNet", **MODEL_KWARGS}}
    a = build_or_load_model_from_config(config, str(tmp_path / "absent.npz"),
                                        torch.device("cpu"), seed=3)
    b = build_or_load_model_from_config(config, None, torch.device("cpu"), seed=3)
    c = build_or_load_model_from_config(config, None, torch.device("cpu"), seed=4)
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
        p = p.detach()
        assert torch.equal(p, q), name
        if name.endswith("kernel"):
            assert not torch.equal(p, r), name
            std = (1.0 / np.prod(p.shape[:-1])) ** 0.5
            assert abs(float(p.std()) / std - 1.0) < 0.25, name
            assert float(p.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        elif name.endswith("scale"):
            assert torch.all(p == 1)
        else:
            assert torch.all(p == 0)


def test_strict_load_rejects_missing_extra_and_mismatched(jax_dynunet):
    _, variables, _, path = jax_dynunet
    flat = load_checkpoint(path)
    model = create_model("DynUNet", **MODEL_KWARGS)
    missing = dict(flat)
    missing.pop("params/deep_supervision_head1/kernel")
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(model, missing)
    extra = dict(flat, **{"params/extra/kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra"):
        load_jax_variables(model, extra)
    bad = dict(flat, **{"params/output_block/bias": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(model, bad)
    # non-strict: missing keys keep their values and extras are dropped, but
    # a shape mismatch still raises
    before = model.deep_supervision_head1.kernel.clone()
    load_jax_variables(model, dict(missing, **{"params/extra/kernel": np.zeros(3)}),
                       strict=False)
    assert torch.equal(model.deep_supervision_head1.kernel, before)
    np.testing.assert_array_equal(model.output_block.bias.detach().numpy(),
                                  flat["params/output_block/bias"])
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(model, bad, strict=False)


def test_flax_keys_map_to_state_dict(jax_dynunet):
    _, variables, _, _ = jax_dynunet
    sd = flax_to_state_dict(_flat(variables))
    assert set(sd) == set(create_model("DynUNet", **MODEL_KWARGS).state_dict())
    with pytest.raises(ValueError):
        flax_to_state_dict({"batch_stats/x/mean": np.zeros(2)})


def _jax_layer(module, x, seed=0):
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return _flat(variables), np.asarray(module.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("use_bias", [True, False])
def test_pointwise_conv_matches_flax(use_bias):
    x = np.random.RandomState(1).randn(2, 4, 5, 6, 7).astype(np.float32)
    flat, want = _jax_layer(jax_layers.PointwiseConv(5, use_bias=use_bias), x)
    if use_bias:
        flat["params/bias"] = np.random.RandomState(2).randn(5).astype(np.float32)
        want = want + flat["params/bias"]
    mod = load_jax_variables(layers.PointwiseConv(7, 5, use_bias), flat)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [(2, 2, 2), (1, 2, 3)])
def test_subpixel_conv_transpose_matches_flax(k):
    x = np.random.RandomState(3).randn(2, 3, 4, 5, 6).astype(np.float32)
    flat, want = _jax_layer(jax_layers.SubpixelConvTranspose(4, k), x)
    mod = load_jax_variables(layers.SubpixelConvTranspose(6, 4, k), flat)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3 * k[0], 4 * k[1], 5 * k[2], 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_transposed_conv_other_kernels_are_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        layers.transposed_conv(4, 4, 3, 2)


@pytest.mark.parametrize("strides", [(1, 1, 1), (2, 2, 2)])
def test_fastconv_tuple_split_matches_flax(strides):
    """A tuple input convolves the virtual channel concat (kernel split)."""
    rng = np.random.RandomState(4)
    a = rng.randn(1, 6, 6, 6, 3).astype(np.float32)
    b = rng.randn(1, 6, 6, 6, 5).astype(np.float32)
    fc = jax_layers.FastConv(4, (3, 3, 3), strides=strides, use_bias=False,
                             with_stats=True)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    variables = fc.init(jax.random.PRNGKey(0), (ja, jb))
    want = fc.apply(variables, (ja, jb))
    mod = load_jax_variables(layers.FastConv(8, 4, (3, 3, 3), strides,
                                             use_bias=False, with_stats=True),
                             _flat(variables))
    with torch.no_grad():
        got = mod((torch.from_numpy(a), torch.from_numpy(b)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        create_model("DynUNet", **dict(MODEL_KWARGS, res_block=True))
    with pytest.raises(ValueError, match="not ported"):
        create_model("SegResNet")
    with pytest.raises(ValueError):
        init_parameters(torch.nn.Linear(2, 2), torch.Generator())

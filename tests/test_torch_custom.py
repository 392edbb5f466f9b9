"""The port's hybrid classifiers (``models/custom.py``: RegularizedResNet,
RegularizedBasicResNet, ResNetWithDecoder1D) and the FCN against the JAX
package's, through the ``Classifier`` harness of
``tests/test_torch_resnet.py`` (one jitted JAX computation of the eval and
training forwards, the running statistics and the gradients in f32 and
bf16 AMP; the objective the cross entropy of the logits plus ``sum(e * g)``
of the reconstruction, ``mu`` and ``logvar``; the tolerances stated there).

Each net at its smallest valid shape: RegularizedResNet with a two-level
Myronenko encoder of base width 4 on (2, 16^3, 2), its dropout patched out
and the latent not sampled (``sample=False``: ``jax.random`` cannot be
matched); RegularizedBasicResNet and ResNetWithDecoder1D on one stage of
basic blocks (``layers`` (1,)) on (4, 16^3, 2), the first with a two-level
``BasicDecoder`` from a 64-wide latent, the second decoding 8 logits from
length 8 to 32 in two levels and resampling to 20; the FCN on (4, 5). The
variable trees are JAX's (the strict load of each case). Then the 1-D
resample against JAX's ``_interp_1d``, the config factory's input width for
ResNetWithDecoder1D, and every classifier name of the registry.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.models import custom as jax_custom
from unet3d_tpu.models import fcn as jax_fcn

from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
from unet3d_tpu_torch.models import custom, fcn, layers
from unet3d_tpu_torch.models.registry import NOT_YET_PORTED, create_model

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_myronenko import _x
from test_torch_resnet import (Classifier, check_bf16, check_forwards, check_grads_f32,
                               check_structure)

REGULARIZED = dict(n_outputs=3, input_shape=(16, 16, 16), n_features=2, base_width=4,
                   encoder_blocks=(1, 1), vae_features=8, n_reduced_latent_feature_maps=4)
BASIC = dict(n_features=2, n_outputs=3, layers=(1,), decoding_layers=(1, 1), latent_planes=64)
DECODER_1D = dict(n_fc_outputs=8, n_outputs=20, initial_upsample=8, layers=(1,))
FCN = dict(hidden_layers_list=(8, 6), n_inputs=5, n_outputs=3)


@functools.lru_cache(maxsize=None)
def _case(name):
    if name == "RegularizedResNet":
        return Classifier(jax_custom.RegularizedResNet(**REGULARIZED),
                          lambda: custom.RegularizedResNet(**REGULARIZED),
                          _x(2, 16, 16, 16, 2, seed=1), 3,
                          jax_kwargs=dict(sample=False), port_kwargs=dict(sample=False),
                          no_noise=((layers, "channel_dropout"),))
    if name == "RegularizedBasicResNet":
        return Classifier(jax_custom.RegularizedBasicResNet(**BASIC),
                          lambda: custom.RegularizedBasicResNet(**BASIC),
                          _x(4, 16, 16, 16, 2, seed=1), 3)
    if name == "ResNetWithDecoder1D":
        return Classifier(jax_custom.ResNetWithDecoder1D(**DECODER_1D),
                          lambda: custom.ResNetWithDecoder1D(**DECODER_1D, input_channels=2),
                          _x(4, 16, 16, 16, 2, seed=1))
    return Classifier(jax_fcn.FCN(**FCN), lambda: fcn.FCN(**FCN), _x(4, 5, seed=1), 3)


NETS = ["RegularizedResNet", "RegularizedBasicResNet", "ResNetWithDecoder1D", "FCN"]


@pytest.mark.parametrize("name", NETS)
def test_forwards_match_jax(name):
    check_forwards(_case(name))


@pytest.mark.parametrize("name", NETS)
def test_f32_gradients_match_jax(name):
    check_grads_f32(_case(name))


@pytest.mark.parametrize("name", NETS)
def test_bf16_forward_gradients_and_statistics_match_jax(name):
    check_bf16(_case(name))


def test_outputs_are_jax_s():
    """RegularizedResNet returns (out, reconstruction, mu, logvar), the
    reconstruction at twice the input (four decoder levels up from the
    latent, JAX's default); RegularizedBasicResNet (out, reconstruction);
    ResNetWithDecoder1D a (N, n_outputs, 1) signal; shapes as JAX's."""
    for name, n_out in (("RegularizedResNet", 4), ("RegularizedBasicResNet", 2),
                        ("ResNetWithDecoder1D", 1)):
        c = _case(name)
        want = jax.eval_shape(lambda: c.jmod.apply(c.variables, jnp.asarray(c.x),
                                                   **c.jax_kwargs))
        with torch.no_grad():
            got = c.port()(torch.from_numpy(c.x), **c.port_kwargs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == n_out
        assert [tuple(t.shape) for t in got] == [tuple(w.shape) for w in want]


def test_structure_of_the_defaults_matches_jax():
    """At their defaults (RegularizedResNet's base width 32, the ResNets'
    (2, 2, 2, 2) basic blocks, seven decoder levels) the trees are JAX's."""
    shape = (1, 32, 32, 32, 1)
    check_structure("RegularizedResNet", dict(n_outputs=2, input_shape=(32, 32, 32)), shape)
    check_structure("RegularizedBasicResNet", dict(n_features=1, n_outputs=2), shape)
    check_structure("ResNetWithDecoder1D", dict(n_fc_outputs=16, n_outputs=100), shape,
                    port_kwargs=dict(input_channels=1))


@pytest.mark.parametrize("mode,align", [("nearest", True), ("linear", True),
                                        ("linear", False)])
@pytest.mark.parametrize("size", [7, 20])
def test_interp_1d_matches_jax(mode, align, size):
    """``interp_1d`` down and up along L, f32 and bf16 (the linear modes'
    f32 weights make a bf16 signal f32, the nearest mode keeps the dtype),
    equal to JAX's ``_interp_1d``."""
    x = _x(2, 12, 3, seed=4)
    fn = jax.jit(lambda v: jax_custom._interp_1d(v, size, mode, align))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = fn(jnp.asarray(x).astype(jdt))
        got = custom.interp_1d(torch.from_numpy(x).to(dtype), size, mode, align)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-6, atol=1e-6)


def test_factory_passes_the_input_width():
    """The config factory builds ResNetWithDecoder1D for the input width
    ``model_input_shape_from_config`` gives, on which the JAX CLI
    initialises it: the module takes neither ``in_channels`` nor
    ``n_features``, so 1 (a config naming either fails in both packages)."""
    config = {"model": {"name": "ResNetWithDecoder1D", "n_fc_outputs": 8, "n_outputs": 20,
                        "layers": [1]},
              "dataset": {"desired_shape": [16, 16, 16]}}
    model = build_or_load_model_from_config(config, None, torch.device("cpu"))
    assert model.encoder.conv1.kernel.shape == (7, 7, 7, 1, 64)
    with torch.no_grad():
        assert model(torch.zeros(2, 16, 16, 16, 1)).shape == (2, 20, 1)
    config["model"]["n_features"] = 3
    with pytest.raises(TypeError, match="n_features"):
        build_or_load_model_from_config(config, None, torch.device("cpu"))
    with pytest.raises(TypeError, match="n_features"):
        jax_custom.ResNetWithDecoder1D(n_fc_outputs=8, n_outputs=20, n_features=3)


def test_fcn_trains_through_make_train_step():
    """The train step takes the FCN's ``(N, n_inputs)`` batch as it is (the
    JAX step transposes every batch as NCDHW and refuses it): one SGD step
    of CrossEntropyLoss, the same gradients as the harness's f32 ones."""
    from unet3d_tpu_torch.train import losses, optim, step
    c = _case("FCN")
    model = c.port()
    params = dict(model.named_parameters())
    run = step.make_train_step(model, losses.CrossEntropyLoss(),
                               optim.build_optimizer("SGD", params.values(), lr=0.1))
    loss = float(run(c.x, c.y))
    assert np.isfinite(loss) and abs(loss - float(c.jax["loss"])) < 1e-5 * abs(loss)
    _, grads, _ = c.port_f32
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[k], rtol=1e-6, atol=1e-7)


CLASSIFIERS = ("DenseNet", "DenseNet121", "DenseNet169", "DenseNet201", "DenseNet264",
               "EfficientNetBN", "FCN", "RegularizedBasicResNet", "RegularizedResNet",
               "ResNet", "ResNetWithDecoder1D", "resnet_101", "resnet_152", "resnet_18",
               "resnet_34", "resnet_50", "resnext_101_32x8d", "resnext_50_32x4d")
REQUIRED = {"FCN": FCN, "RegularizedBasicResNet": dict(n_features=1),
            "RegularizedResNet": dict(n_outputs=2, input_shape=(32, 32, 32)),
            "ResNetWithDecoder1D": dict(n_fc_outputs=8, n_outputs=20)}


def test_every_classifier_name_resolves():
    """The 18 names build in the port (``ResNet`` and ``DenseNet`` at their
    defaults as ``resnet_18`` and ``DenseNet121``); nothing of the JAX
    registry is left to port, and an unknown name still raises."""
    assert NOT_YET_PORTED == ()
    shapes = {}
    for name in CLASSIFIERS:
        model = create_model(name, **REQUIRED.get(name, {}))
        shapes[name] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["ResNet"] == shapes["resnet_18"]
    assert shapes["DenseNet"] == shapes["DenseNet121"]
    with pytest.raises(ValueError, match="is unknown"):
        create_model("NoSuchClassifier")

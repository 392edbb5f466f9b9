"""Every loss of the port's registry against the JAX package's, value and
gradient, in f32 and bf16.

The same seeded numpy prediction and target go through both (one-hot
targets for the segmentation losses, continuous ones for the regression
losses, log-probabilities for NLLLoss). Tolerances: f32 1e-6 absolute and
1e-5 relative on the value and relative L2 1e-5 on the gradient; bf16
within 1e-2 on both (the Dice family keeps bf16 products, as JAX does, and
the sums of either package round differently).
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.train import losses as jax_losses

from unet3d_tpu_torch.train import losses

SEG = "seg"        # one-hot target over the channels
REG = "reg"        # continuous target in [0, 1]
LOGP = "logp"      # one-hot target, the prediction as log-probabilities
CASES = [
    ("DiceLoss", dict(sigmoid=True, squared_pred=True), SEG),
    ("GeneralizedDiceLoss", dict(softmax=True), SEG),
    ("GeneralizedDiceLoss", dict(sigmoid=True, w_type="simple", batch=True), SEG),
    ("GeneralizedDiceLoss", dict(w_type="uniform", include_background=False,
                                 reduction="none"), SEG),
    ("FocalLoss", dict(), SEG),
    ("FocalLoss", dict(alpha=0.25, weight=[1.0, 2.0, 0.5], reduction="sum"), SEG),
    ("FocalLoss", dict(use_softmax=True, alpha=0.3), SEG),
    ("FocalLoss", dict(use_softmax=True, include_background=False, alpha=0.3,
                       gamma=1.5), SEG),
    ("DiceCELoss", dict(softmax=True, lambda_ce=0.7), SEG),
    ("DiceCELoss", dict(sigmoid=True, batch=True), "seg1"),
    ("DiceFocalLoss", dict(sigmoid=True), SEG),
    ("DiceFocalLoss", dict(softmax=True, include_background=False, lambda_focal=0.5), SEG),
    ("GeneralizedDiceFocalLoss", dict(sigmoid=True, gamma=1.0), SEG),
    ("SSIMLoss", dict(win_size=3), REG),
    ("SSIMLoss", dict(win_size=5, kernel_type="uniform", data_range=2.0,
                      reduction="none"), REG),
    ("CrossEntropyLoss", dict(), SEG),
    ("CrossEntropyLoss", dict(weight=[0.2, 1.0, 3.0], label_smoothing=0.1), SEG),
    ("CrossEntropyLoss", dict(weight=[0.2, 1.0, 3.0], reduction="sum"), SEG),
    ("BCEWithLogitsLoss", dict(), SEG),
    ("BCEWithLogitsLoss", dict(pos_weight=[1.0, 3.0, 0.5], reduction="sum"), SEG),
    ("MSELoss", dict(), REG),
    ("L1Loss", dict(reduction="sum"), REG),
    ("SmoothL1Loss", dict(beta=0.5), REG),
    ("TverskyLoss", dict(sigmoid=True, alpha=0.3, beta=0.7), SEG),
    ("TverskyLoss", dict(softmax=True, batch=True, include_background=False), SEG),
    ("MaskedDiceLoss", dict(sigmoid=True), SEG),
    ("NLLLoss", dict(), LOGP),
    ("NLLLoss", dict(weight=[1.0, 0.5, 2.0]), LOGP),
    ("HuberLoss", dict(delta=0.4), REG),
    ("VAELoss", dict(beta=0.5), REG),
    ("VAELoss", dict(reconstruction="L1Loss"), REG),
]


def _inputs(kind, seed=21):
    rng = np.random.RandomState(seed)
    channels = 1 if kind == "seg1" else 3
    pred = 2.0 * rng.randn(2, 7, 6, 5, channels).astype(np.float32)
    if kind == REG:
        return pred, rng.rand(*pred.shape).astype(np.float32)
    labels = rng.randint(0, channels + (kind == "seg1"), size=pred.shape[:-1])
    target = np.eye(max(channels, 2), dtype=np.float32)[labels][..., :channels]
    target[0, ..., -1] = 0.0  # an empty class in the first sample
    if kind == LOGP:
        pred = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
    return pred.astype(np.float32), target


def _extras(name):
    """The keyword arguments of one call beyond (pred, target)."""
    rng = np.random.RandomState(22)
    if name == "MaskedDiceLoss":
        return {"mask": (rng.rand(2, 7, 6, 5, 1) > 0.3).astype(np.float32)}
    if name == "VAELoss":
        return {"mu": rng.randn(2, 16).astype(np.float32),
                "logvar": 0.2 * rng.randn(2, 16).astype(np.float32)}
    return {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kwargs,kind", CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CASES)])
def test_loss_matches_jax(name, kwargs, kind, dtype):
    pred, target = _inputs(kind)
    extras = _extras(name)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # FocalLoss's alpha warning, in both
        jl = jax_losses.load_criterion(name, dict(kwargs))
        jextras = {k: jnp.asarray(v) for k, v in extras.items()}
        want, want_g = jax.value_and_grad(
            lambda p: jnp.sum(jl(p, jnp.asarray(target), **jextras)))(jnp.asarray(pred, jdt))
        p = torch.from_numpy(pred).to(tdt).requires_grad_()
        got = losses.load_criterion(name, dict(kwargs))(
            p, torch.from_numpy(target), **{k: torch.from_numpy(v) for k, v in extras.items()})
    got.sum().backward()
    assert got.dtype == torch.float32
    assert got.shape == tuple(np.shape(jl(jnp.asarray(pred), jnp.asarray(target), **jextras)))
    g, wg = p.grad.float().numpy(), np.asarray(want_g, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(float(got.detach().sum()), float(want), rtol=1e-5, atol=1e-6)
        assert np.linalg.norm(g - wg) <= 1e-5 * np.linalg.norm(wg)
    else:
        np.testing.assert_allclose(float(got.detach().sum()), float(want), rtol=1e-2, atol=1e-2)
        assert np.linalg.norm(g - wg) <= 1e-2 * np.linalg.norm(wg)


def test_every_jax_loss_name_is_ported():
    assert sorted(losses.LOSS_REGISTRY) == sorted(jax_losses.LOSS_REGISTRY)
    assert {name for name, _, _ in CASES} == set(jax_losses.LOSS_REGISTRY)
    with pytest.raises(ValueError, match="not supported"):
        losses.load_criterion("NoSuchLoss")


def test_focal_softmax_without_background_drops_alpha_with_a_warning():
    pred, target = _inputs(SEG)
    args = (torch.from_numpy(pred), torch.from_numpy(target))
    focal = losses.FocalLoss(use_softmax=True, include_background=False, alpha=0.3)
    with pytest.warns(UserWarning, match="alpha"):
        with_alpha = focal(*args)
    plain = losses.FocalLoss(use_softmax=True, include_background=False)(*args)
    assert torch.equal(with_alpha, plain)


def test_ssim_refuses_a_window_larger_than_the_volume():
    pred, target = _inputs(REG)
    for module in (losses, jax_losses):
        with pytest.raises(ValueError, match="win_size"):
            module.SSIMLoss(win_size=11)(*(np.asarray(a) if module is jax_losses
                                           else torch.from_numpy(a)
                                           for a in (pred, target)))

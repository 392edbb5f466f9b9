"""Whole-model remat, VQVAE and GraphCMR on the card.

Small nets at 32^3, widths multiples of 8 (the bf16 wgmma form): a
SegResNetVAE's training step with ``training.remat`` against the step
without (the gradients within 1e-3 in f32 and 2e-2 in bf16, ``conv``
launched as often plus the remat blocks' forward launches once more,
``s2_wgrad`` as often), and
its remat gradients through the hand kernels against the plain path
(``F.conv3d``); a SegResNetDS's running statistics after a remat step
within 1e-4 of the step without. VQVAE's codebook after a training forward
on the card against the EMA formula in f64 from the forward's own codes and
inputs (1e-5 in f32, 1e-2 in bf16); GraphCMR's template on the card, f32
through the inference cast, and its step finite. The kernels have no CPU or
interpret mode: without a GPU these tests skip; the CPU parity against JAX
is test_torch_whole_remat.py, test_torch_vqvae.py and test_torch_graph.py.
No flax import: the file collects on the GPU machine.
"""
import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
from unet3d_tpu_torch.models import layers
from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
from unet3d_tpu_torch.ops.conv3d import _pads, conv3d_torch
from unet3d_tpu_torch.predict.volumetric import make_forward
from unet3d_tpu_torch.train.losses import DiceLoss, MSELoss
from unet3d_tpu_torch.train.step import forward_loss, noise_generator, prepare_batch

S = 32
SEGRESNET_VAE = {"name": "SegResNetVAE", "input_image_size": [S, S, S], "init_filters": 8,
                 "in_channels": 4, "out_channels": 3, "blocks_down": [1, 2], "blocks_up": [1],
                 "vae_nz": 8, "smallest_filters": 8, "dropout_prob": 0.2}
SEGRESNET_DS = {"name": "SegResNetDS", "init_filters": 8, "in_channels": 4, "out_channels": 3,
                "blocks_down": [1, 2]}
VQVAE = {"name": "VQVAE", "in_channel": 4, "channel": 16, "n_res_block": 1,
         "n_res_channel": 8, "embed_dim": 8, "n_embed": 32}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_convs():
    """Every FastConv through ``F.conv3d`` with torch autograd."""
    real = layers.conv3d
    layers.conv3d = lambda x, w, strides=(1, 1, 1), padding="SAME": conv3d_torch(
        x, w, tuple(strides), _pads(padding, w.shape[:3]))
    try:
        yield
    finally:
        layers.conv3d = real


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, 4, S, S, S).astype(np.float32),
            (rng.rand(1, 3, S, S, S) > 0.5).astype(np.float32))


def _grads(model, images, labels, device, amp):
    """One step's gradients, the launches of the hand kernels and the
    ``conv`` launches of the remat blocks' forward."""
    x, y = prepare_batch(images, labels, device, amp)
    K.reset_launches()
    W.reset_launches()
    with chip_smoke.launches_in_blocks(model, lambda: K.LAUNCHES["conv"]) as in_blocks:
        loss = forward_loss(model, DiceLoss(sigmoid=True), x, y, amp, noise_generator(model, 3))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    return grads, {"conv": K.LAUNCHES["conv"], "s2_wgrad": W.LAUNCHES["s2_wgrad"],
                   "blocks_conv": in_blocks[0]}


def _rel(got, want) -> float:
    num = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(got, want))
    return (num / sum(float(b.double().square().sum()) for b in want)) ** 0.5


def _pair(cfg, device):
    config = {"model": dict(cfg), "dataset": {"desired_shape": [S, S, S]}}
    return [build_or_load_model_from_config(config, None, device, seed=1, remat=remat)
            for remat in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_remat_step_matches_the_step_without(cuda_device, amp):
    plain, remat = _pair(SEGRESNET_VAE, cuda_device)
    images, labels = _batch()
    want, p = _grads(plain, images, labels, cuda_device, amp)
    got, r = _grads(remat, images, labels, cuda_device, amp)
    assert _rel(got, want) < (2e-2 if amp else 1e-3)
    # the recompute runs the remat blocks' forward conv launches once more
    assert p["blocks_conv"] == r["blocks_conv"] > 0
    assert r["conv"] == p["conv"] + p["blocks_conv"] and r["s2_wgrad"] == p["s2_wgrad"] > 0
    with plain_convs():
        path, q = _grads(remat, images, labels, cuda_device, amp)
    assert q["conv"] == 0 and _rel(got, path) < (2e-2 if amp else 1e-3)


@pytest.mark.cuda
def test_remat_running_statistics_match(cuda_device):
    plain, remat = _pair(SEGRESNET_DS, cuda_device)
    images, labels = _batch(1)
    (_, p), (_, r) = (_grads(model, images, labels, cuda_device, False)
                      for model in (plain, remat))
    assert r["conv"] == p["conv"] + p["blocks_conv"] and p["blocks_conv"] > 0
    keys = [k for k, _ in plain.named_buffers()]
    assert keys and _rel([dict(remat.named_buffers())[k] for k in keys],
                         [dict(plain.named_buffers())[k] for k in keys]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_vqvae_codebook_update_on_the_card(cuda_device, amp):
    config = {"model": dict(VQVAE), "dataset": {"desired_shape": [S, S, S]}}
    model = build_or_load_model_from_config(config, None, cuda_device, seed=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    images, _ = _batch(2)
    x, y = prepare_batch(images, images, cuda_device, amp)
    with chip_smoke.quantizer_inputs(model) as seen:
        loss = forward_loss(model, MSELoss(), x, y, amp)
    loss.backward()
    assert np.isfinite(float(loss)) and set(seen) == {"quantize_t", "quantize_b"}
    gap = chip_smoke.codebook_gap(model, before, seen)
    assert gap < (1e-2 if amp else 1e-5), gap


@pytest.mark.cuda
def test_graphcmr_on_the_card(cuda_device):
    verts, faces = chip_smoke.icosphere(2)
    from unet3d_tpu_torch.models.graph import faces_to_adjacency_matrix
    cfg = {"name": "GraphCMR", "ref_vertices": verts.T,
           "adjacency_matrix": faces_to_adjacency_matrix(len(verts), faces), "n_layers": 1,
           "n_channels": 32, "encoder_outputs": 64}
    model = build_or_load_model_from_config({"model": cfg, "dataset": {
        "desired_shape": [S, S, S]}}, None, cuda_device)
    assert model.adjacency.is_cuda and model.adjacency.dtype == torch.float32
    x = torch.randn(2, S, S, S, 1, device=cuda_device)
    y = make_forward(model, amp=True)(x)
    assert y.shape == (2, 3, len(verts)) and bool(torch.isfinite(y).all())
    out = model(x.to(torch.float32), True)
    (out * torch.randn_like(out)).sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())

"""The BatchNorm segmentation nets through the hand kernels against their
plain path, on the card.

SegResNetDS, AttentionUnet and MONAI UNet (batch norm, 2 residual units) at
32^3 with widths of 16 and up (the wgmma forms; UNet's last unit maps 3
channels to 3 and takes the narrow form), the plain path sending every
FastConv to ``F.conv3d`` (torch autograd): the eval forward (relative L2
1e-5 in f32, 3e-2 in bf16 AMP), then one training forward and backward from
the same running statistics: the gradients (relative L2 over all
parameters: 1e-3 in f32 and 2e-2 in bf16, as chip_smoke.py phase 5 holds
them; in bf16 also the kernels' no further from the plain f32 gradients
than 1.25 times the plain bf16 path's) and the running statistics
it leaves (1e-4 f32, 1e-2 bf16). The kernels have no CPU or interpret mode:
without a GPU these tests skip; the CPU parity against JAX is
test_torch_segresnet_ds.py, test_torch_monai_nets.py and test_torch_vnet.py.
"""
import contextlib
import copy

import numpy as np
import pytest
import torch

from unet3d_tpu_torch.models import layers
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops.conv3d import _pads, conv3d_torch
from unet3d_tpu_torch.predict.volumetric import make_forward
from unet3d_tpu_torch.train.losses import DiceLoss
from unet3d_tpu_torch.train.step import forward_loss, noise_generator, prepare_batch

NETS = {
    "SegResNetDS": dict(init_filters=16, blocks_down=[1, 2, 2]),
    "AttentionUnet": dict(channels=[16, 32, 64], strides=[2, 2]),
    "UNet": dict(channels=[16, 32, 64], strides=[2, 2], num_res_units=2, norm="batch"),
}
S = 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_convs():
    def plain(x, w, strides=(1, 1, 1), padding="SAME"):
        return conv3d_torch(x, w, tuple(strides), _pads(padding, w.shape[:3]))

    real, layers.conv3d = layers.conv3d, plain
    try:
        yield
    finally:
        layers.conv3d = real


def _rel(got, want) -> float:
    diff = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(got, want))
    return (diff / sum(float(b.double().square().sum()) for b in want)) ** 0.5


def _net(name, device):
    model = create_model(name, in_channels=4, out_channels=3, **NETS[name])
    init_parameters(model, torch.Generator().manual_seed(1))
    return model.to(device).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETS))
def test_eval_forward_through_the_kernels(cuda_device, name):
    model = _net(name, cuda_device)
    x = torch.randn(1, S, S, S, 4, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(2))
    for amp, bound in ((False, 1e-5), (True, 3e-2)):
        forward = make_forward(model, amp=amp)
        K.reset_launches()
        got = forward(x)
        launches = K.LAUNCHES["conv"]
        with plain_convs():
            want = forward(x)
        assert launches > 0 and K.LAUNCHES["conv"] == launches
        assert _rel([got], [want]) < bound, (amp, _rel([got], [want]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETS))
def test_training_gradients_and_statistics_through_the_kernels(cuda_device, name):
    model = _net(name, cuda_device)
    rng = np.random.RandomState(3)
    images = rng.randn(1, 4, S, S, S).astype(np.float32)
    labels = (rng.rand(1, 3, S, S, S) > 0.5).astype(np.float32)
    params = list(model.parameters())
    start = [b.clone() for b in model.buffers()]

    def run(amp, plain):
        net = copy.deepcopy(model)
        x, y = prepare_batch(images, labels, cuda_device, amp)
        with plain_convs() if plain else contextlib.nullcontext():
            loss = forward_loss(net, DiceLoss(sigmoid=True), x, y, amp,
                                noise_generator(net, 0))
            grads = torch.autograd.grad(loss, list(net.parameters()))
        return grads, list(net.buffers())

    runs = {(amp, plain): run(amp, plain) for amp in (False, True) for plain in (False, True)}
    assert len(runs[False, False][0]) == len(params)
    assert all(torch.equal(a, b) for a, b in zip(model.buffers(), start))
    assert _rel(runs[False, False][0], runs[False, True][0]) < 1e-3
    assert _rel(runs[False, False][1], runs[False, True][1]) < 1e-4
    assert _rel(runs[True, False][0], runs[True, True][0]) < 2e-2
    assert _rel(runs[True, False][1], runs[True, True][1]) < 1e-2
    f32 = runs[False, True][0]
    kernels, plain = _rel(runs[True, False][0], f32), _rel(runs[True, True][0], f32)
    assert kernels < max(2e-2, 1.25 * plain), (kernels, plain)

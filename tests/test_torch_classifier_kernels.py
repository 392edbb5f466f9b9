"""The classifiers on the card: DenseNet's ``conv2`` (a 3^3 stride-1
``FastConv``) and RegularizedResNet's Myronenko blocks through the hand
``conv`` kernel (and ``s2_wgrad`` for the latter's stride-2 convs),
against the plain path; the other classifiers, whose convs are cuDNN's
(grouped and depthwise too), launching no hand kernel.

Small nets (2, 32^3, 1): DenseNet with blocks (2, 1), growth 8 (``conv2``
32 -> 8, the wgmma form), RegularizedResNet at base width 8. The eval
forward, kernels against the plain path (relative L2 1e-5 in f32, 3e-2 in
bf16) with one ``conv`` launch a 3^3 stride-1 site; DenseNet's training
forward and backward with one more a site (the input gradients), f32
gradients within 1e-3, bf16 no further from the plain f32 ones than 1.25
times the plain bf16 path's or 2e-2. The grouped and depthwise convs in f32
on the card within 1e-5 of f64 on the CPU (the port's full-f32 policy). The
kernels have no CPU or interpret mode: without a GPU these tests skip; the
CPU parity against JAX is test_torch_resnet.py, test_torch_densenet.py,
test_torch_efficientnet.py, test_torch_custom.py and
test_torch_grouped_conv.py. No flax import: the file collects on the GPU
machine.
"""
import contextlib

import numpy as np
import pytest
import torch

from unet3d_tpu_torch.models import layers
from unet3d_tpu_torch.models.layers import Conv, FastConv, init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
from unet3d_tpu_torch.ops import winograd_kernel
from unet3d_tpu_torch.ops.conv3d import _pads, conv3d_torch
from unet3d_tpu_torch.predict.volumetric import make_forward
from unet3d_tpu_torch.train.losses import CrossEntropyLoss
from unet3d_tpu_torch.train.step import forward_loss, noise_generator, prepare_batch

S = 32
KERNEL_NETS = {
    "DenseNet": dict(in_channels=1, out_channels=2, init_features=16, growth_rate=8,
                     block_config=(2, 1)),
    "RegularizedResNet": dict(n_outputs=2, input_shape=(S, S, S), n_features=1,
                              base_width=8),
}
NO_KERNEL = {
    "resnext_50_32x4d": dict(n_features=1, n_outputs=2),
    "EfficientNetBN": dict(in_channels=1, num_classes=2),
    "RegularizedBasicResNet": dict(n_features=1, n_outputs=2, layers=(1, 1, 1, 1)),
    "ResNetWithDecoder1D": dict(n_fc_outputs=8, n_outputs=20, layers=(1, 1, 1, 1),
                                input_channels=1),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_convs():
    """Every FastConv through F.conv3d (torch autograd): no hand kernel."""
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


def _net(name, kwargs, device):
    model = create_model(name, **kwargs)
    init_parameters(model, torch.Generator().manual_seed(1))
    return model.to(device).eval()


def _stride1_sites(model):
    return [m for m in model.modules() if isinstance(m, FastConv)
            and m.kernel_size == (3, 3, 3) and m.strides == (1, 1, 1)]


def _reset():
    for module in (K, W, winograd_kernel):
        module.reset_launches()


def _x(device, seed=2):
    return torch.randn(2, S, S, S, 1, device=device,
                       generator=torch.Generator(device=device).manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_NETS))
def test_eval_forward_through_the_kernel(cuda_device, name):
    model = _net(name, KERNEL_NETS[name], cuda_device)
    one = _stride1_sites(model)
    x = _x(cuda_device)
    for amp, bound in ((False, 1e-5), (True, 3e-2)):
        forward = make_forward(model, amp=amp)
        _reset()
        got = forward(x)
        launches = dict(K.LAUNCHES)
        with plain_convs():
            want = forward(x)
        assert launches["conv"] == len(one) > 0
        assert dict(K.LAUNCHES) == launches  # the plain path launched nothing
        assert _rel([got], [want]) < bound, (amp, _rel([got], [want]))


@pytest.mark.cuda
def test_densenet_training_through_the_kernel(cuda_device):
    model = _net("DenseNet", KERNEL_NETS["DenseNet"], cuda_device)
    one = _stride1_sites(model)
    rng = np.random.RandomState(3)
    images = rng.randn(2, 1, S, S, S).astype(np.float32)
    labels = np.eye(2, dtype=np.float32)[[0, 1]]
    params = list(model.parameters())
    start = [b.clone() for b in model.buffers()]

    def run(amp, plain):
        with torch.no_grad():
            for b, b0 in zip(model.buffers(), start):
                b.copy_(b0)
        x, y = prepare_batch(images, labels, cuda_device, amp)
        _reset()
        with plain_convs() if plain else contextlib.nullcontext():
            loss = forward_loss(model, CrossEntropyLoss(), x, y, amp, noise_generator(model, 0))
            grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return grads, dict(K.LAUNCHES)

    runs = {(amp, plain): run(amp, plain) for amp in (False, True) for plain in (False, True)}
    for amp in (False, True):
        assert runs[amp, False][1]["conv"] == 2 * len(one)
        assert not runs[amp, True][1]["conv"]
    assert _rel(runs[False, False][0], runs[False, True][0]) < 1e-3
    f32 = runs[False, True][0]
    kernels, plain = _rel(runs[True, False][0], f32), _rel(runs[True, True][0], f32)
    assert kernels < max(2e-2, 1.25 * plain), (kernels, plain)


@pytest.mark.cuda
def test_regularized_resnet_training_launches_conv_and_s2_wgrad(cuda_device):
    model = _net("RegularizedResNet", KERNEL_NETS["RegularizedResNet"], cuda_device)
    x, y = prepare_batch(np.random.RandomState(4).randn(2, 1, S, S, S).astype(np.float32),
                         np.eye(2, dtype=np.float32)[[1, 0]], cuda_device, True)
    _reset()
    loss = forward_loss(model, CrossEntropyLoss(), x, y, True, noise_generator(model, 0))
    loss.backward()
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert K.LAUNCHES["conv"] > len(_stride1_sites(model)) and W.LAUNCHES["s2_wgrad"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NO_KERNEL))
def test_cudnn_classifiers_launch_no_hand_kernel(cuda_device, name):
    model = _net(name, NO_KERNEL[name], cuda_device)
    x = _x(cuda_device, 5)
    _reset()
    out = make_forward(model, amp=True)(x)
    loss = forward_loss(model, lambda o, t: o.float().square().mean(), x, torch.zeros(()),
                        False, noise_generator(model, 0))
    loss.backward()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and np.isfinite(float(loss))
    assert not any(K.LAUNCHES.values()) and not any(W.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("channels,groups,kernel", [(64, 32, 3), (16, 16, 5)])
def test_grouped_conv_is_full_f32_on_the_card(cuda_device, channels, groups, kernel):
    conv = Conv(channels, channels, kernel, 2, "SAME", use_bias=False, groups=groups)
    init_parameters(conv, torch.Generator().manual_seed(6))
    x = torch.randn(2, 8, 8, 8, channels, generator=torch.Generator().manual_seed(7))
    g = torch.randn(2, 4, 4, 4, channels, generator=torch.Generator().manual_seed(8))
    grads = []
    for dev, dtype in ((cuda_device, torch.float32), (torch.device("cpu"), torch.float64)):
        c = Conv(channels, channels, kernel, 2, "SAME", use_bias=False, groups=groups)
        c = c.to(dev, dtype)
        with torch.no_grad():
            c.kernel.copy_(conv.kernel)
        xt = x.to(dev, dtype).requires_grad_(True)
        y = c(xt)
        y.backward(g.to(dev, dtype))
        grads.append([y.detach().cpu(), xt.grad.cpu(), c.kernel.grad.cpu()])
    for got, want in zip(*grads):
        assert _rel([got], [want]) < 1e-5

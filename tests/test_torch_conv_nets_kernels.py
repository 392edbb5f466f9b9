"""The last MONAI conv nets on the card: the registration nets' and the
autoencoders' 3^3 convs through the hand ``conv`` kernel and their stride-2
weight gradients through ``s2_wgrad``, against the plain versions; HighResNet
and AHNet, whose convs are cuDNN's, launching no hand kernel.

The sites (chip_smoke.py phase 14, here at 32^3): an extraction head 16 ->
3 and its input gradient 3 -> 16 (the wmma form: 3 channels are no multiple
of 8 or 4), 16 -> 16 (wgmma), ``s2_wgrad`` at 16 -> 16 (wgmma) and at 4 ->
4 (the autoencoder's first stride-2 conv: wmma), each in bf16 against the
plain version (relative max error 1e-2; 1e-4 for s2_wgrad's f32 sums).
Then small nets at 32^3 (4 input channels), the plain path sending every
``FastConv`` through ``F.conv3d``: the eval forward (relative L2 1e-5 in
f32, 3e-2 in bf16 AMP) with one ``conv`` launch a 3^3 stride-1 FastConv,
by form, and one training forward and backward (gradients over all
parameters 1e-3 in f32; in bf16 the kernels' no further from the plain f32
gradients than 1.25 times the plain bf16 path's, or 2e-2) with ``conv``
once a site and once more for each site whose input needs a gradient (all
but a first conv on the raw input), ``s2_wgrad`` once a stride-2 site.
The kernels have no CPU or interpret mode: without a GPU these tests skip;
the CPU parity against JAX is test_torch_regunet.py,
test_torch_monai_coders.py, test_torch_highresnet.py and test_torch_ahnet.py.
No flax import: the file collects on the GPU machine.
"""
import contextlib

import numpy as np
import pytest
import torch

from unet3d_tpu_torch.models import layers
from unet3d_tpu_torch.models.layers import FastConv, init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
from unet3d_tpu_torch.ops import winograd_kernel
from unet3d_tpu_torch.ops.conv3d import _pads, conv3d_torch
from unet3d_tpu_torch.predict.volumetric import make_forward
from unet3d_tpu_torch.train.losses import DiceLoss
from unet3d_tpu_torch.train.step import forward_loss, noise_generator, prepare_batch

S = 32
# (spatial, cin, cout, form)
CONV_SITES = [(S, 16, 3, "wmma"), (S, 3, 16, "wmma"), (S, 16, 16, "wgmma")]
S2_SITES = [(S, 16, 16, "wgmma"), (S, 4, 4, "wmma")]
NETS = {
    "LocalNet": dict(in_channels=4, out_channels=3, num_channel_initial=8, depth=2),
    "RegUNet": dict(in_channels=4, out_channels=3, num_channel_initial=8, depth=2,
                    extract_levels=[0, 2], pooling=False, concat_skip=True),
    "GlobalNet": dict(in_channels=4, num_channel_initial=8, depth=2, image_size=[S, S, S]),
    "AutoEncoder": dict(in_channels=4, out_channels=3, channels=[4, 8, 16], strides=[2, 2, 2],
                        num_res_units=2, inter_channels=[16, 16], inter_dilations=[1, 2]),
}
NO_KERNEL = {
    "HighResNet": dict(in_channels=4, out_channels=3),
    "AHNet": dict(in_channels=4, out_channels=3, layers=[1, 1, 1, 1], image_size=[S, S, S]),
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
    if name == "GlobalNet":  # a non-zero head: the encoder's gradients are real
        with torch.no_grad():
            model.affine_head.fc.kernel.normal_(0.0, 1e-3, generator=torch.Generator()
                                                .manual_seed(2))
    return model.to(device).eval()


def _sites(model):
    """The (stride-1, stride-2) 3^3 FastConvs."""
    convs = [m for m in model.modules() if isinstance(m, FastConv)
             and m.kernel_size == (3, 3, 3)]
    one = [m for m in convs if m.strides == (1, 1, 1)]
    two = [m for m in convs if m.strides == (2, 2, 2)]
    return one, two


def _reset():
    for module in (K, W, winograd_kernel):
        module.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("s,cin,cout,form", CONV_SITES)
def test_conv_at_a_site(cuda_device, s, cin, cout, form):
    gen = torch.Generator(device=cuda_device).manual_seed(cin * 100 + cout)
    x = torch.randn(1, s, s, s, cin, device=cuda_device, generator=gen).to(torch.bfloat16)
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda_device, generator=gen)
         / (27 * cin) ** 0.5).to(torch.bfloat16)
    _reset()
    got, want = K.conv3x3x3(x, w), K.conv3d_reference(x, w)
    torch.cuda.synchronize()
    assert dict(K.FORM_LAUNCHES) == {("conv", form): 1}
    rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert rel < 1e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("s,cin,cout,form", S2_SITES)
def test_s2_wgrad_at_a_site(cuda_device, s, cin, cout, form):
    gen = torch.Generator(device=cuda_device).manual_seed(cin * 100 + cout + 1)
    x = torch.randn(1, s, s, s, cin, device=cuda_device, generator=gen).to(torch.bfloat16)
    g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=cuda_device,
                    generator=gen).to(torch.bfloat16)
    _reset()
    got, want = W.s2_wgrad(x, g), W.s2_wgrad_reference(x, g)
    torch.cuda.synchronize()
    assert W.kernel_form(x, g) == form and dict(W.FORM_LAUNCHES) == {("s2_wgrad", form): 1}
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 1e-4, rel


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETS))
def test_eval_forward_through_the_kernel(cuda_device, name):
    model = _net(name, NETS[name], cuda_device)
    one, _ = _sites(model)
    x = torch.randn(1, S, S, S, 4, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(2))
    for amp, bound in ((False, 1e-5), (True, 3e-2)):
        forward = make_forward(model, amp=amp)
        _reset()
        got = forward(x)
        launches, forms = dict(K.LAUNCHES), dict(K.FORM_LAUNCHES)
        with plain_convs():
            want = forward(x)
        assert launches["conv"] == len(one)
        assert sum(forms.values()) == len(one)
        assert dict(K.LAUNCHES) == launches  # the plain path launched nothing
        assert _rel([got], [want]) < bound, (amp, _rel([got], [want]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETS))
def test_training_gradients_through_the_kernel(cuda_device, name):
    model = _net(name, NETS[name], cuda_device)
    one, two = _sites(model)
    rng = np.random.RandomState(3)
    images = rng.randn(1, 4, S, S, S).astype(np.float32)
    labels = (rng.rand(1, 3, S, S, S) > 0.5).astype(np.float32)
    params = list(model.parameters())
    start = [b.clone() for b in model.buffers()]

    # the stride-1 sites whose input needs a gradient (all but one that
    # reads the raw input) take the kernel again for it
    dx_sites = []
    hooks = [m.register_forward_pre_hook(lambda m, a: dx_sites.append(a[0].requires_grad))
             for m in one]

    def run(amp, plain):
        with torch.no_grad():
            for b, b0 in zip(model.buffers(), start):
                b.copy_(b0)
        x, y = prepare_batch(images, labels, cuda_device, amp)
        dx_sites.clear()
        _reset()
        with plain_convs() if plain else contextlib.nullcontext():
            loss = forward_loss(model, DiceLoss(sigmoid=True), x, y, amp,
                                noise_generator(model, 0))
            grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        return grads, dict(K.LAUNCHES), dict(W.LAUNCHES), sum(dx_sites)

    runs = {(amp, plain): run(amp, plain) for amp in (False, True) for plain in (False, True)}
    for hook in hooks:
        hook.remove()
    for amp in (False, True):
        _, conv, s2, dx = runs[amp, False]
        assert dx >= len(one) - 1
        assert conv["conv"] == len(one) + dx and s2["s2_wgrad"] == len(two), (conv, s2)
        assert not runs[amp, True][1]["conv"] and not runs[amp, True][2]["s2_wgrad"]
    assert _rel(runs[False, False][0], runs[False, True][0]) < 1e-3
    f32 = runs[False, True][0]
    kernels, plain = _rel(runs[True, False][0], f32), _rel(runs[True, True][0], f32)
    assert kernels < max(2e-2, 1.25 * plain), (kernels, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NO_KERNEL))
def test_cudnn_nets_launch_no_hand_kernel(cuda_device, name):
    """HighResNet's and AHNet's convs are Flax ``nn.Conv`` (XLA's in JAX),
    so cuDNN's here: a bf16 window and a training backward launch no hand
    kernel, and the output is finite."""
    model = _net(name, NO_KERNEL[name], cuda_device)
    rng = np.random.RandomState(4)
    images = rng.randn(2, 4, S, S, S).astype(np.float32)
    labels = (rng.rand(2, 3, S, S, S) > 0.5).astype(np.float32)
    _reset()
    out = make_forward(model, amp=True)(torch.from_numpy(np.moveaxis(images, 1, -1).copy())
                                        .to(cuda_device))
    x, y = prepare_batch(images, labels, cuda_device, True)
    forward_loss(model, DiceLoss(sigmoid=True), x, y, True).backward()
    torch.cuda.synchronize()
    assert out.shape == (2, S, S, S, 3) and bool(torch.isfinite(out).all())
    for module in (K, W, winograd_kernel):
        assert not any(module.LAUNCHES.values()) and not module.FORM_LAUNCHES

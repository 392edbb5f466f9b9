"""The MONAI conv stacks on the card: BasicUNet's and BasicUNetPlusPlus's
3^3 convs through the hand ``conv`` kernel against its plain version, and
QuickNAT and DiNTS, whose convs are cuDNN's, launching no hand kernel.

The sites (chip_smoke.py phase 13): 32 output channels at 128^3 from the
concatenated inputs of 64, 96, 128 and 160 channels (Cout 32 half of a
64-wide tile, Cin 96 and 160 part-filled 64-channel chunks), the input
gradient of 64 -> 32 (32 -> 64) and 256 -> 128 at 16^3, each in bf16 in the
wgmma form against the plain version (relative max error 1e-2). Then small
nets at 32^3 (features (16, 16, 32, 32, 64, 16), 4 input channels), the
plain path sending every ``FastConv`` through ``F.conv3d``: the eval forward
(relative L2 1e-5 in f32, 3e-2 in bf16 AMP) with one ``conv`` launch a 3^3
conv, and one training forward and backward (gradients over all parameters
1e-3 in f32; in bf16 the kernels' no further from the plain f32 gradients
than 1.25 times the plain bf16 path's, or 2e-2). The kernels have no CPU or
interpret mode: without a GPU these tests skip; the CPU parity against JAX
is test_torch_basicunet.py, test_torch_basicunetplusplus.py,
test_torch_quicknat.py and test_torch_dints.py. No flax import: the file
collects on the GPU machine.
"""
import contextlib

import numpy as np
import pytest
import torch

from unet3d_tpu_torch.models import layers
from unet3d_tpu_torch.models.layers import FastConv, init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops import s2_wgrad_kernel, winograd_kernel
from unet3d_tpu_torch.ops.conv3d import _pads, conv3d_torch
from unet3d_tpu_torch.predict.volumetric import make_forward
from unet3d_tpu_torch.train.losses import DiceLoss
from unet3d_tpu_torch.train.step import forward_loss, prepare_batch

# (spatial, cin, cout): the conv kernel's new sites in these nets
SITES = [(128, 64, 32), (128, 96, 32), (128, 128, 32), (128, 160, 32), (128, 32, 64),
         (16, 256, 128)]
FEATURES = [16, 16, 32, 32, 64, 16]
NETS = {
    "BasicUNet": dict(in_channels=4, out_channels=3, features=FEATURES),
    "BasicUNetPlusPlus": dict(in_channels=4, out_channels=3, features=FEATURES,
                              deep_supervision=True),
}
NO_KERNEL = {
    "Quicknat": dict(num_channels=4, num_classes=3, num_filters=16, se_block="CSSE"),
    "DiNTS": dict(in_channels=4, num_classes=3, dints_space=dict(channel_mul=0.5,
                                                                 num_blocks=2)),
}
S = 32


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


@pytest.mark.cuda
@pytest.mark.parametrize("s,cin,cout", SITES)
def test_conv_at_a_site(cuda_device, s, cin, cout):
    gen = torch.Generator(device=cuda_device).manual_seed(cin * 1000 + cout)
    x = torch.randn(1, s, s, s, cin, device=cuda_device, generator=gen).to(torch.bfloat16)
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda_device, generator=gen)
         / (27 * cin) ** 0.5).to(torch.bfloat16)
    K.reset_launches()
    got, want = K.conv3x3x3(x, w), K.conv3d_reference(x, w)
    torch.cuda.synchronize()
    assert dict(K.FORM_LAUNCHES) == {("conv", "wgmma"): 1}
    rel = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert rel < 1e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETS))
def test_eval_forward_through_the_kernel(cuda_device, name):
    model = _net(name, NETS[name], cuda_device)
    sites = sum(isinstance(m, FastConv) for m in model.modules())
    x = torch.randn(1, S, S, S, 4, device=cuda_device, generator=torch.Generator(
        device=cuda_device).manual_seed(2))
    for amp, bound in ((False, 1e-5), (True, 3e-2)):
        forward = make_forward(model, amp=amp)
        K.reset_launches()
        got = forward(x)
        launches, forms = dict(K.LAUNCHES), dict(K.FORM_LAUNCHES)
        with plain_convs():
            want = forward(x)
        assert launches["conv"] == sites
        assert set(forms) == {("conv", "tf32x3" if not amp else "wgmma")}
        assert dict(K.LAUNCHES) == launches  # the plain path launched nothing
        assert _rel([got], [want]) < bound, (amp, _rel([got], [want]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETS))
def test_training_gradients_through_the_kernel(cuda_device, name):
    model = _net(name, NETS[name], cuda_device)
    rng = np.random.RandomState(3)
    images = rng.randn(1, 4, S, S, S).astype(np.float32)
    labels = (rng.rand(1, 3, S, S, S) > 0.5).astype(np.float32)
    params = list(model.parameters())

    def run(amp, plain):
        x, y = prepare_batch(images, labels, cuda_device, amp)
        with plain_convs() if plain else contextlib.nullcontext():
            loss = forward_loss(model, DiceLoss(sigmoid=True), x, y, amp)
            return torch.autograd.grad(loss, params)

    runs = {(amp, plain): run(amp, plain) for amp in (False, True) for plain in (False, True)}
    assert _rel(runs[False, False], runs[False, True]) < 1e-3
    f32 = runs[False, True]
    kernels, plain = _rel(runs[True, False], f32), _rel(runs[True, True], f32)
    assert kernels < max(2e-2, 1.25 * plain), (kernels, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NO_KERNEL))
def test_cudnn_nets_launch_no_hand_kernel(cuda_device, name):
    """QuickNAT's and DiNTS's convs are Flax ``nn.Conv`` (XLA's in JAX), so
    cuDNN's here: a bf16 window and a training backward launch no hand
    kernel, and the output is finite."""
    model = _net(name, NO_KERNEL[name], cuda_device)
    rng = np.random.RandomState(4)
    images = rng.randn(1, 4, S, S, S).astype(np.float32)
    labels = (rng.rand(1, 3, S, S, S) > 0.5).astype(np.float32)
    for module in (K, s2_wgrad_kernel, winograd_kernel):
        module.reset_launches()
    out = make_forward(model, amp=True)(torch.from_numpy(np.moveaxis(images, 1, -1).copy())
                                        .to(cuda_device))
    x, y = prepare_batch(images, labels, cuda_device, True)
    forward_loss(model, DiceLoss(sigmoid=True), x, y, True).backward()
    torch.cuda.synchronize()
    assert out.shape == (1, S, S, S, 3) and bool(torch.isfinite(out).all())
    for module in (K, s2_wgrad_kernel, winograd_kernel):
        assert not any(module.LAUNCHES.values()) and not module.FORM_LAUNCHES

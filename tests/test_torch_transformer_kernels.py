"""The transformers' conv sites through the hand kernels against their plain
versions, on the card.

UNETR's (feature 16) and SwinUNETR's (feature 48) UnetResBlock sites: the
direct conv's three variants (``conv_stats`` at a conv1, ``block_stats`` at
a conv2, ``conv`` at their input gradients) in bf16, each in the wgmma form,
against the plain version (relative max error 1e-2 on y, 1e-4 on the
statistics: f32 atomics change the sum order run to run). Then small UNETR
and SwinUNETR nets at 32^3 with widths of 16 and up, the plain path sending
every DynUNet block through ``F.conv3d`` and a plain instance norm: the
eval forward (relative L2 1e-5 in f32, 3e-2 in bf16 AMP) and one training
forward and backward (gradients over all parameters: 1e-3 in f32, as
chip_smoke.py phase 5 holds them; in bf16 the kernels' no further from the
plain f32 gradients than 1.25 times the plain bf16 path's, phase 11's rule:
at this size bf16 rounding puts the two bf16 paths 4.9e-2 apart for UNETR
on the H100; phase 12 holds them within 2e-2 at full width). The kernels have no CPU or interpret mode: without a GPU these
tests skip; the CPU parity against JAX is test_torch_unetr.py and
test_torch_swin_unetr.py. No flax import: the file collects on the GPU
machine.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet3d_tpu_torch.models import dynunet
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops.conv3d import _pads, conv3d_torch
from unet3d_tpu_torch.ops.norm import instance_norm_from_stats
from unet3d_tpu_torch.predict.volumetric import make_forward
from unet3d_tpu_torch.train.losses import DiceLoss
from unet3d_tpu_torch.train.step import forward_loss, prepare_batch

# (spatial, cin, cout, variant): the sites of chip_smoke.py phase 12
SITES = [(128, 4, 16, "conv_stats"), (128, 16, 16, "block_stats"), (128, 32, 16, "conv_stats"),
         (128, 16, 32, "conv"), (64, 32, 32, "block_stats"), (128, 4, 48, "conv_stats"),
         (128, 48, 48, "block_stats"), (128, 96, 48, "conv_stats"), (128, 48, 96, "conv"),
         (64, 96, 48, "conv_stats"), (32, 192, 96, "conv_stats"), (4, 768, 768, "block_stats")]
NETS = {
    "UNETR": dict(img_size=32, feature_size=16, hidden_size=64, mlp_dim=128, num_heads=4,
                  num_layers=4),
    "SwinUNETR": dict(img_size=[32, 32, 32], feature_size=24, num_heads=[3, 3, 3, 3]),
}
S = 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _plain_block(block, x):
    """A DynUNet block through F.conv3d and the instance norm from plain
    statistics, as the JAX model runs it."""
    residual = isinstance(block, dynunet.UnetResBlock)
    h = x
    for conv, norm in ((block.conv1, block.norm1), (block.conv2, block.norm2)):
        y = conv3d_torch(h, conv.kernel, conv.strides, _pads("SAME", conv.kernel_size))
        h = instance_norm_from_stats(y, *K.instance_stats(y), norm.scale, norm.bias)
        if not (residual and conv is block.conv2):
            h = F.leaky_relu(h, 0.01)
    if residual:
        identity = x
        if block.project:
            identity = block.conv3(x)
            identity = instance_norm_from_stats(identity, *K.instance_stats(identity),
                                                block.norm3.scale, block.norm3.bias)
        h = F.leaky_relu(h + identity, 0.01)
    return h


@contextlib.contextmanager
def plain_blocks():
    saved = dynunet.UnetBasicBlock.forward, dynunet.UnetResBlock.forward
    dynunet.UnetBasicBlock.forward = dynunet.UnetResBlock.forward = _plain_block
    try:
        yield
    finally:
        dynunet.UnetBasicBlock.forward, dynunet.UnetResBlock.forward = saved


def _rel(got, want) -> float:
    diff = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(got, want))
    return (diff / sum(float(b.double().square().sum()) for b in want)) ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("s,cin,cout,variant", SITES)
def test_variant_at_a_transformer_site(cuda_device, s, cin, cout, variant):
    gen = torch.Generator(device=cuda_device).manual_seed(cin * 1000 + cout)
    x = torch.randn(1, s, s, s, cin, device=cuda_device, generator=gen).to(torch.bfloat16)
    w = (torch.randn(3, 3, 3, cin, cout, device=cuda_device, generator=gen)
         / (27 * cin) ** 0.5).to(torch.bfloat16)
    inv = torch.rand(1, cin, device=cuda_device, generator=gen) + 0.5
    shift = torch.randn(1, cin, device=cuda_device, generator=gen) * 0.3
    args = (x, w, inv, shift) if variant == "block_stats" else (x, w)
    kernel = {"conv": K.conv3x3x3, "conv_stats": K.conv3x3x3_with_stats,
              "block_stats": K.conv3x3x3_block_with_stats}[variant]
    plain = {"conv": K.conv3d_reference, "conv_stats": K.conv3d_with_stats_reference,
             "block_stats": K.conv3d_block_with_stats_reference}[variant]
    K.reset_launches()
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    assert dict(K.FORM_LAUNCHES) == {(variant, "wgmma"): 1}
    got_y, want_y = (got, want) if variant == "conv" else (got[0], want[0])
    rel = float((got_y.float() - want_y.float()).abs().max() / want_y.float().abs().max())
    assert rel < 1e-2, rel
    if variant != "conv":
        yd = got_y.double()
        for stat, exact in ((got[1], yd.sum((1, 2, 3))), (got[2], (yd * yd).sum((1, 2, 3)))):
            assert float((stat - exact).abs().max()) <= 1e-4 * float(exact.abs().max())


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
    n_blocks = sum(isinstance(m, dynunet.UnetBasicBlock) for m in model.modules())
    for amp, bound in ((False, 1e-5), (True, 3e-2)):
        forward = make_forward(model, amp=amp)
        K.reset_launches()
        got = forward(x)
        launches = dict(K.LAUNCHES)
        with plain_blocks():
            want = forward(x)
        assert launches["conv_stats"] == launches["block_stats"] == n_blocks
        assert dict(K.LAUNCHES) == launches  # the plain path launched nothing
        assert _rel([got], [want]) < bound, (amp, _rel([got], [want]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NETS))
def test_training_gradients_through_the_kernels(cuda_device, name):
    model = _net(name, cuda_device)
    rng = np.random.RandomState(3)
    images = rng.randn(1, 4, S, S, S).astype(np.float32)
    labels = (rng.rand(1, 3, S, S, S) > 0.5).astype(np.float32)
    params = list(model.parameters())

    def run(amp, plain):
        x, y = prepare_batch(images, labels, cuda_device, amp)
        with plain_blocks() if plain else contextlib.nullcontext():
            loss = forward_loss(model, DiceLoss(sigmoid=True), x, y, amp)
            return torch.autograd.grad(loss, params)

    runs = {(amp, plain): run(amp, plain) for amp in (False, True) for plain in (False, True)}
    assert _rel(runs[False, False], runs[False, True]) < 1e-3
    f32 = runs[False, True]
    kernels, plain = _rel(runs[True, False], f32), _rel(runs[True, True], f32)
    assert kernels < max(2e-2, 1.25 * plain), (kernels, plain)

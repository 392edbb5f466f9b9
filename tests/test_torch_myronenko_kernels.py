"""The hand kernels at the Myronenko family's shapes, on the card.

SegResNet's level 0 runs 32 channels, narrower than one 64-wide tile of the
wgmma form; under AMP its decoder runs in f32 (the trilinear upsample
returns f32), so its 3-cubed convs take the f32 form, ``conv3d_tf32x3.cu``; its
stride-2 convs' weight gradients run ``s2_wgrad`` at 32 -> 64 @128^3 and,
in the VAE branch, 256 -> 16 @16^3. Each is held against its plain version
(relative to the largest value: 1e-2 bf16 and 1e-5 f32 for the conv, 1e-4
for ``s2_wgrad``, whose sums run in f32 on both sides) and its form is
checked. The kernels have no CPU or interpret mode: without a GPU these
tests skip.
"""
import numpy as np
import pytest
import torch

from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
from unet3d_tpu_torch.ops.conv3d import flip_io

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("spatial,cin,cout,dtype,form,dx_form", [
    (128, 4, 32, "bfloat16", "wgmma", "narrow"), (128, 32, 32, "bfloat16", "wgmma", "wgmma"),
    (128, 32, 32, "float32", "tf32x3", "tf32x3"), (64, 64, 64, "float32", "tf32x3", "tf32x3")])
def test_conv_at_the_family_shapes(cuda_device, spatial, cin, cout, dtype, form, dx_form):
    """Forward and input gradient (the conv on the flipped, io-swapped
    weight), in the form each takes: a dx with 4 outputs (the U-Nets' first
    conv follows a GroupNorm, so training takes it) is no multiple of 8 and
    takes the narrow form."""
    rng = np.random.RandomState(cin + cout)
    x = torch.from_numpy(rng.randn(1, spatial, spatial, spatial, cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 3, cin, cout) / np.sqrt(27 * cin))
                         .astype(np.float32))
    x, w = x.to(cuda_device, _DT[dtype]), w.to(cuda_device, _DT[dtype])
    g = torch.randn(1, spatial, spatial, spatial, cout, device=cuda_device).to(_DT[dtype])
    K.reset_launches()
    y = K.conv3x3x3(x, w)
    dx = K.conv3x3x3(g, flip_io(w))
    torch.cuda.synchronize()
    assert sorted(K.FORM_LAUNCHES.elements()) == sorted([("conv", form), ("conv", dx_form)])
    assert _rel(y, K.conv3d_reference(x, w)) < _TOL[dtype]
    assert _rel(dx, K.conv3d_reference(g, flip_io(w))) < _TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("x_shape,cin,cout", [((1, 128, 128, 128), 32, 64),
                                              ((1, 16, 16, 16), 256, 16)])
def test_s2_wgrad_at_the_family_shapes(cuda_device, x_shape, cin, cout):
    x = torch.randn(*x_shape, cin, device=cuda_device).to(torch.bfloat16)
    out = tuple((s + 1) // 2 for s in x_shape[1:])
    g = torch.randn(x_shape[0], *out, cout, device=cuda_device).to(torch.bfloat16)
    W.reset_launches()
    got = W.s2_wgrad(x, g)
    torch.cuda.synchronize()
    assert dict(W.FORM_LAUNCHES) == {("s2_wgrad", "wgmma"): 1}
    assert _rel(got, W.s2_wgrad_reference(x, g)) < 1e-4

"""Exported artifacts on the card: the loaded program launches the hand
kernels, as the eager forward does, and agrees with it.

A DynUNet at widths of 16 and 32 (4 -> 3 channels, two levels, 16^3: every
3^3 stride-1 site in the wgmma or tf32x3 form) is exported on the card and
on the CPU and loaded onto the card; the kernels' launches per variant
during one forward of the artifact must equal the eager forward's, the
output within relative L2 1e-2 of the eager bf16 forward (other graphs of
the same kernels: the statistics' atomics change the sum order) and 1e-5
of the eager f32 one. The kernels have no CPU or interpret mode: without a
GPU these tests skip; the CPU parity against JAX is test_torch_export.py.
"""
import numpy as np
import pytest
import torch

from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d_kernel as K
from unet3d_tpu_torch.ops import winograd_kernel as WK
from unet3d_tpu_torch.predict.export import export_forward, load_exported, save_exported
from unet3d_tpu_torch.predict.volumetric import make_forward, to_ndhwc

MODEL_KWARGS = dict(in_channels=4, out_channels=3, spatial_dims=3,
                    strides=[[1, 1, 1], [2, 2, 2]], filters=[16, 32],
                    kernel_size=[[3, 3, 3]] * 2, upsample_kernel_size=[[2, 2, 2]],
                    deep_supervision=False)
SHAPE = (16, 16, 16, 4)
BOUNDS = {False: 1e-5, True: 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU or interpret mode)")
    return torch.device("cuda")


def _net(device):
    net = create_model("DynUNet", **MODEL_KWARGS)
    init_parameters(net, torch.Generator().manual_seed(0))
    return net.to(device).eval()


def _launches():
    return {**K.LAUNCHES, **WK.LAUNCHES}, dict(K.FORM_LAUNCHES) | dict(WK.FORM_LAUNCHES)


def _run(fn, x):
    K.reset_launches()
    WK.reset_launches()
    out = fn(x)
    torch.cuda.synchronize()
    return out, _launches()


def _rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("exported_on", ["cuda", "cpu"])
def test_artifact_launches_the_kernels(cuda_device, tmp_path, amp, exported_on):
    net = _net(cuda_device)
    path = str(tmp_path / "model.u3dexp")
    save_exported(export_forward(net, SHAPE, amp=amp, device=exported_on), path)
    served = load_exported(path)
    assert served.device.type == "cuda"
    x = torch.randn(2, 4, 16, 16, 16, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    got, (launches, forms) = _run(served, x)
    want, (eager_launches, eager_forms) = _run(
        lambda v: make_forward(net, amp=amp)(to_ndhwc(v)).permute(0, 4, 1, 2, 3), x)
    assert launches == eager_launches and launches["conv_stats"] > 0
    assert launches["block_stats"] > 0
    assert forms == eager_forms
    assert {form for _, form in forms} == {"wgmma" if amp else "tf32x3"}
    assert _rel(got, want) < BOUNDS[amp]


@pytest.mark.cuda
def test_winograd_artifact_launches_winograd(cuda_device, tmp_path, monkeypatch):
    """UNET3D_TPU_CONV=winograd at export (the gate lowered to the net's
    widths): the loaded artifact launches winograd_stats where the eager
    strategy forward does, also with the strategy unset when it runs."""
    monkeypatch.setattr(WK, "_MIN_WINOGRAD_CHANNELS", 16)
    monkeypatch.setattr(WK, "_MIN_WINOGRAD_VOXELS", 8 ** 3)
    monkeypatch.setenv("UNET3D_TPU_CONV", "winograd")
    net = _net(cuda_device)
    path = str(tmp_path / "winograd.u3dexp")
    save_exported(export_forward(net, SHAPE, amp=True), path)
    x = torch.randn(1, 4, 16, 16, 16, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))
    want, (eager_launches, _) = _run(
        lambda v: make_forward(net, amp=True)(to_ndhwc(v)).permute(0, 4, 1, 2, 3), x)
    monkeypatch.delenv("UNET3D_TPU_CONV")
    got, (launches, forms) = _run(load_exported(path), x)
    assert launches == eager_launches and launches["winograd_stats"] > 0
    assert {form for _, form in forms} == {"wgmma"}
    assert _rel(got, want) < BOUNDS[True]
    assert np.isfinite(got.cpu().numpy()).all()

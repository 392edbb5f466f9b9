"""How far bf16 AMP moves the Myronenko family's gradients on a CUDA GPU.

    python tools/family_grad_conditioning.py [--seed N]

For each net of ``chip_smoke.FAMILY_MODELS`` (UNet3D, AutoImplantUNet,
LabeledVariationalAutoEncoder at 128^3, seeded random weights) and each
loss (the BraTS config's DiceLoss; for the VAE also ``VAELoss`` with a
BCE-with-logits reconstruction, whose KL term reads mu and logvar), one
train step's gradients four ways: f32 and bf16 AMP, each through the hand
kernels and through the plain path (``chip_smoke.plain_convs``), the noise
drawn from generators seeded alike. Prints the relative L2 (over all
parameters) of bf16 kernels against bf16 plain, of each bf16 path against
the f32 plain gradients, and of f32 kernels against f32 plain: a bf16 gap
between the two paths as large as each path's distance from f32 is the
objective's conditioning, not a kernel's fault. Prints the card first. TF32
off. Needs a CUDA GPU and nvcc.
"""
import argparse
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SHAPE = (128, 128, 128)
LOSSES = {"DiceLoss": {"name": "DiceLoss", "sigmoid": True},
          "VAELoss": {"name": "VAELoss", "reconstruction": "BCEWithLogitsLoss"}}


def rel_l2(got, want) -> float:
    diff = sum(float((a - b).double().square().sum()) for a, b in zip(got, want))
    return (diff / sum(float(b.double().square().sum()) for b in want)) ** 0.5


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("family_grad_conditioning: no CUDA device", file=sys.stderr)
        return 2
    from unet3d_tpu_torch.kernels.build import load_library
    from unet3d_tpu_torch.models.layers import init_parameters
    from unet3d_tpu_torch.models.registry import create_model
    from unet3d_tpu_torch.train.losses import load_criterion
    from unet3d_tpu_torch.train.step import forward_loss, noise_generator, prepare_batch
    from unet3d_tpu_torch.utils.config import get_kwargs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    load_library()
    for i, (name, kwargs, n_labels) in enumerate(chip_smoke.FAMILY_MODELS):
        losses = ["DiceLoss"] + (["VAELoss"] if "Variational" in name else [])
        for loss_name in losses:
            model = create_model(name, **kwargs)
            init_parameters(model, torch.Generator().manual_seed(args.seed + i))
            model = model.to(device)
            criterion = load_criterion(loss_name, loss_kwargs=get_kwargs(LOSSES[loss_name]))
            rng = np.random.RandomState(args.seed + 30 + i)
            images = rng.randn(1, kwargs["n_features"], *SHAPE).astype(np.float32)
            labels = (rng.rand(1, n_labels, *SHAPE) > 0.5).astype(np.float32)
            params = [p for _, p in model.named_parameters()]
            grads = {}
            for amp in (False, True):
                x, y = prepare_batch(images, labels, device, amp)
                for plain in (False, True):
                    with chip_smoke.plain_convs() if plain else chip_smoke.contextlib.nullcontext():
                        loss = forward_loss(model, criterion, x, y, amp,
                                            noise_generator(model, args.seed))
                        grads[amp, plain] = torch.autograd.grad(loss, params)
                del x, y
            f32 = grads[False, True]
            print(f"{name} {loss_name}: bf16 kernels vs plain "
                  f"{rel_l2(grads[True, False], grads[True, True]):.3e}; bf16 kernels vs f32 "
                  f"{rel_l2(grads[True, False], f32):.3e}; bf16 plain vs f32 "
                  f"{rel_l2(grads[True, True], f32):.3e}; f32 kernels vs plain "
                  f"{rel_l2(grads[False, False], f32):.3e} [{card}]", flush=True)
            del model, grads, f32
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

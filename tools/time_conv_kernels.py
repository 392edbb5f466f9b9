"""Time the port's direct 3x3x3 conv kernels at the BraTS DynUNet's bf16 sites.

    python tools/time_conv_kernels.py [--root CHECKOUT] [--reps N]

Imports ``unet3d_tpu_torch`` from ``--root`` (default: this checkout), so that
two checkouts can be timed on one card in turns, e.g. a parent commit
unpacked under ``build/`` and this one: parent, this, this, parent. Each
``chip_smoke.SHAPES`` site is timed in the variant it runs
(``chip_smoke.SITE_VARIANT``) and each ``chip_smoke.DX_SHAPES`` site as
``conv`` on the flipped weight, on seeded N(0, 1) bf16 inputs, with CUDA
events over ``--reps`` calls after one warm-up. Prints the card and one JSON
line: {"root": ..., "card": ..., "ms": {label: ms}}. Needs a CUDA GPU.
"""
import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_conv_kernels: no CUDA device", file=sys.stderr)
        return 2
    # the shapes, timer and card line of this checkout's smoke, whatever --root is
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    from unet3d_tpu_torch.ops.conv3d import flip_io

    kernel = {"conv": K.conv3x3x3, "conv_stats": K.conv3x3x3_with_stats,
              "block_stats": K.conv3x3x3_block_with_stats}
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    sites = [(label, s, cin, cout, variant) for (label, s, cin, cout), variant
             in zip(chip_smoke.SHAPES, chip_smoke.SITE_VARIANT)]
    sites += [(label, s, cin, cout, "conv") for label, s, cin, cout in chip_smoke.DX_SHAPES]
    ms = {}
    for label, s, cin, cout, variant in sites:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).bfloat16()
        if label.startswith("dx"):  # the cotangent and the flipped weight
            w = flip_io((torch.randn(3, 3, 3, cout, cin, device=device, generator=gen)
                         / (27 * cin) ** 0.5).bfloat16())
        else:
            w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
                 / (27 * cin) ** 0.5).bfloat16()
        inv = torch.rand(1, cin, device=device, generator=gen) + 0.5
        shift = torch.randn(1, cin, device=device, generator=gen) * 0.3
        call_args = (x, w, inv, shift) if variant == "block_stats" else (x, w)
        ms[f"{variant} {label}"] = chip_smoke.cuda_ms(lambda: kernel[variant](*call_args),
                                                      args.reps)
    print(chip_smoke.card_line())
    print(json.dumps({"root": args.root, "card": chip_smoke.card_line(), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

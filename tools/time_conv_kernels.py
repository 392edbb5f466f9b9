"""Time the port's direct conv, s2_wgrad and Winograd-DH kernels at the BraTS DynUNet's bf16 sites.

    python tools/time_conv_kernels.py [--root CHECKOUT] [--reps N] [--sites bf16|narrow_f32]

Imports ``unet3d_tpu_torch`` from ``--root`` (default: this checkout), so that
two checkouts can be timed on one card in turns, e.g. a parent commit
unpacked under ``build/`` and this one: parent, this, this, parent. Each
``chip_smoke.SHAPES`` site is timed in the variant it runs
(``chip_smoke.SITE_VARIANT``) and each ``chip_smoke.DX_SHAPES`` site as
``conv`` on the flipped weight, each ``chip_smoke.S2_SHAPES`` site as
``s2_wgrad`` (x at that size, the cotangent at half of it), and each
``chip_smoke.WINO_SHAPES`` site (where UNET3D_TPU_CONV=winograd runs the
Winograd kernels) as ``winograd_stats`` (the three forward sites) or
``winograd`` (the two input gradients, and 192->96), on seeded
N(0, 1) bf16 inputs: device time by CUDA events over ``--reps`` calls after
one warm-up, queued behind a device-side sleep (``chip_smoke.device_ms``), so
the wrappers' host time is not counted. ``--sites narrow_f32`` times
instead the calls that take neither the wgmma nor the direct tf32x3 form:
Winograd-DH in f32 at the ``chip_smoke.WINO_SHAPES`` sites (its
``winograd_stats`` forward sites and ``winograd`` input gradients), the
bf16 s2_wgrad at ``chip_smoke.NARROW_S2_SHAPES`` (4 input channels), and
``winograd`` in bf16 at ``WMMA_WINO_SITES`` (100 -> 100 @64^3 and 96 -> 96
@64^3 with x one element off alignment: winograd.cu's wmma form), each of
these beside ``F.conv3d`` on the same operands and its bound
(``chip_smoke.conv_bound``, 48 of the direct conv's 108 products). Prints
the card and one JSON line: {"root": ..., "card": ..., "ms": {label: ms}}.
Needs a CUDA GPU.
"""
import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, spatial, cin, cout, element offset of x)
WMMA_WINO_SITES = [("100->100 @64^3", 64, 100, 100, 0),
                   ("96->96 @64^3, x off alignment", 64, 96, 96, 1)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--sites", choices=["bf16", "narrow_f32"], default="bf16")
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
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
    from unet3d_tpu_torch.ops import winograd_kernel as WG
    from unet3d_tpu_torch.ops.conv3d import flip_io

    kernel = {"conv": K.conv3x3x3, "conv_stats": K.conv3x3x3_with_stats,
              "block_stats": K.conv3x3x3_block_with_stats}
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    wino = {"winograd": WG.winograd3x3x3, "winograd_stats": WG.winograd3x3x3_with_stats}
    if args.sites == "narrow_f32":
        ms = {}
        for label, s, cin, cout in chip_smoke.WINO_SHAPES:
            x = torch.randn(1, s, s, s, cin, device=device, generator=gen)
            w = torch.randn(3, 3, 3, cin, cout, device=device, generator=gen) / (27 * cin) ** 0.5
            variant = "winograd" if label.startswith("dx") else "winograd_stats"
            ms[f"{variant} f32 {label}"] = chip_smoke.device_ms(lambda: wino[variant](x, w),
                                                                args.reps)
        for label, s, cin, cout in chip_smoke.NARROW_S2_SHAPES:
            x = torch.randn(1, s, s, s, cin, device=device, generator=gen).bfloat16()
            g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device,
                            generator=gen).bfloat16()
            ms[f"s2_wgrad {label}"] = chip_smoke.device_ms(lambda: W.s2_wgrad(x, g), args.reps)
        for label, s, cin, cout, offset in WMMA_WINO_SITES:
            x = torch.randn(1, s, s, s, cin, device=device, generator=gen).bfloat16()
            if offset:
                store = torch.empty(offset + x.numel(), dtype=x.dtype, device=device)
                x = store[offset:].view(x.shape).copy_(x)
            w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
                 / (27 * cin) ** 0.5).bfloat16()
            ms[f"winograd bf16 {label}"] = chip_smoke.device_ms(lambda: WG.winograd3x3x3(x, w),
                                                                args.reps)
            ms[f"winograd bf16 {label} form"] = WG.kernel_form(x, w)
            ms[f"F.conv3d bf16 {label}"] = chip_smoke.device_ms(
                chip_smoke.library_conv(x.clone(), w), args.reps)
            ms[f"winograd bf16 {label} bound"] = chip_smoke.conv_bound(
                "winograd", s, cin, cout, chip_smoke.WINOGRAD_PRODUCTS)[0]
        print(chip_smoke.card_line())
        print(json.dumps({"root": args.root, "card": chip_smoke.card_line(), "ms": ms}))
        return 0
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
        ms[f"{variant} {label}"] = chip_smoke.device_ms(lambda: kernel[variant](*call_args),
                                                      args.reps)
    for label, s, cin, cout in chip_smoke.S2_SHAPES:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).bfloat16()
        g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device,
                        generator=gen).bfloat16()
        ms[f"s2_wgrad {label}"] = chip_smoke.device_ms(lambda: W.s2_wgrad(x, g), args.reps)
    for label, s, cin, cout in chip_smoke.WINO_SHAPES:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).bfloat16()
        w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
             / (27 * cin) ** 0.5).bfloat16()
        variants = ["winograd"] if label.startswith("dx") else ["winograd_stats"]
        if "192->96" in label:
            variants.append("winograd")
        for variant in variants:
            ms[f"{variant} {label}"] = chip_smoke.device_ms(lambda: wino[variant](x, w),
                                                            args.reps)
    print(chip_smoke.card_line())
    print(json.dumps({"root": args.root, "card": chip_smoke.card_line(), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

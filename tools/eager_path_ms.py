"""Time the port's eager path: host microseconds per kernel call, the BraTS
DynUNet's window forward and its train step.

    python tools/eager_path_ms.py [--root CHECKOUT] [--calls N] [--rounds R]

Imports ``unet3d_tpu_torch`` from ``--root`` (default: this checkout), so
that two checkouts can be timed on one card in turns, e.g. a parent commit
unpacked under ``build/`` and this one: parent, this, this, parent. Prints
the card and one JSON line: {"root", "card", "torch", "host_us", "window_ms",
"step_ms"}, each a list of ``--rounds`` samples:

* ``host_us``: microseconds of host time per call of each kernel wrapper
  (``conv3x3x3``, ``conv3x3x3_with_stats``, ``conv3x3x3_block_with_stats``,
  ``winograd3x3x3``, ``winograd3x3x3_with_stats``) on a 1 x 8^3 x 16 -> 16
  bf16 input, whose kernel takes a few microseconds of the card: ``--calls``
  calls made back to back between two synchronisations, the wall time
  over the count (the host's time to launch a call, which bounds the eager
  steps, PERF.md section 5), the wrappers taken in turns each round;
* ``window_ms``: one 128^3 bf16 window through the seeded BraTS DynUNet
  (``chip_smoke.py`` phase 4's forward: CUDA events over 5 calls after a
  warm-up, ``chip_smoke.cuda_ms``);
* ``step_ms``: one bf16 AMP train step of it (``make_train_step``, the
  config's DiceLoss, Adam at lr 1e-6; phase 5's ``chip_smoke.step_ms``:
  10 steps after 2 warm-up steps).

``--boundary_pairs N`` (this checkout on, which has the kernels as
torch.library operators) then times N pairs of the window and the step in
this process through the operators and with the public functions calling
the launch directly (the parent's path), in turns, first one then the
other: ``boundary`` {"operator", "direct"} of window and step ms lists.

Needs a CUDA GPU.
"""
import argparse
import copy
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--calls", type=int, default=1000)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--boundary_pairs", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("eager_path_ms: no CUDA device", file=sys.stderr)
        return 2
    # the timers, config and card line of this checkout's smoke, whatever --root is
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from unet3d_tpu_torch.config.factory import (build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.kernels.build import load_library
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    from unet3d_tpu_torch.ops import winograd_kernel as WG
    from unet3d_tpu_torch.train.step import make_train_step
    from unet3d_tpu_torch.utils.config import load_json

    device = torch.device("cuda")
    load_library()
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(1, 8, 8, 8, 16, device=device, generator=gen).bfloat16()
    w = (torch.randn(3, 3, 3, 16, 16, device=device, generator=gen) / 27 ** 0.5).bfloat16()
    inv = torch.rand(1, 16, device=device, generator=gen) + 0.5
    shift = torch.randn(1, 16, device=device, generator=gen)
    calls = {"conv3x3x3": lambda: K.conv3x3x3(x, w),
             "conv3x3x3_with_stats": lambda: K.conv3x3x3_with_stats(x, w),
             "conv3x3x3_block_with_stats": lambda: K.conv3x3x3_block_with_stats(
                 x, w, inv, shift),
             "winograd3x3x3": lambda: WG.winograd3x3x3(x, w),
             "winograd3x3x3_with_stats": lambda: WG.winograd3x3x3_with_stats(x, w)}
    host_us = {name: [] for name in calls}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn()
            torch.cuda.synchronize()
            host_us[name].append((time.perf_counter() - t0) / args.calls * 1e6)

    config = load_json(chip_smoke.CONFIG)
    model = build_or_load_model_from_config(config, None, device, seed=0)
    net = copy.deepcopy(model).to(torch.bfloat16).eval()
    rng = np.random.RandomState(1)
    window = torch.from_numpy(rng.randn(1, 128, 128, 128, 4).astype(np.float32)).to(
        device, torch.bfloat16)
    with torch.inference_mode():
        window_ms = [chip_smoke.cuda_ms(lambda: net(window)) for _ in range(args.rounds)]
    del net
    images = rng.randn(1, 4, 128, 128, 128).astype(np.float32)
    labels = (rng.rand(1, 3, 128, 128, 128) > 0.5).astype(np.float32)
    step = make_train_step(model, load_criterion_from_config(config),
                           torch.optim.Adam(model.parameters(), lr=1e-6), amp=True)
    step_ms = [chip_smoke.step_ms(step, images, labels, reps=10) for _ in range(args.rounds)]
    boundary = {"operator": {"window_ms": [], "step_ms": []},
                "direct": {"window_ms": [], "step_ms": []}}
    if args.boundary_pairs:
        direct = {
            (K, "_conv_op"): lambda x, w, pads: K._launch("conv", x, w, pads=pads)[0],
            (K, "_conv_stats_op"): lambda x, w, pads: K._launch("conv_stats", x, w, pads=pads),
            (K, "_block_stats_op"): lambda x, w, i, s, a, pads: K._launch(
                "block_stats", x, w, i, s, a, pads),
            (WG, "_winograd_op"): lambda x, w, pads: WG._launch("winograd", x, w, pads)[0],
            (WG, "_winograd_stats_op"): lambda x, w, pads: WG._launch("winograd_stats", x, w,
                                                                      pads)}
        operators = {key: getattr(*key) for key in direct}
        net = copy.deepcopy(model).to(torch.bfloat16).eval()
        for pair in range(args.boundary_pairs):
            for path in (("operator", "direct") if pair % 2 == 0 else ("direct", "operator")):
                for (module, name), fn in (direct if path == "direct" else operators).items():
                    setattr(module, name, fn)
                with torch.inference_mode():
                    boundary[path]["window_ms"].append(chip_smoke.cuda_ms(lambda: net(window)))
                boundary[path]["step_ms"].append(chip_smoke.step_ms(step, images, labels,
                                                                    reps=10))
        for (module, name), fn in operators.items():
            setattr(module, name, fn)
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"root": args.root, "card": card, "torch": torch.__version__,
                      "host_us": host_us, "window_ms": window_ms, "step_ms": step_ms,
                      "boundary": boundary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

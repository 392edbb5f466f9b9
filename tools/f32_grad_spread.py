"""How far apart one f32 SegResNetVAE step's gradients lie through the hand
kernels and through the plain path, each against an f64 reference, on a
CUDA GPU.

    python tools/f32_grad_spread.py [--seeds 0 1 2] [--steps 0 2 6]

For each seed: ``chip_smoke.SEGRESNET_MODEL`` on the BraTS config's 128^3
patch with seeded weights and the batch phase 10 of ``chip_smoke.py`` draws;
after each count of ``--steps`` bf16 AMP steps of the config's optimizer
(phase 10 measures after 2), one f32 step's gradients of every parameter
five ways, the noise drawn from generators seeded alike:

* ``K``: through the hand kernels under torch's default flags, twice
  (``K2``: how far the path differs from itself run to run);
* ``K_off``: the same with cuDNN's TF32 turned off by the caller;
* ``P``, ``P_off``: the plain path (``chip_smoke.plain_convs``), likewise;
* ``D``: the plain path in f64 on a double copy of the net and batch.

Prints the relative L2 over all parameters of each pair that tells one
thing apart: the kernels against the plain path (what phase 10 bounds), each
path against its own run with TF32 off (the port's f32 policy alone), each
path against f64 (how exact each is), with the worst parameter where the
kernels and the plain path part. Prints the card first and one JSON line
last. Needs a CUDA GPU and nvcc.
"""
import argparse
import contextlib
import copy
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def rel_l2(got, want) -> float:
    diff = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(got, want))
    return (diff / sum(float(b.double().square().sum()) for b in want)) ** 0.5


def worst(got, want, names):
    norm = sum(float(b.double().square().sum()) for b in want) ** 0.5
    return max((float((a.double() - b.double()).norm() / b.double().norm()), n)
               for a, b, n in zip(got, want, names) if float(b.double().norm()) > 1e-6 * norm)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--steps", type=int, nargs="+", default=[0, 2, 6])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("f32_grad_spread: no CUDA device", file=sys.stderr)
        return 2
    from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.kernels.build import load_library
    from unet3d_tpu_torch.train.step import (forward_loss, make_train_step, noise_generator,
                                             prepare_batch)
    from unet3d_tpu_torch.utils.config import load_json

    card = chip_smoke.card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    load_library()
    config = load_json(chip_smoke.CONFIG)
    config["model"] = dict(chip_smoke.SEGRESNET_MODEL)
    shape = tuple(config["dataset"]["desired_shape"])
    criterion = load_criterion_from_config(config)
    results = []
    for seed in args.seeds:
        model = build_or_load_model_from_config(config, None, device, seed=seed)
        rng = np.random.RandomState(seed + 20)
        rng.randn(1, *shape, 4)  # phase 10's window
        images = rng.randn(1, 4, *shape).astype(np.float32)
        labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
        step = make_train_step(model, criterion, build_optimizer_from_config(
            config, model.parameters()), amp=True, seed=seed)
        taken = 0
        for target in sorted(args.steps):
            while taken < target:
                step(images, labels)
                taken += 1
            names, params = zip(*model.named_parameters())
            x, y = prepare_batch(images, labels, device, False)

            def grads(net, xs, plain, tf32, ps=params):
                torch.backends.cudnn.allow_tf32 = tf32
                try:
                    with chip_smoke.plain_convs() if plain else contextlib.nullcontext():
                        loss = forward_loss(net, criterion, xs, y, False,
                                            noise_generator(net, seed))
                        return [g.detach() for g in torch.autograd.grad(loss, ps)]
                finally:
                    torch.backends.cudnn.allow_tf32 = True

            g = {"K": grads(model, x, False, True), "K2": grads(model, x, False, True),
                 "K_off": grads(model, x, False, False), "P": grads(model, x, True, True),
                 "P_off": grads(model, x, True, False)}
            double = copy.deepcopy(model).double()
            g["D"] = grads(double, x.double(), True, False, list(double.parameters()))
            del double
            torch.cuda.empty_cache()
            row = {"seed": seed, "steps": taken}
            for a, b in (("K", "P_off"), ("K", "P"), ("K", "K2"), ("K", "K_off"),
                         ("P", "P_off"), ("K", "D"), ("K_off", "D"), ("P_off", "D")):
                row[f"{a} vs {b}"] = rel_l2(g[a], g[b])
            row["worst K vs P_off"] = worst(g["K"], g["P_off"], names)
            row["worst P_off vs D"] = worst(g["P_off"], g["D"], names)
            row["worst K vs D"] = worst(g["K"], g["D"], names)
            print(json.dumps(row), flush=True)
            results.append(row)
            del g, x, y
            torch.cuda.empty_cache()
        del model, step
        torch.cuda.empty_cache()
    print(card, flush=True)
    print(json.dumps({"card": card, "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

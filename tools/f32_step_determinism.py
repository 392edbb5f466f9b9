"""How far one f32 train step's gradients move run to run on a CUDA GPU,
with cuDNN's and torch's determinism switches off and on.

    python tools/f32_step_determinism.py [--runs 3]

For ``chip_smoke.F32_POLICY_LAST``'s nets (LocalNet at 128^3, HighResNet
at 64^3) in the BraTS config, batch 1, weights from seed 0: ``--runs``
f32 steps' gradients (``forward_loss`` and ``torch.autograd.grad``, TF32
off) through the plain path (``chip_smoke.plain_convs``: every conv
cuDNN's) and through the kernels, under three settings: torch's defaults,
``torch.backends.cudnn.deterministic`` and
``torch.use_deterministic_algorithms(True, warn_only=True)`` (cuDNN's too).
Prints, per net, path and setting, the largest relative L2 between a run
and the first: the run-to-run spread the f32-policy check of
``chip_smoke.transformer_f32_policy`` must stay under. Prints the card
first and one JSON line last. Needs a CUDA GPU and nvcc.
"""
import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def setting(name: str):
    saved = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    if name == "cudnn_deterministic":
        torch.backends.cudnn.deterministic = True
    elif name == "deterministic_algorithms":
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("f32_step_determinism: no CUDA device", file=sys.stderr)
        return 2
    from unet3d_tpu_torch.config.factory import (build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.kernels.build import load_library
    from unet3d_tpu_torch.train.step import forward_loss, prepare_batch
    from unet3d_tpu_torch.utils.config import load_json

    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    load_library()
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    models = dict(cs.LAST_CONV_NETS)
    for name, s in cs.F32_POLICY_LAST.items():
        config = load_json(cs.CONFIG)
        config["model"] = dict(models[name])
        criterion = load_criterion_from_config(config)
        model = build_or_load_model_from_config(config, None, device, seed=0)
        rng = np.random.RandomState(7)
        images = rng.randn(1, 4, s, s, s).astype(np.float32)
        labels = (rng.rand(1, 3, s, s, s) > 0.5).astype(np.float32)
        x, y = prepare_batch(images, labels, device, False)
        params = list(model.parameters())
        start = [b.clone() for b in model.buffers()]

        def grads(plain):
            with torch.no_grad():
                for b, b0 in zip(model.buffers(), start):
                    b.copy_(b0)
            with cs.plain_convs() if plain else contextlib.nullcontext():
                return torch.autograd.grad(forward_loss(model, criterion, x, y, False), params)

        out[name] = {}
        for path, plain in (("plain", True), ("kernels", False)):
            for which in ("defaults", "cudnn_deterministic", "deterministic_algorithms"):
                with setting(which):
                    first = grads(plain)
                    spread = max(cs.rel_l2_of(grads(plain), first) for _ in range(args.runs - 1))
                out[name][f"{path}/{which}"] = spread
                print(f"{name} f32 step at {s}^3, {path} path, {which}: largest rel L2 of a "
                      f"run from the first over {args.runs} runs {spread:.3e} [{card}]",
                      flush=True)
        del model
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

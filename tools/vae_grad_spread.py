"""How far the autoencoders' bf16 gradients lie through the hand kernels
and through the plain path, over noise draws and batches, on a CUDA GPU.

    python tools/vae_grad_spread.py [--seeds 0 1 2 3 4]

For each seed: ``chip_smoke.VAR_AUTOENCODER_MODEL`` and
``chip_smoke.AUTOENCODER_MODEL`` in the BraTS config at 128^3, weights
initialised from the seed, a seeded batch with random binary labels, and
``chip_smoke.path_grads`` (one training forward and backward through the
kernels and through ``chip_smoke.plain_convs``, f32 and bf16 AMP, the
VarAutoEncoder's latent noise drawn alike on both paths). Prints, per seed,
the bf16 gradients' relative L2 kernels against the plain path, each path's
bf16 gradients against the plain f32 ones and their ratio (what phase 14's
BF16_EXCESS rule reads), and the f32 kernels-vs-plain gap: how much of a
single draw's reading is noise. Prints the card first and one JSON line
last. Needs a CUDA GPU and nvcc.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("vae_grad_spread: no CUDA device", file=sys.stderr)
        return 2
    from unet3d_tpu_torch.config.factory import (build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.kernels.build import load_library
    from unet3d_tpu_torch.utils.config import load_json

    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    load_library()
    out = {}
    for name, model_cfg in (("VarAutoEncoder", cs.VAR_AUTOENCODER_MODEL),
                            ("AutoEncoder", cs.AUTOENCODER_MODEL)):
        config = load_json(cs.CONFIG)
        config["model"] = dict(model_cfg)
        criterion = load_criterion_from_config(config)
        shape = tuple(config["dataset"]["desired_shape"])
        out[name] = []
        for seed in args.seeds:
            model = build_or_load_model_from_config(config, None, device, seed=seed)
            rng = np.random.RandomState(100 + seed)
            images = rng.randn(1, 4, *shape).astype(np.float32)
            labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
            g = cs.path_grads(model, criterion, images, labels, device, seed)
            b = g["bf16"]
            row = dict(seed=seed, bf16_kernels_vs_plain=b["gradients"],
                       kernels_vs_f32=b["kernels_vs_f32"], plain_vs_f32=b["plain_vs_f32"],
                       ratio=b["kernels_vs_f32"] / b["plain_vs_f32"],
                       f32_kernels_vs_plain=g["f32"]["gradients"])
            out[name].append(row)
            print(f"{name} seed {seed}: bf16 kernels vs plain {row['bf16_kernels_vs_plain']:.3e}; "
                  f"vs f32 kernels {row['kernels_vs_f32']:.3e} plain {row['plain_vs_f32']:.3e} "
                  f"ratio {row['ratio']:.3f}; f32 kernels vs plain "
                  f"{row['f32_kernels_vs_plain']:.3e} [{card}]", flush=True)
            del model
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

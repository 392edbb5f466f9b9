"""The peak bytes of live tensors in one training step of SegResNetVAE,
without remat, with one checkpoint around the whole forward, and with
``training.remat`` (``models/remat.whole_model_remat``: each block of the
root checkpointed), on the CPU.

    python tools/remat_live_bytes.py [--size 64] [--init_filters 16]

A ``TorchDispatchMode`` counts the storage of every tensor an op returns
until it is freed; the peak over the step's forward and backward is what a
device would have to hold for the tensors the step makes (no allocator
caching, no workspaces). One checkpoint around the whole forward rebuilds
every activation before the first gradient, so its peak is that of no
remat; per block, the blocks keep their inputs alone. Prints one line per
mode and one JSON line last.
"""
import argparse
import json
import os
import sys
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class LiveBytes(TorchDispatchMode):
    """The bytes of the tensor storages alive, and their peak, over the ops
    run inside the mode."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.sizes = {}

    def _freed(self, key):
        self.live -= self.sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                storage = t.untyped_storage()
                key = storage.data_ptr()
                if key not in self.sizes:
                    self.sizes[key] = storage.nbytes()
                    self.live += storage.nbytes()
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(storage, self._freed, key)
        return out


def main() -> None:
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.models.remat import remat_class
    from unet3d_tpu_torch.train.losses import DiceLoss
    from unet3d_tpu_torch.train.step import forward_loss, noise_generator, prepare_batch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--init_filters", type=int, default=16)
    args = parser.parse_args()
    s = args.size
    model_cfg = {"name": "SegResNetVAE", "input_image_size": [s, s, s],
                 "init_filters": args.init_filters, "in_channels": 4, "out_channels": 3,
                 "blocks_down": [1, 2, 2, 4], "blocks_up": [1, 1, 1], "vae_nz": 64,
                 "smallest_filters": 16, "dropout_prob": 0.2}
    rng = np.random.RandomState(0)
    images = rng.randn(1, 4, s, s, s).astype(np.float32)
    labels = (rng.rand(1, 3, s, s, s) > 0.5).astype(np.float32)
    peaks = {}
    for mode in ("none", "whole forward", "per block"):
        model = build_or_load_model_from_config({"model": dict(model_cfg)}, None,
                                                torch.device("cpu"),
                                                remat=mode == "per block")
        if mode == "whole forward":
            model.__class__ = remat_class(type(model))
        x, y = prepare_batch(images, labels, torch.device("cpu"), True)
        with LiveBytes() as live:
            forward_loss(model, DiceLoss(sigmoid=True), x, y, True,
                         noise_generator(model, 0)).backward()
        peaks[mode] = live.peak / 2**20
        print(f"remat {mode}: peak live tensors {peaks[mode]:.1f} MiB (CPU, bf16 AMP step, "
              f"1x4x{s}^3, init_filters {args.init_filters})", flush=True)
    print(json.dumps({"peak_mib": peaks, "size": s, "init_filters": args.init_filters}))


if __name__ == "__main__":
    main()

"""How far f32 lies from f64 where a BatchNorm sees few values a channel,
in the JAX package and in the port, on the CPU; and what the BatchNorm nets'
CPU parity tests pay to compile.

    env JAX_PLATFORMS=cpu python tools/bn_f32_conditioning.py [--seeds 1]

For each net of the parity tests (``tests/test_torch_segresnet_ds.py``,
``tests/test_torch_monai_nets.py``, ``tests/test_torch_vnet.py``, each
built by ``test_torch_batchnorm.Net`` as its test builds it, other seeds
after the first), and for VNet at batch 2 besides its tests' batch 4, every
result the tests hold with ``_check_f32``: the training forward's output,
the running statistics it leaves, the first step's gradients, and the
parameters and ``batch_stats`` after two SGD steps in one batch and in 2
microbatches. For each, relative L2: the port against JAX, and each
against JAX's f64 result (``Net.jax_f64`` and the "f64" steps: the JAX
module and step on f64 variables under ``jax.enable_x64``), and the ratio
of the port's distance from f64 to JAX's. Then the compile seconds of
VNet's JAX train step (batch 2) at XLA's default CPU optimisation level
(3) and at levels 2 and 1 (``test_torch_batchnorm.COMPILE``), and of a
jitted ``init`` of SegResNetDS (which the tests replace by
``jax.eval_shape``). Imports both packages, as the tests do; about ten
minutes of CPU.
"""
import argparse
import copy
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import test_torch_batchnorm as bn  # noqa: E402
import test_torch_monai_nets  # noqa: E402
import test_torch_segresnet_ds  # noqa: E402
import test_torch_vnet  # noqa: E402
from test_torch_myronenko import _all, _rel  # noqa: E402
from unet3d_tpu.models.registry import create_model as jax_create_model  # noqa: E402
from unet3d_tpu.train import losses as jax_losses  # noqa: E402
from unet3d_tpu.train import step as jax_step  # noqa: E402

NETS = {
    "SegResNetDS": ("SegResNetDS", test_torch_segresnet_ds.KWARGS, test_torch_segresnet_ds.SHAPE),
    "AttentionUnet": ("AttentionUnet", test_torch_monai_nets.NETS["AttentionUnet"],
                      test_torch_monai_nets.SHAPE),
    "UNet": ("UNet", test_torch_monai_nets.NETS["UNet"], test_torch_monai_nets.SHAPE),
    "VNet": ("VNet", test_torch_vnet.KWARGS, test_torch_vnet.SHAPE),
    "VNet batch 2": ("VNet", test_torch_vnet.KWARGS, (2,) + test_torch_vnet.SHAPE[1:]),
}


def conditioning(label: str, seed: int) -> dict:
    """{check: (port/jax, jax/f64, port/f64)} for one net and seed."""
    name, kwargs, shape = NETS[label]
    n = bn.Net(name, kwargs, shape, seed=seed)
    _, tr, stats = n.jax_f32
    _, tr64, stats64 = n.jax_f64
    net = copy.deepcopy(n.port())
    with torch.no_grad(), bn.no_dropout():
        got = net(torch.from_numpy(n.x), train=True).numpy()
    rows = {"train forward": (got, tr, tr64)}
    keys = sorted(stats)
    if keys:
        rows["statistics"] = (_all(bn._stats(net), keys), _all(stats, keys), _all(stats64, keys))
    grads = {p: n.steps(p, 1)[1] for p in ("port", "jax", "f64")}
    keys = sorted(grads["jax"])
    rows["gradients"] = tuple(_all(grads[p], keys) for p in ("port", "jax", "f64"))
    for accum in (1, 2):
        after = {p: n.steps(p, accum)[2] for p in ("port", "jax", "f64")}
        for collection in ("params/", "batch_stats/"):
            keys = sorted(k for k in after["jax"] if k.startswith(collection))
            if keys:
                rows[f"{collection[:-1]} after 2 steps, {accum} microbatch"
                     f"{'es' if accum > 1 else ''}"] = tuple(
                    _all(after[p], keys) for p in ("port", "jax", "f64"))
    return {k: (_rel(p, j), _rel(j, f), _rel(p, f)) for k, (p, j, f) in rows.items()}


def compile_seconds() -> dict:
    n = bn.Net(*NETS["VNet batch 2"])
    images, labels = n.batches[0]
    out = {}
    levels = [("default", None)] + [(f"level {i}", {"xla_backend_optimization_level": i})
                                     for i in (2, 1)]
    for label, options in levels:
        tx = bn._sgd_keeping_grads(bn.LR)
        state = jax_step.create_train_state(n.fresh(), tx)
        with bn.no_dropout():
            body = jax_step.train_step_body(n.jmod, jax_losses.DiceLoss(sigmoid=True), tx)
            t0 = time.perf_counter()
            jax.jit(body, compiler_options=options).lower(state, images, labels).compile()
        out[f"VNet train step, {label}"] = time.perf_counter() - t0
    model = jax_create_model("SegResNetDS", init_filters=4, in_channels=2, out_channels=3,
                             blocks_down=[1, 1, 1], dsdepth=2)
    x = jnp.zeros((2, 16, 16, 16, 2))
    t0 = time.perf_counter()
    jax.jit(lambda r, v: model.init(r, v)).lower(jax.random.PRNGKey(0), x).compile()
    out["SegResNetDS jitted init"] = time.perf_counter() - t0
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=1)
    args = parser.parse_args()
    torch.manual_seed(0)
    torch.set_num_threads(2)
    for label in NETS:
        for seed in range(args.seeds):
            for check, (pj, jf, pf) in conditioning(label, seed).items():
                print(f"{label} seed {seed} {check}: port/jax {pj:.3e}, jax/f64 {jf:.3e}, "
                      f"port/f64 {pf:.3e}, ratio {pf / jf:.3f}", flush=True)
    for label, seconds in compile_seconds().items():
        print(f"compile: {label} {seconds:.1f} s (CPU)", flush=True)
    return 0


if __name__ == "__main__":
    np.set_printoptions(precision=3)
    sys.exit(main())

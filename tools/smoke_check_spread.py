"""The distribution, over fresh processes, of two f32 checks of
``chip_smoke.py`` on a CUDA GPU, with cuDNN's algorithm choice free and
pinned.

    python tools/smoke_check_spread.py [--runs 8] [--checks vae dp]
                                       [--settings defaults cudnn_deterministic]

Each run is one new Python process that measures one check and prints one
JSON line:

* ``vae``: phase 10's SegResNetVAE f32 step (``chip_smoke.default_tf32_flags``
  after phase 10's window draw and two bf16 AMP steps from seed 0, on a fresh
  model's seeded initial weights, as phase 10 checks them): the kernels'
  gradients and the plain path's against the f64 plain path, and the excess
  that ``F64_EXCESS_BOUND`` holds; then the kernels' step once more in the
  same process, against the first (the spread within one process).
* ``dp``: phase 17's two gloo ranks on the card
  (``chip_smoke.phase17_two_ranks``): each rank's f32 updates against the
  batch-2 step, and the batch-2 f32 step's own run-to-run spread, which set
  the bound ``max(DP_BOUNDS["f32"], 2 * spread)``.

Each run also records ``chip_smoke.state_digest`` of the weights its check
reads (``state``): where the digests of all the runs agree, every process
checked one weight state.

For ``vae`` each process also records the cuDNN and cuBLAS kernels (by
name, from ``torch.profiler``) that one f32 gradient of each path ran, and
the summary counts the distinct sets over the processes: which algorithms
cuDNN chose in each. ``cudnn_deterministic`` sets
``torch.backends.cudnn.deterministic`` in every process of the run (the
ranks too), so cuDNN takes only its deterministic algorithms. The checks' bounds
are read, never changed: a run past its bound is recorded, not fatal. Prints
the card first, then per check and setting the values over the runs, and
one JSON line last. Needs a CUDA GPU and nvcc (the first run builds the
kernels; the others load them).
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DETERMINISTIC_ENV = "SMOKE_CHECK_CUDNN_DETERMINISTIC"


def _settle() -> None:
    import torch
    if os.environ.get(DETERMINISTIC_ENV) == "1":
        torch.backends.cudnn.deterministic = True


def dp_rank(path, seed):
    """``chip_smoke.phase17_rank`` under this run's cuDNN setting (the ranks
    are spawned processes: the setting travels in the environment)."""
    import chip_smoke
    _settle()
    return chip_smoke.phase17_rank(path, seed)


def one_vae(cs) -> dict:
    import numpy as np
    import torch
    from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.train.step import (forward_loss, make_train_step, noise_generator,
                                             prepare_batch)
    from unet3d_tpu_torch.utils.config import load_json

    seed, device = 0, torch.device("cuda")
    config = load_json(cs.CONFIG)
    config["model"] = dict(cs.SEGRESNET_MODEL)
    shape = tuple(config["dataset"]["desired_shape"])
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    criterion = load_criterion_from_config(config)
    rng = np.random.RandomState(seed + 20)
    rng.randn(1, *shape, 4)  # phase 10's window
    images = rng.randn(1, 4, *shape).astype(np.float32)
    labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
    step = make_train_step(model, criterion, build_optimizer_from_config(
        config, model.parameters()), amp=True, seed=seed)
    for _ in range(2):  # phase 10's warm-up and measured bf16 steps
        step(images, labels)
    model = build_or_load_model_from_config(config, None, device, seed=seed)  # as phase 10
    out = cs.default_tf32_flags(model, criterion, images, labels, device, seed)
    out["excess"] = out["kernels_vs_f64"] - out["plain_vs_f64"]
    x, y = prepare_batch(images, labels, device, False)

    def kernel_grads():
        loss = forward_loss(model, criterion, x, y, False, noise_generator(model, seed))
        return torch.autograd.grad(loss, list(model.parameters()))
    out["kernels_in_process"] = cs.rel_l2_of(kernel_grads(), kernel_grads())
    # the cuDNN / cuBLAS kernels each path's f32 gradients ran (TF32 off, as
    # the check's plain path runs), by name
    torch.backends.cudnn.allow_tf32 = False
    try:
        with cs.plain_convs():
            out["plain_library_kernels"] = library_kernels(kernel_grads)
        out["kernels_library_kernels"] = library_kernels(kernel_grads)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    return out


def library_kernels(fn) -> list:
    """The names of the device kernels ``fn`` runs that are neither the
    port's hand kernels nor torch's own elementwise, reduction and copy
    kernels: cuDNN's and cuBLAS's, whose algorithm each call chose."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hand = ("conv3x3x3", "s2_wgrad", "sum_splits", "winograd")
    torch_own = ("at::native", "elementwise", "reduce", "Memcpy", "Memset", "copy")
    names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    return sorted(n[:120] for n in names
                  if not any(h in n for h in hand) and not any(t in n for t in torch_own))


def one_dp(cs) -> dict:
    import torch
    cs.phase17_rank = dp_rank
    got = cs.phase17_two_ranks(torch.device("cuda", 0), 0, cs.card_line())[1]
    return {"ranks_f32": [r["f32"] for r in got["ranks"]],
            "state": got["state"], "rank_states": [r["state"] for r in got["ranks"]],
            "plain_f32_run_to_run": got["plain_f32_run_to_run"],
            "bound": max(cs.DP_BOUNDS["f32"], 2 * got["plain_f32_run_to_run"])}


def one(check: str) -> int:
    import chip_smoke as cs
    from unet3d_tpu_torch.kernels.build import load_library
    failures = []
    cs.check = lambda cond, msg: cond or failures.append(msg)
    _settle()
    load_library()
    t0 = time.perf_counter()
    out = one_vae(cs) if check == "vae" else one_dp(cs)
    out.update(failures=failures, seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=8)
    parser.add_argument("--checks", nargs="+", default=["vae", "dp"], choices=["vae", "dp"])
    parser.add_argument("--settings", nargs="+", default=["defaults", "cudnn_deterministic"],
                        choices=["defaults", "cudnn_deterministic"])
    parser.add_argument("--one", choices=["vae", "dp"], help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        return one(args.one)
    import torch
    if not torch.cuda.is_available():
        print("smoke_check_spread: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    card = chip_smoke.card_line()
    print(card, flush=True)
    results = {}
    for check in args.checks:
        for setting in args.settings:
            env = dict(os.environ, **{DETERMINISTIC_ENV: str(int(setting != "defaults"))})
            rows = []
            for run in range(args.runs):
                proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", check],
                                      env=env, capture_output=True, text=True, cwd=REPO)
                lines = proc.stdout.strip().splitlines()
                if proc.returncode != 0 or not lines:
                    print(f"{check} {setting} run {run}: exit {proc.returncode}\n"
                          f"{proc.stderr[-3000:]}", flush=True)
                    return 1
                rows.append(json.loads(lines[-1]))
                print(f"{check} {setting} run {run}: {lines[-1]}", flush=True)
            results[f"{check}/{setting}"] = rows
            keys = (("excess", "kernels_vs_f64", "plain_vs_f64", "kernels_in_process")
                    if check == "vae" else ("ranks_f32", "plain_f32_run_to_run"))
            states = {r["state"] for r in rows} | {s for r in rows for s in r.get("rank_states", [])}
            print(f"{check} {setting}: {len(states)} distinct weight states over {len(rows)} "
                  f"processes: {sorted(states)}", flush=True)
            if check == "vae":  # which library kernels each process chose
                for path in ("plain", "kernels"):
                    sets = [tuple(r[f"{path}_library_kernels"]) for r in rows]
                    print(f"{check} {setting} {path} path: {len(set(sets))} distinct sets of "
                          f"cuDNN / cuBLAS kernels over {len(rows)} processes; per process "
                          f"{[sorted(set(sets)).index(x) for x in sets]}", flush=True)
                    for i, names in enumerate(sorted(set(sets))):
                        print(f"  set {i}: {list(names)}", flush=True)
            for key in keys:
                values = [r[key] for r in rows]
                print(f"{check} {setting} {key} over {len(rows)} processes: {values} [{card}]",
                      flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

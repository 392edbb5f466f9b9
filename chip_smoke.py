"""Drive the PyTorch port's BraTS prediction, training and CLI paths once on one CUDA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an H100 (sm_90). Phases:

0. the card (nvidia-smi name and power limit), torch / CUDA versions, SM;
   TF32 off, so f32 comparisons are exact to f32 rounding;
1. build the CUDA kernels from ``unet3d_tpu_torch/ops/kernels/`` (timed);
2. each kernel against its plain PyTorch version, bf16 and f32, at the
   DynUNet's shapes: the three conv variants at the forward's shapes
   (relative bounds 1e-5 in f32 and 1e-2 in bf16 on y, 1e-4 on the
   statistics: f32 atomics change the sum order run to run), the ``conv``
   variant as the input gradient (flipped, in/out-transposed weight) at the
   level-0 shapes, and ``s2_wgrad`` at the five stride-2 convs (relative
   1e-4: f32 sums of up to 262,144 products in another order; its bf16 calls
   take the wgmma form, ``s2_wgrad_wgmma.cu``, each timed against cuDNN's
   weight gradient beside its bound); the two
   Winograd-DH variants (``winograd``, ``winograd_stats``) at the shapes
   where UNET3D_TPU_CONV=winograd sends them (C >= 96 at >= 64^3: three
   forward sites and two input gradients), against their plain Winograd
   version (the same bounds as the direct kernels) and the direct conv's
   (2e-2 in bf16: the input transform rounds twice; 1e-4 in f32), each call's
   form printed (every bf16 one takes the wgmma form, ``winograd_wgmma.cu``,
   or the smoke fails), each bf16 case timed against the direct hand kernel
   and cuDNN. Every bf16 time
   is a device time (the calls queued behind a device-side sleep, so the
   host's time to issue them is not counted), printed beside the plain
   composition's, one PyTorch call's where one
   computes the same function (``F.conv3d``, cuDNN's weight gradient), and
   the bound: the larger of the operations at 989 TFLOP/s and the bytes
   (inputs read once, outputs written once) at 3.35 TB/s. The direct conv is
   timed at every SHAPES site in the variant that site runs and at both
   DX_SHAPES; its bf16 calls (Cin a multiple of 4, Cout of 8: every site)
   take the wgmma form (``conv3d_wgmma.cu``);
3. the slice: the BraTS DynUNet of ``examples/brats2020/brats2020_config.json``
   (seeded random weights, no trained checkpoint in the repo), its sliding-
   window inferer and sigmoid, answering two requests through
   ``volumetric_predictions`` in bf16: (1,4,128,128,128), one window, and the
   raw BraTS grid (1,4,240,240,155), 18 windows. The NIfTI outputs are read
   back and checked (shape, finite, in [0, 1], affine). The direct conv's
   launches by form are printed, and any bf16 site off the wgmma form fails;
   one window's forward is profiled (device time by kernel group, span, idle
   share);
4. the launch count of every kernel on the path (``conv_stats``,
   ``block_stats``) grew during phase 3, and the whole forward on one 128^3
   window, kernels against the plain path, agrees within relative L2 3e-2 in
   bf16; both forwards timed (plain, kernels, kernels, plain). The ``conv``
   variant (no statistics) and ``s2_wgrad`` have no site in the forward: they
   run in training;
5. training: the same model, DiceLoss, Adam and ReduceLROnPlateau from the
   config, through ``make_train_step`` / ``make_eval_step`` / ``run_training``,
   2 epochs of 3 bf16 AMP steps on one seeded (1,4,128,128,128) batch with
   random binary labels, validated on one 128^3 case through the sliding-window
   inferer, checkpoints in ``build/chip_smoke/``. Checks: finite losses, the
   last step's below the first; 2 CSV rows; ``model.npz`` reloads into a
   fresh model equal to the trained one; all four kernels launched during the
   training. Then one step's gradients, kernels against the plain path
   (cuDNN, torch autograd, the same weights and batch): relative L2 over all
   parameters within 1e-3 in f32 (the f32 gradient of this net lies ~1.5e-4
   from an f64 one on either path: the instance norms amplify sum-order
   differences) and 2e-2 in bf16 (each path ~1.3e-2 from f64); and the
   train-step time with kernels and plain, and the peak memory; the launches
   by form of the direct conv and of ``s2_wgrad`` over the training run,
   failing on any bf16 launch off the wgmma form, and one step of each path
   profiled;
6. the predict CLI: two synthetic BraTS-grid cases (four modalities of
   240 x 240 x 155 int16, zero around a seeded ellipsoid, uncompressed
   ``.nii``), the seeded model's ``.npz`` checkpoint and a copy of the BraTS
   config whose ``bratsvalidation_filenames`` names them, through
   ``scripts.predict.main(... --group bratsvalidation --activation
   sigmoid)`` in this process: crop to foreground, resize to 128^3,
   normalise, one bf16 forward, sigmoid, trilinear resample back to the
   native grid, ``.nii.gz`` write. Run with the default routing and with
   UNET3D_TPU_CONV=winograd. Checks: one file per case on the native grid,
   3 channels, the source affine, finite, in [0, 1]; Winograd launches only
   with the strategy; every bf16 launch of the direct conv and of Winograd in
   the wgmma form; the two runs within relative L2 3e-2 of each other.
   Prints each case's seconds: read + preprocess, forward, resample, write;
7. one bf16 train step under UNET3D_TPU_CONV=winograd: the launch counts of
   one step (``winograd`` as the input gradient of the three 64^3 sites) and
   its launches by form, checked as in phase 5,
   its gradients against the plain path within the phase-5 bounds, and its
   time beside the default routing's (default, winograd, winograd, default);
8. the train CLI: four labelled synthetic BraTS-grid cases (phase 6's
   modalities plus a ``seg`` with labels 1, 2 and 4) under
   ``build/chip_smoke_train/`` and a copy of the BraTS config that differs
   only in its file lists (the four cases; ``bratsvalidation`` one of them),
   2 epochs and 2 cross-validation folds; the model, 128^3 shape,
   augmentations, AMP, loss, optimizer, scheduler and inferer as published.
   ``scripts.train.main(... --setup_crossval_only)`` must split the cases
   2/2 into ``fold1.json`` / ``fold2.json``; then ``main`` trains fold 1.
   Checks: the four training kernels launched in the wgmma form during the
   training (and no bf16 launch off it); every training batch reached the
   step in bf16 on the card, copied from pinned memory; the first step's
   batch equals its sample rebuilt on the CPU from the dataset at the same
   epoch and index; 2 log rows with finite losses; the checkpoint reloads
   equal; the ``bratsvalidation`` prediction is on the source grid with the
   source affine, in [0, 1], and within relative L2 3e-2 of the predict CLI
   run on the saved checkpoint. Prints seconds per epoch, each step's ms
   (CUDA events around the step), the loader's wait per step with the
   training samples' host ms by stage (preprocess, augment), each epoch's
   seconds by part (training waits and steps, validation waits, the rest),
   each batch's H2D span on the prefetcher's side stream and one batch's
   copy alone from pinned memory, and the launches.

Exits non-zero if any phase fails or there is no CUDA device. The last lines
are the card, a JSON object of the kernels, and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "examples", "brats2020", "brats2020_config.json")
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_cli")
TRAIN_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
# the bf16 form of each kernel on the path (conv3d.cu, s2_wgrad.cu and
# winograd.cu keep the f32 form and a bf16 WMMA form for channel counts no
# DynUNet site has)
SOURCES = {
    "conv": "unet3d_tpu_torch/ops/kernels/conv3d_wgmma.cu",
    "conv_stats": "unet3d_tpu_torch/ops/kernels/conv3d_wgmma.cu",
    "block_stats": "unet3d_tpu_torch/ops/kernels/conv3d_wgmma.cu",
    "s2_wgrad": "unet3d_tpu_torch/ops/kernels/s2_wgrad_wgmma.cu",
    "winograd": "unet3d_tpu_torch/ops/kernels/winograd_wgmma.cu",
    "winograd_stats": "unet3d_tpu_torch/ops/kernels/winograd_wgmma.cu",
}
REPLACES = {
    "conv": "unet3d_tpu/ops/pallas/conv3d_kernel.py:154",
    "conv_stats": "unet3d_tpu/ops/pallas/winograd_kernel.py:274",
    "block_stats": "unet3d_tpu/ops/pallas/block_kernel.py:171",
    "s2_wgrad": "unet3d_tpu/ops/pallas/s2_wgrad_kernel.py:177",
    "winograd": "unet3d_tpu/ops/pallas/winograd_kernel.py:229",
    "winograd_stats": "unet3d_tpu/ops/pallas/winograd_kernel.py:274",
}
# (label, spatial, cin, cout): the stride-1 3x3x3 convs of the BraTS DynUNet.
# Per window the path runs conv_stats at input_block.conv1 and at every
# up-block conv1 (on the concatenated (upsampled, skip), 6 launches) and
# block_stats at every block's conv2 (11 launches).
SHAPES = [
    ("input conv1 4->64 @128^3", 128, 4, 64),
    ("level-0 conv 64->64 @128^3", 128, 64, 64),
    ("up-block conv1 128->64 @128^3", 128, 128, 64),
    ("level-1 conv 96->96 @64^3", 64, 96, 96),
    ("up-block conv1 192->96 @64^3", 64, 192, 96),
    ("bottleneck conv2 384->384 @4^3", 4, 384, 384),
]
# the variant each SHAPES site runs in the forward (and so in training)
SITE_VARIANT = ("conv_stats", "block_stats", "conv_stats", "block_stats", "conv_stats",
                "block_stats")
# (label, spatial, cin, cout) of the input gradients the conv kernel takes
# at level 0: dx of a conv2 and of an up-block conv1 (64 -> 128 channels)
DX_SHAPES = [
    ("dx of level-0 conv2 64->64 @128^3", 128, 64, 64),
    ("dx of up-block conv1 64->128 @128^3", 128, 64, 128),
]
# (label, spatial of x, cin, cout): the stride-2 convs, whose weight gradient
# s2_wgrad computes (x at that size, the cotangent at half of it)
S2_SHAPES = [
    ("s2 64->96 @128^3", 128, 64, 96),
    ("s2 96->128 @64^3", 64, 96, 128),
    ("s2 128->192 @32^3", 32, 128, 192),
    ("s2 192->256 @16^3", 16, 192, 256),
    ("s2 256->384 @8^3", 8, 256, 384),
]
# (label, spatial, cin, cout): where UNET3D_TPU_CONV=winograd runs the
# Winograd kernels in the BraTS DynUNet at 128^3 (input C >= 96 at >= 64^3):
# three forward sites with statistics (a fourth, upsample3.conv2, has the
# first's shape) and the two input-gradient shapes of the three 64^3 sites
WINO_SHAPES = [
    ("downsample0.conv2 96->96 @64^3", 64, 96, 96),
    ("upsample3.conv1 192->96 @64^3", 64, 192, 96),
    ("upsample4.conv1 128->64 @128^3", 128, 128, 64),
    ("dx of a 96->96 conv @64^3", 64, 96, 96),
    ("dx of upsample3.conv1 96->192 @64^3", 64, 96, 192),
]
# the kernels each path launches, and the shape each kernel's time is
# reported at (its largest on the path; conv at the level-0 conv2's dx;
# winograd at the dx it runs in training)
PREDICT_KERNELS = ("conv_stats", "block_stats")
TRAIN_KERNELS = ("conv", "conv_stats", "block_stats", "s2_wgrad")
STRATEGY_KERNELS = ("winograd", "winograd_stats")
TIMED_AT = {"conv_stats": 2, "block_stats": 1, "winograd": 3, "winograd_stats": 2}
# dense peaks of one H100 SXM (NVIDIA's data sheet, at 700 W) for the bounds
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Winograd-DH's channel products per output against the direct conv's
WINOGRAD_PRODUCTS = 48 / 108
BOUNDS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
STATS_BOUND = 1e-4
WINO_DIRECT_BOUNDS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
S2_BOUND = 1e-4
L2_BOUND = 3e-2
GRAD_BOUND_F32 = 1e-3
GRAD_BOUND_BF16 = 2e-2
TRAIN_EPOCHS, TRAIN_STEPS = 2, 3
# phase 8: labelled cases, epochs and cross-validation folds of the train CLI
TRAIN_CLI_CASES, TRAIN_CLI_EPOCHS, TRAIN_CLI_FOLDS = 4, 2, 2


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def reset_launches() -> None:
    from unet3d_tpu_torch.ops import conv3d_kernel, s2_wgrad_kernel, winograd_kernel
    conv3d_kernel.reset_launches()
    s2_wgrad_kernel.reset_launches()
    winograd_kernel.reset_launches()


def launch_counts() -> dict:
    from unet3d_tpu_torch.ops import conv3d_kernel, s2_wgrad_kernel, winograd_kernel
    return {**conv3d_kernel.LAUNCHES, **s2_wgrad_kernel.LAUNCHES,
            **winograd_kernel.LAUNCHES}


@contextlib.contextmanager
def conv_strategy(strategy):
    """UNET3D_TPU_CONV set to ``strategy`` (None: unset) inside the block."""
    os.environ.pop("UNET3D_TPU_CONV", None)
    if strategy:
        os.environ["UNET3D_TPU_CONV"] = strategy
    try:
        yield
    finally:
        os.environ.pop("UNET3D_TPU_CONV", None)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """ms per call of ``fn`` by CUDA events, the host's time to issue each
    call included where it is the longer (a forward's launches)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# device clock cycles the card idles per queued call in device_ms: ~1 ms at
# the H100's clocks, far more than a wrapper's host time per call
QUEUE_CYCLES_PER_CALL = 2_000_000


def device_ms(fn, reps: int = 5) -> float:
    """The device's ms per call of ``fn``: the calls are queued behind a
    device-side sleep, so the events time their kernels back to back and not
    the host's time to issue them (tens of microseconds per wrapper call,
    more than a deep site's kernel)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, dtype=torch.bfloat16):
    """The least time the card could take: the larger of the operations at
    the dtype's peak and the bytes (each input read once, each output written
    once) at the memory rate; and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def conv_bound(variant, s, cin, cout, products=1.0):
    """bound_ms of one bf16 3x3x3 conv variant on (1, s, s, s, cin) -> cout."""
    vox = s ** 3
    nbytes = 2 * (vox * (cin + cout) + 27 * cin * cout)
    nbytes += 8 * cout if variant in ("conv_stats", "block_stats", "winograd_stats") else 0
    nbytes += 8 * cin if variant == "block_stats" else 0
    return bound_ms(2.0 * vox * 27 * cin * cout * products, nbytes)


def library_conv(x, w):
    """One PyTorch call for the conv alone (cuDNN): F.conv3d on the NCDHW view
    (channels_last_3d, no copy) of the same NDHWC operands."""
    wn = w.permute(4, 3, 0, 1, 2).contiguous()
    xn = x.permute(0, 4, 1, 2, 3)
    return lambda: F.conv3d(xn, wn, padding=1)


def form_launches() -> dict:
    """Launches by (kernel, form) of the direct conv, s2_wgrad and Winograd."""
    from unet3d_tpu_torch.ops import conv3d_kernel, s2_wgrad_kernel, winograd_kernel
    return {**conv3d_kernel.FORM_LAUNCHES, **s2_wgrad_kernel.FORM_LAUNCHES,
            **winograd_kernel.FORM_LAUNCHES}


def form_counts() -> str:
    forms = {f"{v}/{f}": n for (v, f), n in sorted(form_launches().items())}
    return f"direct conv, s2_wgrad and Winograd launches by form {forms}"


def check_forms(where: str) -> None:
    """In a bf16 run, every direct conv, s2_wgrad and Winograd call took the
    wgmma form."""
    off = {k: n for k, n in form_launches().items() if k[1] != "wgmma"}
    check(not off, f"{where}: bf16 sites off the wgmma form: {off}")


def profile_device(fn, label: str, card: str) -> dict:
    """Device time of one call of ``fn`` by kernel group (torch.profiler),
    its device span and idle share; printed, and returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile {label}: no device events traced (not measured)", flush=True)
        return {}
    groups = (("conv wgmma", "conv3x3x3_wgmma"), ("conv wmma/fma", "conv3x3x3_ndhwc"),
              ("s2_wgrad", "s2_wgrad"), ("s2_wgrad", "sum_splits"),
              ("winograd", "winograd3x3x3"), ("winograd", "winograd_wgmma"),
              ("memcpy/memset", "mem"), ("copies and casts", "copy"),
              ("reductions", "reduce"), ("elementwise", "elementwise"))
    by_group, by_name = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        lname = e.name.lower()
        group = next((g for g, key in groups if key.lower() in lname), "other (cuDNN, cuBLAS, ...)")
        by_group[group] = by_group.get(group, 0.0) + ms
        by_name[e.name[:70]] = by_name.get(e.name[:70], 0.0) + ms
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    span = (spans[-1][1] - spans[0][0]) / 1e3
    total = sum(by_group.values())
    idle = 1.0 - busy / 1e3 / span
    print(f"profile {label}: device {total:.3f} ms in {len(kernels)} kernels, span "
          f"{span:.3f} ms, idle {idle:.1%} [{card}]", flush=True)
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:28s} {ms:9.3f} ms {ms / total:6.1%}", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:9.3f} ms  {name}", flush=True)
    return dict(device_ms=total, span_ms=span, idle=idle, groups=by_group)


def plain_fast(variant, x, w, inv, shift):
    """The plain PyTorch composition in the working dtype (cuDNN conv, torch
    elementwise and reductions): what the kernel is timed against."""
    from unet3d_tpu_torch.ops.conv3d import conv3d_torch
    from unet3d_tpu_torch.ops.conv3d_kernel import instance_stats
    if variant == "block_stats":
        x = F.leaky_relu(x * inv[:, None, None, None, :].to(x.dtype)
                         + shift[:, None, None, None, :].to(x.dtype), 0.01)
    y = conv3d_torch(x, w, (1, 1, 1), ((1, 1),) * 3)
    if variant == "conv":
        return y
    return (y, *instance_stats(y))


def stats_err(y, s1, s2) -> float:
    """The statistics against an f64 sum of the kernel's own rounded y."""
    yd = y.double()
    return max(((s1 - yd.sum((1, 2, 3))).abs().max()
                / yd.abs().sum((1, 2, 3)).max()).item(),
               ((s2 - (yd * yd).sum((1, 2, 3))).abs().max()
                / (yd * yd).sum((1, 2, 3)).max()).item())


def phase2(device, gen):
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    kernel = {"conv": K.conv3x3x3, "conv_stats": K.conv3x3x3_with_stats,
              "block_stats": K.conv3x3x3_block_with_stats}
    plain = {"conv": K.conv3d_reference,
             "conv_stats": K.conv3d_with_stats_reference,
             "block_stats": K.conv3d_block_with_stats_reference}
    report = {v: {"max_abs_err": 0.0} for v in kernel}
    for si, (label, s, cin, cout) in enumerate(SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(dtype)
            w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
                 / (27 * cin) ** 0.5).to(dtype)
            inv = torch.rand(1, cin, device=device, generator=gen) + 0.5
            shift = torch.randn(1, cin, device=device, generator=gen) * 0.3
            for variant in kernel:
                args = (x, w) if variant != "block_stats" else (x, w, inv, shift)
                got, want = kernel[variant](*args), plain[variant](*args)
                got_y = got if variant == "conv" else got[0]
                want_y = want if variant == "conv" else want[0]
                torch.cuda.synchronize()
                diff = (got_y.float() - want_y.float()).abs().max().item()
                rel = diff / want_y.float().abs().max().item()
                msg = f"{variant:11s} {label:31s} {str(dtype)[6:]:8s} y rel {rel:.3e}"
                check(rel < BOUNDS[dtype], f"{msg} > {BOUNDS[dtype]}")
                if variant != "conv":
                    s_err = stats_err(*got)
                    msg += f" stats rel {s_err:.3e}"
                    check(s_err < STATS_BOUND, f"{msg} > {STATS_BOUND}")
                if variant == SITE_VARIANT[si] and dtype == torch.bfloat16:
                    ms = device_ms(lambda: kernel[variant](*args))
                    plain_ms = device_ms(lambda: plain_fast(variant, x, w, inv, shift))
                    library_ms = device_ms(library_conv(x, w))
                    bms, bound_by = conv_bound(variant, s, cin, cout)
                    msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d "
                            f"{library_ms:.3f} ms, bound {bms:.3f} ms ({bound_by}, "
                            f"{bms / ms:.1%})")
                    if si == TIMED_AT.get(variant):
                        # no one PyTorch call takes the statistics with the conv
                        report[variant].update(
                            ms=ms, plain_ms=plain_ms, shape=label, max_abs_err=diff,
                            bound_ms=bms, bound_by=bound_by, library_ms=None)
                print(msg, flush=True)
            del x, w
    torch.cuda.empty_cache()
    return report


def rel_max(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def phase2_backward(device, gen, report):
    """The conv kernel as the input gradient, and s2_wgrad, against their
    plain versions; each bf16 case timed against the plain composition in
    bf16 (cuDNN), the first shape's time reported."""
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
    from unet3d_tpu_torch.ops.conv3d import conv3d_torch, flip_io

    for si, (label, s, cin, cout) in enumerate(DX_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            # the cotangent of a conv with cin outputs, and its cin -> cout weight
            g = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(dtype)
            w = (torch.randn(3, 3, 3, cout, cin, device=device, generator=gen)
                 / (27 * cin) ** 0.5).to(dtype)
            wf = flip_io(w)
            got, want = K.conv3x3x3(g, wf), K.conv3d_reference(g, wf)
            torch.cuda.synchronize()
            rel = rel_max(got, want)
            msg = f"conv as dx  {label:36s} {str(dtype)[6:]:8s} rel {rel:.3e}"
            check(rel < BOUNDS[dtype], f"{msg} > {BOUNDS[dtype]}")
            if dtype == torch.bfloat16:
                ms = device_ms(lambda: K.conv3x3x3(g, wf))
                plain_ms = device_ms(lambda: conv3d_torch(g, wf, (1, 1, 1), ((1, 1),) * 3))
                library_ms = device_ms(library_conv(g, wf))
                bms, bound_by = conv_bound("conv", s, cin, cout)
                msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d "
                        f"{library_ms:.3f} ms, bound {bms:.3f} ms ({bound_by}, "
                        f"{bms / ms:.1%})")
                if si == 0:
                    report["conv"] = dict(
                        ms=ms, plain_ms=plain_ms, shape=label, bound_ms=bms,
                        bound_by=bound_by, library_ms=library_ms,
                        max_abs_err=(got.float() - want.float()).abs().max().item())
            print(msg, flush=True)
            del g, w, wf, got, want
    for si, (label, s, cin, cout) in enumerate(S2_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(dtype)
            g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device,
                            generator=gen).to(dtype)
            got, want = W.s2_wgrad(x, g), W.s2_wgrad_reference(x, g)
            torch.cuda.synchronize()
            rel = rel_max(got, want)
            msg = (f"s2_wgrad    {label:36s} {str(dtype)[6:]:8s} "
                   f"{W.kernel_form(x, g):5s} rel {rel:.3e}")
            check(rel < S2_BOUND, f"{msg} > {S2_BOUND}")
            if dtype == torch.bfloat16:
                xn, gn = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
                ms = device_ms(lambda: W.s2_wgrad(x, g))
                plain_ms = device_ms(lambda: torch.nn.grad.conv3d_weight(
                    xn, (cout, cin, 3, 3, 3), gn, stride=2, padding=1))
                # dw: 27 * cin * cout products per output voxel; x and g read,
                # the f32 weight gradient written
                half = (s // 2) ** 3
                bms, bound_by = bound_ms(2.0 * half * 27 * cin * cout,
                                         2 * (s ** 3 * cin + half * cout) + 4 * 27 * cin * cout)
                msg += (f" | kernel {ms:.3f} ms, cuDNN {plain_ms:.3f} ms, bound {bms:.3f} ms "
                        f"({bound_by}, {bms / ms:.1%})")
                if si == 0:
                    # the plain composition is one PyTorch call (cuDNN's dw)
                    report["s2_wgrad"] = dict(ms=ms, plain_ms=plain_ms, shape=label,
                                              bound_ms=bms, bound_by=bound_by,
                                              library_ms=plain_ms,
                                              max_abs_err=(got - want).abs().max().item())
            print(msg, flush=True)
            del x, g, got, want
    torch.cuda.empty_cache()


def phase2_winograd(device, gen, report):
    """Both Winograd variants against their plain Winograd version and the
    direct conv's plain version; each bf16 case timed against the direct
    hand kernel and the plain composition in bf16 (cuDNN)."""
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    from unet3d_tpu_torch.ops import winograd_kernel as W
    kernel = {"winograd": W.winograd3x3x3, "winograd_stats": W.winograd3x3x3_with_stats}
    direct = {"winograd": ("conv", K.conv3x3x3),
              "winograd_stats": ("conv_stats", K.conv3x3x3_with_stats)}
    for si, (label, s, cin, cout) in enumerate(WINO_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(dtype)
            w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
                 / (27 * cin) ** 0.5).to(dtype)
            want, want_direct = W.winograd_reference(x, w), K.conv3d_reference(x, w)
            for variant in kernel:
                got = kernel[variant](x, w)
                got_y = got if variant == "winograd" else got[0]
                torch.cuda.synchronize()
                rel, rel_direct = rel_max(got_y, want), rel_max(got_y, want_direct)
                form = W.kernel_form(x, w)
                msg = (f"{variant:14s} {label:36s} {str(dtype)[6:]:8s} {form:5s} y rel "
                       f"{rel:.3e}, vs direct {rel_direct:.3e}")
                check(dtype != torch.bfloat16 or form == "wgmma",
                      f"{msg}: a bf16 call off the wgmma form")
                check(rel < BOUNDS[dtype], f"{msg} > {BOUNDS[dtype]}")
                check(rel_direct < WINO_DIRECT_BOUNDS[dtype],
                      f"{msg} > {WINO_DIRECT_BOUNDS[dtype]}")
                if variant == "winograd_stats":
                    s_err = stats_err(*got)
                    msg += f" stats rel {s_err:.3e}"
                    check(s_err < STATS_BOUND, f"{msg} > {STATS_BOUND}")
                if dtype == torch.bfloat16:
                    plain_variant, direct_fn = direct[variant]
                    ms = device_ms(lambda: kernel[variant](x, w))
                    direct_ms = device_ms(lambda: direct_fn(x, w))
                    plain_ms = device_ms(lambda: plain_fast(plain_variant, x, w, None, None))
                    # Winograd-DH issues 48 of the direct conv's 108 products
                    bms, bound_by = conv_bound(variant, s, cin, cout, WINOGRAD_PRODUCTS)
                    msg += (f" | kernel {ms:.3f} ms, direct kernel {direct_ms:.3f} ms, "
                            f"cuDNN {plain_ms:.3f} ms, bound {bms:.3f} ms ({bound_by}, "
                            f"{bms / ms:.1%})")
                    if si == TIMED_AT[variant]:
                        report[variant] = dict(
                            ms=ms, plain_ms=plain_ms, direct_ms=direct_ms, shape=label,
                            bound_ms=bms, bound_by=bound_by,
                            library_ms=plain_ms if variant == "winograd" else None,
                            max_abs_err=(got_y.float() - want.float()).abs().max().item())
                print(msg, flush=True)
            del x, w, want, want_direct
    torch.cuda.empty_cache()


def plain_block(block, x):
    """Basic block through F.conv3d and the concat, as the JAX model runs it."""
    from unet3d_tpu_torch.ops.conv3d import conv3d_torch, _pads
    from unet3d_tpu_torch.ops.conv3d_kernel import instance_stats
    from unet3d_tpu_torch.ops.norm import instance_norm_from_stats
    if isinstance(x, tuple):
        x = torch.cat(x, dim=-1)
    for conv, norm in ((block.conv1, block.norm1), (block.conv2, block.norm2)):
        y = conv3d_torch(x, conv.kernel, conv.strides, _pads("SAME", conv.kernel_size))
        y = instance_norm_from_stats(y, *instance_stats(y), norm.scale, norm.bias)
        x = F.leaky_relu(y, 0.01)
    return x


def plain_forward(net, x):
    n = net.n_levels
    skips = [plain_block(net.input_block, x)]
    for i in range(1, n - 1):
        skips.append(plain_block(getattr(net, f"downsample{i - 1}"), skips[-1]))
    h = plain_block(net.bottleneck, skips[-1])
    for i in range(n - 2, -1, -1):
        up = getattr(net, f"upsample{n - 2 - i}")
        h = plain_block(up.conv_block, (up.transp_conv(h), skips[i]))
    return net.output_block(h)


def phase3(device, seed, card):
    from unet3d_tpu_torch.config.factory import (build_inferer_from_config,
                                                 build_or_load_model_from_config,
                                                 get_activation_from_config)
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.predict.sliding_window import (_scan_interval,
                                                         dense_patch_slices)
    from unet3d_tpu_torch.predict.volumetric import volumetric_predictions
    from unet3d_tpu_torch.utils.config import load_json

    config = load_json(CONFIG)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    inferer = build_inferer_from_config(config)
    activation = get_activation_from_config(config)
    amp = bool(config["training"]["amp"])
    print(f"model DynUNet filters {config['model']['filters']}, {n_params} params; "
          f"inferer roi {inferer.roi_size} overlap {inferer.overlap} {inferer.mode}; "
          f"activation {activation}; amp {amp}", flush=True)
    rng = np.random.RandomState(seed)
    affine = np.array([[-1.0, 0, 0, 120.0], [0, -1.0, 0, 120.0],
                       [0, 0, 1.0, -77.0], [0, 0, 0, 1]])
    cases = {"A": (128, 128, 128), "B": (240, 240, 155)}
    images = {k: rng.randn(1, 4, *s).astype(np.float32) for k, s in cases.items()}
    shutil.rmtree(OUT_DIR, ignore_errors=True)

    def request(name):
        batch = {"image": images[name], "affine": [affine],
                 "source_filename": [f"case{name}.nii.gz"]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = volumetric_predictions(model, [batch], OUT_DIR, activation=activation,
                                         resample=False, inferer=inferer, amp=amp)
        torch.cuda.synchronize()
        return written, time.perf_counter() - t0

    request("A")  # warm-up: cuDNN plans, the allocator
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    seconds = {}
    for name, spatial in cases.items():
        written, seconds[name] = request(name)
        data, got_affine, _ = nifti.load(written[0])
        data = np.moveaxis(data, -1, 0)
        check(data.shape == (3,) + spatial, f"case {name}: shape {data.shape}")
        check(bool(np.isfinite(data).all()), f"case {name}: non-finite output")
        check(0.0 <= data.min() and data.max() <= 1.0, f"case {name}: outside [0, 1]")
        check(np.allclose(got_affine, affine, atol=1e-6), f"case {name}: affine")
        n_win = len(dense_patch_slices(spatial, inferer.roi_size, _scan_interval(
            spatial, inferer.roi_size, inferer.overlap)))
        print(f"case {name} {spatial}: {n_win} windows, {seconds[name]:.3f} s "
              f"(write included), mean {data.mean():.4f} [{card}]", flush=True)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"launches during the requests: {launches}; peak memory {peak:.2f} GiB",
          flush=True)
    print(f"requests: {form_counts()}", flush=True)
    check_forms("requests")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    # the device time of one window's forward, as the requests ran it
    import copy
    dtype = torch.bfloat16 if amp else torch.float32
    net = copy.deepcopy(model).to(dtype).eval()
    window = torch.from_numpy(images["A"]).to(device, dtype).permute(0, 2, 3, 4, 1).contiguous()

    def forward():
        with torch.inference_mode():
            net(window)

    profile = profile_device(forward, "one 128^3 window forward", card)
    del net, window
    return model, launches, seconds, profile


def phase4(model, launches, device, seed, card):
    import copy
    for variant in PREDICT_KERNELS:
        check(launches[variant] > 0, f"kernel {variant} was not launched on the path")
    net = copy.deepcopy(model).to(torch.bfloat16).eval()
    x = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        1, 128, 128, 128, 4).astype(np.float32)).to(device, torch.bfloat16)
    with torch.inference_mode():
        got = net(x).float()
        want = plain_forward(net, x).float()
    rel_l2 = ((got - want).norm() / want.norm()).item()
    max_err = (got - want).abs().max().item()
    print(f"whole forward 128^3 bf16, kernels vs plain path: rel L2 {rel_l2:.3e}, "
          f"max abs {max_err:.3e} (logits max {want.abs().max().item():.3e})", flush=True)
    check(rel_l2 < L2_BOUND, f"whole-forward rel L2 {rel_l2:.3e} > {L2_BOUND}")
    times = {"plain": [], "kernels": []}
    with torch.inference_mode():
        for which in ("plain", "kernels", "kernels", "plain"):
            fn = (lambda: net(x)) if which == "kernels" else (lambda: plain_forward(net, x))
            times[which].append(cuda_ms(fn))
    print(f"window forward 128^3 bf16: kernels {times['kernels']} ms, plain "
          f"{times['plain']} ms [{card}]", flush=True)
    return {k: sum(v) / len(v) for k, v in times.items()}


class PlainNet(torch.nn.Module):
    """The model's forward through the plain path, for functional_call."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, train=False):
        return plain_forward(self.net, x)


class BatchLoader:
    """In-memory loader of the same batch: iteration, len, set_epoch."""

    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def __iter__(self):
        return iter([self.batch] * self.n)

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass


def grad_rel_l2(model, criterion, x, y, amp):
    """One step's gradients, kernels against the plain path: (relative L2
    over all parameters, worst tensor's relative L2, its name)."""
    from unet3d_tpu_torch.train.step import forward_loss
    names, params = zip(*model.named_parameters())
    got = torch.autograd.grad(forward_loss(model, criterion, x, y, amp), params)
    want = torch.autograd.grad(forward_loss(PlainNet(model), criterion, x, y, amp), params)
    diff = sum(float((a - b).float().square().sum()) for a, b in zip(got, want))
    norm = sum(float(b.float().square().sum()) for b in want)
    # tensors whose gradient is ~0 next to the whole are left out of the worst
    worst = max((float((a - b).float().norm() / b.float().norm()), n)
                for a, b, n in zip(got, want, names)
                if float(b.float().norm()) > 1e-6 * norm ** 0.5)
    return (diff / norm) ** 0.5, worst[0], worst[1]


def step_ms(step, images, labels, reps=5) -> float:
    for _ in range(2):
        step(images, labels)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step(images, labels)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase5(device, seed, card):
    from unet3d_tpu_torch.config.factory import (build_inferer_from_config,
                                                 build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 build_scheduler_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.convert import load_jax_variables
    from unet3d_tpu_torch.train.checkpoint import load_checkpoint
    from unet3d_tpu_torch.train.optim import get_learning_rate
    from unet3d_tpu_torch.train.step import (make_eval_step, make_train_step,
                                             prepare_batch)
    from unet3d_tpu_torch.train.train import read_training_log, run_training
    from unet3d_tpu_torch.utils.config import load_json

    config = load_json(CONFIG)
    amp = bool(config["training"]["amp"])
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    criterion = load_criterion_from_config(config)
    optimizer = build_optimizer_from_config(config, model.parameters())
    scheduler = build_scheduler_from_config(config, get_learning_rate(optimizer))
    inferer = build_inferer_from_config(config)
    rng = np.random.RandomState(seed + 2)
    shape = tuple(config["dataset"]["desired_shape"])
    train_batch = {"image": rng.randn(1, 4, *shape).astype(np.float32),
                   "label": (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)}
    val_batch = {"image": rng.randn(1, 4, *shape).astype(np.float32),
                 "label": (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)}
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    log_file = os.path.join(OUT_DIR, "training_log.csv")
    model_file = os.path.join(OUT_DIR, "model.npz")
    train_step = make_train_step(model, criterion, optimizer, amp=amp)
    step_losses = []

    def recorded_step(images, labels):
        loss = train_step(images, labels)
        step_losses.append(loss)
        return loss

    print(f"training: {TRAIN_EPOCHS} epochs x {TRAIN_STEPS} steps, batch "
          f"{train_batch['image'].shape}, amp {amp}, {type(optimizer).__name__} lr "
          f"{get_learning_rate(optimizer)}, {type(scheduler).__name__}", flush=True)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_training(recorded_step, make_eval_step(model, criterion, inferer, amp=amp),
                 model, optimizer, TRAIN_EPOCHS, BatchLoader(train_batch, TRAIN_STEPS),
                 BatchLoader(val_batch, 1), log_file, model_file,
                 save_best=bool(config["training"]["save_best"]), scheduler=scheduler)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in step_losses]
    rows = read_training_log(log_file)
    print(f"run_training {seconds:.3f} s (first step included); step losses "
          f"{[round(v, 6) for v in losses]}; log {rows}; launches {launches}; "
          f"peak memory {peak:.2f} GiB [{card}]", flush=True)
    check(len(losses) == TRAIN_EPOCHS * TRAIN_STEPS, f"{len(losses)} steps ran")
    check(all(np.isfinite(losses)), f"non-finite training loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(len(rows) == TRAIN_EPOCHS, f"training log has {len(rows)} rows")
    check(all(np.isfinite(r[3]) for r in rows), f"non-finite validation loss {rows}")
    for kernel in TRAIN_KERNELS:
        check(launches[kernel] > 0, f"kernel {kernel} was not launched in training")
    print(f"training: {form_counts()}", flush=True)
    check_forms("training")
    fresh = build_or_load_model_from_config(config, None, device, seed=seed + 1)
    load_jax_variables(fresh, load_checkpoint(model_file))
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        check(torch.equal(a, b), f"checkpoint round trip changed {name}")
    print(f"checkpoint {os.path.basename(model_file)} reloads equal; files "
          f"{sorted(os.listdir(OUT_DIR))}", flush=True)
    del fresh
    shutil.rmtree(OUT_DIR, ignore_errors=True)

    # one step's gradients, kernels against the plain path
    grads = {}
    for name, dt_amp, bound in (("f32", False, GRAD_BOUND_F32),
                                ("bf16", True, GRAD_BOUND_BF16)):
        x, y = prepare_batch(train_batch["image"], train_batch["label"], device, dt_amp)
        rel, worst, worst_name = grad_rel_l2(model, criterion, x, y, dt_amp)
        grads[name] = rel
        msg = (f"gradients {name}, kernels vs plain path: rel L2 {rel:.3e} over all "
               f"parameters; worst tensor {worst_name} {worst:.3e}")
        print(msg, flush=True)
        check(rel < bound, f"{msg} > {bound}")
        del x, y
    torch.cuda.empty_cache()

    # train-step time, plain, kernels, kernels, plain
    times = {"plain": [], "kernels": []}
    peaks = {}
    for which in ("plain", "kernels", "kernels", "plain"):
        net = model if which == "kernels" else PlainNet(model)
        opt = torch.optim.Adam(model.parameters(), lr=1e-6)
        torch.cuda.reset_peak_memory_stats()
        times[which].append(step_ms(make_train_step(net, criterion, opt, amp=amp),
                                    train_batch["image"], train_batch["label"]))
        peaks[which] = torch.cuda.max_memory_allocated() / 2**30
    step = {k: sum(v) / len(v) for k, v in times.items()}
    profile = {}
    for which in ("kernels", "plain"):
        net = model if which == "kernels" else PlainNet(model)
        one_step = make_train_step(net, criterion, torch.optim.Adam(model.parameters(), lr=1e-6),
                                   amp=amp)
        profile[which] = profile_device(
            lambda: one_step(train_batch["image"], train_batch["label"]),
            f"one bf16 train step ({which})", card)
    print(f"train step (amp {amp}) batch {train_batch['image'].shape}: kernels "
          f"{times['kernels']} ms, plain "
          f"{times['plain']} ms; peak memory kernels {peaks['kernels']:.2f} GiB, plain "
          f"{peaks['plain']:.2f} GiB [{card}]", flush=True)
    return launches, dict(step_ms=step, peak_gib=peaks, grad_rel_l2=grads,
                          losses=losses, profile=profile)


# the synthetic BraTS cases of phase 6: the BraTS 2020 grid, 1 mm voxels with
# flipped x and y axes, and its four modalities
BRATS_GRID = (240, 240, 155)
BRATS_AFFINE = np.array([[-1.0, 0, 0, 0], [0, -1.0, 0, 239.0], [0, 0, 1.0, 0],
                         [0, 0, 0, 1]])
MODALITIES = ("flair", "t1", "t1ce", "t2")
CLI_CASES = 2


def write_cases(seed, out_dir=CLI_DIR, n_cases=CLI_CASES, prefix="BraTS20_Validation",
                with_label=False):
    """``n_cases`` cases of four int16 modalities under ``out_dir``: zero
    background around a seeded ellipsoid of noisy tissue, written as
    uncompressed ``.nii``. ``with_label`` adds a ``seg`` with the BraTS
    labels in a seeded sphere inside the ellipsoid: 4 at its core, 1 around
    that, 2 in its outer shell."""
    from unet3d_tpu_torch.data import nifti
    rng = np.random.RandomState(seed + 3)
    grid = np.stack(np.meshgrid(*(np.arange(n, dtype=np.float32) for n in BRATS_GRID),
                                indexing="ij"))
    cases = []
    for i in range(n_cases):
        centre = np.array(BRATS_GRID, np.float32) / 2 + rng.uniform(-10, 10, 3)
        radii = np.array([70.0, 85.0, 60.0]) * rng.uniform(0.8, 1.0, 3)
        inside = (((grid - centre[:, None, None, None].astype(np.float32))
                   / radii[:, None, None, None].astype(np.float32)) ** 2).sum(0) <= 1
        name = f"{prefix}_{i + 1:03d}"
        os.makedirs(os.path.join(out_dir, name))
        files = []
        for modality in MODALITIES:
            tissue = rng.normal(400.0, 100.0, size=BRATS_GRID).astype(np.float32)
            fn = os.path.join(out_dir, name, f"{name}_{modality}.nii")
            nifti.save(fn, np.where(inside, tissue, 0).astype(np.int16), BRATS_AFFINE)
            files.append(fn)
        cases.append({"image": files})
        if with_label:
            tumour = centre + rng.uniform(-20, 20, 3).astype(np.float32)
            dist = np.sqrt(((grid - tumour[:, None, None, None]) ** 2).sum(0))
            dist /= rng.uniform(18.0, 28.0)
            seg = np.select([dist < 0.4, dist < 0.7, dist < 1.0], [4, 1, 2], 0)
            cases[-1]["label"] = os.path.join(out_dir, name, f"{name}_seg.nii")
            nifti.save(cases[-1]["label"], np.where(inside, seg, 0).astype(np.int16),
                       BRATS_AFFINE)
    return cases


class LogRecords(logging.Handler):
    """Collects the ``attr`` of every record that carries one (the per-case
    stage seconds of ``predict/volumetric.py``, the per-sample ones of
    ``data/dataset.py``), and in ``threads`` the thread that logged it."""

    def __init__(self, attr="case_seconds"):
        super().__init__(logging.DEBUG)
        self.attr = attr
        self.records, self.threads = [], []

    def emit(self, record):
        if hasattr(record, self.attr):
            self.records.append(getattr(record, self.attr))
            self.threads.append(threading.current_thread())


def phase6_cli(seed, card):
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.scripts import predict
    from unet3d_tpu_torch.train.checkpoint import save_checkpoint
    from unet3d_tpu_torch.utils.config import dump_json, load_json

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    config = load_json(CONFIG)
    config["bratsvalidation_filenames"] = write_cases(seed)
    config_file = os.path.join(CLI_DIR, "brats2020_config.json")
    dump_json(config, config_file)
    model_file = os.path.join(CLI_DIR, "model.npz")
    save_checkpoint(build_or_load_model_from_config(config, None, torch.device("cpu"),
                                                    seed=seed), model_file)
    print(f"CLI set-up: {CLI_CASES} cases of {len(MODALITIES)} x {BRATS_GRID} int16 "
          f".nii, checkpoint, config: {time.perf_counter() - t0:.1f} s", flush=True)
    volumetric_log = logging.getLogger("unet3d_tpu_torch.predict.volumetric")
    volumetric_log.setLevel(logging.INFO)
    predictions, launches, breakdown = {}, {}, {}
    for strategy in (None, "winograd"):
        name = strategy or "default"
        out_dir = os.path.join(CLI_DIR, f"out_{name}")
        case_seconds = LogRecords()
        volumetric_log.addHandler(case_seconds)
        with conv_strategy(strategy):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            predict.main(["--config_filename", config_file, "--model_filename", model_file,
                          "--output_directory", out_dir, "--group", "bratsvalidation",
                          "--activation", "sigmoid"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[name] = launch_counts()
        volumetric_log.removeHandler(case_seconds)
        written = sorted(os.listdir(os.path.join(out_dir, "predictions")))
        check(len(written) == CLI_CASES, f"CLI {name}: wrote {written}")
        breakdown[name] = case_seconds.records
        print(f"CLI {name}: {form_counts()}", flush=True)
        check_forms(f"CLI {name}")
        for fn in written:
            data, affine, _ = nifti.load(os.path.join(out_dir, "predictions", fn))
            check(data.shape == BRATS_GRID + (3,), f"CLI {name} {fn}: shape {data.shape}")
            check(bool(np.isfinite(data).all()), f"CLI {name} {fn}: non-finite output")
            check(0.0 <= data.min() and data.max() <= 1.0, f"CLI {name} {fn}: outside [0, 1]")
            check(np.allclose(affine, BRATS_AFFINE, atol=1e-6), f"CLI {name} {fn}: affine")
            predictions[name, fn] = data
        for record in breakdown[name]:
            print(f"CLI {name} {record['case']}: " + ", ".join(
                f"{k} {record[k]:.3f} s" for k in ("read_preprocess", "forward",
                                                    "resample", "write"))
                  + f" [{card}]", flush=True)
        print(f"CLI {name}: {seconds:.3f} s for {CLI_CASES} cases (model build and "
              f"load included); launches {launches[name]}", flush=True)
    wino = {k: sum(launches[k][v] for v in STRATEGY_KERNELS) for k in launches}
    check(wino["default"] == 0 and wino["winograd"] > 0,
          f"Winograd launches by run {wino}: expected only under the strategy")
    rel = {}
    for fn in written:
        a, b = predictions["default", fn], predictions["winograd", fn]
        rel[fn] = float(np.linalg.norm(b - a) / np.linalg.norm(a))
        check(rel[fn] < L2_BOUND, f"CLI {fn}: strategy vs default rel L2 {rel[fn]:.3e}")
    print(f"CLI predictions, winograd vs default routing: rel L2 {rel}", flush=True)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches, dict(case_seconds=breakdown, rel_l2=rel)


def phase7_strategy_step(device, seed, card):
    from unet3d_tpu_torch.config.factory import (build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.train.step import make_train_step, prepare_batch
    from unet3d_tpu_torch.utils.config import load_json

    config = load_json(CONFIG)
    amp = bool(config["training"]["amp"])
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    criterion = load_criterion_from_config(config)
    rng = np.random.RandomState(seed + 2)
    shape = tuple(config["dataset"]["desired_shape"])
    images = rng.randn(1, 4, *shape).astype(np.float32)
    labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
    with conv_strategy("winograd"):
        step = make_train_step(model, criterion,
                               torch.optim.Adam(model.parameters(), lr=1e-6), amp=amp)
        step(images, labels)
        torch.cuda.synchronize()
        reset_launches()
        step(images, labels)
        torch.cuda.synchronize()
        launches = launch_counts()
        print(f"strategy train step (amp {amp}): launches {launches}; {form_counts()}",
              flush=True)
        check_forms("strategy train step")
        for kernel in STRATEGY_KERNELS:
            check(launches[kernel] > 0, f"kernel {kernel} was not launched in the step")
        grads = {}
        for name, dt_amp, bound in (("f32", False, GRAD_BOUND_F32),
                                    ("bf16", True, GRAD_BOUND_BF16)):
            x, y = prepare_batch(images, labels, device, dt_amp)
            rel, worst, worst_name = grad_rel_l2(model, criterion, x, y, dt_amp)
            grads[name] = rel
            msg = (f"gradients {name} under the strategy, kernels vs plain path: rel L2 "
                   f"{rel:.3e}; worst tensor {worst_name} {worst:.3e}")
            print(msg, flush=True)
            check(rel < bound, f"{msg} > {bound}")
            del x, y
    torch.cuda.empty_cache()
    times = {"default": [], "winograd": []}
    for which in ("default", "winograd", "winograd", "default"):
        with conv_strategy(None if which == "default" else which):
            opt = torch.optim.Adam(model.parameters(), lr=1e-6)
            times[which].append(step_ms(make_train_step(model, criterion, opt, amp=amp),
                                        images, labels))
    print(f"train step (amp {amp}) batch {images.shape}: winograd {times['winograd']} ms, "
          f"default {times['default']} ms [{card}]", flush=True)
    return launches, dict(step_ms={k: sum(v) / len(v) for k, v in times.items()},
                          grad_rel_l2=grads)


def _mean(values) -> float:
    return float(np.mean(values)) if len(values) else float("nan")


def phase8_train_cli(device, seed, card):
    """The train CLI on the BraTS config, cut only in its file lists, epochs
    and folds: cross-validation set-up, then fold 1 trained through
    ``scripts.train.main`` (its own loaders, prefetcher, steps and
    inference), with ``run_training`` and ``DevicePrefetcher`` wrapped in
    this function to read the launches, each step's batch and time, the
    loader's waits and the samples' stage seconds."""
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.convert import load_jax_variables
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.data.prefetch import DevicePrefetcher
    from unet3d_tpu_torch.scripts import predict
    from unet3d_tpu_torch.scripts import train as train_cli
    from unet3d_tpu_torch.train.checkpoint import load_checkpoint
    from unet3d_tpu_torch.train.train import read_training_log
    from unet3d_tpu_torch.utils.config import dump_json, load_json

    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    cases = write_cases(seed + 5, TRAIN_CLI_DIR, TRAIN_CLI_CASES, "BraTS20_Training",
                        with_label=True)
    config = load_json(CONFIG)
    config["training_filenames"] = cases
    config["bratsvalidation_filenames"] = [{"image": cases[0]["image"]}]
    config["training"]["n_epochs"] = TRAIN_CLI_EPOCHS
    config["cross_validation"]["folds"] = TRAIN_CLI_FOLDS
    config_file = os.path.join(TRAIN_CLI_DIR, "brats2020_config.json")
    dump_json(config, config_file)
    work = os.path.join(TRAIN_CLI_DIR, "out", "brats2020_config")
    print(f"train CLI set-up: {TRAIN_CLI_CASES} labelled cases of {len(MODALITIES)} x "
          f"{BRATS_GRID} int16 .nii, config: {time.perf_counter() - t0:.1f} s", flush=True)
    check(train_cli.main(["--config_filename", config_file, "--output_dir",
                          os.path.dirname(work), "--setup_crossval_only"]) == [],
          "--setup_crossval_only trained a fold")
    folds = [load_json(os.path.join(work, f"fold{i + 1}.json"))
             for i in range(TRAIN_CLI_FOLDS)]
    labels = sorted(c["label"] for c in cases)
    for i, fold in enumerate(folds):
        train_labels = [c["label"] for c in fold["training_filenames"]]
        val_labels = [c["label"] for c in fold["validation_filenames"]]
        print(f"fold{i + 1}.json: training {[os.path.basename(f) for f in train_labels]}, "
              f"validation {[os.path.basename(f) for f in val_labels]}", flush=True)
        check(len(train_labels) == len(val_labels) == TRAIN_CLI_CASES // TRAIN_CLI_FOLDS
              and sorted(train_labels + val_labels) == labels,
              f"fold{i + 1}.json does not split the cases 2/2")
    check(sorted(c["label"] for f in folds for c in f["validation_filenames"]) == labels,
          "the folds' validation sets do not partition the cases")

    steps, prefetchers, run = [], [], {}

    class TimedPrefetcher(DevicePrefetcher):
        """The CLI's prefetcher, with each batch's host wait, the threads
        that produce its batches, its epochs' start times, its first batch's
        source files, whether each host copy was pinned, and each batch's
        copies timed by events on the side stream."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.waits, self.epochs, self.threads, self.first = [], [], [], None
            self.pinned, self.copies = [], []
            prefetchers.append(self)

        def set_epoch(self, epoch):
            self.epochs.append((epoch, time.perf_counter()))
            super().set_epoch(epoch)

        def _put(self, batch, stream):
            if threading.current_thread() not in self.threads:  # the samples ran here
                self.threads.append(threading.current_thread())
            if self.first is None:
                self.first = batch["source_filename"]
            self.side, self.start = stream, torch.cuda.Event(enable_timing=True)
            out = super()._put(batch, stream)
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self.copies.append((self.start, end))
            return out

        def _pinned(self, array):
            host = super()._pinned(array)
            self.pinned.append(host.is_pinned())
            self.start.record(self.side)  # again after each key: the copies start here
            return host

        def __iter__(self):
            batches = super().__iter__()
            try:
                while True:
                    t = time.perf_counter()
                    batch = next(batches, None)
                    if batch is None:
                        return
                    self.waits.append(time.perf_counter() - t)
                    yield batch
            finally:
                batches.close()

    real_run_training = train_cli.run_training

    def timed_run_training(train_step, *args, **kwargs):
        def step(images, labels):
            if not steps:
                run["first"] = (images.clone(), labels.clone())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            start.record()
            loss = train_step(images, labels)
            end.record()
            steps.append(dict(batch=[(t.dtype, t.device.type) for t in (images, labels)],
                              events=(start, end), host_s=time.perf_counter() - t))
            return loss

        torch.cuda.synchronize()
        reset_launches()
        model = real_run_training(step, *args, **kwargs)
        torch.cuda.synchronize()
        run.update(end=time.perf_counter(), launches=launch_counts(),
                   forms=dict(form_launches()))
        return model

    dataset_log = logging.getLogger("unet3d_tpu_torch.data.dataset")
    samples, level = LogRecords("sample_seconds"), dataset_log.level
    dataset_log.addHandler(samples)
    dataset_log.setLevel(logging.DEBUG)
    train_cli.run_training, train_cli.DevicePrefetcher = timed_run_training, TimedPrefetcher
    fold_file, fold_dir = os.path.join(work, "fold1.json"), os.path.join(work, "fold1")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = train_cli.main(["--config_filename", fold_file, "--output_dir", work])
        torch.cuda.synchronize()
        cli_seconds = time.perf_counter() - t0
    finally:
        train_cli.run_training, train_cli.DevicePrefetcher = real_run_training, DevicePrefetcher
        dataset_log.removeHandler(samples)
        dataset_log.setLevel(level)
    peak = torch.cuda.max_memory_allocated() / 2**30

    check(result["work_dir"] == fold_dir, f"trained into {result['work_dir']}")
    train_pf = result["training_loader"]
    check(train_pf is prefetchers[0], "the training batches bypassed the prefetcher")
    n_steps = TRAIN_CLI_EPOCHS * len(train_pf)
    check(len(steps) == n_steps, f"{len(steps)} training steps ran, expected {n_steps}")
    kinds = {kind for s in steps for kind in s["batch"]}
    check(kinds == {(torch.bfloat16, "cuda")},
          f"training batches (dtype, device) {kinds}: expected bf16 on the card")
    check(len(train_pf.copies) == n_steps and len(train_pf.pinned) == 2 * n_steps
          and all(train_pf.pinned),
          f"training batches' host copies pinned: {train_pf.pinned}")
    launches, forms = run["launches"], run["forms"]
    print(f"train CLI training: launches {launches}; by form "
          f"{ {f'{v}/{f}': n for (v, f), n in sorted(forms.items())} }", flush=True)
    for kernel in TRAIN_KERNELS:
        check(forms.get((kernel, "wgmma"), 0) > 0,
              f"train CLI: kernel {kernel} was not launched in the wgmma form")
    off = {k: n for k, n in forms.items() if k[1] != "wgmma"}
    check(not off, f"train CLI: bf16 sites off the wgmma form: {off}")

    # the first step's batch, rebuilt on the CPU from the dataset
    dataset = train_pf.dataset
    index = [list(c["image"]) for c in dataset.filenames].index(list(train_pf.first[0]))
    first_epoch = train_pf.epochs[0][0]
    dataset.set_epoch(first_epoch)
    sample = dataset[index]
    got_image, got_label = (t.cpu() for t in run["first"])
    same = (torch.equal(got_image, torch.from_numpy(sample["image"][None]).to(torch.bfloat16))
            and torch.equal(got_label,
                            torch.from_numpy(sample["label"][None]).to(torch.bfloat16)))
    print(f"first step's batch {tuple(got_image.shape)} {got_image.dtype} equals the "
          f"dataset's sample {index} at epoch {first_epoch} rebuilt on the CPU: {same}",
          flush=True)
    check(same, "the first step's batch differs from its sample rebuilt on the CPU")

    rows = read_training_log(os.path.join(fold_dir, "training_log.csv"))
    print(f"training_log.csv: {rows}", flush=True)
    check(len(rows) == TRAIN_CLI_EPOCHS, f"training log has {len(rows)} rows")
    check(all(np.isfinite(r[1]) and np.isfinite(r[3]) for r in rows),
          f"non-finite losses in the training log {rows}")
    model = result["model"]
    fresh = build_or_load_model_from_config(config, None, device, seed=seed + 1)
    load_jax_variables(fresh, load_checkpoint(os.path.join(fold_dir, "model.npz")))
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        check(torch.equal(a, b), f"train CLI checkpoint round trip changed {name}")
    del fresh

    (written,) = result["predictions"]["bratsvalidation"]
    data, affine, _ = nifti.load(written)
    print(f"bratsvalidation prediction {os.path.basename(written)}: shape {data.shape}, "
          f"range [{data.min():.4f}, {data.max():.4f}]", flush=True)
    check(data.shape == BRATS_GRID + (3,), f"train CLI prediction shape {data.shape}")
    check(bool(np.isfinite(data).all()), "train CLI prediction: non-finite output")
    check(0.0 <= data.min() and data.max() <= 1.0, "train CLI prediction: outside [0, 1]")
    check(np.allclose(affine, BRATS_AFFINE, atol=1e-6), "train CLI prediction: affine")
    predict_dir = os.path.join(TRAIN_CLI_DIR, "predict")
    predict.main(["--config_filename", fold_file, "--model_filename",
                  os.path.join(fold_dir, "model.npz"), "--output_directory", predict_dir,
                  "--group", "bratsvalidation", "--activation", "sigmoid"])
    (name,) = os.listdir(os.path.join(predict_dir, "predictions"))
    want, _, _ = nifti.load(os.path.join(predict_dir, "predictions", name))
    rel = float(np.linalg.norm(data - want) / np.linalg.norm(want))
    print(f"train CLI prediction vs the predict CLI on its checkpoint: rel L2 {rel:.3e}",
          flush=True)
    check(rel < L2_BOUND, f"train CLI vs predict CLI rel L2 {rel:.3e} > {L2_BOUND}")

    starts = [t for _, t in train_pf.epochs] + [run["end"]]
    epoch_s = [b - a for a, b in zip(starts, starts[1:])]
    step_ms = [s["events"][0].elapsed_time(s["events"][1]) for s in steps]
    waits_ms = [1e3 * w for w in train_pf.waits]
    # where each epoch's seconds went: the training loop's waits for batches
    # and its steps (host time: the step returns before the device ends), the
    # validation loop's waits, and the rest (validation forwards, the log,
    # the checkpoint)
    val_pf, n_train, n_val = result["validation_loader"], len(train_pf), len(prefetchers[1])
    epochs = []
    for e, total in enumerate(epoch_s):
        part = dict(train_wait=sum(train_pf.waits[e * n_train:(e + 1) * n_train]),
                    train_steps=sum(st["host_s"] for st in steps[e * n_train:(e + 1) * n_train]),
                    val_wait=sum(val_pf.waits[e * n_val:(e + 1) * n_val]))
        epochs.append(dict(part, rest=total - sum(part.values())))
    # the in-run copy spans include the worker's waits for the GIL between
    # issuing the two copies; one batch's copy alone, from pinned memory:
    h2d_ms = [start.elapsed_time(end) for start, end in train_pf.copies]
    pinned = [got_image.pin_memory(), got_label.pin_memory()]
    h2d_alone_ms = cuda_ms(lambda: [t.to(device, non_blocking=True) for t in pinned])
    batch_mb = sum(t.numel() * t.element_size() for t in pinned) / 1e6
    mine = [r for r, th in zip(samples.records, samples.threads) if th in train_pf.threads]
    per_epoch = len(dataset)
    stages = {f"epoch {first_epoch + e}": {
        k: _mean([1e3 * r[k] for r in mine[e * per_epoch:(e + 1) * per_epoch]])
        for k in ("preprocess", "augment")} for e in range(TRAIN_CLI_EPOCHS)}
    summary = dict(cli_s=cli_seconds, epoch_s=epoch_s, step_ms=step_ms,
                   step_ms_mean=_mean(step_ms), loader_wait_ms=waits_ms,
                   loader_wait_ms_mean=_mean(waits_ms), sample_ms=stages,
                   h2d_ms=h2d_ms, h2d_alone_ms=h2d_alone_ms, batch_mb=batch_mb,
                   epoch_parts_s=epochs,
                   peak_gib=peak, launches=launches, rel_l2_vs_predict=rel,
                   log=[list(map(float, r)) for r in rows])
    print(f"train CLI: {cli_seconds:.3f} s for main (fold 1: {len(dataset)} training, "
          f"{len(result['validation_loader'])} validation cases, {TRAIN_CLI_EPOCHS} epochs, "
          f"1 bratsvalidation prediction) [{card}]", flush=True)
    print(f"train CLI seconds per epoch {[round(s, 3) for s in epoch_s]}; by part "
          f"{[{k: round(v, 3) for k, v in e.items()} for e in epochs]} [{card}]", flush=True)
    print(f"train CLI step ms {[round(s, 3) for s in step_ms]}, mean {_mean(step_ms):.3f} "
          f"[{card}]", flush=True)
    print(f"train CLI loader wait ms per step {[round(w, 3) for w in waits_ms]}, mean "
          f"{_mean(waits_ms):.3f}; per training sample, host ms by stage (preprocess: read, "
          f"crop, resize and the cache; augment: the random stages and normalisation) "
          f"{json.dumps(stages)} [{card}]", flush=True)
    print(f"train CLI H2D ms per batch ({batch_mb:.1f} MB bf16, pinned): side-stream span "
          f"in the run {[round(h, 3) for h in h2d_ms]}, one batch's copy alone "
          f"{h2d_alone_ms:.3f} ({batch_mb / h2d_alone_ms:.1f} GB/s); peak memory "
          f"{peak:.2f} GiB [{card}]", flush=True)
    del model, result
    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    return launches, summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from unet3d_tpu_torch.kernels.build import load_library
    from unet3d_tpu_torch.utils.device import require_cuda, sm_version

    os.environ.pop("UNET3D_TPU_CONV", None)  # phases 3-5 run the default routing
    # phase 0
    card = card_line()
    print(card, flush=True)
    device = require_cuda()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"sm_{''.join(map(str, sm_version(device)))}, {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # phase 1
    t0 = time.perf_counter()
    load_library()
    print(f"kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    # phase 2
    gen = torch.Generator(device=device).manual_seed(args.seed)
    report = phase2(device, gen)
    phase2_backward(device, gen, report)
    phase2_winograd(device, gen, report)
    # phase 3
    model, launches, seconds, window_profile = phase3(device, args.seed, card)
    # phase 4
    window_ms = phase4(model, launches, device, args.seed, card)
    del model
    torch.cuda.empty_cache()
    # phase 5
    train_launches, training = phase5(device, args.seed, card)
    # phase 6
    cli_launches, cli = phase6_cli(args.seed, card)
    # phase 7
    strategy_launches, strategy = phase7_strategy_step(device, args.seed, card)
    # phase 8
    train_cli_launches, train_cli = phase8_train_cli(device, args.seed, card)
    check(not any(m in sys.modules for m in ("jax", "unet3d_tpu")),
          "the port imported jax")
    # launches: the training path's (phase 5; phase 7 for the Winograd
    # variants, which run only under the strategy); launches_predict: the
    # prediction path's (phase 3; the CLI under the strategy for Winograd);
    # launches_train_cli: the train CLI's training (phase 8)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = [{"name": v, "route": "cuda", "source": SOURCES[v],
                "replaces": REPLACES[v], "launches": train_launches[v],
                "launches_predict": launches[v], "launches_train_cli": train_cli_launches[v],
                **{k: report[v][k] for k in keys}}
               for v in TRAIN_KERNELS]
    kernels += [{"name": v, "route": "cuda", "source": SOURCES[v],
                 "replaces": REPLACES[v], "launches": strategy_launches[v],
                 "launches_predict": cli_launches["winograd"][v],
                 "launches_train_cli": train_cli_launches[v],
                 **{k: report[v][k] for k in keys}, "direct_ms": report[v]["direct_ms"]}
                for v in STRATEGY_KERNELS]
    print(f"seconds per case: {json.dumps(seconds)} [{card}]")
    print(f"window: {json.dumps(dict(forward_ms=window_ms, profile=window_profile))} [{card}]")
    print(f"training: {json.dumps(training)} [{card}]")
    print(f"cli: {json.dumps(cli)} [{card}]")
    print(f"strategy train step: {json.dumps(strategy)} [{card}]")
    print(f"train cli: {json.dumps(train_cli)} [{card}]")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

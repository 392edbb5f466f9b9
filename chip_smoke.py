"""Drive the PyTorch port's BraTS prediction, training and CLI paths once on one CUDA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an H100 (sm_90). Phases:

0. the card (nvidia-smi name and power limit), torch / CUDA versions, SM;
   no TF32 flag is set: every phase runs under torch's defaults (cuDNN's f32
   convs in TF32), as a user runs the CLIs, and the port's own policy
   (``utils/device.full_f32``) keeps its f32 paths full f32;
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
   DX_SHAPES, in bf16 and in f32; its bf16 calls (Cin a multiple of 4, Cout
   of 8: every site) take the wgmma form (``conv3d_wgmma.cu``), its f32 calls
   (Cin a multiple of 4) the tf32x3 form (``conv3d_tf32x3.cu``), each timed
   beside F.conv3d with TF32 off and two bounds: the f32 one (67 TFLOP/s on
   the CUDA cores) and the 3xTF32 one (three TF32 products per product at
   495 TFLOP/s), the share read against the second. The f32 ``s2_wgrad`` and
   Winograd calls are timed too, beside cuDNN with TF32 off and the f32 bound;
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
   differences) and 2e-2 in bf16 (each path ~1.3e-2 from f64), the f32
   step's direct convs all in the tf32x3 form; and the
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
   copy alone from pinned memory, and the launches;
9. the train CLI again on phase 8's cases and folds, with the options a
   user sets when a patch does not fit or training resumes: a residual
   DynUNet (``model.res_block``), ``training.remat``, batches of 2 in 2
   microbatches (``gradient_accumulation_steps``), DiceFocalLoss, AdamW and
   ``save_optimizer``; fold 1 for 2 epochs, then ``main`` again with 3,
   which resumes. Checks: the four training kernels in the wgmma form; each
   step's ``conv_stats`` and ``block_stats`` launches 2 x 2 times one
   forward's (forward and recompute, per microbatch); the resume loads the
   optimizer file the first run wrote, equal to it, and the log ends with 3
   rows of finite losses; one step's gradients kernels vs the plain path,
   remat vs none and 2 microbatches vs one batch of 2, each within the
   phase-5 bounds (1e-3 f32, 2e-2 bf16); the step's peak memory lower with
   remat, at batch 1 and at 2 in 2; flip TTA (``predictions_with_tta``) on
   one 128^3 window within relative L2 2e-2 of the mean of the four flipped
   forwards. Prints the launches, the log, seconds per epoch, the CLI's
   step ms, the step's ms (CUDA events) and peak memory with and without
   remat, and a profile of one step each way.

10. the Myronenko family (the BraTS config with its model section replaced
   by SegResNetVAE at Myronenko's widths, ``SEGRESNET_MODEL``): the conv
   kernel at the family's new shapes (bf16 at 32 channels; the U-Nets'
   first-conv input gradient, 32 -> 4, in the wmma form; f32 at the three
   decoder sites, 32 -> 32 @128^3, 64 -> 64 @64^3 and 128 -> 128 @32^3, in
   the tf32x3 form) and ``s2_wgrad`` at its new widths, each against its
   plain version, its form checked, and timed as in phase 2; (a) one
   128^3 bf16 window forward, eval, kernels against the plain path (every
   FastConv through ``F.conv3d``) within relative L2 3e-2, the conv's
   launches 19 in the wgmma form (encoder) and 6 in the tf32x3 form (the
   decoder, which AMP runs in f32 after the trilinear upsample), times and
   a profile; (b) one bf16 AMP train step at batch 1 (DiceLoss plus the VAE
   term): ``conv`` 61 (31 forward, 30 input gradients: 37 wgmma and 24
   tf32x3), ``s2_wgrad`` 4, no wmma form, gradients against the plain path
   within the phase-5 bounds (the noise drawn alike), step ms, peak memory
   and a profile; then, under torch's default TF32 flags, the f32 step's
   gradients through the kernels and through the plain path, and one f32
   stride-2 conv (32 -> 64 @128^3, forward and both gradients), each
   against the same computation with TF32 off by the caller within
   relative L2 1e-5 (the port's f32 policy), and the kernels' f32
   gradients against the f64 plain path no more than 1e-5 farther than
   the plain f32 path's own; (c) the
   train CLI on phase 8's cases and folds (fold 1, 2 epochs) with that
   model: finite losses, the checkpoint reloads strictly and equal, the
   bratsvalidation prediction on the source grid in [0, 1], launches by
   form, seconds per epoch and step ms; (d) UNet3D at its reference
   defaults, AutoImplantUNet (``test=True`` through ``make_forward``) and
   LabeledVariationalAutoEncoder at 128^3: one bf16 window forward and one
   step's gradients (f32, bf16) against the plain path within the phase-5
   bounds, with their launches.

Exits non-zero if any phase fails or there is no CUDA device. The last lines
are the card, a JSON object of the kernels (the bf16 forms' rows, then the
f32 form's: ``conv_tf32x3``, ``conv_stats_tf32x3``, ``block_stats_tf32x3``,
with both bounds), and ``{"ok": true, ...}``.
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
RES_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_train_res")
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
# dense peaks of one H100 SXM (NVIDIA's data sheet, at 700 W) for the bounds:
# bf16 and TF32 on the tensor cores, f32 on the CUDA cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
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
# phase 9: the options of the train CLI ported last; 2 epochs, then resumed to 3
RES_TRAINING = dict(remat=True, gradient_accumulation_steps=2, batch_size=2,
                    save_optimizer=True)
RES_EPOCHS = 2
TTA_BOUND = 2e-2
# phase 10: the Myronenko family. SegResNetVAE as Myronenko's BraTS 2018 net
# (arXiv:1810.11654 section 2: 32 initial filters, GroupNorm of 8 groups,
# blocks 1, 2, 2, 4 down and 1, 1, 1 up, a 256-d VAE latent) on the BraTS
# config's 128^3 patch (the paper crops 160 x 192 x 128)
SEGRESNET_MODEL = {"name": "SegResNetVAE", "input_image_size": [128, 128, 128],
                   "init_filters": 32, "in_channels": 4, "out_channels": 3,
                   "dropout_prob": 0.2, "norm_groups": 8, "blocks_down": [1, 2, 2, 4],
                   "blocks_up": [1, 1, 1], "upsample_mode": "nontrainable", "vae_nz": 256,
                   "smallest_filters": 16}
SEGRESNET_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_segresnet")
# the other nets of the family at their reference defaults (the reference's
# UNet3D: base_width 32, blocks 1, 2, 2, 4), each with the BraTS config's
# DiceLoss (sigmoid): AutoImplantUNet maps a CT channel to itself (its output
# is y - x); the labelled VAE mirrors its encoder so its segmentation has the
# input's size, and trains through its sampled latent (the loss ignores mu
# and logvar; tools/family_grad_conditioning.py measures VAELoss's KL term)
FAMILY_MODELS = (
    ("UNet3D", dict(n_features=4, base_width=32, encoder_blocks=[1, 2, 2, 4], n_outputs=3),
     3),
    ("AutoImplantUNet", dict(n_features=1, base_width=32, encoder_blocks=[1, 2, 2, 4],
                             n_outputs=1), 1),
    ("LabeledVariationalAutoEncoder",
     dict(n_features=4, base_width=32, encoder_blocks=[1, 2, 2, 4], n_outputs=3,
          input_shape=[128, 128, 128], decoder_mirrors_encoder=True), 3),
)
# (label, spatial, cin, cout, dtype, form): the conv kernel at the family's
# new shapes: bf16 (wgmma) at level 0's 32 channels, half of a 64-wide tile;
# the U-Nets' first-conv input gradient (4 outputs, the wmma form of
# conv3d.cu); and f32 (the tf32x3 form, conv3d_tf32x3.cu) at SegResNetVAE's
# three decoder sites, which AMP runs in f32 after the trilinear upsample
FAMILY_CONV_SHAPES = [
    ("convInit 4->32 @128^3", 128, 4, 32, torch.bfloat16, "wgmma"),
    ("layer0 32->32 @128^3", 128, 32, 32, torch.bfloat16, "wgmma"),
    ("U-Net first conv dx 32->4 @128^3", 128, 32, 4, torch.bfloat16, "wmma"),
    ("up2 block 32->32 @128^3", 128, 32, 32, torch.float32, "tf32x3"),
    ("up1 block 64->64 @64^3", 64, 64, 64, torch.float32, "tf32x3"),
    ("up0 block 128->128 @32^3", 32, 128, 128, torch.float32, "tf32x3"),
]
# the f32 form's rows of the kernels line: its source, and the SegResNetVAE
# decoder site the conv variant's time is reported at
TF32X3_SOURCE = "unet3d_tpu_torch/ops/kernels/conv3d_tf32x3.cu"
TF32X3_CONV_AT = "up2 block 32->32 @128^3"
# torch's default TF32 flags: each f32 path against itself with TF32 off
TF32_FLAGS_BOUND = 1e-5
# the kernels' f32 step gradients: their distance from the f64 plain path
# past the plain f32 path's own
F64_EXCESS_BOUND = 1e-5
# (label, spatial of x, cin, cout): s2_wgrad at SegResNetVAE's new widths
FAMILY_S2_SHAPES = [("down1 32->64 @128^3", 128, 32, 64),
                    ("vae_down_conv 256->16 @16^3", 16, 256, 16)]
FAMILY_KERNELS = ("conv", "s2_wgrad")


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


def conv_bytes(variant, s, cin, cout, size) -> int:
    """Bytes one 3x3x3 conv variant on (1, s, s, s, cin) -> cout must move
    with ``size``-byte values: x and w read, y written, statistics and the
    block prologue's (inv, shift) in f32."""
    nbytes = size * (s ** 3 * (cin + cout) + 27 * cin * cout)
    nbytes += 8 * cout if variant in ("conv_stats", "block_stats", "winograd_stats") else 0
    return nbytes + (8 * cin if variant == "block_stats" else 0)


def conv_bound(variant, s, cin, cout, products=1.0, dtype=torch.bfloat16):
    """bound_ms of one 3x3x3 conv variant on (1, s, s, s, cin) -> cout in
    ``dtype`` (bf16 by default; f32 on the CUDA cores)."""
    return bound_ms(2.0 * s ** 3 * 27 * cin * cout * products,
                    conv_bytes(variant, s, cin, cout, torch.finfo(dtype).bits // 8), dtype)


def tf32x3_bound(variant, s, cin, cout):
    """bound_ms of one f32 3x3x3 conv variant done f32-accurate on the tensor
    cores, as the tf32x3 form does it: three TF32 products per product at the
    TF32 peak, or the f32 bytes at the memory rate."""
    return bound_ms(3 * 2.0 * s ** 3 * 27 * cin * cout, conv_bytes(variant, s, cin, cout, 4),
                    "tf32")


def library_conv(x, w):
    """One PyTorch call for the conv alone (cuDNN): F.conv3d on the NCDHW view
    (channels_last_3d, no copy) of the same NDHWC operands; f32 with TF32 off
    (the port's ``full_f32`` scope, host-side only)."""
    from unet3d_tpu_torch.utils.device import full_f32
    wn = w.permute(4, 3, 0, 1, 2).contiguous()
    xn = x.permute(0, 4, 1, 2, 3)

    def call():
        with full_f32(xn):
            return F.conv3d(xn, wn, padding=1)
    return call


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
    groups = (("conv wgmma", "conv3x3x3_wgmma"), ("conv tf32x3", "conv3x3x3_tf32x3"),
              ("conv wmma/fma", "conv3x3x3_ndhwc"),
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
    report.update({f"{v}_tf32x3": {} for v in kernel})
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
                form = K.kernel_form(x, w)
                msg = (f"{variant:11s} {label:31s} {str(dtype)[6:]:8s} {form:6s} y rel "
                       f"{rel:.3e}")
                check(form == ("wgmma" if dtype == torch.bfloat16 else "tf32x3"),
                      f"{msg}: form")
                check(rel < BOUNDS[dtype], f"{msg} > {BOUNDS[dtype]}")
                if variant != "conv":
                    s_err = stats_err(*got)
                    msg += f" stats rel {s_err:.3e}"
                    check(s_err < STATS_BOUND, f"{msg} > {STATS_BOUND}")
                if variant == SITE_VARIANT[si]:
                    ms = device_ms(lambda: kernel[variant](*args))
                    plain_ms = device_ms(lambda: plain_fast(variant, x, w, inv, shift))
                    library_ms = device_ms(library_conv(x, w))
                    entry = dict(ms=ms, plain_ms=plain_ms, shape=label, max_abs_err=diff)
                    if dtype == torch.bfloat16:
                        bms, bound_by = conv_bound(variant, s, cin, cout)
                        msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d "
                                f"{library_ms:.3f} ms, bound {bms:.3f} ms ({bound_by}, "
                                f"{bms / ms:.1%})")
                    else:
                        f32_ms, _ = conv_bound(variant, s, cin, cout, dtype=dtype)
                        bms, bound_by = tf32x3_bound(variant, s, cin, cout)
                        entry["f32_bound_ms"] = f32_ms
                        msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d "
                                f"(TF32 off) {library_ms:.3f} ms, f32 bound {f32_ms:.3f} ms, "
                                f"3xTF32 bound {bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
                    if si == TIMED_AT.get(variant):
                        # no one PyTorch call takes the statistics with the conv
                        key = variant if dtype == torch.bfloat16 else f"{variant}_tf32x3"
                        report[key].update(entry, bound_ms=bms, bound_by=bound_by,
                                           library_ms=None)
                print(msg, flush=True)
            del x, w
    torch.cuda.empty_cache()
    return report


def rel_max(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def phase2_backward(device, gen, report):
    """The conv kernel as the input gradient, and s2_wgrad, against their
    plain versions; each case timed against the plain composition in its
    dtype (cuDNN, TF32 off in f32), the first bf16 shape's time reported."""
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
    from unet3d_tpu_torch.ops.conv3d import conv3d_torch, flip_io
    from unet3d_tpu_torch.utils.device import full_f32

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
            form = K.kernel_form(g, wf)
            msg = f"conv as dx  {label:36s} {str(dtype)[6:]:8s} {form:6s} rel {rel:.3e}"
            check(form == ("wgmma" if dtype == torch.bfloat16 else "tf32x3"), f"{msg}: form")
            check(rel < BOUNDS[dtype], f"{msg} > {BOUNDS[dtype]}")
            ms = device_ms(lambda: K.conv3x3x3(g, wf))
            plain_ms = device_ms(lambda: conv3d_torch(g, wf, (1, 1, 1), ((1, 1),) * 3))
            library_ms = device_ms(library_conv(g, wf))
            if dtype == torch.float32:
                f32_ms, _ = conv_bound("conv", s, cin, cout, dtype=dtype)
                bms, bound_by = tf32x3_bound("conv", s, cin, cout)
                msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d (TF32 off) "
                        f"{library_ms:.3f} ms, f32 bound {f32_ms:.3f} ms, 3xTF32 bound "
                        f"{bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
            else:
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
            xn, gn = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            ms = device_ms(lambda: W.s2_wgrad(x, g))

            def cudnn_dw():
                with full_f32(gn):
                    return torch.nn.grad.conv3d_weight(xn, (cout, cin, 3, 3, 3), gn,
                                                       stride=2, padding=1)
            plain_ms = device_ms(cudnn_dw)
            # dw: 27 * cin * cout products per output voxel; x and g read,
            # the f32 weight gradient written
            half = (s // 2) ** 3
            size = torch.finfo(dtype).bits // 8
            bms, bound_by = bound_ms(2.0 * half * 27 * cin * cout,
                                     size * (s ** 3 * cin + half * cout) + 4 * 27 * cin * cout,
                                     dtype)
            msg += (f" | kernel {ms:.3f} ms, cuDNN{' (TF32 off)' * (dtype == torch.float32)} "
                    f"{plain_ms:.3f} ms, bound {bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
            if dtype == torch.bfloat16 and si == 0:
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
    direct conv's plain version; each case timed against the direct hand
    kernel and the plain composition in its dtype (cuDNN, TF32 off in f32)."""
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
                plain_variant, direct_fn = direct[variant]
                ms = device_ms(lambda: kernel[variant](x, w))
                direct_ms = device_ms(lambda: direct_fn(x, w))
                plain_ms = device_ms(lambda: plain_fast(plain_variant, x, w, None, None))
                # Winograd-DH issues 48 of the direct conv's 108 products
                bms, bound_by = conv_bound(variant, s, cin, cout, WINOGRAD_PRODUCTS, dtype)
                msg += (f" | kernel {ms:.3f} ms, direct kernel {direct_ms:.3f} ms, "
                        f"cuDNN{' (TF32 off)' * (dtype == torch.float32)} {plain_ms:.3f} ms, "
                        f"bound {bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
                if dtype == torch.bfloat16 and si == TIMED_AT[variant]:
                    report[variant] = dict(
                        ms=ms, plain_ms=plain_ms, direct_ms=direct_ms, shape=label,
                        bound_ms=bms, bound_by=bound_by,
                        library_ms=plain_ms if variant == "winograd" else None,
                        max_abs_err=(got_y.float() - want.float()).abs().max().item())
                print(msg, flush=True)
            del x, w, want, want_direct
    torch.cuda.empty_cache()


def plain_block(block, x):
    """A basic or residual block through F.conv3d and the concat, as the JAX
    model runs it: the residual block's norm2 without its activation, plus
    the identity (projected where the block has conv3), then the activation."""
    from unet3d_tpu_torch.models.dynunet import UnetResBlock
    from unet3d_tpu_torch.ops.conv3d import conv3d_torch, _pads
    from unet3d_tpu_torch.ops.conv3d_kernel import instance_stats
    from unet3d_tpu_torch.ops.norm import instance_norm_from_stats
    if isinstance(x, tuple):
        x = torch.cat(x, dim=-1)
    residual = isinstance(block, UnetResBlock)
    h = x
    for conv, norm in ((block.conv1, block.norm1), (block.conv2, block.norm2)):
        y = conv3d_torch(h, conv.kernel, conv.strides, _pads("SAME", conv.kernel_size))
        h = instance_norm_from_stats(y, *instance_stats(y), norm.scale, norm.bias)
        if not (residual and conv is block.conv2):
            h = F.leaky_relu(h, 0.01)
    if residual:
        identity = x
        if block.project:
            identity = block.conv3(x)
            identity = instance_norm_from_stats(identity, *instance_stats(identity),
                                                block.norm3.scale, block.norm3.bias)
        h = F.leaky_relu(h + identity, 0.01)
    return h


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

    # one step's gradients, kernels against the plain path; the f32 step's
    # direct convs take the tf32x3 form
    grads = {}
    for name, dt_amp, bound in (("f32", False, GRAD_BOUND_F32),
                                ("bf16", True, GRAD_BOUND_BF16)):
        x, y = prepare_batch(train_batch["image"], train_batch["label"], device, dt_amp)
        reset_launches()
        rel, worst, worst_name = grad_rel_l2(model, criterion, x, y, dt_amp)
        grads[name] = rel
        msg = (f"gradients {name}, kernels vs plain path: rel L2 {rel:.3e} over all "
               f"parameters; worst tensor {worst_name} {worst:.3e}; {form_counts()}")
        print(msg, flush=True)
        check(rel < bound, f"{msg} > {bound}")
        if not dt_amp:
            f32_forms = forms_of(("conv", "conv_stats", "block_stats"))
            check(set(f32_forms) == {f"{v}/tf32x3" for v in ("conv", "conv_stats", "block_stats")},
                  f"f32 step: direct conv launches by form {f32_forms}")
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
                          losses=losses, profile=profile, f32_step_forms=f32_forms)


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
    for part in ("out", "predict"):  # phase 9 trains on the same cases
        shutil.rmtree(os.path.join(TRAIN_CLI_DIR, part), ignore_errors=True)
    return launches, summary, cases


def all_grads(model, criterion, x, y, amp, grad_accum=1):
    """One step's f32 gradients of every parameter (no update)."""
    from unet3d_tpu_torch.train.step import accumulate_gradients
    model.zero_grad(set_to_none=True)
    accumulate_gradients(model, criterion, x, y, amp, grad_accum)
    grads = [p.grad.detach().clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return grads


def rel_l2_all(got, want) -> float:
    """Relative L2 of one set of tensors against another, over all of them."""
    diff = sum(float((a - b).float().square().sum()) for a, b in zip(got, want))
    return (diff / sum(float(b.float().square().sum()) for b in want)) ** 0.5


def phase9_train_cli_res(device, seed, card, cases):
    """The train CLI with the options ported last, on phase 8's cases: the
    BraTS config with a residual DynUNet, remat, batches of 2 in 2
    microbatches, DiceFocalLoss, AdamW and the optimizer state saved; fold 1
    for 2 epochs, then ``main`` again with 3 epochs, which resumes. Then, on
    the trained model, one step's gradients three ways, the step's time and
    peak memory with and without remat, and flip TTA on one window."""
    from unet3d_tpu_torch.config.factory import (build_inferer_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.data.prefetch import DevicePrefetcher
    from unet3d_tpu_torch.predict.volumetric import make_forward, predictions_with_tta
    from unet3d_tpu_torch.scripts import train as train_cli
    from unet3d_tpu_torch.train import train as engine
    from unet3d_tpu_torch.train.checkpoint import opt_state_arrays
    from unet3d_tpu_torch.train.step import make_train_step, prepare_batch
    from unet3d_tpu_torch.train.train import read_training_log
    from unet3d_tpu_torch.utils.config import dump_json, load_json

    shutil.rmtree(RES_CLI_DIR, ignore_errors=True)
    os.makedirs(RES_CLI_DIR)
    config = load_json(CONFIG)
    config["model"]["res_block"] = True
    config["training"].update(RES_TRAINING, n_epochs=RES_EPOCHS)
    config["loss"] = {"name": "DiceFocalLoss", "sigmoid": True}
    config["optimizer"] = {"name": "AdamW", "lr": 1e-3}
    config["training_filenames"] = cases
    config["cross_validation"]["folds"] = TRAIN_CLI_FOLDS
    del config["bratsvalidation_filenames"]
    config_file = os.path.join(RES_CLI_DIR, "brats2020_res.json")
    dump_json(config, config_file)
    work = os.path.join(RES_CLI_DIR, "out", "brats2020_res")
    train_cli.main(["--config_filename", config_file, "--output_dir",
                    os.path.dirname(work), "--setup_crossval_only"])
    fold_file, fold_dir = os.path.join(work, "fold1.json"), os.path.join(work, "fold1")
    grad_accum = RES_TRAINING["gradient_accumulation_steps"]
    print(f"train CLI, residual DynUNet: {json.dumps(RES_TRAINING)}, DiceFocalLoss, "
          f"AdamW; fold 1, {RES_EPOCHS} epochs, then resumed to {RES_EPOCHS + 1}", flush=True)

    runs, loads, epochs = [], [], []

    class EpochPrefetcher(DevicePrefetcher):
        def set_epoch(self, epoch):
            epochs.append((len(runs), epoch, time.perf_counter()))
            super().set_epoch(epoch)

    real_run_training, real_load = train_cli.run_training, engine.load_opt_state

    def timed_run_training(train_step, *args, **kwargs):
        steps = []

        def step(images, labels):
            before = launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = train_step(images, labels)
            end.record()
            after = launch_counts()
            steps.append(dict(shape=tuple(images.shape), events=(start, end),
                              launches={k: after[k] - before[k] for k in after}))
            return loss

        torch.cuda.synchronize()
        reset_launches()
        model = real_run_training(step, *args, **kwargs)
        torch.cuda.synchronize()
        runs.append(dict(end=time.perf_counter(), steps=steps, launches=launch_counts(),
                         forms=dict(form_launches()), model=model))
        return model

    def recorded_load(optimizer, names, filename):
        real_load(optimizer, names, filename)
        loads.append((filename, opt_state_arrays(optimizer, names)))

    train_cli.run_training, engine.load_opt_state = timed_run_training, recorded_load
    train_cli.DevicePrefetcher = EpochPrefetcher
    optimizer_file = os.path.join(fold_dir, "model_optimizer.npz")
    try:
        t0 = time.perf_counter()
        result = train_cli.main(["--config_filename", fold_file, "--output_dir", work])
        first_s = time.perf_counter() - t0
        with np.load(optimizer_file) as data:
            saved = {k: data[k] for k in data.files}
        fold = load_json(fold_file)
        fold["training"]["n_epochs"] = RES_EPOCHS + 1
        dump_json(fold, fold_file)
        t0 = time.perf_counter()
        resumed = train_cli.main(["--config_filename", fold_file, "--output_dir", work])
        resume_s = time.perf_counter() - t0
    finally:
        train_cli.run_training, engine.load_opt_state = real_run_training, real_load
        train_cli.DevicePrefetcher = DevicePrefetcher

    # launches: all four training kernels, wgmma only, in both runs
    for i, run in enumerate(runs):
        forms = {f"{v}/{f}": n for (v, f), n in sorted(run["forms"].items())}
        print(f"train CLI res+remat run {i + 1}: launches {run['launches']}; by form {forms}",
              flush=True)
        for kernel in TRAIN_KERNELS:
            check(run["forms"].get((kernel, "wgmma"), 0) > 0,
                  f"res+remat run {i + 1}: kernel {kernel} not launched in the wgmma form")
        off = {k: n for k, n in run["forms"].items() if k[1] != "wgmma"}
        check(not off, f"res+remat run {i + 1}: bf16 sites off the wgmma form: {off}")
    # under remat each microbatch runs the stats kernels twice: forward and recompute
    model = resumed["model"]
    check(model.remat and type(model.input_block).__name__ == "UnetResBlock",
          "the CLI did not build the residual remat model")
    shape = tuple(config["dataset"]["desired_shape"])
    forward = make_forward(model, amp=True)
    window = torch.randn(1, *shape, 4, device=device,
                         generator=torch.Generator(device=device).manual_seed(seed + 9))
    reset_launches()
    forward(window)
    torch.cuda.synchronize()
    per_forward = {k: launch_counts()[k] for k in ("conv_stats", "block_stats")}
    steps = [st for run in runs for st in run["steps"]]
    for st in steps:
        want = {k: 2 * grad_accum * n for k, n in per_forward.items()}
        got = {k: st["launches"][k] for k in per_forward}
        check(st["shape"][0] == RES_TRAINING["batch_size"], f"step batch {st['shape']}")
        check(got == want, f"res+remat step launches {got}: expected 2 x {grad_accum} "
              f"microbatches x the forward's {per_forward}")
    print(f"res+remat: one forward launches {per_forward}; each training step (batch "
          f"{RES_TRAINING['batch_size']}, {grad_accum} microbatches) "
          f"{[{k: st['launches'][k] for k in TRAIN_KERNELS} for st in steps]}", flush=True)

    # the resume read the optimizer file written by the first run, as written
    check(len(loads) == 1 and loads[0][0] == optimizer_file,
          f"the resume loaded {[f for f, _ in loads]}")
    loaded = loads[0][1]
    same = loaded.keys() == saved.keys() and all(
        np.array_equal(loaded[k], saved[k]) for k in saved)
    print(f"resume: loaded {os.path.basename(optimizer_file)} ({len(saved)} leaves, count "
          f"{int(saved['.count'])}); equal to the saved state: {same}", flush=True)
    check(same, "the optimizer state the resume loaded differs from the saved one")
    with np.load(optimizer_file) as data:
        check(int(data[".count"]) == RES_EPOCHS + 1, f"final update count {int(data['.count'])}")
    rows = read_training_log(os.path.join(fold_dir, "training_log.csv"))
    print(f"res+remat training_log.csv: {rows}", flush=True)
    check(len(rows) == RES_EPOCHS + 1 and [r[0] for r in rows] == [1, 2, 3],
          f"resumed log has rows {[r[0] for r in rows]}")
    check(all(np.isfinite(r[1]) and np.isfinite(r[3]) for r in rows),
          f"non-finite losses in the resumed log {rows}")
    step_ms_cli = [st["events"][0].elapsed_time(st["events"][1]) for st in steps]
    ends = {i: run["end"] for i, run in enumerate(runs)}
    epoch_s = []
    for j, (run_i, epoch, t) in enumerate(epochs):
        nxt = epochs[j + 1] if j + 1 < len(epochs) else None
        stop = nxt[2] if nxt is not None and nxt[0] == run_i else ends[run_i]
        epoch_s.append((epoch, stop - t))
    print(f"train CLI res+remat: main {first_s:.3f} s ({RES_EPOCHS} epochs), resumed main "
          f"{resume_s:.3f} s (1 epoch); seconds per epoch "
          f"{[(e, round(v, 3)) for e, v in epoch_s]}; step ms "
          f"{[round(v, 3) for v in step_ms_cli]} [{card}]", flush=True)
    del result, resumed

    # one step's gradients: kernels vs the plain path, remat vs none, 2
    # microbatches vs one batch of 2
    criterion = load_criterion_from_config(config)
    rng = np.random.RandomState(seed + 11)
    images = rng.randn(2, 4, *shape).astype(np.float32)
    labels = (rng.rand(2, 3, *shape) > 0.5).astype(np.float32)
    grads = {}
    for name, amp, bound in (("f32", False, GRAD_BOUND_F32), ("bf16", True, GRAD_BOUND_BF16)):
        x, y = prepare_batch(images, labels, device, amp)
        rel, worst, worst_name = grad_rel_l2(model, criterion, x[:1], y[:1], amp)
        remat = all_grads(model, criterion, x[:1], y[:1], amp)
        model.remat = False
        plain = all_grads(model, criterion, x[:1], y[:1], amp)
        model.remat = True
        accum = all_grads(model, criterion, x, y, amp, grad_accum)
        whole = all_grads(model, criterion, x, y, amp, 1)
        grads[name] = dict(kernels_vs_plain=rel, remat_vs_none=rel_l2_all(remat, plain),
                           accum_vs_batch=rel_l2_all(accum, whole))
        print(f"res+remat gradients {name}: kernels vs plain path rel L2 {rel:.3e} (worst "
              f"{worst_name} {worst:.3e}); remat vs no remat "
              f"{grads[name]['remat_vs_none']:.3e}; {grad_accum} microbatches vs one batch "
              f"of 2 {grads[name]['accum_vs_batch']:.3e}", flush=True)
        for what, value in grads[name].items():
            check(value < bound, f"res+remat gradients {name} {what} {value:.3e} > {bound}")
        del x, y, remat, plain, accum, whole
    torch.cuda.empty_cache()

    # the step's time and peak memory, with and without remat, at batch 1 and
    # at the CLI's batch of 2 in 2 microbatches
    cases_ms = {}
    peaks = {}
    order = [(1, 1, False), (1, 1, True), (2, grad_accum, False), (2, grad_accum, True)]
    for batch, accum, remat in order + order[::-1]:
        model.remat = remat
        opt = torch.optim.AdamW(model.parameters(), lr=1e-6)
        one_step = make_train_step(model, criterion, opt, amp=True, grad_accum=accum)
        one_step(images[:batch], labels[:batch])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        key = f"batch {batch} x{accum} remat {remat}"
        cases_ms.setdefault(key, []).append(step_ms(one_step, images[:batch], labels[:batch]))
        peaks[key] = torch.cuda.max_memory_allocated() / 2**30
        del opt, one_step
        torch.cuda.empty_cache()
    profiles = {}
    for remat in (False, True):
        model.remat = remat
        one_step = make_train_step(model, criterion, torch.optim.AdamW(model.parameters(),
                                                                       lr=1e-6),
                                   amp=True, grad_accum=grad_accum)
        profiles[f"remat {remat}"] = profile_device(
            lambda: one_step(images, labels),
            f"one bf16 train step, batch 2 in {grad_accum} microbatches, remat {remat}", card)
        del one_step
    model.remat = True
    print(f"res train step ms (CUDA events, 5 steps after 2, two turns): "
          f"{json.dumps(cases_ms)}; peak memory GiB {json.dumps(peaks)} [{card}]", flush=True)
    for batch, accum in ((1, 1), (2, grad_accum)):
        on, off = (peaks[f"batch {batch} x{accum} remat {r}"] for r in (True, False))
        check(on < off, f"batch {batch} x{accum}: remat's peak {on:.2f} GiB is not below "
              f"{off:.2f} GiB without it")

    # flip TTA on one window through the config's inferer
    inferer = build_inferer_from_config(config)
    with torch.no_grad():
        got = predictions_with_tta(model, window, inferer=inferer, forward=forward)
        runs_tta = [inferer(window, forward)]
        for axis in (1, 2, 3):
            runs_tta.append(torch.flip(inferer(torch.flip(window, dims=(axis,)), forward),
                                       dims=(axis,)))
        want = torch.stack(runs_tta).mean(0)
    tta_rel = float((got - want).norm() / want.norm())
    print(f"flip TTA on one {shape} window, bf16: rel L2 {tta_rel:.3e} against the mean of "
          f"the four flipped forwards; {tuple(got.shape)}, finite "
          f"{bool(torch.isfinite(got).all())}", flush=True)
    check(got.shape == (1, *shape, 3) and bool(torch.isfinite(got).all()),
          "flip TTA output")
    check(tta_rel < TTA_BOUND, f"flip TTA rel L2 {tta_rel:.3e} > {TTA_BOUND}")
    del model, forward, window, got, want, runs_tta
    torch.cuda.empty_cache()
    shutil.rmtree(RES_CLI_DIR, ignore_errors=True)
    return runs[0]["launches"], dict(
        per_forward=per_forward, step_launches=[st["launches"] for st in steps],
        step_ms_cli=step_ms_cli, epoch_s=epoch_s, main_s=[first_s, resume_s],
        log=[list(map(float, r)) for r in rows], grad_rel_l2=grads, step_ms=cases_ms,
        peak_gib=peaks, profile=profiles, tta_rel_l2=tta_rel)


@contextlib.contextmanager
def plain_convs():
    """Inside the block every FastConv (the Myronenko family's convs) runs
    ``F.conv3d`` with torch autograd: the plain path, no hand kernel."""
    from unet3d_tpu_torch.models import layers
    from unet3d_tpu_torch.ops.conv3d import _pads, conv3d_torch

    def plain(x, w, strides=(1, 1, 1), padding="SAME"):
        return conv3d_torch(x, w, tuple(strides), _pads(padding, w.shape[:3]))

    real, layers.conv3d = layers.conv3d, plain
    try:
        yield
    finally:
        layers.conv3d = real


def phase10_kernels(device, gen):
    """The conv kernel and s2_wgrad at the family's new shapes against their
    plain versions, in the form each takes there, timed (device ms) beside
    the plain composition, one PyTorch call and the bound (f32: both the f32
    CUDA-core bound and the 3xTF32 tensor-core bound the tf32x3 form is held
    to)."""
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
    from unet3d_tpu_torch.ops.conv3d import conv3d_torch

    rows = []
    for label, s, cin, cout, dtype, expected in FAMILY_CONV_SHAPES:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(dtype)
        w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
             / (27 * cin) ** 0.5).to(dtype)
        form = K.kernel_form(x, w)
        got, want = K.conv3x3x3(x, w), K.conv3d_reference(x, w)
        torch.cuda.synchronize()
        rel = rel_max(got, want)
        msg = f"family conv {label:32s} {str(dtype)[6:]:8s} {form:6s} rel {rel:.3e}"
        check(form == expected, f"{msg}: form, expected {expected}")
        check(rel < BOUNDS[dtype], f"{msg} > {BOUNDS[dtype]}")
        ms = device_ms(lambda: K.conv3x3x3(x, w))
        plain_ms = device_ms(lambda: conv3d_torch(x, w, (1, 1, 1), ((1, 1),) * 3))
        library_ms = device_ms(library_conv(x, w))
        row = dict(name="conv" if dtype == torch.bfloat16 else "conv_tf32x3", shape=label,
                   dtype=str(dtype)[6:], form=form, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   max_abs_err=(got.float() - want.float()).abs().max().item())
        if dtype == torch.float32:
            row["f32_bound_ms"], _ = conv_bound("conv", s, cin, cout, dtype=dtype)
            bms, bound_by = tf32x3_bound("conv", s, cin, cout)
            msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d (TF32 off) "
                    f"{library_ms:.3f} ms, f32 bound {row['f32_bound_ms']:.3f} ms, 3xTF32 "
                    f"bound {bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
        else:
            bms, bound_by = conv_bound("conv", s, cin, cout, dtype=dtype)
            msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d "
                    f"{library_ms:.3f} ms, bound {bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
        print(msg, flush=True)
        rows.append(dict(row, bound_ms=bms, bound_by=bound_by))
        del x, w, got, want
    for label, s, cin, cout in FAMILY_S2_SHAPES:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(torch.bfloat16)
        g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device,
                        generator=gen).to(torch.bfloat16)
        form = W.kernel_form(x, g)
        got, want = W.s2_wgrad(x, g), W.s2_wgrad_reference(x, g)
        torch.cuda.synchronize()
        rel = rel_max(got, want)
        msg = f"family s2_wgrad {label:28s} bfloat16 {form:5s} rel {rel:.3e}"
        check(form == "wgmma", f"{msg}: form")
        check(rel < S2_BOUND, f"{msg} > {S2_BOUND}")
        xn, gn = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        ms = device_ms(lambda: W.s2_wgrad(x, g))
        plain_ms = device_ms(lambda: torch.nn.grad.conv3d_weight(
            xn, (cout, cin, 3, 3, 3), gn, stride=2, padding=1))
        half = (s // 2) ** 3
        bms, bound_by = bound_ms(2.0 * half * 27 * cin * cout,
                                 2 * (s ** 3 * cin + half * cout) + 4 * 27 * cin * cout)
        print(f"{msg} | kernel {ms:.3f} ms, cuDNN {plain_ms:.3f} ms, bound {bms:.3f} ms "
              f"({bound_by}, {bms / ms:.1%})", flush=True)
        # the plain composition is one PyTorch call (cuDNN's dw)
        rows.append(dict(name="s2_wgrad", shape=label, dtype="bfloat16", form=form, ms=ms,
                         plain_ms=plain_ms, library_ms=plain_ms, bound_ms=bms,
                         bound_by=bound_by, max_abs_err=(got - want).abs().max().item()))
        del x, g, got, want
    torch.cuda.empty_cache()
    return rows


def forms_of(kernels) -> dict:
    return {f"{v}/{f}": n for (v, f), n in sorted(form_launches().items()) if v in kernels}


def check_family_forms(where: str, wmma_conv: bool = False) -> None:
    """Under AMP the family's conv launches take the wgmma form (bf16) or
    the tf32x3 form (the f32 decoder), s2_wgrad the wgmma form; the conv's
    wmma form only where ``wmma_conv`` allows it: in the U-Nets and
    autoencoders the first conv follows a GroupNorm, so training takes its
    input gradient, whose n_features outputs are no multiple of 8, and
    AutoImplantUNet's one-channel input conv is no multiple of 4."""
    allowed = {("conv", "wgmma"), ("conv", "tf32x3"), ("s2_wgrad", "wgmma")}
    if wmma_conv:
        allowed.add(("conv", "wmma"))
    off = {k: n for k, n in form_launches().items() if k not in allowed}
    check(not off, f"{where}: launches off the wgmma / tf32x3 forms: {off}")


def family_grads(model, criterion, x, y, amp, seed):
    """One step's gradients of every parameter, kernels against the plain
    path, the noise drawn from generators seeded alike: (relative L2 over
    all, worst tensor's, its name)."""
    from unet3d_tpu_torch.train.step import forward_loss, noise_generator
    names, params = zip(*model.named_parameters())

    def grads():
        loss = forward_loss(model, criterion, x, y, amp, noise_generator(model, seed))
        return torch.autograd.grad(loss, params)

    got = grads()
    with plain_convs():
        want = grads()
    diff = sum(float((a - b).float().square().sum()) for a, b in zip(got, want))
    norm = sum(float(b.float().square().sum()) for b in want)
    worst = max((float((a - b).float().norm() / b.float().norm()), n)
                for a, b, n in zip(got, want, names)
                if float(b.float().norm()) > 1e-6 * norm ** 0.5)
    return (diff / norm) ** 0.5, worst[0], worst[1]


def rel_l2_of(got, want) -> float:
    """Relative L2 of tensors ``got`` against ``want``, over all of them."""
    diff = sum(float((a.double() - b.double()).square().sum()) for a, b in zip(got, want))
    return (diff / sum(float(b.double().square().sum()) for b in want)) ** 0.5


def default_tf32_flags(model, criterion, images, labels, device, seed):
    """Under torch's default flags (cuDNN's f32 convs in TF32; this script sets
    no flag) the f32 paths stay full f32: one f32 SegResNetVAE step's
    gradients (the hand kernels or the plain path, cuDNN's stride-2 convs,
    weight gradients and transposed convs) and one f32 stride-2 conv at V's
    down1 (32 -> 64 @128^3: cuDNN forward and input gradient, s2_wgrad),
    each against the same computation with cuDNN's TF32 off by the caller,
    within TF32_FLAGS_BOUND relative L2 (TF32 would be ~1e-3; the same path
    run twice differs by 2e-8 to 1.5e-7). The two f32 paths are not each
    other's yardstick: GroupNorm's E[x^2] - E[x]^2 in f32 (the reference's
    formula) puts each 4e-7 to 2.6e-4 from f64 by the weights' state, and
    the kernels anywhere from 0.6x to 1.9x as far as the plain path
    (tools/f32_grad_spread.py). So the kernels' gradients are held to the
    f64 plain path: no more than F64_EXCESS_BOUND farther from it than the
    plain f32 path's."""
    import copy

    from unet3d_tpu_torch.ops.conv3d import conv3d
    from unet3d_tpu_torch.train.step import forward_loss, noise_generator, prepare_batch
    check(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 flag is not torch's default")
    x, y = prepare_batch(images, labels, device, False)
    rng = np.random.RandomState(seed + 40)
    xs = torch.from_numpy(rng.randn(1, 128, 128, 128, 32).astype(np.float32)).to(device)
    ws = torch.from_numpy((rng.randn(3, 3, 3, 32, 64) / np.sqrt(27 * 32))
                          .astype(np.float32)).to(device)
    gs = torch.from_numpy(rng.randn(1, 64, 64, 64, 64).astype(np.float32)).to(device)

    def step_grads(net, xx, plain):
        with plain_convs() if plain else contextlib.nullcontext():
            loss = forward_loss(net, criterion, xx, y, False, noise_generator(net, seed))
            return torch.autograd.grad(loss, list(net.parameters()))

    def stride2():
        lx, lw = xs.clone().requires_grad_(), ws.clone().requires_grad_()
        out = conv3d(lx, lw, (2, 2, 2))
        return (out.detach(), *torch.autograd.grad(out, (lx, lw), gs))

    got = {"kernels": step_grads(model, x, False), "plain": step_grads(model, x, True)}
    got_s2 = stride2()
    check(torch.backends.cudnn.allow_tf32, "the port left cuDNN's TF32 flag changed")
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = {"kernels": step_grads(model, x, False), "plain": step_grads(model, x, True)}
        want_s2 = stride2()
    finally:
        torch.backends.cudnn.allow_tf32 = True
    double = copy.deepcopy(model).double()
    f64 = step_grads(double, x.double(), True)
    del double
    out = {f"step_{path}": rel_l2_of(got[path], want[path]) for path in got}
    for name, a, b in zip(("stride2_y", "stride2_dx", "stride2_dw"), got_s2, want_s2):
        out[name] = rel_l2_of([a], [b])
    accuracy = {"kernels_vs_plain": rel_l2_of(got["kernels"], want["plain"]),
                "kernels_vs_f64": rel_l2_of(got["kernels"], f64),
                "plain_vs_f64": rel_l2_of(want["plain"], f64)}
    print(f"torch's default TF32 flags: f32 paths vs themselves with TF32 off, rel L2 {out}; "
          f"f32 step gradients {accuracy}", flush=True)
    for name, rel in out.items():
        check(rel < TF32_FLAGS_BOUND, f"default TF32 flags: {name} rel L2 {rel:.3e} > "
              f"{TF32_FLAGS_BOUND}")
    excess = accuracy["kernels_vs_f64"] - accuracy["plain_vs_f64"]
    check(excess < F64_EXCESS_BOUND,
          f"f32 step gradients: the kernels {accuracy['kernels_vs_f64']:.3e} from f64, the "
          f"plain path {accuracy['plain_vs_f64']:.3e}: {excess:.3e} farther > "
          f"{F64_EXCESS_BOUND}")
    return dict(out, **accuracy)


def window_check(model, window, use_test=False):
    """One bf16 window forward through ``make_forward``, kernels against the
    plain path: (output, relative L2, launches, forms)."""
    from unet3d_tpu_torch.predict.volumetric import make_forward
    forward = make_forward(model, amp=True, use_test=use_test)
    torch.cuda.synchronize()
    reset_launches()
    got = forward(window)
    torch.cuda.synchronize()
    launches, forms = launch_counts(), dict(form_launches())
    with plain_convs():
        want = forward(window)
    check(launch_counts() == launches, "the plain path launched a hand kernel")
    rel = float((got - want).norm() / want.norm())
    return forward, got, rel, launches, forms


def phase10_segresnet(device, seed, card):
    """SegResNetVAE at Myronenko's widths: (a) one 128^3 bf16 window forward,
    kernels against the plain path, launches by form, time and profile; (b)
    one bf16 AMP train step at batch 1 (DiceLoss plus the VAE term):
    launches, gradients against the plain path, step ms, peak memory,
    profile; then the f32 step and an f32 stride-2 conv under torch's default
    TF32 flags (``default_tf32_flags``)."""
    from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.train.step import make_train_step, prepare_batch
    from unet3d_tpu_torch.utils.config import load_json

    config = load_json(CONFIG)
    config["model"] = dict(SEGRESNET_MODEL)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"SegResNetVAE {json.dumps(SEGRESNET_MODEL)}: {n_params} params [{card}]",
          flush=True)
    shape = tuple(config["dataset"]["desired_shape"])
    rng = np.random.RandomState(seed + 20)
    window = torch.from_numpy(rng.randn(1, *shape, 4).astype(np.float32)).to(device)

    # (a) one window forward, eval: the segmentation alone
    forward, got, rel, launches, forms = window_check(model, window)
    check(got.shape == (1, *shape, 3) and bool(torch.isfinite(got).all()),
          f"SegResNetVAE window output {tuple(got.shape)}")
    print(f"SegResNetVAE window 128^3 bf16: kernels vs plain path rel L2 {rel:.3e}; "
          f"launches {launches}; by form {forms_of(FAMILY_KERNELS)}", flush=True)
    check(rel < L2_BOUND, f"SegResNetVAE window rel L2 {rel:.3e} > {L2_BOUND}")
    check_family_forms("SegResNetVAE window")
    window_by_form = forms_of(FAMILY_KERNELS)
    window_forms = {k: forms.get(k, 0) for k in (("conv", "wgmma"), ("conv", "tf32x3"))}
    check(window_forms == {("conv", "wgmma"): 19, ("conv", "tf32x3"): 6},
          f"SegResNetVAE window conv launches by form {window_forms}: expected 19 "
          "wgmma (encoder) and 6 tf32x3 (the f32 decoder)")
    times = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            times[which].append(cuda_ms(lambda: forward(window)))
    window_profile = profile_device(lambda: forward(window),
                                    "SegResNetVAE one 128^3 window forward", card)
    print(f"SegResNetVAE window forward 128^3 bf16: kernels {times['kernels']} ms, plain "
          f"{times['plain']} ms [{card}]", flush=True)
    del forward, got

    # (b) one bf16 AMP train step at batch 1
    criterion = load_criterion_from_config(config)
    images = rng.randn(1, 4, *shape).astype(np.float32)
    labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
    optimizer = build_optimizer_from_config(config, model.parameters())
    step = make_train_step(model, criterion, optimizer, amp=True, seed=seed)
    step(images, labels)  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    reset_launches()
    loss = float(step(images, labels))
    torch.cuda.synchronize()
    step_launches, step_forms = launch_counts(), forms_of(FAMILY_KERNELS)
    print(f"SegResNetVAE train step: loss {loss:.6f}; launches {step_launches}; by form "
          f"{step_forms}", flush=True)
    check(np.isfinite(loss), f"SegResNetVAE train loss {loss}")
    check_family_forms("SegResNetVAE train step")
    check(step_launches["s2_wgrad"] == 4,
          f"s2_wgrad launched {step_launches['s2_wgrad']} times, expected 4 "
          "(down1..3 and vae_down_conv)")
    check(step_launches["conv"] == 61,
          f"conv launched {step_launches['conv']} times, expected 61 (31 forward: 19 bf16 "
          "and 12 f32 with the VAE replay; 30 input gradients)")
    step_conv_forms = {k: step_forms.get(k, 0) for k in ("conv/wgmma", "conv/tf32x3")}
    check(step_conv_forms == {"conv/wgmma": 37, "conv/tf32x3": 24},
          f"SegResNetVAE step conv launches by form {step_conv_forms}: expected 37 wgmma "
          "and 24 tf32x3 (the f32 decoder's forward, input gradients and VAE replay)")
    grads = {}
    for name, amp, bound in (("f32", False, GRAD_BOUND_F32), ("bf16", True, GRAD_BOUND_BF16)):
        x, y = prepare_batch(images, labels, device, amp)
        grel, worst, worst_name = family_grads(model, criterion, x, y, amp, seed)
        grads[name] = grel
        msg = (f"SegResNetVAE gradients {name}, kernels vs plain path: rel L2 {grel:.3e}; "
               f"worst tensor {worst_name} {worst:.3e}")
        print(msg, flush=True)
        check(grel < bound, f"{msg} > {bound}")
        del x, y
    # torch's default TF32 flags
    tf32_flags = default_tf32_flags(model, criterion, images, labels, device, seed)
    torch.cuda.empty_cache()
    step_times, peaks = {"plain": [], "kernels": []}, {}
    for which in ("plain", "kernels", "kernels", "plain"):
        one = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-6),
                              amp=True, seed=seed)
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats()
            step_times[which].append(step_ms(one, images, labels))
            peaks[which] = torch.cuda.max_memory_allocated() / 2**30
    step_profile = profile_device(lambda: step(images, labels),
                                  "SegResNetVAE one bf16 train step", card)
    print(f"SegResNetVAE train step (bf16 AMP, batch 1, 128^3): kernels "
          f"{step_times['kernels']} ms, plain {step_times['plain']} ms; peak memory kernels "
          f"{peaks['kernels']:.2f} GiB, plain {peaks['plain']:.2f} GiB [{card}]", flush=True)
    del model, optimizer, step
    torch.cuda.empty_cache()
    return step_launches, dict(
        window_rel_l2=rel, window_launches=launches, window_forms=window_by_form,
        window_ms=times, window_profile=window_profile, step_loss=loss,
        step_forms=step_forms, grad_rel_l2=grads, step_ms=step_times, peak_gib=peaks,
        step_profile=step_profile, default_tf32_flags_rel_l2=tf32_flags)


def phase10_train_cli(device, seed, card, cases):
    """The train CLI on phase 8's cases and folds with the BraTS config's
    model section replaced by SegResNetVAE: fold 1, 2 epochs, its validation
    and bratsvalidation prediction through the CLI's own code."""
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.convert import load_jax_variables
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.data.prefetch import DevicePrefetcher
    from unet3d_tpu_torch.scripts import train as train_cli
    from unet3d_tpu_torch.train.checkpoint import load_checkpoint
    from unet3d_tpu_torch.train.train import read_training_log
    from unet3d_tpu_torch.utils.config import dump_json, load_json

    shutil.rmtree(SEGRESNET_CLI_DIR, ignore_errors=True)
    os.makedirs(SEGRESNET_CLI_DIR)
    config = load_json(CONFIG)
    config["model"] = dict(SEGRESNET_MODEL)
    config["training_filenames"] = cases
    config["bratsvalidation_filenames"] = [{"image": cases[0]["image"]}]
    config["training"]["n_epochs"] = TRAIN_CLI_EPOCHS
    config["cross_validation"]["folds"] = TRAIN_CLI_FOLDS
    config_file = os.path.join(SEGRESNET_CLI_DIR, "brats2020_segresnet.json")
    dump_json(config, config_file)
    work = os.path.join(SEGRESNET_CLI_DIR, "out", "brats2020_segresnet")
    train_cli.main(["--config_filename", config_file, "--output_dir",
                    os.path.dirname(work), "--setup_crossval_only"])
    fold_file, fold_dir = os.path.join(work, "fold1.json"), os.path.join(work, "fold1")
    steps, epochs, run = [], [], {}

    class EpochPrefetcher(DevicePrefetcher):
        def set_epoch(self, epoch):
            epochs.append((epoch, time.perf_counter()))
            super().set_epoch(epoch)

    real_run_training = train_cli.run_training

    def timed_run_training(train_step, *args, **kwargs):
        def step(images, labels):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = train_step(images, labels)
            end.record()
            steps.append((start, end))
            return loss

        torch.cuda.synchronize()
        reset_launches()
        model = real_run_training(step, *args, **kwargs)
        torch.cuda.synchronize()
        run.update(end=time.perf_counter(), launches=launch_counts(),
                   forms=forms_of(FAMILY_KERNELS))
        check_family_forms("SegResNetVAE train CLI")
        return model

    train_cli.run_training, train_cli.DevicePrefetcher = timed_run_training, EpochPrefetcher
    try:
        t0 = time.perf_counter()
        result = train_cli.main(["--config_filename", fold_file, "--output_dir", work])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        train_cli.run_training, train_cli.DevicePrefetcher = real_run_training, DevicePrefetcher
    print(f"SegResNetVAE train CLI training: launches {run['launches']}; by form "
          f"{run['forms']}", flush=True)
    for kernel in FAMILY_KERNELS:
        check(run["launches"][kernel] > 0, f"train CLI: kernel {kernel} was not launched")
    check(run["forms"].get("conv/wgmma", 0) > 0 and run["forms"].get("conv/tf32x3", 0) > 0,
          f"train CLI: conv forms {run['forms']}")
    rows = read_training_log(os.path.join(fold_dir, "training_log.csv"))
    print(f"SegResNetVAE training_log.csv: {rows}", flush=True)
    check(len(rows) == TRAIN_CLI_EPOCHS and all(
        np.isfinite(r[1]) and np.isfinite(r[3]) for r in rows),
        f"SegResNetVAE training log {rows}")
    model = result["model"]
    fresh = build_or_load_model_from_config(config, None, device, seed=seed + 1)
    load_jax_variables(fresh, load_checkpoint(os.path.join(fold_dir, "model.npz")),
                       strict=True)
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        check(torch.equal(a, b), f"SegResNetVAE checkpoint round trip changed {name}")
    (written,) = result["predictions"]["bratsvalidation"]
    data, affine, _ = nifti.load(written)
    print(f"SegResNetVAE bratsvalidation prediction {os.path.basename(written)}: shape "
          f"{data.shape}, range [{data.min():.4f}, {data.max():.4f}]", flush=True)
    check(data.shape == BRATS_GRID + (3,) and bool(np.isfinite(data).all())
          and 0.0 <= data.min() and data.max() <= 1.0
          and np.allclose(affine, BRATS_AFFINE, atol=1e-6),
          f"SegResNetVAE train CLI prediction {data.shape}")
    starts = [t for _, t in epochs] + [run["end"]]
    epoch_s = [b - a for a, b in zip(starts, starts[1:])]
    step_ms_cli = [a.elapsed_time(b) for a, b in steps]
    print(f"SegResNetVAE train CLI: main {cli_s:.3f} s; seconds per epoch "
          f"{[round(v, 3) for v in epoch_s]}; step ms {[round(v, 3) for v in step_ms_cli]} "
          f"[{card}]", flush=True)
    del model, fresh, result
    torch.cuda.empty_cache()
    shutil.rmtree(SEGRESNET_CLI_DIR, ignore_errors=True)
    return run["launches"], dict(main_s=cli_s, epoch_s=epoch_s, step_ms=step_ms_cli,
                                 log=[list(map(float, r)) for r in rows],
                                 forms=run["forms"])


def phase10_family(device, seed, card):
    """UNet3D, AutoImplantUNet (``test=True`` through ``make_forward``) and
    LabeledVariationalAutoEncoder at 128^3: one bf16 window forward and one
    train step's gradients (f32 and bf16), kernels against the plain path,
    with the launches."""
    from unet3d_tpu_torch.config.factory import load_criterion_from_config
    from unet3d_tpu_torch.models.layers import init_parameters
    from unet3d_tpu_torch.models.registry import create_model
    from unet3d_tpu_torch.train.step import prepare_batch
    from unet3d_tpu_torch.utils.config import load_json

    config = load_json(CONFIG)
    shape = tuple(config["dataset"]["desired_shape"])
    criterion = load_criterion_from_config(config)
    out = {}
    for i, (name, kwargs, n_labels) in enumerate(FAMILY_MODELS):
        if "input_shape" in kwargs:
            kwargs = dict(kwargs, input_shape=list(shape))
        model = create_model(name, **kwargs)
        init_parameters(model, torch.Generator().manual_seed(seed + i))
        model = model.to(device).eval()
        rng = np.random.RandomState(seed + 30 + i)
        n_in = kwargs["n_features"]
        window = torch.from_numpy(rng.randn(1, *shape, n_in).astype(np.float32)).to(device)
        forward, got, rel, launches, forms = window_check(
            model, window, use_test=name == "AutoImplantUNet")
        check(got.shape == (1, *shape, kwargs["n_outputs"]) and bool(torch.isfinite(got).all()),
              f"{name} window output {tuple(got.shape)}")
        msg = (f"{name} window {shape} bf16: kernels vs plain rel L2 {rel:.3e}; launches "
               f"{launches}; by form {forms_of(FAMILY_KERNELS)}")
        print(msg, flush=True)
        check(rel < L2_BOUND, f"{msg} > {L2_BOUND}")
        check_family_forms(f"{name} window", wmma_conv=kwargs["n_features"] % 4 != 0)
        check(launches["conv"] > 0, f"{name}: conv not launched")
        window_ms = cuda_ms(lambda: forward(window))
        del forward, got
        images = rng.randn(1, n_in, *shape).astype(np.float32)
        labels = (rng.rand(1, n_labels, *shape) > 0.5).astype(np.float32)
        grads = {}
        for dt, amp, bound in (("f32", False, GRAD_BOUND_F32), ("bf16", True, GRAD_BOUND_BF16)):
            x, y = prepare_batch(images, labels, device, amp)
            reset_launches()
            grel, worst, worst_name = family_grads(model, criterion, x, y, amp, seed)
            grads[dt] = grel
            step_launches = launch_counts()
            msg = (f"{name} gradients {dt}, kernels vs plain path: rel L2 {grel:.3e}; worst "
                   f"tensor {worst_name} {worst:.3e}; launches {step_launches}")
            print(msg, flush=True)
            check(grel < bound, f"{msg} > {bound}")
            check(step_launches["s2_wgrad"] > 0, f"{name}: s2_wgrad not launched")
            if amp:
                check_family_forms(f"{name} train step", wmma_conv=True)
            del x, y
        print(f"{name} window forward {shape} bf16 {window_ms:.3f} ms [{card}]", flush=True)
        out[name] = dict(window_rel_l2=rel, window_launches=launches, window_ms=window_ms,
                         grad_rel_l2=grads, step_launches=step_launches)
        del model
        torch.cuda.empty_cache()
    return out


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
    # no TF32 flag is set: the phases run under torch's defaults, as a user
    # runs the CLIs, and the port's own policy keeps f32 full f32
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
    train_cli_launches, train_cli, cases = phase8_train_cli(device, args.seed, card)
    torch.cuda.empty_cache()
    # phase 9
    res_launches, res = phase9_train_cli_res(device, args.seed, card, cases)
    # phase 10
    family_rows = phase10_kernels(device, gen)
    segresnet_launches, segresnet = phase10_segresnet(device, args.seed, card)
    segresnet_cli_launches, segresnet_cli = phase10_train_cli(device, args.seed, card, cases)
    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    family = phase10_family(device, args.seed, card)
    check(not any(m in sys.modules for m in ("jax", "unet3d_tpu")),
          "the port imported jax")
    # launches: the training path's (phase 5; phase 7 for the Winograd
    # variants, which run only under the strategy); launches_predict: the
    # prediction path's (phase 3; the CLI under the strategy for Winograd);
    # launches_train_cli: the train CLI's training (phase 8);
    # launches_train_cli_res_remat: its first run with the residual DynUNet,
    # remat and 2 microbatches (phase 9); launches_segresnet: one bf16 train
    # step of SegResNetVAE (phase 10b), and family_shapes the kernel at the
    # Myronenko family's new shapes (phase 10)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = [{"name": v, "route": "cuda", "source": SOURCES[v],
                "replaces": REPLACES[v], "launches": train_launches[v],
                "launches_predict": launches[v], "launches_train_cli": train_cli_launches[v],
                "launches_train_cli_res_remat": res_launches[v],
                "launches_segresnet": segresnet_launches[v],
                **{k: report[v][k] for k in keys}}
               for v in TRAIN_KERNELS]
    for entry in kernels:
        rows = [r for r in family_rows if r["name"] == entry["name"]]
        if rows:
            entry["family_shapes"] = rows
    kernels += [{"name": v, "route": "cuda", "source": SOURCES[v],
                 "replaces": REPLACES[v], "launches": strategy_launches[v],
                 "launches_predict": cli_launches["winograd"][v],
                 "launches_train_cli": train_cli_launches[v],
                 "launches_train_cli_res_remat": res_launches[v],
                 "launches_segresnet": segresnet_launches[v],
                 **{k: report[v][k] for k in keys}, "direct_ms": report[v]["direct_ms"]}
                for v in STRATEGY_KERNELS]
    # the f32 form (conv3d_tf32x3.cu): conv's launches in SegResNetVAE's bf16
    # AMP train step (its f32 decoder, phase 10b) and time at the decoder's
    # 32 -> 32 @128^3 site; conv_stats' and block_stats' launches in the f32
    # DynUNet step (phase 5) and times at their phase-2 f32 sites; bound_ms
    # the 3xTF32 bound, f32_bound_ms the f32 CUDA-core one
    tf32_rows = [r for r in family_rows if r["name"] == "conv_tf32x3"]
    conv_tf32 = next(r for r in tf32_rows if r["shape"] == TF32X3_CONV_AT)
    kernels += [{"name": "conv_tf32x3", "route": "cuda", "source": TF32X3_SOURCE,
                 "replaces": REPLACES["conv"],
                 "launches": segresnet["step_forms"].get("conv/tf32x3", 0),
                 "launches_segresnet_window": segresnet["window_forms"].get("conv/tf32x3", 0),
                 "launches_train_cli_segresnet": segresnet_cli["forms"].get("conv/tf32x3", 0),
                 **{k: conv_tf32[k] for k in keys + ("f32_bound_ms",)},
                 "family_shapes": tf32_rows}]
    kernels += [{"name": f"{v}_tf32x3", "route": "cuda", "source": TF32X3_SOURCE,
                 "replaces": REPLACES[v],
                 "launches": training["f32_step_forms"].get(f"{v}/tf32x3", 0),
                 **{k: report[f"{v}_tf32x3"][k] for k in keys + ("f32_bound_ms",)}}
                for v in ("conv_stats", "block_stats")]
    idle = [k["name"] for k in kernels if not k["launches"]]
    check(not idle, f"kernels not launched on their paths: {idle}")
    print(f"seconds per case: {json.dumps(seconds)} [{card}]")
    print(f"window: {json.dumps(dict(forward_ms=window_ms, profile=window_profile))} [{card}]")
    print(f"training: {json.dumps(training)} [{card}]")
    print(f"cli: {json.dumps(cli)} [{card}]")
    print(f"strategy train step: {json.dumps(strategy)} [{card}]")
    print(f"train cli: {json.dumps(train_cli)} [{card}]")
    print(f"train cli res remat: {json.dumps(res)} [{card}]")
    print(f"segresnet: {json.dumps(dict(kernel_shapes=family_rows, **segresnet))} [{card}]")
    print(f"segresnet train cli: {json.dumps(dict(segresnet_cli, launches=segresnet_cli_launches))} "
          f"[{card}]")
    print(f"myronenko family: {json.dumps(family)} [{card}]")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

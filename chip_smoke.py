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
   every f32 one the tf32x3 form, ``winograd_tf32x3.cu``, or the smoke
   fails), each case timed against the direct hand kernel and cuDNN, the f32
   rows beside both bounds, and the f32 form at ragged channel counts and a
   misaligned x. Every bf16 time
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
   then the narrow form of the direct conv (``conv3d_narrow.cu``: bf16 calls
   with Cin no multiple of 4, Cout none of 8, or x not 16-byte aligned), its
   three variants at batch 2 of a ragged volume for Cin 1, 3, 6, 16, 32 x
   Cout 1, 3, 4, 12, 70, with x at an odd element offset, and in the D-halo
   modes (0, 1), (1, 0), (2, 1), (1, 2), each call's form checked, within
   the bf16 and statistics bounds above (its timed sites are phases 10, 11
   and 14's); the narrow form of ``s2_wgrad`` (``s2_wgrad.cu``: bf16 calls
   with Cin or Cout no multiple of 8 or an operand off 16-byte alignment) at
   batch 2 of a ragged volume for Cin 1, 3, 4, 12 x Cout 1, 4, 16, 17, with x
   one element off alignment and in the D-halo mode (pad_lo 0), each call's
   form checked, two calls equal to the bit, within 1e-4, and timed at x
   128^3 4 -> 16 and 4 -> 4 beside cuDNN's dw and its bytes bound;
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
   its gradients against the plain path within the phase-5 bounds (the f32
   gradients launch ``winograd`` and ``winograd_stats`` in the tf32x3 form
   alone, or the smoke fails), and its time beside the default routing's
   (default, winograd, winograd, default), in bf16 AMP and in f32;
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
   first-conv input gradient, 32 -> 4, and AutoImplantUNet's input conv,
   1 -> 32, in the narrow form; f32 at the three
   decoder sites, 32 -> 32 @128^3, 64 -> 64 @64^3 and 128 -> 128 @32^3, in
   the tf32x3 form) and ``s2_wgrad`` at its new widths, each against its
   plain version, its form checked, and timed as in phase 2; (a) one
   128^3 bf16 window forward, eval, kernels against the plain path (every
   FastConv through ``F.conv3d``) within relative L2 3e-2, the conv's
   launches 19 in the wgmma form (encoder) and 6 in the tf32x3 form (the
   decoder, which AMP runs in f32 after the trilinear upsample), times and
   a profile; (b) one bf16 AMP train step at batch 1 (DiceLoss plus the VAE
   term): ``conv`` 61 (31 forward, 30 input gradients: 37 wgmma and 24
   tf32x3), ``s2_wgrad`` 4, no narrow form, gradients against the plain path
   within the phase-5 bounds (the noise drawn alike), step ms, peak memory
   and a profile; then, under torch's default TF32 flags, the f32 step's
   gradients through the kernels and through the plain path, and one f32
   stride-2 conv (32 -> 64 @128^3, forward and both gradients), each
   against the same computation with TF32 off by the caller within
   relative L2 1e-5 (the port's f32 policy), and the kernels' f32
   gradients against the f64 plain path no more than 1e-5 farther than
   the plain f32 path's own, on a fresh model's seeded initial weights
   (the steps before add by atomics: their weights differ run to run);
   (c) the
   train CLI on phase 8's cases and folds (fold 1, 2 epochs) with that
   model: finite losses, the checkpoint reloads strictly and equal, the
   bratsvalidation prediction on the source grid in [0, 1], launches by
   form, seconds per epoch and step ms; (d) UNet3D at its reference
   defaults, AutoImplantUNet (``test=True`` through ``make_forward``) and
   LabeledVariationalAutoEncoder at 128^3: one bf16 window forward and one
   step's gradients (f32, bf16) against the plain path within the phase-5
   bounds, with their launches.
11. the BatchNorm segmentation nets (the BraTS config with its model
   section replaced; ``SEGRESNET_DS_MODEL``, ``BN_NETS``): the conv kernel
   and ``s2_wgrad`` at their new shapes against their plain versions, timed
   as in phase 2; (a) SegResNetDS at MONAI's widths: one 128^3 bf16 window
   through ``volumetric_predictions``, kernels against the plain path
   within relative L2 3e-2, the conv launched once per 3-cubed stride-1
   conv, all wgmma, forward times; one bf16 AMP train step (DiceLoss, Adam):
   its launches by form (conv: the forward's plus every input gradient but
   conv_init's; s2_wgrad: the three downsamples), the gradients and the
   running statistics one training forward leaves, kernels against the plain
   path from the same statistics (f32: gradients within 1e-3, statistics
   1e-4; bf16: statistics 1e-2, the kernels' gradients no further from the
   plain f32 ones than 1.25 times the plain bf16 path's), step ms, peak
   memory, a profile; (b) the train CLI on phase 8's cases and folds (fold
   1, 2 epochs) with SegResNetDS and deep supervision on 2 heads: finite
   losses, a ``model.npz`` whose ``batch_stats`` hold a running mean off 0
   for every BatchNorm and that reloads strictly and equal, the predict CLI
   on it within 3e-2 of the train CLI's prediction; (c) AttentionUnet, MONAI
   UNet (batch norm, 2 residual units) and VNet at 128^3: one bf16 window
   and one training forward and backward (f32, bf16) against the plain path
   as in (a), with their launches (VNet's 5-cubed and 2-cubed convs are
   cuDNN's on both paths: it launches no hand kernel).
12. the transformers (the BraTS config with its model section replaced;
   ``UNETR_MODEL``, ``SWIN_UNETR_MODEL``, ``VIT_MODELS``): the conv
   kernel's three variants at their UnetResBlock sites
   (``TRANSFORMER_CONV_SHAPES``: 16 and 48 output channels at 128^3, 768 at
   4^3) against their plain versions, timed as in phase 2; (a) UNETR and
   SwinUNETR at their published widths: one 128^3 bf16 window through
   ``volumetric_predictions``, kernels against the plain path (every DynUNet
   block through ``F.conv3d``: ``plain_blocks``) within relative L2 3e-2,
   ``conv_stats`` and ``block_stats`` once per block (8 and 10), all
   wgmma, forward times and a profile by group (attention matmuls, softmax,
   LayerNorm, conv_stats, block_stats, cuDNN / cuBLAS); one bf16 AMP train
   step at batch 1 (DiceLoss, Adam): launches (``conv`` 15 and 19: every
   input gradient but encoder1.conv1's), gradients against the plain path
   (f32 within 1e-3, bf16 2e-2 and no further from the plain f32 ones than
   1.25 times the plain bf16 path's), the f32 step under torch's default
   TF32 flags and with cuBLAS's TF32 on, each against TF32 off by the
   caller (the plain path within 1e-5; the kernels, whose f32 atomics move
   the step ~3e-5 run to run, within a fifth of what TF32 does with the
   port's policy taken out), step ms, peak memory and a profile; (b) the train
   CLI on phase 8's cases and folds (fold 1, 2 epochs) with SwinUNETR:
   finite losses, a ``model.npz`` of ``params`` alone that reloads strictly
   and equal, the predict CLI on it on the source grid in [0, 1], launches
   by form, seconds per epoch and step ms; (c) ViT (classification) and
   ViTAutoEnc at MONAI's defaults: one forward (f32, bf16) and one training
   backward (f32) on the card against f64 on the CPU (they launch no hand
   kernel).
   (Phases 13-15 time each window and step one round each way,
   ``LATE_ROUNDS``, and profile the steps of the nets that run a hand
   kernel.)
13. the MONAI conv stacks without BatchNorm (``CONV_STACKS``): the conv
   kernel at their UpCats' sites; BasicUNet, BasicUNetPlusPlus, QuickNAT
   and DiNTS at MONAI's widths, one 128^3 bf16 window and one bf16 step
   each against the plain path; QuickNAT's CSSE window, a DiNTS supernet
   step; the train and predict CLIs with BasicUNetPlusPlus.
14. the last MONAI conv nets (``LAST_CONV_NETS``, ``LAST_HEADS``): (a) the
   conv kernel at the registration nets' new sites (an extraction head 16
   -> 3 @128^3 and its input gradient 3 -> 16, both in the narrow form;
   LocalNet's 16 -> 16 @128^3) and ``s2_wgrad`` at RegUNet's pool_conv_0
   (16 -> 16) and the AutoEncoder's first stride-2 conv (4 -> 4, narrow),
   against their plain versions, timed as in phase 2; (b) LocalNet,
   RegUNet (stride-2 encoder, concatenated skips, levels 0 and 3),
   GlobalNet, AutoEncoder, VarAutoEncoder, HighResNet and AHNet at full
   width: one 128^3 bf16 window through ``make_forward`` against the plain
   path within relative L2 3e-2, launches by kernel and form as their 3^3
   FastConvs predict (one ``conv`` each, narrow where a channel count is no
   multiple of 8 / 4; HighResNet's and AHNet's convs are cuDNN's: none),
   times; GlobalNet's DDF at init exactly 0 and ``warp_image`` of the
   window by it; AHNet's second window in "trilinear" mode; (c) one bf16
   AMP train step each: launches by form as its calls predict (the input
   gradients in/out swapped, ``s2_wgrad`` once per stride-2 conv), the
   gradients and running statistics against the plain path (phase 11's
   rules; VarAutoEncoder's on the means over three noise draws),
   LocalNet's and HighResNet's (at 64^3) f32 step under torch's
   default TF32 flags against TF32 off, with cuDNN deterministic (the plain
   path within 1e-5; the kernels within a fifth of what TF32 does with the
   port's policy taken out), step ms, peak memory and LocalNet's profile; (d) Regressor,
   Classifier, Discriminator, Critic and Generator at their defaults: one
   forward (f32, bf16) and one f32 backward on the card against f64 on the
   CPU, with their launches; (e) the train CLI with LocalNet on phase 8's
   cases (fold 1, 2 epochs): a ``params`` + ``batch_stats`` checkpoint that
   reloads strictly, the predict CLI on it on the source grid within 3e-2
   of the train CLI's prediction.

15. the classifiers (``CLASSIFIERS``) at their published widths on the
   input of MONAI's 3-D classification tutorial (batch 2, one channel, 96^3,
   two classes): (a) the conv kernel at DenseNet121's conv2 sites (128 ->
   32 and its input gradient 32 -> 128 at 24^3 to 3^3) against its plain
   version, timed as in phase 2; (b) resnet_50, resnext_50_32x4d (grouped
   convs), DenseNet121, EfficientNetBN b0 (depthwise convs),
   RegularizedResNet, RegularizedBasicResNet, ResNetWithDecoder1D and the
   FCN: one bf16 and one f32 forward of every output, the hand kernels
   against the plain path within relative L2 3e-2, launches by form
   (DenseNet121 ``conv`` 58, RegularizedResNet ``conv``, the others none),
   the bf16 forward timed; (c) one bf16 AMP ``make_train_step`` each
   (CrossEntropyLoss on one-hot targets; ``sum(out * g)`` for the 1-D
   decoder): launches by form (DenseNet121 ``conv`` 116, RegularizedResNet
   ``conv`` and ``s2_wgrad``), the gradients of every output and the
   running statistics against the plain path with cuDNN deterministic
   (phase 11's rules; where BatchNorm's invariances carry the f32 paths'
   noise past 1e-3, as in DenseNet121 and RegularizedResNet at batch 2, the
   kernels held to the plain path's f64 gradients: no further from them
   than 1.25 times the plain path, in f32 and bf16), step ms, peak memory and
   the idle share; (d) resnet_152, resnext_101_32x8d, DenseNet264 and
   efficientnet-b7: one bf16 forward each, finite logits (DenseNet264
   ``conv`` 130).

16. the last models and whole-model remat: (a) VQVAE at the JAX defaults
   (4 channels in) on the 128^3 window: a bf16 and an f32 forward (finite
   reconstruction, positive ``diff``; cuDNN and plain matmuls only), the
   bf16 window timed; one ``make_train_step`` step in each dtype (MSELoss on
   the input plus ``diff``), the codebook it leaves against the EMA formula
   in f64 on the host from the forward's own codes and inputs (1e-5 in f32,
   1e-2 in bf16: the AMP step's counts and sums round to bf16), the loss
   falling over 4 bf16 steps on the batch, step ms, peak, profiles; (b)
   GraphCMR at the JAX defaults on an icosphere of 10242 vertices (a GIFTI
   file the config names), batch 2 of one channel at 128^3: a bf16 and an
   f32 forward, one bf16 step on ``sum(out * g)``, the running statistics
   finite and moved, ms, peak, profiles; (c) ``training.remat`` recomputing
   the whole SegResNetVAE, SegResNetDS and VQVAE: one step with and one
   without in f32 and bf16 on one batch and generator seed, the gradients
   within phase 5's bounds, the running statistics within 1e-4 / 1e-2, the
   codebook equal (also with VQVAE's root checkpointed as one block, the
   codebook update inside the checkpoint), the launches by form with and
   without (``conv`` exactly the step's without plus the remat blocks'
   forward launches, ``s2_wgrad`` as often), peak memory lower with remat,
   SegResNetVAE's remat gradients through the kernels against the plain
   path, step ms each way and a profile.

17. data-parallel training (``unet3d_tpu_torch/parallel/``) on the one
   card, the BraTS DynUNet at full width, batch 2 of 128^3, one SGD step
   (lr 1: the update is the gradient): (a) ``make_sharded_train_step`` at
   world size 1 over NCCL against ``make_train_step`` from the same weights
   in bf16 AMP: the updates within twice the plain step's own run-to-run
   spread (1e-5 at least), the four training kernels' launches equal, the
   step ms of each, the all-reduce's ms and bytes, a profile of the sharded
   step; (b) two ranks sharing the card over gloo, one item each (two
   processes on one card: not a scaling figure), against the
   single-process batch-2 step: the updates within 1e-4 (f32; twice that
   step's own run-to-run spread where it is larger) and 2e-2 (bf16, phase
   5's gradient bound) on each rank, each rank's launches the
   batch-2 step's, the ranks' bf16 step ms and all-reduce ms, every step
   from the seeded initial weights (each rank's weight digest checked
   against the reference's); (c)
   SegResNetDS at MONAI's widths on the same two ranks: the running
   statistics after one f32 step within 1e-4 of the single-process step;
   (d) the train CLI with ``--ngpus 2`` on phase 8's cases: clamped to the
   one card (world size 1), one epoch, the log written once, the kernels
   launched.
18. the space axis (each volume's D planes split over ranks): each
   kernel's D-halo mode (``conv``, ``conv_stats``, ``block_stats``: a slab
   with its neighbours' planes and pads; ``s2_wgrad`` with ``pad_lo`` 0) at
   the BraTS DynUNet's slab shapes against its plain version (phase 2's
   bounds, bf16 and f32), the bf16 calls timed beside the plain
   composition, cuDNN's conv on the padded input and the bound; then the
   BraTS DynUNet at full width on two ranks sharing the card over gloo,
   ``{"space": 2}``: (a) one 128^3 bf16 window, each rank its 64 planes,
   the gathered output within relative L2 3e-2 (phase 4's bound) of the
   single-device forward, launches by kernel and by halo mode and pads;
   (b) one bf16 train step at batch 1, the updates within 2e-2 (phase 5's
   bf16 gradient bound) of the single-device step's, every kernel launched
   in its halo mode; (c) the predict CLI with ``--ngpus 2``: JAX's default
   plan, the space axis, clamped to the one card; (d) the SPPIN config's
   bf16 step (192^3, batch 2) at world size 1: its peak allocated memory.

Exits non-zero if any phase fails or there is no CUDA device. The last lines
are the card, a JSON object of the kernels (the bf16 forms' rows, then the
f32 form's: ``conv_tf32x3``, ``conv_stats_tf32x3``, ``block_stats_tf32x3``,
with both bounds, then the D-halo modes': ``conv_halo``, ``conv_stats_halo``,
``block_stats_halo``, ``s2_wgrad_halo``), and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import logging
import os
import re
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
# the bf16 form of each kernel on the DynUNet's path (conv3d_narrow.cu, the
# "conv_narrow" entry, takes the bf16 calls with channel counts no DynUNet
# site has, and in f32, the "conv_tf32x3_narrow" entry, the f32 calls that
# conv3d_tf32x3.cu does not take; s2_wgrad_tf32x3.cu, the "s2_wgrad_tf32x3"
# entry, every f32 s2_wgrad call; s2_wgrad.cu, the "s2_wgrad_narrow" entry,
# the bf16 s2_wgrad calls of other channel counts; winograd_tf32x3.cu, the
# "winograd_tf32x3" and "winograd_stats_tf32x3" entries, every f32 Winograd
# call; winograd.cu keeps a bf16 WMMA form for other channel counts)
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
# the U-Nets' first-conv input gradient (4 outputs) and AutoImplantUNet's
# one-channel input conv (the narrow form, conv3d_narrow.cu); and f32 (the tf32x3 form, conv3d_tf32x3.cu) at SegResNetVAE's
# three decoder sites, which AMP runs in f32 after the trilinear upsample
FAMILY_CONV_SHAPES = [
    ("convInit 4->32 @128^3", 128, 4, 32, torch.bfloat16, "wgmma"),
    ("layer0 32->32 @128^3", 128, 32, 32, torch.bfloat16, "wgmma"),
    ("U-Net first conv dx 32->4 @128^3", 128, 32, 4, torch.bfloat16, "narrow"),
    ("AutoImplantUNet input conv 1->32 @128^3", 128, 1, 32, torch.bfloat16, "narrow"),
    ("up2 block 32->32 @128^3", 128, 32, 32, torch.float32, "tf32x3"),
    ("up1 block 64->64 @64^3", 64, 64, 64, torch.float32, "tf32x3"),
    ("up0 block 128->128 @32^3", 32, 128, 128, torch.float32, "tf32x3"),
]
# the f32 form's rows of the kernels line: its source, and the SegResNetVAE
# decoder site the conv variant's time is reported at
TF32X3_SOURCE = "unet3d_tpu_torch/ops/kernels/conv3d_tf32x3.cu"
TF32X3_CONV_AT = "up2 block 32->32 @128^3"
# the narrow form's rows of the kernels line: its source, and the site its
# time is reported at (the U-Nets' first-conv input gradient, the largest)
NARROW_SOURCE = "unet3d_tpu_torch/ops/kernels/conv3d_narrow.cu"
# the f32 form of s2_wgrad, every f32 call (phase 5's f32 step, phase 2's
# f32 rows)
S2_TF32X3_SOURCE = "unet3d_tpu_torch/ops/kernels/s2_wgrad_tf32x3.cu"
# the f32 form of Winograd-DH, every f32 call (phase 7's f32 gradients,
# phase 2's f32 rows); its ragged cases: (x shape, cin, cout, element offset)
WINO_TF32X3_SOURCE = "unet3d_tpu_torch/ops/kernels/winograd_tf32x3.cu"
WINO_TF32_RAGGED = [((1, 6, 10, 40), 5, 7, 0), ((2, 8, 18, 33), 12, 20, 1),
                    ((1, 4, 6, 70), 17, 50, 3)]
# the narrow form of s2_wgrad (s2_wgrad.cu): phase 2's cases, every Cin of
# S2_NARROW_CIN by every Cout of S2_NARROW_COUT at batch 2 of a ragged
# volume, then x one element off alignment and the D-halo mode's pad_lo 0
S2_NARROW_SOURCE = "unet3d_tpu_torch/ops/kernels/s2_wgrad.cu"
S2_NARROW_SHAPE = (2, 13, 21, 30)
S2_NARROW_CIN, S2_NARROW_COUT = (1, 3, 4, 12), (1, 4, 16, 17)
S2_NARROW_MISALIGNED = [(4, 16), (3, 4), (12, 17), (16, 16)]
S2_NARROW_HALO = [(4, 16), (1, 17), (12, 4)]
NARROW_CONV_AT = "U-Net first conv dx 32->4 @128^3"
# phase 2's narrow-form cases: every variant at batch 2 of a ragged volume
# (no side a multiple of the 4 x 8 x 16 brick), Cin x Cout over the form's
# kinds (taps folded into K below 16 input channels, one and two 16- or
# 32-channel chunks, 1 to 8 N tiles, two N blocks at 70 outputs); then x at
# an odd element offset (2-byte aligned), and the space axis's D-halo pads
NARROW_SHAPE = (2, 13, 21, 30)
NARROW_CHANNELS = [(cin, cout) for cin in (1, 3, 6, 16, 32) for cout in (1, 3, 4, 12, 70)]
NARROW_MISALIGNED = [(3, 3), (16, 4), (32, 4), (16, 16)]
NARROW_PADS = [((0, 1), 3, 3), ((1, 0), 16, 3), ((2, 1), 3, 16), ((1, 2), 32, 4)]
# the f32 form's (tf32x3_narrow) channel pairs: ragged Cin below 16 (folded
# taps) x ragged Cout, and one to three 16-channel chunks with Cout past a
# 32-wide N block; its misaligned cases are the narrow form's (x one element,
# 4 bytes, off 16-byte alignment), its D-halo cases have Cin no multiple of 4
# (the others take the tf32x3 form)
NARROW_TF32_CHANNELS = ([(cin, cout) for cin in (1, 3, 6) for cout in (1, 3, 4, 12)]
                        + [(15, 70), (17, 12), (33, 40)])
NARROW_TF32_PADS = [((0, 1), 3, 3), ((1, 0), 6, 3), ((2, 1), 3, 16), ((1, 2), 17, 4)]
# phase 2's ragged cases of s2_wgrad's f32 form: x (N, D, H, W), Cin, Cout,
# pad_lo, x's offset in elements
S2_TF32_RAGGED = [((1, 9, 13, 17), 64, 96, 1, 0), ((2, 7, 5, 3), 24, 40, 1, 0),
                  ((3, 11, 6, 9), 5, 7, 1, 0), ((1, 5, 4, 150), 72, 200, 1, 0),
                  ((2, 10, 13, 17), 24, 40, 0, 0), ((1, 9, 13, 17), 12, 20, 1, 1)]
# torch's default TF32 flags: each f32 path against itself with TF32 off
TF32_FLAGS_BOUND = 1e-5
# the kernels' f32 step gradients: their distance from the f64 plain path
# past the plain f32 path's own
F64_EXCESS_BOUND = 1e-5
# (label, spatial of x, cin, cout): s2_wgrad at SegResNetVAE's new widths
FAMILY_S2_SHAPES = [("down1 32->64 @128^3", 128, 32, 64),
                    ("vae_down_conv 256->16 @16^3", 16, 256, 16)]
FAMILY_KERNELS = ("conv", "s2_wgrad")
# phase 11: the BatchNorm segmentation nets, each in the BraTS config with its
# model section replaced. SegResNetDS at MONAI's defaults, which are the JAX
# package's (unet3d_tpu/models/segresnet_ds.py: 32 initial filters, blocks 1,
# 2, 2, 4, batch norm, relu, deconv); deep supervision on 2 heads in the CLI
SEGRESNET_DS_MODEL = {"name": "SegResNetDS", "init_filters": 32, "in_channels": 4,
                      "out_channels": 3, "blocks_down": [1, 2, 2, 4], "norm": "batch",
                      "act": "relu", "upsample_mode": "deconv"}
SEGRESNET_DS_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_segresnet_ds")
# AttentionUnet and MONAI UNet at their MONAI tutorial widths (UNet with 2
# residual units and batch norm), VNet at its defaults (ELU, dropout 0.5)
BN_NETS = (
    ("AttentionUnet", dict(in_channels=4, out_channels=3, channels=[16, 32, 64, 128],
                           strides=[2, 2, 2])),
    ("UNet", dict(in_channels=4, out_channels=3, channels=[16, 32, 64, 128, 256],
                  strides=[2, 2, 2, 2], num_res_units=2, norm="batch")),
    ("VNet", dict(in_channels=4, out_channels=3)),
)
# (label, spatial, cin, cout, dtype, form): the conv kernel at the new nets'
# shapes: SegResNetDS's deeper blocks, AttentionUnet's 16-channel level 0 and
# its merge conv, and UNet's last up unit (3 -> 3 channels: the narrow form;
# in f32, which UNet's f32 step runs, its f32 instantiation tf32x3_narrow)
BN_CONV_SHAPES = [
    ("SegResNetDS down1 block 64->64 @64^3", 64, 64, 64, torch.bfloat16, "wgmma"),
    ("SegResNetDS down3 block 256->256 @16^3", 16, 256, 256, torch.bfloat16, "wgmma"),
    ("AttentionUnet conv0.conv1 16->16 @128^3", 128, 16, 16, torch.bfloat16, "wgmma"),
    ("AttentionUnet merge0 32->16 @128^3", 128, 32, 16, torch.bfloat16, "wgmma"),
    ("UNet up_0_ru 3->3 @128^3", 128, 3, 3, torch.bfloat16, "narrow"),
    ("UNet up_0_ru 3->3 @128^3", 128, 3, 3, torch.float32, "tf32x3_narrow"),
]
# (label, spatial of x, cin, cout): s2_wgrad at the new nets' stride-2 convs
# (UNet's first, 4 -> 16 channels, takes the narrow form of s2_wgrad.cu)
BN_S2_SHAPES = [("SegResNetDS down1_downsample 64->128 @64^3", 64, 64, 128),
                ("SegResNetDS down2_downsample 128->256 @32^3", 32, 128, 256),
                ("AttentionUnet down1 16->32 @128^3", 128, 16, 32),
                ("UNet down_0 4->16 @128^3", 128, 4, 16)]
# the running statistics after one training forward, kernels against the
# plain path (relative L2 over every mean and var): they are means over the
# batch's voxels of conv outputs that agree within the kernels' own bounds
BN_STATS_BOUNDS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# bf16 gradients through the kernels no further from the plain f32 ones than
# this many times the plain bf16 path's (two samples of bf16 rounding noise)
BF16_EXCESS = 1.25
# where the f32 paths' gradients lie GRAD_BOUND_F32 or more apart, each is
# held to f64: the kernels' no further from it than this many times the
# plain path's (phase 15; the tests' rule against JAX's f64 evaluation)
F64_EXCESS = 1.25
# phase 12: the transformers, each in the BraTS config with its model section
# replaced. UNETR at the paper's and MONAI's widths (Hatamizadeh et al., WACV
# 2022, arXiv:2103.10504: hidden 768, mlp 3072, 12 heads, 12 layers, patch
# 16, feature 16, residual blocks) on the config's 128^3 patch and window;
# SwinUNETR at its BraTS 2021 widths (Hatamizadeh et al. 2022,
# arXiv:2201.01266: feature 48, depths 2, 2, 2, 2, heads 3, 6, 12, 24,
# window 7, patch 2) on a 128^3 ROI
UNETR_MODEL = {"name": "UNETR", "in_channels": 4, "out_channels": 3,
               "img_size": [128, 128, 128], "feature_size": 16, "hidden_size": 768,
               "mlp_dim": 3072, "num_heads": 12, "num_layers": 12, "res_block": True}
SWIN_UNETR_MODEL = {"name": "SwinUNETR", "img_size": [128, 128, 128], "in_channels": 4,
                    "out_channels": 3, "feature_size": 48, "depths": [2, 2, 2, 2],
                    "num_heads": [3, 6, 12, 24], "window_size": 7, "patch_size": 2}
TRANSFORMERS = (("UNETR", UNETR_MODEL), ("SwinUNETR", SWIN_UNETR_MODEL))
SWIN_UNETR_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_swin_unetr")
# the standalone ViT (classification) and ViTAutoEnc at MONAI's defaults
# (96^3, patch 16, hidden 768, mlp 3072, 12 heads, 12 layers), 4 channels in
VIT_MODELS = (
    ("ViT", dict(in_channels=4, img_size=[96, 96, 96], patch_size=[16, 16, 16],
                 classification=True, num_classes=3)),
    ("ViTAutoEnc", dict(in_channels=4, img_size=[96, 96, 96], patch_size=[16, 16, 16],
                        out_channels=4)),
)
# their f32 forward and gradients on the card against f64 on the CPU
VIT_F32_BOUND = 1e-4
# the f32 step through the kernels under TF32 flags against TF32 off: at
# most this share of what TF32 does with the policy taken out (the kernels'
# own run-to-run spread, f32 atomics through leaky-ReLU kinks, is ~3e-5)
TF32_SHARE = 0.2
# (label, spatial, cin, cout, dtype, form, variant): the direct conv's three
# variants at the transformers' UnetResBlock sites (conv1: conv_stats, conv2:
# block_stats, their input gradients: conv), Cout 16 and 48 a quarter and
# three quarters of a 64-wide tile, Cin 48 a part-filled chunk, 768 twelve
TRANSFORMER_CONV_SHAPES = [
    ("UNETR encoder1.conv1 4->16 @128^3", 128, 4, 16, torch.bfloat16, "wgmma", "conv_stats"),
    ("UNETR encoder1.conv2 16->16 @128^3", 128, 16, 16, torch.bfloat16, "wgmma",
     "block_stats"),
    ("UNETR decoder2 conv1 32->16 @128^3", 128, 32, 16, torch.bfloat16, "wgmma",
     "conv_stats"),
    ("UNETR dx of decoder2 conv1 16->32 @128^3", 128, 16, 32, torch.bfloat16, "wgmma",
     "conv"),
    ("UNETR decoder3 conv2 32->32 @64^3", 64, 32, 32, torch.bfloat16, "wgmma", "block_stats"),
    ("SwinUNETR encoder1.conv1 4->48 @128^3", 128, 4, 48, torch.bfloat16, "wgmma",
     "conv_stats"),
    ("SwinUNETR encoder1.conv2 48->48 @128^3", 128, 48, 48, torch.bfloat16, "wgmma",
     "block_stats"),
    ("SwinUNETR decoder1 conv1 96->48 @128^3", 128, 96, 48, torch.bfloat16, "wgmma",
     "conv_stats"),
    ("SwinUNETR dx of decoder1 conv1 48->96 @128^3", 128, 48, 96, torch.bfloat16, "wgmma",
     "conv"),
    ("SwinUNETR decoder2 conv1 96->48 @64^3", 64, 96, 48, torch.bfloat16, "wgmma",
     "conv_stats"),
    ("SwinUNETR decoder3 conv1 192->96 @32^3", 32, 192, 96, torch.bfloat16, "wgmma",
     "conv_stats"),
    ("SwinUNETR encoder10 conv2 768->768 @4^3", 4, 768, 768, torch.bfloat16, "wgmma",
     "block_stats"),
]

# phase 13: the MONAI conv stacks without BatchNorm, each in the BraTS config
# with its model section replaced, at MONAI's default widths (the JAX
# package's): BasicUNet and BasicUNetPlusPlus with features 32, 32, 64, 128,
# 256, 32; QuickNAT with 64 filters, kernel 5, kernel_c 1, pool 2 (a 128^3
# window is 128 slices of 128^2); DiNTS on TopologyInstance's defaults
# (channel_mul 1, 6 blocks, 3 depths, downsampling: filters 16, 32, 64, all
# 42 edges conv_3x3x3)
BASIC_UNET_MODEL = {"name": "BasicUNet", "in_channels": 4, "out_channels": 3,
                    "features": [32, 32, 64, 128, 256, 32], "dropout": 0.0}
QUICKNAT_MODEL = {"name": "Quicknat", "num_classes": 3, "num_channels": 4, "num_filters": 64,
                  "kernel_size": 5, "kernel_c": 1, "pool": 2, "stride_pool": 2,
                  "se_block": "None"}
DINTS_MODEL = {"name": "DiNTS", "in_channels": 4, "num_classes": 3}
CONV_STACKS = (("BasicUNet", BASIC_UNET_MODEL),
               ("BasicUNetPlusPlus", dict(BASIC_UNET_MODEL, name="BasicUNetPlusPlus")),
               ("QuickNAT", QUICKNAT_MODEL), ("DiNTS", DINTS_MODEL))
# the nets whose 3^3 convs are FastConvs (the hand conv kernel), and those
# whose f32 step is held under torch's default TF32 flags
KERNEL_STACKS = ("BasicUNet", "BasicUNetPlusPlus")
F32_POLICY_STACKS = ("BasicUNet", "DiNTS")
# QuickNAT's second window (both squeeze-and-excitation gates) and the DiNTS
# supernet on the same space (all five ops on every edge)
QUICKNAT_CSSE_MODEL = dict(QUICKNAT_MODEL, se_block="CSSE")
DINTS_SEARCH_MODEL = dict(DINTS_MODEL, dints_space={"search": True})
BASIC_UNET_PP_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_basicunetpp")
# (label, spatial, cin, cout, dtype, form): the conv kernel at the UpCats'
# new sites: 32 output channels (half a 64-wide tile) at 128^3 from the
# concatenated 64, 96, 128 and 160 channels (96 and 160 part-filled
# chunks), an input gradient 32 -> 64 at 128^3 and 256 -> 128 at 16^3
CONV_STACK_SHAPES = [
    ("BasicUNet upcat_1 conv_0 64->32 @128^3", 128, 64, 32, torch.bfloat16, "wgmma"),
    ("BasicUNet++ upcat_0_2 conv_0 96->32 @128^3", 128, 96, 32, torch.bfloat16, "wgmma"),
    ("BasicUNet++ upcat_0_3 conv_0 128->32 @128^3", 128, 128, 32, torch.bfloat16, "wgmma"),
    ("BasicUNet++ upcat_0_4 conv_0 160->32 @128^3", 128, 160, 32, torch.bfloat16, "wgmma"),
    ("BasicUNet dx of upcat_1 conv_0 32->64 @128^3", 128, 32, 64, torch.bfloat16, "wgmma"),
    ("BasicUNet upcat_4 conv_0 256->128 @16^3", 16, 256, 128, torch.bfloat16, "wgmma"),
]

# phase 14: the last MONAI conv nets in the BraTS config (4 -> 3 channels,
# 128^3), batch 1, at the JAX package's defaults (MONAI's where it has them):
# the registration nets at 16 initial channels, depth 3 (RegUNet with the
# stride-2 encoder, the concatenated skips and levels 0 and 3; LocalNet with
# every level, kernel 7 at level 0; GlobalNet, whose DDF then warps the
# window), HighResNet's fixed plan, AHNet at MONAI's defaults (a second
# window in "trilinear" mode), the autoencoders at channels (4, 8, 16)
LOCALNET_MODEL = {"name": "LocalNet", "in_channels": 4, "out_channels": 3,
                  "num_channel_initial": 16, "depth": 3}
REGUNET_MODEL = dict(LOCALNET_MODEL, name="RegUNet", extract_levels=[0, 3], pooling=False,
                     concat_skip=True)
GLOBALNET_MODEL = {"name": "GlobalNet", "in_channels": 4, "num_channel_initial": 16,
                   "depth": 3}
AUTOENCODER_MODEL = {"name": "AutoEncoder", "in_channels": 4, "out_channels": 3,
                     "channels": [4, 8, 16], "strides": [2, 2, 2], "num_res_units": 2,
                     "inter_channels": [16, 16], "inter_dilations": [1, 2]}
VAR_AUTOENCODER_MODEL = dict(
    {k: v for k, v in AUTOENCODER_MODEL.items() if k != "in_channels"},
    name="VarAutoEncoder", in_shape=[4, 128, 128, 128], latent_size=16)
AHNET_MODEL = {"name": "AHNet", "in_channels": 4, "out_channels": 3}
LAST_CONV_NETS = (("LocalNet", LOCALNET_MODEL), ("RegUNet", REGUNET_MODEL),
                  ("GlobalNet", GLOBALNET_MODEL), ("AutoEncoder", AUTOENCODER_MODEL),
                  ("VarAutoEncoder", VAR_AUTOENCODER_MODEL),
                  ("HighResNet", {"name": "HighResNet", "in_channels": 4, "out_channels": 3}),
                  ("AHNet", AHNET_MODEL))
AHNET_TRILINEAR_MODEL = dict(AHNET_MODEL, upsample_mode="trilinear")
# the nets whose f32 step is held under torch's default TF32 flags, and the
# window each is held at (HighResNet's seven f32 steps at 64^3)
F32_POLICY_LAST = {"LocalNet": 128, "HighResNet": 64}
# the heads at their defaults on a (4, 128^3) input, the Generator from its
# 64-element latent
LAST_HEADS = (("Regressor", {"in_shape": [4, 128, 128, 128]}),
              ("Classifier", {"in_shape": [4, 128, 128, 128]}),
              ("Discriminator", {"in_shape": [4, 128, 128, 128]}),
              ("Critic", {"in_shape": [4, 128, 128, 128]}),
              ("Generator", {}))
HEAD_F32_BOUND = 1e-4
# noise draws over which a sampling net's bf16 gradients are held
NOISE_DRAWS = 3
LOCALNET_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_localnet")
# (label, spatial, cin, cout, dtype, form): the conv kernel at the
# registration nets' new sites: an extraction head to 3 channels at 128^3
# and its input gradient (the narrow form; the gradient also in f32, the
# tf32x3_narrow form), LocalNet's level-0 decoder conv;
# s2_wgrad at RegUNet's pool_conv_0 and the AutoEncoder's first stride-2
# conv (4 channels: the narrow form)
LAST_CONV_SHAPES = [
    ("RegUNet extract_0 16->3 @128^3", 128, 16, 3, torch.bfloat16, "narrow"),
    ("RegUNet dx of extract_0 3->16 @128^3", 128, 3, 16, torch.bfloat16, "narrow"),
    ("RegUNet dx of extract_0 3->16 @128^3", 128, 3, 16, torch.float32, "tf32x3_narrow"),
    ("LocalNet decode_0 16->16 @128^3", 128, 16, 16, torch.bfloat16, "wgmma"),
]
LAST_S2_SHAPES = [("RegUNet pool_conv_0 x 128^3 16->16", 128, 16, 16),
                  ("AutoEncoder encode_0 x 128^3 4->4", 128, 4, 4)]
# (label, spatial of x, cin, cout): the bf16 stride-2 weight gradients that
# take s2_wgrad.cu's narrow form on the nets' paths (4 input channels)
NARROW_S2_SHAPES = [("UNet down_0 4->16 @128^3", 128, 4, 16),
                    ("AutoEncoder encode_0 4->4 @128^3", 128, 4, 4)]

# phase 15: the classifiers at the JAX package's (MONAI's and torchvision's)
# published widths, on the input of MONAI's 3-D classification tutorial
# (3d_classification/: DenseNet121 on IXI): batch 2, one channel, 96^3, two
# classes. RegularizedResNet sizes its variational layer from the input;
# ResNetWithDecoder1D decodes 512 logits into one value per vertex of an
# fs_LR 32k hemisphere (32492); the FCN reads the flattened volume.
CLASSIFIER_SHAPE = (96, 96, 96)
CLASSIFIER_BATCH = 2
CLASSIFIERS = (
    ("resnet_50", {"name": "resnet_50", "n_features": 1, "n_outputs": 2}),
    ("resnext_50_32x4d", {"name": "resnext_50_32x4d", "n_features": 1, "n_outputs": 2}),
    ("DenseNet121", {"name": "DenseNet121", "in_channels": 1, "out_channels": 2}),
    ("EfficientNetBN", {"name": "EfficientNetBN", "model_name": "efficientnet-b0",
                        "in_channels": 1, "num_classes": 2}),
    ("RegularizedResNet", {"name": "RegularizedResNet", "n_outputs": 2,
                           "input_shape": list(CLASSIFIER_SHAPE), "n_features": 1}),
    ("RegularizedBasicResNet", {"name": "RegularizedBasicResNet", "n_features": 1,
                                "n_outputs": 2}),
    ("ResNetWithDecoder1D", {"name": "ResNetWithDecoder1D", "n_fc_outputs": 512,
                             "n_outputs": 32492}),
    ("FCN", {"name": "FCN", "hidden_layers_list": [128, 64],
             "n_inputs": int(np.prod(CLASSIFIER_SHAPE)), "n_outputs": 2}),
)
# the deepest and widest factories: one bf16 forward each
CLASSIFIERS_LARGE = (
    ("resnet_152", {"name": "resnet_152", "n_features": 1, "n_outputs": 2}),
    ("resnext_101_32x8d", {"name": "resnext_101_32x8d", "n_features": 1, "n_outputs": 2}),
    ("DenseNet264", {"name": "DenseNet264", "in_channels": 1, "out_channels": 2}),
    ("efficientnet-b7", {"name": "EfficientNetBN", "model_name": "efficientnet-b7",
                         "in_channels": 1, "num_classes": 2}),
)
# the nets whose 3^3 stride-1 convs are FastConvs (the hand conv kernel):
# DenseNet121's 58 dense layers' conv2, RegularizedResNet's Myronenko blocks
CLASSIFIER_KERNEL_NETS = ("DenseNet121", "RegularizedResNet")
# (label, spatial, cin, cout, dtype, form): DenseNet121's conv2 (bn_size 4 x
# growth 32 = 128 -> 32) and its input gradient (32 -> 128) at each dense
# block's size on the 96^3 input, one item
DENSENET_CONV_SHAPES = [
    (f"DenseNet121 {label} @{s}^3", s, cin, cout, torch.bfloat16, "wgmma")
    for s in (24, 12, 6, 3)
    for label, cin, cout in (("conv2 128->32", 128, 32), ("dx of conv2 32->128", 32, 128))]


# phase 16: VQVAE and GraphCMR at the JAX package's defaults (VQVAE on the
# BraTS window's 4 channels; GraphCMR on an icosphere of fsaverage5's vertex
# count and topology, 10242 vertices and 20480 faces, batch 2, one channel),
# and whole-model remat of three nets of earlier phases
VQVAE_MODEL = {"name": "VQVAE", "in_channel": 4}
VQVAE_SHAPE = (128, 128, 128)
VQ_LOSS_STEPS = 4
GRAPH_CMR_SUBDIVISIONS = 5
GRAPH_CMR_SHAPE = (128, 128, 128)
GRAPH_CMR_BATCH = 2
GRAPH_CMR_DIR = os.path.join(ROOT, "build", "chip_smoke_graph")
REMAT_NETS = (("SegResNetVAE", SEGRESNET_MODEL), ("SegResNetDS", SEGRESNET_DS_MODEL),
              ("VQVAE", VQVAE_MODEL))
REMAT_SHAPE = (128, 128, 128)
# the EMA codebook against its f64 evaluation on the host: f32, and bf16
# (the AMP step's one-hot counts and sums round to bf16, as in JAX)
EMA_BOUNDS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# phase 17: data-parallel training on the one card (two ranks share it over
# gloo); the updates of two ranks against the single-process step
DP_BATCH = 2
DP_DIR = os.path.join(ROOT, "build", "chip_smoke_dp")
DP_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_dp_cli")
DP_TIMED_STEPS = 3
DP_BOUNDS = {"f32": 1e-4, "bf16": GRAD_BOUND_BF16}
DP_WORLD1_FLOOR = 1e-5
# phases 13-15 time each net's window and step one round each way (their
# four-round A/B and the cuDNN-only nets' step profiles are on record in
# PERF.md section 5), which keeps the smoke's time with phase 18
LATE_ROUNDS = ("kernels", "plain")
# phase 18: the space axis, two ranks sharing the card; the halo modes at
# the BraTS DynUNet's sites on a slab of a 128^3 window cut in two (label,
# local D, H = W, Cin, Cout, variant, pads: rank 0's (1, 0), rank 1's (0,
# 1), a middle rank's (0, 0); the input gradient's (1, 2) and (2, 1))
SPACE_RANKS = 2
SPACE_DIR = os.path.join(ROOT, "build", "chip_smoke_space")
SPACE_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_space_cli")
SPPIN_CONFIG = os.path.join(ROOT, "examples", "sppin", "sppin_config.json")
SPACE_BF16_BOUND = GRAD_BOUND_BF16
SPACE_SHAPE = (128, 128, 128)
HALO_SHAPES = [
    ("input conv 4->64 rank 0", 64, 128, 4, 64, "conv_stats", (1, 0)),
    ("level-0 conv2 64->64 rank 1", 64, 128, 64, 64, "block_stats", (0, 1)),
    ("level-0 up conv1 128->64 rank 0", 64, 128, 128, 64, "conv_stats", (1, 0)),
    ("level-1 conv2 96->96 middle", 32, 64, 96, 96, "block_stats", (0, 0)),
    ("dx of level-0 conv2 64->64 rank 0", 64, 128, 64, 64, "conv", (1, 2)),
    ("dx of level-4 conv2 256->256 rank 1", 4, 8, 256, 256, "conv", (2, 1)),
]
HALO_TIMED_AT = {"conv_stats": "level-0 up conv1 128->64 rank 0",
                 "block_stats": "level-0 conv2 64->64 rank 1",
                 "conv": "dx of level-0 conv2 64->64 rank 0"}
# s2_wgrad's halo mode: x a slab of local D planes (plus the one below),
# H = W, Cin, Cout, pad_lo
S2_HALO_SHAPES = [("level-0 -> 1 64->96 rank 1", 64, 128, 64, 96, 0),
                  ("level-4 -> 5 256->384 rank 1", 4, 8, 256, 384, 0)]
DP_STATS_BOUND = 1e-4


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


def tf32x3_bound(variant, s, cin, cout, products=1.0):
    """bound_ms of one f32 3x3x3 conv variant done f32-accurate on the tensor
    cores, as the tf32x3 forms do it: three TF32 products per product at the
    TF32 peak, or the f32 bytes at the memory rate (``products``: Winograd-DH's
    share of the direct conv's)."""
    return bound_ms(3 * 2.0 * s ** 3 * 27 * cin * cout * products,
                    conv_bytes(variant, s, cin, cout, 4), "tf32")


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


_WGMMA_VARIANT = re.compile(r"conv3x3x3_wgmma<.*(true|false), (true|false)>")
_KERNEL_GROUPS = (("conv tf32x3", "conv3x3x3_tf32x3"),
                  ("conv tf32x3 narrow", "conv3x3x3_narrow<float"),
                  ("conv narrow", "conv3x3x3_narrow"),
                  ("s2_wgrad", "s2_wgrad"), ("s2_wgrad", "sum_splits"),
                  ("winograd", "winograd3x3x3"), ("winograd", "winograd_wgmma"),
                  ("memcpy/memset", "mem"), ("copies and casts", "copy"),
                  ("reductions", "reduce"), ("elementwise", "elementwise"))


def _kernel_group(name: str) -> str:
    """A device kernel's group by its name: the wgmma direct conv by variant
    (its template's PROLOGUE, STATS flags), the other hand kernels, then
    torch's kernels by kind; cuDNN's and cuBLAS's fall to the last."""
    match = _WGMMA_VARIANT.search(name)
    if match:
        return {("true", "true"): "block_stats", ("false", "true"): "conv_stats",
                ("false", "false"): "conv"}[match.groups()]
    return next((g for g, key in _KERNEL_GROUPS if key.lower() in name.lower()),
                "cuDNN / cuBLAS (other matmuls and convs)")


def profile_device(fn, label: str, card: str) -> dict:
    """Device time of one call of ``fn`` by group (torch.profiler): by kernel
    name (``_kernel_group``), except that the kernels launched under
    ``aten::bmm`` (the attention products, forward and backward), the
    softmax's and those inside a ``layers.LayerNorm`` forward (its backward
    falls among the elementwise and reduction kernels) form groups of their
    own; its device span and idle share, and the kernels that take longest;
    printed, and returned."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    from unet3d_tpu_torch.models.layers import LayerNorm

    real = LayerNorm.forward

    def scoped(self, x):
        with record_function("LayerNorm"):
            return real(self, x)

    fn()
    torch.cuda.synchronize()
    # on the class: make_forward runs a bf16 copy of the model
    LayerNorm.forward = scoped
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        LayerNorm.forward = real
    events = prof.events()
    # the LayerNorm ranges appear on the device's timeline too: not kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name != "LayerNorm"
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"profile {label}: no device events traced (not measured)", flush=True)
        return {}
    by_group, by_name = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        group = _kernel_group(e.name)
        by_group[group] = by_group.get(group, 0.0) + ms
        by_name[e.name[:70]] = by_name.get(e.name[:70], 0.0) + ms
    # each kernel is listed once, under the op that launched it
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        node, group = e, None
        while node is not None and group is None:
            if node.name == "LayerNorm":
                group = "LayerNorm (forward)"
            elif node.name in ("aten::bmm", "aten::baddbmm"):
                group = "attention matmuls (bmm)"
            elif node.name.startswith("aten::_softmax"):
                group = "softmax"
            node = node.cpu_parent
        for k in (k for k in e.kernels if k.name != "LayerNorm") if group else ():
            by_group[_kernel_group(k.name)] -= k.duration / 1e3
            by_group[group] = by_group.get(group, 0.0) + k.duration / 1e3
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
        if abs(ms) > 5e-4:
            print(f"  {g:42s} {ms:9.3f} ms {ms / total:6.1%}", flush=True)
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
    dtype (cuDNN, TF32 off in f32), the first bf16 shape's time reported.
    Returns s2_wgrad's f32 rows (``s2_tf32x3_row``)."""
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
    rows = []
    for si, (label, s, cin, cout) in enumerate(S2_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(dtype)
            g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device,
                            generator=gen).to(dtype)
            got, want = W.s2_wgrad(x, g), W.s2_wgrad_reference(x, g)
            torch.cuda.synchronize()
            rel = rel_max(got, want)
            form = W.kernel_form(x, g)
            msg = f"s2_wgrad    {label:36s} {str(dtype)[6:]:8s} {form:6s} rel {rel:.3e}"
            check(form == ("wgmma" if dtype == torch.bfloat16 else "tf32x3"), f"{msg}: form")
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
            if dtype == torch.float32:
                row = s2_tf32x3_row(label, s, cin, cout, ms, plain_ms, got, want)
                rows.append(row)
                msg += (f" | kernel {ms:.3f} ms, cuDNN (TF32 off) {plain_ms:.3f} ms, f32 "
                        f"bound {row['f32_bound_ms']:.3f} ms, 3xTF32 bound "
                        f"{row['bound_ms']:.3f} ms ({row['bound_by']}, "
                        f"{row['bound_ms'] / ms:.1%})")
                if si == 0:
                    report["s2_wgrad_tf32x3"] = row
            else:
                msg += (f" | kernel {ms:.3f} ms, cuDNN {plain_ms:.3f} ms, bound {bms:.3f} ms "
                        f"({bound_by}, {bms / ms:.1%})")
            if dtype == torch.bfloat16 and si == 0:
                # the plain composition is one PyTorch call (cuDNN's dw)
                report["s2_wgrad"] = dict(ms=ms, plain_ms=plain_ms, shape=label,
                                          bound_ms=bms, bound_by=bound_by,
                                          library_ms=plain_ms,
                                          max_abs_err=(got - want).abs().max().item())
            print(msg, flush=True)
            del x, g, got, want
    torch.cuda.empty_cache()
    return rows


def s2_tf32x3_row(label, s, cin, cout, ms, cudnn_ms, got, want) -> dict:
    """A kernels-line row of s2_wgrad's f32 form on x (1, s, s, s, cin):
    bound_ms the 3xTF32 bound (three TF32 products per product at the TF32
    peak, or the f32 bytes: x and g read, dw written), f32_bound_ms the f32
    CUDA-core one; the plain version and the library call are both cuDNN's
    f32 dw with TF32 off."""
    half = (s // 2) ** 3
    nbytes = 4 * (s ** 3 * cin + half * cout + 27 * cin * cout)
    bms, bound_by = bound_ms(3 * 2.0 * half * 27 * cin * cout, nbytes, "tf32")
    f32_ms, _ = bound_ms(2.0 * half * 27 * cin * cout, nbytes, torch.float32)
    return dict(name="s2_wgrad_tf32x3", shape=label, dtype="float32", form="tf32x3", ms=ms,
                plain_ms=cudnn_ms, library_ms=cudnn_ms, bound_ms=bms, bound_by=bound_by,
                f32_bound_ms=f32_ms, max_abs_err=(got - want).abs().max().item())


def phase2_s2_tf32x3(device, gen) -> list:
    """s2_wgrad's f32 form at the other nets' stride-2 channel counts
    (BN_S2_SHAPES, LAST_S2_SHAPES, FAMILY_S2_SHAPES in f32), timed against
    cuDNN's f32 dw with TF32 off; then ragged volumes, x at an odd element
    offset (4-byte aligned) and the D-halo mode's pad_lo 0, within
    S2_BOUND of the plain version, every call in the tf32x3 form. Returns
    the timed rows."""
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
    from unet3d_tpu_torch.utils.device import full_f32
    rows = []
    for label, s, cin, cout in BN_S2_SHAPES + LAST_S2_SHAPES + FAMILY_S2_SHAPES:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen)
        g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device, generator=gen)
        got, want = W.s2_wgrad(x, g), W.s2_wgrad_reference(x, g)
        torch.cuda.synchronize()
        rel, form = rel_max(got, want), W.kernel_form(x, g)
        xn, gn = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)

        def cudnn_dw():
            with full_f32(gn):
                return torch.nn.grad.conv3d_weight(xn, (cout, cin, 3, 3, 3), gn, stride=2,
                                                   padding=1)
        ms, cudnn_ms = device_ms(lambda: W.s2_wgrad(x, g)), device_ms(cudnn_dw)
        row = s2_tf32x3_row(label, s, cin, cout, ms, cudnn_ms, got, want)
        msg = (f"s2_wgrad    {label:36s} float32  {form:6s} rel {rel:.3e} | kernel {ms:.3f} ms, "
               f"cuDNN (TF32 off) {cudnn_ms:.3f} ms, f32 bound {row['f32_bound_ms']:.3f} ms, "
               f"3xTF32 bound {row['bound_ms']:.3f} ms ({row['bound_by']}, "
               f"{row['bound_ms'] / ms:.1%})")
        print(msg, flush=True)
        check(form == "tf32x3", f"{msg}: form")
        check(rel < S2_BOUND, f"{msg} > {S2_BOUND}")
        rows.append(row)
        del x, g, got, want
    for x_shape, cin, cout, pad_lo, offset in S2_TF32_RAGGED:
        n, d, h, w = x_shape
        x = torch.randn(*x_shape, cin, device=device, generator=gen)
        if offset:
            store = torch.empty(offset + x.numel(), device=device)
            x = store[offset:].view(x.shape).copy_(x)
        g = torch.randn(n, (d + pad_lo) // 2, (h + 1) // 2, (w + 1) // 2, cout, device=device,
                        generator=gen)
        # the plain version on an aligned copy (cuDNN faults on a misaligned f32 x)
        got, want = W.s2_wgrad(x, g, pad_lo), W.s2_wgrad_reference(x.clone(), g, pad_lo)
        torch.cuda.synchronize()
        rel, form = rel_max(got, want), W.kernel_form(x, g)
        msg = (f"s2_wgrad f32 {x_shape} {cin}->{cout} pad_lo {pad_lo} offset {offset}: form "
               f"{form}, rel {rel:.3e}")
        print(msg, flush=True)
        check(form == "tf32x3", f"{msg}: form")
        check(rel < S2_BOUND, f"{msg} > {S2_BOUND}")
    torch.cuda.empty_cache()
    return rows


def phase2_narrow(device, gen, dtype=torch.bfloat16) -> dict:
    """The narrow form (``conv3d_narrow.cu``; in f32 its tf32x3_narrow
    instantiation) against its plain versions: each variant at NARROW_SHAPE
    for every NARROW_CHANNELS (f32: NARROW_TF32_CHANNELS) pair, x at an odd
    element offset for NARROW_MISALIGNED, and each NARROW_PADS D-halo mode;
    every call's form checked, y within the dtype's bound and the statistics
    within STATS_BOUND. Returns the largest errors."""
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    f32 = dtype == torch.float32
    cases = [(cin, cout, K.SAME, 0) for cin, cout in
             (NARROW_TF32_CHANNELS if f32 else NARROW_CHANNELS)]
    cases += [(cin, cout, K.SAME, 1 if f32 else 3) for cin, cout in NARROW_MISALIGNED]
    cases += [(cin, cout, pads, 0) for pads, cin, cout in
              (NARROW_TF32_PADS if f32 else NARROW_PADS)]
    worst = dict(y_rel=0.0, stats_rel=0.0, max_abs_err=0.0, cases=len(cases))
    n = NARROW_SHAPE[0]
    for cin, cout, pads, offset in cases:
        x = torch.randn(*NARROW_SHAPE, cin, device=device, generator=gen).to(dtype)
        if offset:
            store = torch.empty(offset + x.numel(), dtype=x.dtype, device=device)
            x = store[offset:].view(x.shape).copy_(x)
        w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
             / (27 * cin) ** 0.5).to(dtype)
        inv = torch.rand(n, cin, device=device, generator=gen) + 0.5
        shift = torch.randn(n, cin, device=device, generator=gen) * 0.3
        # the plain versions on an aligned copy: cuDNN faults on an f32 x 4
        # bytes off 16-byte alignment (bf16 x is copied by .float() anyway)
        xr = x.clone()
        runs = ((K.conv3x3x3(x, w, pads), K.conv3d_reference(xr, w, pads)),
                (K.conv3x3x3_with_stats(x, w, pads), K.conv3d_with_stats_reference(xr, w, pads)),
                (K.conv3x3x3_block_with_stats(x, w, inv, shift, pads=pads),
                 K.conv3d_block_with_stats_reference(xr, w, inv, shift, pads=pads)))
        torch.cuda.synchronize()
        form = K.kernel_form(x, w)
        y_rel = s_rel = abs_err = 0.0
        for got, want in runs:
            got_y, want_y = (got, want) if isinstance(got, torch.Tensor) else (got[0], want[0])
            check(got_y.shape == want_y.shape, f"narrow {cin}->{cout}: y {tuple(got_y.shape)}")
            y_rel = max(y_rel, rel_max(got_y, want_y))
            abs_err = max(abs_err, (got_y.float() - want_y.float()).abs().max().item())
            if not isinstance(got, torch.Tensor):
                s_rel = max(s_rel, stats_err(*got))
        msg = (f"narrow {str(dtype)[6:]} {cin:2d}->{cout:2d} {str(NARROW_SHAPE):16s} pads "
               f"{pads} offset {offset}: form {form}, y rel {y_rel:.3e}, stats rel "
               f"{s_rel:.3e}")
        print(msg, flush=True)
        check(form == ("tf32x3_narrow" if f32 else "narrow"), f"{msg}: form")
        check(y_rel < BOUNDS[dtype], f"{msg} > {BOUNDS[dtype]}")
        check(s_rel < STATS_BOUND, f"{msg} > {STATS_BOUND}")
        worst.update(y_rel=max(worst["y_rel"], y_rel), stats_rel=max(worst["stats_rel"], s_rel),
                     max_abs_err=max(worst["max_abs_err"], abs_err))
        del x, w, runs
    return worst


def phase2_winograd(device, gen, report):
    """Both Winograd variants against their plain Winograd version and the
    direct conv's plain version; each case timed against the direct hand
    kernel and the plain composition in its dtype (cuDNN, TF32 off in f32).
    Every bf16 call takes the wgmma form, every f32 call the tf32x3 form,
    whose rows carry the 3xTF32 bound and the f32 CUDA-core one; then the
    f32 form at ragged channel counts and misaligned x (WINO_TF32_RAGGED)."""
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
                check(form == ("wgmma" if dtype == torch.bfloat16 else "tf32x3"),
                      f"{msg}: a call off its dtype's form")
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
                # Winograd-DH issues 48 of the direct conv's 108 products; in
                # f32 the 3xTF32 bound, and the f32 CUDA-core one beside it
                if dtype == torch.bfloat16:
                    bms, bound_by = conv_bound(variant, s, cin, cout, WINOGRAD_PRODUCTS, dtype)
                    f32_bms = None
                else:
                    bms, bound_by = tf32x3_bound(variant, s, cin, cout, WINOGRAD_PRODUCTS)
                    f32_bms, _ = conv_bound(variant, s, cin, cout, WINOGRAD_PRODUCTS, dtype)
                msg += (f" | kernel {ms:.3f} ms, direct kernel {direct_ms:.3f} ms, "
                        f"cuDNN{' (TF32 off)' * (dtype == torch.float32)} {plain_ms:.3f} ms, "
                        + (f"f32 bound {f32_bms:.3f} ms, 3xTF32 " if f32_bms else "")
                        + f"bound {bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
                if si == TIMED_AT[variant]:
                    name = variant if dtype == torch.bfloat16 else f"{variant}_tf32x3"
                    report[name] = dict(
                        ms=ms, plain_ms=plain_ms, direct_ms=direct_ms, shape=label,
                        bound_ms=bms, bound_by=bound_by,
                        library_ms=plain_ms if variant == "winograd" else None,
                        max_abs_err=(got_y.float() - want.float()).abs().max().item())
                    if f32_bms is not None:
                        report[name]["f32_bound_ms"] = f32_bms
                print(msg, flush=True)
            del x, w, want, want_direct
    for x_shape, cin, cout, offset in WINO_TF32_RAGGED:
        x = torch.randn(*x_shape, cin, device=device, generator=gen)
        if offset:
            store = torch.empty(offset + x.numel(), device=device)
            x = store[offset:].view(x.shape).copy_(x)
        w = torch.randn(3, 3, 3, cin, cout, device=device, generator=gen) / (27 * cin) ** 0.5
        # the plain version on an aligned copy (cuDNN faults on a misaligned f32 x)
        want = W.winograd_reference(x.clone(), w)
        y = W.winograd3x3x3(x, w)
        ys, s1, s2 = W.winograd3x3x3_with_stats(x, w)
        torch.cuda.synchronize()
        rel, form = max(rel_max(y, want), rel_max(ys, want)), W.kernel_form(x, w)
        s_err = stats_err(ys, s1, s2)
        msg = (f"winograd f32 {x_shape} {cin}->{cout} offset {offset}: form {form}, y rel "
               f"{rel:.3e}, stats rel {s_err:.3e}")
        print(msg, flush=True)
        check(form == "tf32x3", f"{msg}: form")
        check(rel < BOUNDS[torch.float32], f"{msg} > {BOUNDS[torch.float32]}")
        check(s_err < STATS_BOUND, f"{msg} > {STATS_BOUND}")
        del x, w, want, y, ys
    torch.cuda.empty_cache()


def phase2_s2_narrow(device, gen) -> dict:
    """s2_wgrad's narrow form (s2_wgrad.cu) against its plain version, every
    call's form checked: S2_NARROW_CIN x S2_NARROW_COUT at batch 2 of
    S2_NARROW_SHAPE, x one element off alignment (S2_NARROW_MISALIGNED), the
    D-halo mode's pad_lo 0 (S2_NARROW_HALO), each within S2_BOUND; two calls
    agree to the bit (the fixed-order split-K sum). Then the
    NARROW_S2_SHAPES sites timed against cuDNN's dw and the bound. Returns
    the largest error, the case count and the timed rows."""
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
    cases = [(cin, cout, 0, 1) for cin in S2_NARROW_CIN for cout in S2_NARROW_COUT]
    cases += [(cin, cout, 1, 1) for cin, cout in S2_NARROW_MISALIGNED]
    cases += [(cin, cout, 0, 0) for cin, cout in S2_NARROW_HALO]
    n, d, h, wd = S2_NARROW_SHAPE
    worst = 0.0
    for cin, cout, offset, pad_lo in cases:
        x = torch.randn(*S2_NARROW_SHAPE, cin, device=device, generator=gen).bfloat16()
        if offset:
            store = torch.empty(offset + x.numel(), dtype=x.dtype, device=device)
            x = store[offset:].view(x.shape).copy_(x)
        g = torch.randn(n, (d + pad_lo) // 2, (h + 1) // 2, (wd + 1) // 2, cout, device=device,
                        generator=gen).bfloat16()
        got, again = W.s2_wgrad(x, g, pad_lo), W.s2_wgrad(x, g, pad_lo)
        want = W.s2_wgrad_reference(x, g, pad_lo)
        torch.cuda.synchronize()
        rel, form = rel_max(got, want), W.kernel_form(x, g)
        msg = (f"s2_wgrad narrow {S2_NARROW_SHAPE} {cin:2d}->{cout:2d} offset {offset} pad_lo "
               f"{pad_lo}: form {form}, rel {rel:.3e}")
        print(msg, flush=True)
        check(form == "narrow", f"{msg}: form")
        check(rel < S2_BOUND, f"{msg} > {S2_BOUND}")
        check(torch.equal(got, again), f"{msg}: two calls differ")
        worst = max(worst, rel)
        del x, g, got, again, want
    rows = []
    for label, s, cin, cout in NARROW_S2_SHAPES:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).bfloat16()
        g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device,
                        generator=gen).bfloat16()
        got, want = W.s2_wgrad(x, g), W.s2_wgrad_reference(x, g)
        torch.cuda.synchronize()
        rel, form = rel_max(got, want), W.kernel_form(x, g)
        xn, gn = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        ms = device_ms(lambda: W.s2_wgrad(x, g))
        cudnn_ms = device_ms(lambda: torch.nn.grad.conv3d_weight(
            xn, (cout, cin, 3, 3, 3), gn, stride=2, padding=1))
        plain_ms = device_ms(lambda: W.s2_wgrad_reference(x, g))
        half = (s // 2) ** 3
        bms, bound_by = bound_ms(2.0 * half * 27 * cin * cout,
                                 2 * (s ** 3 * cin + half * cout) + 4 * 27 * cin * cout)
        msg = (f"s2_wgrad    {label:36s} bfloat16 {form:6s} rel {rel:.3e} | kernel {ms:.3f} ms, "
               f"cuDNN dw {cudnn_ms:.3f} ms, plain (f32 cuDNN) {plain_ms:.3f} ms, bound "
               f"{bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
        print(msg, flush=True)
        check(form == "narrow", f"{msg}: form")
        check(rel < S2_BOUND, f"{msg} > {S2_BOUND}")
        rows.append(dict(name="s2_wgrad_narrow", shape=label, dtype="bfloat16", form=form,
                         ms=ms, plain_ms=plain_ms, library_ms=cudnn_ms, bound_ms=bms,
                         bound_by=bound_by, max_abs_err=(got - want).abs().max().item()))
        del x, g, got, want
    torch.cuda.empty_cache()
    return dict(worst_rel=worst, cases=len(cases), rows=rows)


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


def grad_gap(got, want, names):
    """Gradients ``got`` against ``want``: (relative L2 over all parameters,
    worst tensor's relative L2, its name)."""
    diff = sum(float((a - b).float().square().sum()) for a, b in zip(got, want))
    norm = sum(float(b.float().square().sum()) for b in want)
    # tensors whose gradient is ~0 next to the whole are left out of the worst
    worst = max((float((a - b).float().norm() / b.float().norm()), n)
                for a, b, n in zip(got, want, names)
                if float(b.float().norm()) > 1e-6 * norm ** 0.5)
    return (diff / norm) ** 0.5, worst[0], worst[1]


def grad_rel_l2(model, criterion, x, y, amp):
    """One step's gradients, kernels against the plain path (``grad_gap``)."""
    from unet3d_tpu_torch.train.step import forward_loss
    names, params = zip(*model.named_parameters())
    got = torch.autograd.grad(forward_loss(model, criterion, x, y, amp), params)
    want = torch.autograd.grad(forward_loss(PlainNet(model), criterion, x, y, amp), params)
    return grad_gap(got, want, names)


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
            f32_forms = forms_of(TRAIN_KERNELS)
            check(set(f32_forms) == {f"{v}/tf32x3" for v in TRAIN_KERNELS},
                  f"f32 step: direct conv and s2_wgrad launches by form {f32_forms}")
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
    # one f32 step through the kernels: the tf32x3 forms' device time (the
    # direct conv's conv3d_tf32x3.cu, s2_wgrad's s2_wgrad_tf32x3.cu)
    f32_step = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-6),
                               amp=False)
    profile["f32_kernels"] = profile_device(
        lambda: f32_step(train_batch["image"], train_batch["label"]),
        "one f32 train step (kernels)", card)
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
            reset_launches()
            rel, worst, worst_name = grad_rel_l2(model, criterion, x, y, dt_amp)
            torch.cuda.synchronize()
            grads[name] = rel
            msg = (f"gradients {name} under the strategy, kernels vs plain path: rel L2 "
                   f"{rel:.3e}; worst tensor {worst_name} {worst:.3e}")
            print(msg, flush=True)
            check(rel < bound, f"{msg} > {bound}")
            if name == "f32":  # every f32 Winograd call in the tf32x3 form
                f32_forms = {k: n for k, n in form_launches().items()
                             if k[0] in STRATEGY_KERNELS}
                print(f"f32 gradients under the strategy: Winograd launches by form "
                      f"{f32_forms}", flush=True)
                check(set(f32_forms) == {(k, "tf32x3") for k in STRATEGY_KERNELS},
                      f"f32 gradients under the strategy: Winograd forms {f32_forms}, "
                      "expected winograd and winograd_stats in the tf32x3 form")
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
    f32_times = {"default": [], "winograd": []}
    for which in ("default", "winograd", "winograd", "default"):
        with conv_strategy(None if which == "default" else which):
            opt = torch.optim.Adam(model.parameters(), lr=1e-6)
            f32_times[which].append(step_ms(make_train_step(model, criterion, opt, amp=False),
                                            images, labels))
    print(f"f32 train step batch {images.shape}: winograd {f32_times['winograd']} ms, "
          f"default {f32_times['default']} ms [{card}]", flush=True)
    torch.cuda.empty_cache()
    return launches, dict(step_ms={k: sum(v) / len(v) for k, v in times.items()},
                          f32_step_ms={k: sum(v) / len(v) for k, v in f32_times.items()},
                          grad_rel_l2=grads,
                          f32_forms={f"{k}/{f}": n for (k, f), n in f32_forms.items()})


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


def phase10_kernels(device, gen, conv_shapes=FAMILY_CONV_SHAPES, s2_shapes=FAMILY_S2_SHAPES,
                    label="family"):
    """The conv kernel (each ``conv_shapes`` entry's variant: ``conv`` unless
    a seventh element names ``conv_stats`` or ``block_stats``) and s2_wgrad
    at the family's new shapes (phase 11: the BatchNorm nets'; phase 12: the
    transformers') against their plain versions, in the form each takes
    there, timed (device ms) beside the plain composition, one PyTorch call
    (``F.conv3d``: the conv alone, beside a statistics variant) and the bound (f32: both the f32 CUDA-core bound and the 3xTF32
    tensor-core bound the tf32x3 form is held to)."""
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W

    kernel = {"conv": K.conv3x3x3, "conv_stats": K.conv3x3x3_with_stats,
              "block_stats": K.conv3x3x3_block_with_stats}
    plain = {"conv": K.conv3d_reference, "conv_stats": K.conv3d_with_stats_reference,
             "block_stats": K.conv3d_block_with_stats_reference}
    rows = []
    for shape_label, s, cin, cout, dtype, expected, *variant in conv_shapes:
        variant = variant[0] if variant else "conv"
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(dtype)
        w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
             / (27 * cin) ** 0.5).to(dtype)
        inv = torch.rand(1, cin, device=device, generator=gen) + 0.5
        shift = torch.randn(1, cin, device=device, generator=gen) * 0.3
        args = (x, w, inv, shift) if variant == "block_stats" else (x, w)
        form = K.kernel_form(x, w)
        got, want = kernel[variant](*args), plain[variant](*args)
        got_y, want_y = (got, want) if variant == "conv" else (got[0], want[0])
        torch.cuda.synchronize()
        rel = rel_max(got_y, want_y)
        msg = (f"{label} {variant} {shape_label:32s} {str(dtype)[6:]:8s} {form:6s} rel "
               f"{rel:.3e}")
        check(form == expected, f"{msg}: form, expected {expected}")
        check(rel < BOUNDS[dtype], f"{msg} > {BOUNDS[dtype]}")
        if variant != "conv":
            s_err = stats_err(*got)
            msg += f" stats rel {s_err:.3e}"
            check(s_err < STATS_BOUND, f"{msg} > {STATS_BOUND}")
        ms = device_ms(lambda: kernel[variant](*args))
        plain_ms = device_ms(lambda: plain_fast(variant, x, w, inv, shift))
        library_ms = device_ms(library_conv(x, w))
        name = variant if dtype == torch.bfloat16 else f"{variant}_{form}"
        row = dict(name=name, shape=shape_label, dtype=str(dtype)[6:], form=form, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   max_abs_err=(got_y.float() - want_y.float()).abs().max().item())
        if variant != "conv":
            # no one PyTorch call takes the statistics with the conv: F.conv3d
            # alone is kept beside it
            row.update(library_ms=None, conv3d_ms=library_ms)
        if dtype == torch.float32:
            row["f32_bound_ms"], _ = conv_bound(variant, s, cin, cout, dtype=dtype)
            bms, bound_by = tf32x3_bound(variant, s, cin, cout)
            msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d (TF32 off) "
                    f"{library_ms:.3f} ms, f32 bound {row['f32_bound_ms']:.3f} ms, 3xTF32 "
                    f"bound {bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
        else:
            bms, bound_by = conv_bound(variant, s, cin, cout, dtype=dtype)
            msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d "
                    f"{library_ms:.3f} ms, bound {bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
        print(msg, flush=True)
        rows.append(dict(row, bound_ms=bms, bound_by=bound_by))
        del x, w, got, want, got_y, want_y
    for shape_label, s, cin, cout in s2_shapes:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(torch.bfloat16)
        g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device,
                        generator=gen).to(torch.bfloat16)
        form = W.kernel_form(x, g)
        got, want = W.s2_wgrad(x, g), W.s2_wgrad_reference(x, g)
        torch.cuda.synchronize()
        rel = rel_max(got, want)
        msg = f"{label} s2_wgrad {shape_label:28s} bfloat16 {form:5s} rel {rel:.3e}"
        expected = "wgmma" if cin % 8 == 0 and cout % 8 == 0 else "narrow"
        check(form == expected, f"{msg}: form, expected {expected}")
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
        rows.append(dict(name="s2_wgrad", shape=shape_label, dtype="bfloat16", form=form, ms=ms,
                         plain_ms=plain_ms, library_ms=plain_ms, bound_ms=bms,
                         bound_by=bound_by, max_abs_err=(got - want).abs().max().item()))
        del x, g, got, want
    torch.cuda.empty_cache()
    return rows


def forms_of(kernels) -> dict:
    return {f"{v}/{f}": n for (v, f), n in sorted(form_launches().items()) if v in kernels}


def check_family_forms(where: str, narrow_conv: bool = False) -> None:
    """Under AMP the family's conv launches take the wgmma form (bf16) or
    the tf32x3 form (the f32 decoder), s2_wgrad the wgmma form; the conv's
    narrow form only where ``narrow_conv`` allows it: in the U-Nets and
    autoencoders the first conv follows a GroupNorm, so training takes its
    input gradient, whose n_features outputs are no multiple of 8, and
    AutoImplantUNet's one-channel input conv is no multiple of 4."""
    allowed = {("conv", "wgmma"), ("conv", "tf32x3"), ("s2_wgrad", "wgmma")}
    if narrow_conv:
        allowed.add(("conv", "narrow"))
    check_allowed_forms(where, allowed)


def check_allowed_forms(where: str, allowed) -> None:
    off = {k: n for k, n in form_launches().items() if k not in allowed}
    check(not off, f"{where}: launches off the allowed forms {sorted(allowed)}: {off}")


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
    return grad_gap(got, want, names)


def state_digest(model) -> str:
    """A digest of ``model``'s parameters and buffers, bit for bit: two runs
    whose digests agree check one weight state."""
    digest = hashlib.sha256()
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        digest.update(name.encode())
        digest.update(t.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


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
    plain f32 path's. The caller gives a model whose weights every run
    reaches bit for bit (phase 10: the seeded initial weights);
    ``state_digest`` of them is returned as ``state``."""
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
    state = state_digest(model)
    print(f"torch's default TF32 flags: f32 paths vs themselves with TF32 off, rel L2 {out}; "
          f"f32 step gradients {accuracy}; weights {state}", flush=True)
    for name, rel in out.items():
        check(rel < TF32_FLAGS_BOUND, f"default TF32 flags: {name} rel L2 {rel:.3e} > "
              f"{TF32_FLAGS_BOUND}")
    excess = accuracy["kernels_vs_f64"] - accuracy["plain_vs_f64"]
    check(excess < F64_EXCESS_BOUND,
          f"f32 step gradients: the kernels {accuracy['kernels_vs_f64']:.3e} from f64, the "
          f"plain path {accuracy['plain_vs_f64']:.3e}: {excess:.3e} farther > "
          f"{F64_EXCESS_BOUND}")
    return dict(out, **accuracy, state=state)


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
    # torch's default TF32 flags, on the seeded initial weights of a fresh
    # model: the steps above add by atomics (the kernels' f32 statistics, the
    # trilinear upsample's backward), so the weights they leave differ from
    # run to run, and with them both f32 paths' distance from f64
    fresh = build_or_load_model_from_config(config, None, device, seed=seed)
    tf32_flags = default_tf32_flags(fresh, criterion, images, labels, device, seed)
    del fresh
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


def train_cli_fold1(model_cfg, cli_dir, config_name, cases, kernels, check_kernel_forms):
    """The train CLI on phase 8's cases and folds with the BraTS config's
    model section replaced by ``model_cfg``: the cross-validation set-up,
    then fold 1 for TRAIN_CLI_EPOCHS epochs through ``scripts.train.main``
    (its own loaders, prefetcher, steps, validation and predictions), with
    ``run_training`` and the prefetcher wrapped to read the launches, the
    forms of ``kernels`` (held by ``check_kernel_forms``), each step's ms by
    CUDA events and each epoch's start. Returns (config, fold file, fold
    dir, the CLI's result, run: launches, forms, main_s, epoch_s,
    step_ms)."""
    from unet3d_tpu_torch.data.prefetch import DevicePrefetcher
    from unet3d_tpu_torch.scripts import train as train_cli
    from unet3d_tpu_torch.utils.config import dump_json, load_json

    shutil.rmtree(cli_dir, ignore_errors=True)
    os.makedirs(cli_dir)
    config = load_json(CONFIG)
    config["model"] = dict(model_cfg)
    config["training_filenames"] = cases
    config["bratsvalidation_filenames"] = [{"image": cases[0]["image"]}]
    config["training"]["n_epochs"] = TRAIN_CLI_EPOCHS
    config["cross_validation"]["folds"] = TRAIN_CLI_FOLDS
    config_file = os.path.join(cli_dir, f"{config_name}.json")
    dump_json(config, config_file)
    work = os.path.join(cli_dir, "out", config_name)
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
        run.update(end=time.perf_counter(), launches=launch_counts(), forms=forms_of(kernels))
        check_kernel_forms()
        return model

    train_cli.run_training, train_cli.DevicePrefetcher = timed_run_training, EpochPrefetcher
    try:
        t0 = time.perf_counter()
        result = train_cli.main(["--config_filename", fold_file, "--output_dir", work])
        torch.cuda.synchronize()
        run["main_s"] = time.perf_counter() - t0
    finally:
        train_cli.run_training, train_cli.DevicePrefetcher = real_run_training, DevicePrefetcher
    starts = [t for _, t in epochs] + [run.pop("end")]
    run.update(epoch_s=[b - a for a, b in zip(starts, starts[1:])],
               step_ms=[a.elapsed_time(b) for a, b in steps])
    return config, fold_file, fold_dir, result, run


def phase10_train_cli(device, seed, card, cases):
    """The train CLI on phase 8's cases and folds with the BraTS config's
    model section replaced by SegResNetVAE: fold 1, 2 epochs, its validation
    and bratsvalidation prediction through the CLI's own code."""
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.convert import load_jax_variables
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.train.checkpoint import load_checkpoint
    from unet3d_tpu_torch.train.train import read_training_log

    config, _, fold_dir, result, run = train_cli_fold1(
        SEGRESNET_MODEL, SEGRESNET_CLI_DIR, "brats2020_segresnet", cases, FAMILY_KERNELS,
        lambda: check_family_forms("SegResNetVAE train CLI"))
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
    print(f"SegResNetVAE train CLI: main {run['main_s']:.3f} s; seconds per epoch "
          f"{[round(v, 3) for v in run['epoch_s']]}; step ms "
          f"{[round(v, 3) for v in run['step_ms']]} [{card}]", flush=True)
    del model, fresh, result
    torch.cuda.empty_cache()
    shutil.rmtree(SEGRESNET_CLI_DIR, ignore_errors=True)
    return run.pop("launches"), dict(run, log=[list(map(float, r)) for r in rows])


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
        check_family_forms(f"{name} window", narrow_conv=kwargs["n_features"] % 4 != 0)
        check(launches["conv"] > 0, f"{name}: conv not launched")
        window_forms = forms_of(FAMILY_KERNELS)
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
                check_family_forms(f"{name} train step", narrow_conv=True)
                step_forms = forms_of(FAMILY_KERNELS)
            del x, y
        print(f"{name} window forward {shape} bf16 {window_ms:.3f} ms [{card}]", flush=True)
        out[name] = dict(window_rel_l2=rel, window_launches=launches, window_ms=window_ms,
                         window_forms=window_forms, grad_rel_l2=grads,
                         step_launches=step_launches, step_forms=step_forms)
        del model
        torch.cuda.empty_cache()
    return out


def conv_sites(model) -> tuple:
    """The 3-cubed FastConvs of ``model``: (stride 1, stride 2) counts. A
    window launches the conv kernel once per stride-1 site; a train step
    adds each one's input gradient except where the input needs none (the
    model's first conv), and s2_wgrad once per stride-2 site."""
    from unet3d_tpu_torch.models.layers import FastConv
    sites = [m.strides for m in model.modules()
             if isinstance(m, FastConv) and m.kernel_size == (3, 3, 3)]
    return sites.count((1, 1, 1)), sites.count((2, 2, 2))


def path_grads(model, criterion, images, labels, device, seed, plain=None,
               objective=None, f64=False) -> dict:
    """One training forward and backward from the same running statistics
    (put back after), the noise drawn alike, through the kernels and the
    plain path (``plain``, a context: ``plain_convs`` by default), in f32
    and bf16 AMP: the gradients' (and a BatchNorm net's running
    statistics') relative L2, kernels against the plain path in each dtype,
    the worst tensor's, and each path's bf16 gradients against the plain
    f32 ones. A net's bf16 gradients can lie far from f32 on either path
    (AttentionUnet's attention gate: 4.8% at 128^3 on the H100; the
    transformers' bf16 attention), so besides phase 5's bound on kernels
    against the plain path, the bf16 check holds the kernels no further from
    f32 than ``BF16_EXCESS`` times the plain path, as the tests hold the port
    against JAX (tests/test_torch_batchnorm.py::check_grads). ``objective``
    (model, x, y, amp, rng) -> loss replaces the step's ``forward_loss`` of
    ``criterion``. With ``f64``, where the f32 paths lie GRAD_BOUND_F32 or
    more apart, each path's gradients are also held to the plain path's in
    f64 on a double copy of the model (``check_path_grads`` then reads
    those distances)."""
    import copy

    from unet3d_tpu_torch.train.step import forward_loss, noise_generator, prepare_batch
    plain_path = plain or plain_convs
    objective = objective or (lambda m, x, y, amp, rng: forward_loss(m, criterion, x, y, amp,
                                                                     rng))
    names, params = zip(*model.named_parameters())
    start = [b.clone() for b in model.buffers()]

    def run(amp, plain):
        x, y = prepare_batch(images, labels, device, amp)
        with torch.no_grad():
            for b, b0 in zip(model.buffers(), start):
                b.copy_(b0)
        with plain_path() if plain else contextlib.nullcontext():
            loss = objective(model, x, y, amp, noise_generator(model, seed))
            grads = torch.autograd.grad(loss, params)
        return grads, [b.clone() for b in model.buffers()]

    runs = {(amp, plain): run(amp, plain) for amp in (False, True) for plain in (False, True)}
    with torch.no_grad():
        for b, b0 in zip(model.buffers(), start):
            b.copy_(b0)
    out = {}
    for dt, amp in (("f32", False), ("bf16", True)):
        (got, got_stats), (want, want_stats) = runs[amp, False], runs[amp, True]
        gap, worst, worst_name = grad_gap(got, want, names)
        out[dt] = dict(gradients=gap, worst=worst, worst_tensor=worst_name)
        if start:
            out[dt]["statistics"] = rel_l2_of(got_stats, want_stats)
    f32 = runs[False, True][0]
    out["bf16"].update(kernels_vs_f32=rel_l2_of(runs[True, False][0], f32),
                       plain_vs_f32=rel_l2_of(runs[True, True][0], f32))
    if f64 and out["f32"]["gradients"] >= GRAD_BOUND_F32:
        double = copy.deepcopy(model).double()
        x, y = prepare_batch(images, labels, device, False)
        with plain_path():
            loss = objective(double, x.double(), y.double(), False,
                             noise_generator(double, seed))
            exact = torch.autograd.grad(loss, list(double.parameters()))
        del double, loss
        torch.cuda.empty_cache()
        for dt, amp in (("f32", False), ("bf16", True)):
            out[dt].update(kernels_vs_f64=rel_l2_of(runs[amp, False][0], exact),
                           plain_vs_f64=rel_l2_of(runs[amp, True][0], exact))
    return out


def check_path_grads(name: str, result: dict) -> None:
    """``path_grads``' result against phase 5's bounds (kernels against the
    plain path in the same dtype), the bf16 rule against f32 and, for a
    BatchNorm net, the statistics bounds. Where ``path_grads`` took the f64
    gradients (its f32 paths GRAD_BOUND_F32 or more apart: the f32 noise of
    either path, carried up by the BatchNorms' invariances, past the bound),
    the kernels' gradients in each dtype are held no further from them than
    F64_EXCESS times the plain path's, as the tests hold the port against
    JAX's f64 evaluation (tests/test_torch_batchnorm.py::_check_f32)."""
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        r = result[dt]
        msg = (f"{name} {dt}, kernels vs plain path: gradients rel L2 {r['gradients']:.3e} "
               f"(worst tensor {r['worst_tensor']} {r['worst']:.3e})")
        if "statistics" in r:
            msg += f"; running statistics rel L2 {r['statistics']:.3e}"
        if dt == "bf16":
            msg += (f"; bf16 gradients vs the plain f32 ones: kernels {r['kernels_vs_f32']:.3e}, "
                    f"plain {r['plain_vs_f32']:.3e}")
        if "kernels_vs_f64" in r:
            msg += (f"; vs the plain path in f64: kernels {r['kernels_vs_f64']:.3e}, plain "
                    f"{r['plain_vs_f64']:.3e}")
        print(msg, flush=True)
        bound = GRAD_BOUND_F32 if dt == "f32" else GRAD_BOUND_BF16
        if "kernels_vs_f64" in r:
            limit = max(bound, F64_EXCESS * r["plain_vs_f64"])
            check(r["kernels_vs_f64"] < limit, f"{msg}: kernels vs f64 > {limit:.3e}")
        else:
            check(r["gradients"] < bound, f"{msg}: gradients > {bound}")
        if dt == "bf16":
            limit = max(GRAD_BOUND_BF16, BF16_EXCESS * r["plain_vs_f32"])
            check(r["kernels_vs_f32"] < limit, f"{msg}: bf16 kernels vs f32 > {limit:.3e}")
        if "statistics" in r:
            check(r["statistics"] < BN_STATS_BOUNDS[dtype],
                  f"{msg}: statistics > {BN_STATS_BOUNDS[dtype]}")


def check_bn_forms(where: str, narrow: bool = False, f32: bool = False) -> None:
    """The BatchNorm nets' launches: every bf16 conv and s2_wgrad in the
    wgmma form, and, where ``narrow`` allows it (UNet: its last up unit maps
    3 channels to 3, its first conv takes 4 input channels), the conv's
    narrow form and s2_wgrad's narrow form; with ``f32`` also the f32 forms
    (the conv's tf32x3 and s2_wgrad's tf32x3, and, for those channel counts,
    the conv's tf32x3_narrow)."""
    allowed = {("conv", "wgmma"), ("s2_wgrad", "wgmma")}
    if narrow:
        allowed |= {("conv", "narrow"), ("s2_wgrad", "narrow")}
    if f32:
        allowed |= {("conv", "tf32x3"), ("s2_wgrad", "tf32x3")}
    if narrow and f32:
        allowed.add(("conv", "tf32x3_narrow"))
    check_allowed_forms(where, allowed)


def phase11_segresnet_ds(device, seed, card):
    """SegResNetDS at MONAI's widths: (a) one 128^3 bf16 window through
    ``volumetric_predictions``, kernels against the plain path, its launches
    by form and CUDA-event time; one bf16 AMP train step at batch 1
    (DiceLoss, Adam): launches by form, gradients and running statistics
    against the plain path (f32 and bf16), step ms, peak memory, a profile."""
    from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.predict.volumetric import make_forward, volumetric_predictions
    from unet3d_tpu_torch.train.step import make_train_step
    from unet3d_tpu_torch.utils.config import load_json

    config = load_json(CONFIG)
    config["model"] = dict(SEGRESNET_DS_MODEL)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    n_stats = sum(b.numel() for b in model.buffers())
    print(f"SegResNetDS {json.dumps(SEGRESNET_DS_MODEL)}: {n_params} params, {n_stats} "
          f"running statistics [{card}]", flush=True)
    stride1, stride2 = conv_sites(model)
    shape = tuple(config["dataset"]["desired_shape"])
    rng = np.random.RandomState(seed + 50)
    image = rng.randn(1, 4, *shape).astype(np.float32)
    batch = {"image": image, "affine": np.eye(4)[None],
             "source_filename": ["segresnet_ds_window.nii.gz"]}

    # (a) one window through volumetric_predictions, kernels and plain path
    outputs = {}
    for which in ("kernels", "plain"):
        out_dir = os.path.join(SEGRESNET_DS_CLI_DIR, "window", which)
        torch.cuda.synchronize()
        reset_launches()
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            (written,) = volumetric_predictions(model, [batch], out_dir, activation="sigmoid",
                                                amp=True)
        torch.cuda.synchronize()
        if which == "kernels":
            launches, forms = launch_counts(), forms_of(FAMILY_KERNELS)
            check_bn_forms("SegResNetDS window")
        outputs[which] = nifti.load(written)[0]
    rel = float(np.linalg.norm(outputs["kernels"] - outputs["plain"])
                / np.linalg.norm(outputs["plain"]))
    print(f"SegResNetDS window 128^3 bf16 through volumetric_predictions: kernels vs plain "
          f"path rel L2 {rel:.3e}; launches {launches}; by form {forms}", flush=True)
    check(outputs["kernels"].shape == shape + (3,)
          and bool(np.isfinite(outputs["kernels"]).all()), "SegResNetDS window output")
    check(rel < L2_BOUND, f"SegResNetDS window rel L2 {rel:.3e} > {L2_BOUND}")
    check(launches["conv"] == stride1, f"SegResNetDS window: conv launched "
          f"{launches['conv']} times, expected {stride1} (its 3-cubed stride-1 convs)")
    forward = make_forward(model, amp=True)
    window = torch.from_numpy(np.moveaxis(image, 1, -1).copy()).to(device)
    times = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            times[which].append(cuda_ms(lambda: forward(window)))
    print(f"SegResNetDS window forward 128^3 bf16: kernels {times['kernels']} ms, plain "
          f"{times['plain']} ms [{card}]", flush=True)
    del forward, window

    # one bf16 AMP train step at batch 1
    criterion = load_criterion_from_config(config)
    labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
    optimizer = build_optimizer_from_config(config, model.parameters())
    step = make_train_step(model, criterion, optimizer, amp=True, seed=seed)
    step(image, labels)  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    reset_launches()
    loss = float(step(image, labels))
    torch.cuda.synchronize()
    step_launches, step_forms = launch_counts(), forms_of(FAMILY_KERNELS)
    print(f"SegResNetDS train step: loss {loss:.6f}; launches {step_launches}; by form "
          f"{step_forms}", flush=True)
    check(np.isfinite(loss), f"SegResNetDS train loss {loss}")
    check_bn_forms("SegResNetDS train step")
    check(step_launches["conv"] == 2 * stride1 - 1,
          f"conv launched {step_launches['conv']} times, expected {2 * stride1 - 1} "
          f"({stride1} forward, {stride1 - 1} input gradients: none for conv_init)")
    check(step_launches["s2_wgrad"] == stride2,
          f"s2_wgrad launched {step_launches['s2_wgrad']} times, expected {stride2}")
    grads = path_grads(model, criterion, image, labels, device, seed)
    check_path_grads("SegResNetDS", grads)
    torch.cuda.empty_cache()
    step_times, peaks = {"plain": [], "kernels": []}, {}
    for which in ("plain", "kernels", "kernels", "plain"):
        one = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-6),
                              amp=True, seed=seed)
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats()
            step_times[which].append(step_ms(one, image, labels))
            peaks[which] = torch.cuda.max_memory_allocated() / 2**30
    step_profile = profile_device(lambda: step(image, labels),
                                  "SegResNetDS one bf16 train step", card)
    print(f"SegResNetDS train step (bf16 AMP, batch 1, 128^3): kernels "
          f"{step_times['kernels']} ms, plain {step_times['plain']} ms; peak memory kernels "
          f"{peaks['kernels']:.2f} GiB, plain {peaks['plain']:.2f} GiB [{card}]", flush=True)
    del model, optimizer, step
    torch.cuda.empty_cache()
    return step_launches, dict(
        window_rel_l2=rel, window_launches=launches, window_forms=forms, window_ms=times,
        step_loss=loss, step_forms=step_forms, kernels_vs_plain=grads, step_ms=step_times,
        peak_gib=peaks, step_profile=step_profile)


def phase11_train_cli(device, seed, card, cases):
    """The train CLI on phase 8's cases and folds with the BraTS config's
    model section replaced by SegResNetDS (deep supervision on 2 heads):
    fold 1, 2 epochs; the checkpoint's running statistics; the predict CLI
    on that checkpoint against the train CLI's own prediction."""
    return bn_train_and_predict_cli(
        "SegResNetDS", dict(SEGRESNET_DS_MODEL, dsdepth=2), SEGRESNET_DS_CLI_DIR,
        "brats2020_segresnet_ds", FAMILY_KERNELS,
        lambda: check_bn_forms("SegResNetDS train CLI"), device, seed, card, cases)


def bn_train_and_predict_cli(name, model_cfg, cli_dir, config_name, kernels,
                             check_kernel_forms, device, seed, card, cases):
    """The train CLI on phase 8's cases and folds with a BatchNorm net
    (``train_cli_fold1``): each of ``kernels`` launched, forms held by
    ``check_kernel_forms``; finite logs; a ``model.npz`` whose
    ``batch_stats`` hold a running mean off 0 for every BatchNorm and that
    reloads strictly and equal; the train CLI's ``bratsvalidation``
    prediction on the source grid in [0, 1], and the predict CLI on the
    checkpoint within L2_BOUND of it."""
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.convert import load_jax_variables
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.models.layers import BatchNorm
    from unet3d_tpu_torch.scripts import predict
    from unet3d_tpu_torch.train.checkpoint import load_checkpoint
    from unet3d_tpu_torch.train.train import read_training_log

    config, fold_file, fold_dir, result, run = train_cli_fold1(
        model_cfg, cli_dir, config_name, cases, kernels, check_kernel_forms)
    print(f"{name} train CLI training: launches {run['launches']}; by form "
          f"{run['forms']}", flush=True)
    for kernel in kernels:
        check(run["launches"][kernel] > 0, f"train CLI: kernel {kernel} was not launched")
    rows = read_training_log(os.path.join(fold_dir, "training_log.csv"))
    print(f"{name} training_log.csv: {rows}", flush=True)
    check(len(rows) == TRAIN_CLI_EPOCHS and all(
        np.isfinite(r[1]) and np.isfinite(r[3]) for r in rows),
        f"{name} training log {rows}")
    saved = load_checkpoint(os.path.join(fold_dir, "model.npz"))
    means = {k: float(np.abs(v).max()) for k, v in saved.items()
             if k.startswith("batch_stats/") and k.endswith("/mean")}
    print(f"{name} model.npz: {len(saved)} arrays, {len(means)} BatchNorms' running "
          f"means, the smallest largest |mean| {min(means.values()):.3e}", flush=True)
    model = result["model"]
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    check(len(means) == n_bn and min(means.values()) > 0,
          f"{name} checkpoint: {len(means)} running means for {n_bn} BatchNorms, {means}")
    fresh = build_or_load_model_from_config(config, None, device, seed=seed + 1)
    load_jax_variables(fresh, saved, strict=True)
    for (key, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        check(torch.equal(a, b), f"{name} checkpoint round trip changed {key}")
    (written,) = result["predictions"]["bratsvalidation"]
    data, affine, _ = nifti.load(written)
    check(data.shape == BRATS_GRID + (3,) and bool(np.isfinite(data).all())
          and 0.0 <= data.min() and data.max() <= 1.0
          and np.allclose(affine, BRATS_AFFINE, atol=1e-6),
          f"{name} train CLI prediction {data.shape}")
    predict_dir = os.path.join(cli_dir, "predict")
    predict.main(["--config_filename", fold_file, "--model_filename",
                  os.path.join(fold_dir, "model.npz"), "--output_directory", predict_dir,
                  "--group", "bratsvalidation", "--activation", "sigmoid"])
    (pred_name,) = os.listdir(os.path.join(predict_dir, "predictions"))
    want, want_affine, _ = nifti.load(os.path.join(predict_dir, "predictions", pred_name))
    check(want.shape == BRATS_GRID + (3,) and bool(np.isfinite(want).all())
          and 0.0 <= want.min() and want.max() <= 1.0
          and np.allclose(want_affine, BRATS_AFFINE, atol=1e-6),
          f"{name} predict CLI prediction {want.shape}")
    rel = float(np.linalg.norm(data - want) / np.linalg.norm(want))
    print(f"{name} train CLI prediction vs the predict CLI on its checkpoint: rel L2 "
          f"{rel:.3e}; main {run['main_s']:.3f} s; seconds per epoch "
          f"{[round(v, 3) for v in run['epoch_s']]}; step ms "
          f"{[round(v, 3) for v in run['step_ms']]} [{card}]", flush=True)
    check(rel < L2_BOUND, f"{name} train CLI vs predict CLI rel L2 {rel:.3e}")
    del model, fresh, result
    torch.cuda.empty_cache()
    shutil.rmtree(cli_dir, ignore_errors=True)
    return run.pop("launches"), dict(run, predict_rel_l2=rel,
                                     log=[list(map(float, r)) for r in rows])


def phase11_nets(device, seed, card):
    """AttentionUnet, MONAI UNet and VNet at 128^3: one bf16 window forward
    and one training forward and backward (f32, bf16), kernels against the
    plain path, with the launches; VNet's 5-cubed and 2-cubed convs are
    cuDNN's on both paths (XLA convs in the JAX package), so it launches no
    hand kernel."""
    from unet3d_tpu_torch.config.factory import load_criterion_from_config
    from unet3d_tpu_torch.models.layers import init_parameters
    from unet3d_tpu_torch.models.registry import create_model
    from unet3d_tpu_torch.utils.config import load_json

    config = load_json(CONFIG)
    shape = tuple(config["dataset"]["desired_shape"])
    criterion = load_criterion_from_config(config)
    out = {}
    for i, (name, kwargs) in enumerate(BN_NETS):
        model = create_model(name, **kwargs)
        init_parameters(model, torch.Generator().manual_seed(seed + 60 + i))
        model = model.to(device).eval()
        stride1, stride2 = conv_sites(model)
        rng = np.random.RandomState(seed + 70 + i)
        window = torch.from_numpy(rng.randn(1, *shape, 4).astype(np.float32)).to(device)
        forward, got, rel, launches, forms = window_check(model, window)
        check(got.shape == (1, *shape, 3) and bool(torch.isfinite(got).all()),
              f"{name} window output {tuple(got.shape)}")
        msg = (f"{name} window {shape} bf16: kernels vs plain rel L2 {rel:.3e}; launches "
               f"{launches}; by form {forms_of(FAMILY_KERNELS)}")
        print(msg, flush=True)
        check(rel < L2_BOUND, f"{msg} > {L2_BOUND}")
        check_bn_forms(f"{name} window", narrow=name == "UNet")
        check(launches["conv"] == stride1, f"{msg}: expected conv {stride1}")
        window_forms = forms_of(FAMILY_KERNELS)
        window_ms = cuda_ms(lambda: forward(window))
        del forward, got
        images = rng.randn(1, 4, *shape).astype(np.float32)
        labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
        reset_launches()
        result = path_grads(model, criterion, images, labels, device, seed)
        step_launches, step_forms = launch_counts(), forms_of(FAMILY_KERNELS)
        print(f"{name} training forwards and backwards (f32 and bf16, kernels and plain "
              f"path): launches {step_launches}; by form {step_forms}", flush=True)
        check_path_grads(name, result)
        # the kernels' two runs (f32, bf16): s2_wgrad once per stride-2 site each
        check(step_launches["s2_wgrad"] == 2 * stride2,
              f"{name}: s2_wgrad {step_launches['s2_wgrad']}, expected {2 * stride2}")
        check_bn_forms(f"{name} train step", narrow=name == "UNet", f32=True)
        print(f"{name} window forward {shape} bf16 {window_ms:.3f} ms [{card}]", flush=True)
        out[name] = dict(window_rel_l2=rel, window_launches=launches, window_ms=window_ms,
                         window_forms=window_forms, step_launches=step_launches,
                         step_forms=step_forms, **result)
        del model
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def plain_blocks():
    """Inside the block every DynUNet block (``UnetBasicBlock``,
    ``UnetResBlock``: the transformers' conv decoders) runs ``plain_block``
    (``F.conv3d``, the instance norm from plain statistics, the concat
    written): the plain path, no hand kernel. The attention, LayerNorm and
    matmuls are plain torch on both paths."""
    from unet3d_tpu_torch.models import dynunet
    saved = dynunet.UnetBasicBlock.forward, dynunet.UnetResBlock.forward
    dynunet.UnetBasicBlock.forward = dynunet.UnetResBlock.forward = plain_block
    try:
        yield
    finally:
        dynunet.UnetBasicBlock.forward, dynunet.UnetResBlock.forward = saved


@contextlib.contextmanager
def cudnn_deterministic():
    """``torch.backends.cudnn.deterministic`` inside the block, restored
    after it."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def transformer_f32_policy(name, model, criterion, images, labels, device,
                           plain=None) -> dict:
    """The port's f32 policy in one f32 step's gradients, each path against
    itself with TF32 off by the caller: under torch's default TF32 flags
    (cuDNN's in TF32) and with cuBLAS's TF32 on too, every run with cuDNN
    deterministic (``cudnn_deterministic``): a BatchNorm net at batch 1
    carries a last-bit change of cuDNN's weight gradients to 5e-5 of
    LocalNet's step by default, 7.7e-7 with cuDNN deterministic (on an H100,
    ``tools/f32_step_determinism.py``). Through the plain path (``plain``, a
    context: ``plain_blocks`` by default, every conv cuDNN's, every matmul
    cuBLAS's, the attention products included) within TF32_FLAGS_BOUND.
    Through the kernels the step is not reproducible: the f32 statistics of
    ``conv_stats`` and ``block_stats`` sum by atomics
    (``ops/kernels/conv3d_wgmma.cu``), and a last-bit change carries a leaky
    ReLU across its kink here and there, so the same step twice differs (the
    spread, printed); each within TF32_SHARE of what TF32 does to the plain
    path's gradients with the policy taken out (``full_f32`` a no-op,
    cuBLAS's and cuDNN's TF32 on: the control, which must move them past
    that)."""
    from unet3d_tpu_torch.ops import conv3d as conv_ops
    from unet3d_tpu_torch.ops import conv3d_kernel
    from unet3d_tpu_torch.train.step import forward_loss, prepare_batch
    check(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 flag is not torch's default")
    check(not torch.backends.cuda.matmul.allow_tf32, "cuBLAS's TF32 flag is not the default")
    x, y = prepare_batch(images, labels, device, False)
    params = list(model.parameters())

    plain_path = plain or plain_blocks

    def grads(plain, cudnn_tf32=True, matmul_tf32=False):
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        try:
            with plain_path() if plain else contextlib.nullcontext(), cudnn_deterministic():
                return torch.autograd.grad(forward_loss(model, criterion, x, y, False), params)
        finally:
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = False

    out = {}
    for path, plain in (("plain", True), ("kernels", False)):
        off = grads(plain, cudnn_tf32=False)
        out[path] = {"default_flags": rel_l2_of(grads(plain), off),
                     "matmul_tf32_on": rel_l2_of(grads(plain, matmul_tf32=True), off),
                     "tf32_off_again": rel_l2_of(grads(plain, cudnn_tf32=False), off)}
        if plain:
            saved = conv_ops.full_f32, conv3d_kernel.full_f32
            conv_ops.full_f32 = conv3d_kernel.full_f32 = lambda *t: contextlib.nullcontext()
            try:
                out[path]["no_policy_tf32_on"] = rel_l2_of(grads(plain, matmul_tf32=True), off)
            finally:
                conv_ops.full_f32, conv3d_kernel.full_f32 = saved
    control = out["plain"]["no_policy_tf32_on"]
    print(f"{name} f32 step gradients vs the same path with TF32 off by the caller, rel L2 "
          f"{out}", flush=True)
    for key in ("default_flags", "matmul_tf32_on"):
        check(out["plain"][key] < TF32_FLAGS_BOUND, f"{name} f32 policy, plain path: {key} "
              f"{out['plain'][key]:.3e} > {TF32_FLAGS_BOUND:.3e}")
        # the kernels' atomic f32 statistics keep their path on the share rule
        limit = TF32_SHARE * control
        check(out["kernels"][key] < limit, f"{name} f32 policy, kernels: {key} "
              f"{out['kernels'][key]:.3e} > {limit:.3e} ({TF32_SHARE} of TF32's {control:.3e})")
    check(control > TF32_FLAGS_BOUND, f"{name}: TF32 without the policy moved the gradients "
          f"only {control:.3e}")
    return out


def phase12_transformer(name, model_cfg, device, seed, card):
    """UNETR or SwinUNETR at its published widths in the BraTS config: (a)
    one 128^3 bf16 window through ``volumetric_predictions``, kernels
    against the plain path (``plain_blocks``), launches by form, forward
    times and a profile; one bf16 AMP train step at batch 1 (DiceLoss,
    Adam): launches by form, gradients against the plain path (f32, bf16),
    the f32 policy under TF32 flags, step ms, peak memory and a profile."""
    from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.models.dynunet import UnetBasicBlock
    from unet3d_tpu_torch.predict.volumetric import make_forward, volumetric_predictions
    from unet3d_tpu_torch.train.step import make_train_step
    from unet3d_tpu_torch.utils.config import load_json

    config = load_json(CONFIG)
    config["model"] = dict(model_cfg)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    # each DynUNet block launches conv_stats (conv1) and block_stats (conv2)
    n_blocks = sum(isinstance(m, UnetBasicBlock) for m in model.modules())
    print(f"{name} {json.dumps(model_cfg)}: {n_params} params, {n_blocks} DynUNet blocks "
          f"[{card}]", flush=True)
    shape = tuple(config["dataset"]["desired_shape"])
    rng = np.random.RandomState(seed + 80)
    image = rng.randn(1, 4, *shape).astype(np.float32)
    batch = {"image": image, "affine": np.eye(4)[None],
             "source_filename": [f"{name.lower()}_window.nii.gz"]}
    out_root = os.path.join(ROOT, "build", "chip_smoke_transformers")

    # (a) one window through volumetric_predictions, kernels and plain path
    outputs = {}
    for which in ("kernels", "plain"):
        torch.cuda.synchronize()
        reset_launches()
        with plain_blocks() if which == "plain" else contextlib.nullcontext():
            (written,) = volumetric_predictions(model, [batch], os.path.join(out_root, which),
                                                activation="sigmoid", amp=True)
        torch.cuda.synchronize()
        if which == "kernels":
            launches, forms = launch_counts(), forms_of(TRAIN_KERNELS)
            check_forms(f"{name} window")
        else:
            check(not any(launch_counts().values()), f"{name}: the plain path launched a kernel")
        outputs[which] = nifti.load(written)[0]
    shutil.rmtree(out_root, ignore_errors=True)
    rel = float(np.linalg.norm(outputs["kernels"] - outputs["plain"])
                / np.linalg.norm(outputs["plain"]))
    print(f"{name} window {shape} bf16 through volumetric_predictions: kernels vs plain path "
          f"rel L2 {rel:.3e}; launches {launches}; by form {forms}", flush=True)
    check(outputs["kernels"].shape == shape + (3,)
          and bool(np.isfinite(outputs["kernels"]).all())
          and 0.0 <= outputs["kernels"].min() and outputs["kernels"].max() <= 1.0,
          f"{name} window output {outputs['kernels'].shape}")
    check(rel < L2_BOUND, f"{name} window rel L2 {rel:.3e} > {L2_BOUND}")
    want = {"conv_stats": n_blocks, "block_stats": n_blocks, "conv": 0, "s2_wgrad": 0}
    check(all(launches[k] == n for k, n in want.items()),
          f"{name} window launches {launches}, expected {want}")
    forward = make_forward(model, amp=True)
    window = torch.from_numpy(np.moveaxis(image, 1, -1).copy()).to(device)
    times = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        with plain_blocks() if which == "plain" else contextlib.nullcontext():
            times[which].append(cuda_ms(lambda: forward(window)))
    print(f"{name} window forward {shape} bf16: kernels {times['kernels']} ms, plain "
          f"{times['plain']} ms [{card}]", flush=True)
    window_profile = profile_device(lambda: forward(window),
                                         f"{name} one {shape} bf16 window forward", card)
    del forward, window

    # one bf16 AMP train step at batch 1
    criterion = load_criterion_from_config(config)
    labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
    optimizer = build_optimizer_from_config(config, model.parameters())
    step = make_train_step(model, criterion, optimizer, amp=True, seed=seed)
    step(image, labels)  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    reset_launches()
    loss = float(step(image, labels))
    torch.cuda.synchronize()
    step_launches, step_forms = launch_counts(), forms_of(TRAIN_KERNELS)
    print(f"{name} train step: loss {loss:.6f}; launches {step_launches}; by form "
          f"{step_forms}", flush=True)
    check(np.isfinite(loss), f"{name} train loss {loss}")
    check_forms(f"{name} train step")
    # every conv2's input gradient, and every conv1's but encoder1's (the raw input)
    want = {"conv_stats": n_blocks, "block_stats": n_blocks, "conv": 2 * n_blocks - 1,
            "s2_wgrad": 0}
    check(all(step_launches[k] == n for k, n in want.items()),
          f"{name} train step launches {step_launches}, expected {want}")
    grads = path_grads(model, criterion, image, labels, device, seed, plain=plain_blocks)
    check_path_grads(name, grads)
    policy = transformer_f32_policy(name, model, criterion, image, labels, device)
    torch.cuda.empty_cache()
    step_times, peaks = {"plain": [], "kernels": []}, {}
    for which in ("plain", "kernels", "kernels", "plain"):
        one = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-6),
                              amp=True, seed=seed)
        with plain_blocks() if which == "plain" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats()
            step_times[which].append(step_ms(one, image, labels, reps=3))
            peaks[which] = torch.cuda.max_memory_allocated() / 2**30
    step_profile = profile_device(lambda: step(image, labels),
                                       f"{name} one bf16 train step", card)
    print(f"{name} train step (bf16 AMP, batch 1, {shape}): kernels {step_times['kernels']} ms, "
          f"plain {step_times['plain']} ms; peak memory kernels {peaks['kernels']:.2f} GiB, "
          f"plain {peaks['plain']:.2f} GiB [{card}]", flush=True)
    del model, optimizer, step
    torch.cuda.empty_cache()
    return step_launches, dict(
        params=n_params, window_rel_l2=rel, window_launches=launches, window_forms=forms,
        window_ms=times, window_profile=window_profile, step_loss=loss,
        step_forms=step_forms, kernels_vs_plain=grads, f32_policy=policy,
        step_ms=step_times, peak_gib=peaks, step_profile=step_profile)


def phase12_train_cli(device, seed, card, cases):
    """The train CLI on phase 8's cases and folds with the BraTS config's
    model section replaced by SwinUNETR: fold 1, 2 epochs; the checkpoint
    reloads strictly and equal; the predict CLI on it, on the source grid."""
    return train_and_predict_cli("SwinUNETR", SWIN_UNETR_MODEL, SWIN_UNETR_CLI_DIR,
                                 "brats2020_swin_unetr", ("conv", "conv_stats", "block_stats"),
                                 lambda: check_forms("SwinUNETR train CLI"), device, seed,
                                 card, cases)


def train_and_predict_cli(name, model_cfg, cli_dir, config_name, kernels, check_kernel_forms,
                          device, seed, card, cases):
    """The train CLI on phase 8's cases and folds with the BraTS config's
    model section replaced by ``model_cfg``: fold 1, 2 epochs, each of
    ``kernels`` launched, forms held by ``check_kernel_forms``; finite logs;
    a checkpoint of ``params`` alone that reloads strictly and equal; the
    train CLI's ``bratsvalidation`` prediction and the predict CLI's on that
    checkpoint on the source grid in [0, 1], within L2_BOUND of each
    other."""
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.convert import load_jax_variables
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.scripts import predict
    from unet3d_tpu_torch.train.checkpoint import load_checkpoint
    from unet3d_tpu_torch.train.train import read_training_log

    config, fold_file, fold_dir, result, run = train_cli_fold1(
        model_cfg, cli_dir, config_name, cases, TRAIN_KERNELS, check_kernel_forms)
    print(f"{name} train CLI training: launches {run['launches']}; by form "
          f"{run['forms']}", flush=True)
    for kernel in kernels:
        check(run["launches"][kernel] > 0, f"train CLI: kernel {kernel} was not launched")
    rows = read_training_log(os.path.join(fold_dir, "training_log.csv"))
    print(f"{name} training_log.csv: {rows}", flush=True)
    check(len(rows) == TRAIN_CLI_EPOCHS and all(
        np.isfinite(r[1]) and np.isfinite(r[3]) for r in rows),
        f"{name} training log {rows}")
    saved = load_checkpoint(os.path.join(fold_dir, "model.npz"))
    model = result["model"]
    check(all(k.startswith("params/") for k in saved) and not list(model.buffers()),
          f"{name} checkpoint holds something other than params")
    fresh = build_or_load_model_from_config(config, None, device, seed=seed + 1)
    load_jax_variables(fresh, saved, strict=True)
    for (pname, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        check(torch.equal(a, b), f"{name} checkpoint round trip changed {pname}")
    (written,) = result["predictions"]["bratsvalidation"]
    data, affine, _ = nifti.load(written)
    check(data.shape == BRATS_GRID + (3,) and bool(np.isfinite(data).all())
          and 0.0 <= data.min() and data.max() <= 1.0
          and np.allclose(affine, BRATS_AFFINE, atol=1e-6),
          f"{name} train CLI prediction {data.shape}")
    predict_dir = os.path.join(cli_dir, "predict")
    predict.main(["--config_filename", fold_file, "--model_filename",
                  os.path.join(fold_dir, "model.npz"), "--output_directory", predict_dir,
                  "--group", "bratsvalidation", "--activation", "sigmoid"])
    (pred_name,) = os.listdir(os.path.join(predict_dir, "predictions"))
    want, want_affine, _ = nifti.load(os.path.join(predict_dir, "predictions", pred_name))
    check(want.shape == BRATS_GRID + (3,) and bool(np.isfinite(want).all())
          and 0.0 <= want.min() and want.max() <= 1.0
          and np.allclose(want_affine, BRATS_AFFINE, atol=1e-6),
          f"{name} predict CLI prediction {want.shape}")
    rel = float(np.linalg.norm(data - want) / np.linalg.norm(want))
    print(f"{name} train CLI prediction vs the predict CLI on its checkpoint: rel L2 "
          f"{rel:.3e}; main {run['main_s']:.3f} s; seconds per epoch "
          f"{[round(v, 3) for v in run['epoch_s']]}; step ms "
          f"{[round(v, 3) for v in run['step_ms']]} [{card}]", flush=True)
    check(rel < L2_BOUND, f"{name} train CLI vs predict CLI rel L2 {rel:.3e}")
    del model, fresh, result
    torch.cuda.empty_cache()
    shutil.rmtree(cli_dir, ignore_errors=True)
    return run.pop("launches"), dict(run, predict_rel_l2=rel,
                                     log=[list(map(float, r)) for r in rows])


def phase12_vits(device, seed, card):
    """ViT (classification) and ViTAutoEnc at MONAI's defaults: one eval
    forward (f32 and bf16 AMP) and one training backward (f32) on the card,
    against the same module in f64 on the CPU (the plain path: they launch
    no hand kernel, so the check is the f32 policy's: every f32 matmul full
    f32)."""
    import copy

    from unet3d_tpu_torch.models.layers import init_parameters
    from unet3d_tpu_torch.models.registry import create_model
    from unet3d_tpu_torch.predict.volumetric import make_forward
    out = {}
    for i, (name, kwargs) in enumerate(VIT_MODELS):
        model = create_model(name, **kwargs)
        init_parameters(model, torch.Generator().manual_seed(seed + 90 + i))
        cpu = copy.deepcopy(model).double()
        model = model.to(device).eval()
        x = torch.from_numpy(np.random.RandomState(seed + 95 + i).randn(
            1, *kwargs["img_size"], kwargs["in_channels"]).astype(np.float32))
        # the features the Dense ``final`` reads (a head's few outputs sum
        # ~10^5 bf16 products: their relative error is the sum's conditioning)
        feats = {}

        def keep(m, args, _):
            feats[args[0].dtype] = args[0].detach().double().cpu()

        hooks = [net.final.register_forward_hook(keep) for net in (model, cpu)
                 if hasattr(net, "final")]
        reset_launches()
        got = {amp: make_forward(model, amp=amp)(x.to(device)).float().cpu()
               for amp in (False, True)}
        xt = x.to(device).requires_grad_(True)
        params = list(model.parameters())
        output = model(xt, train=True)[0]
        g = torch.from_numpy(np.random.RandomState(seed + 99).randn(*output.shape)
                             .astype(np.float32))
        grads = torch.autograd.grad((output * g.to(device)).sum(), params + [xt])
        torch.cuda.synchronize()
        check(not any(launch_counts().values()), f"{name} launched a hand kernel")
        xd = x.double().requires_grad_(True)
        with torch.no_grad():
            want = cpu(x.double())[0]
        out_d = cpu(xd, train=True)[0]
        want_grads = torch.autograd.grad((out_d * g.double()).sum(),
                                         list(cpu.parameters()) + [xd])
        r = dict(f32=rel_l2_of([got[False]], [want]), bf16=rel_l2_of([got[True]], [want]),
                 grads_f32=rel_l2_of([t.cpu() for t in grads], want_grads))
        print(f"{name} {tuple(got[False].shape)} on the card vs f64 on the CPU, rel L2: "
              f"forward f32 {r['f32']:.3e}, bf16 {r['bf16']:.3e}; training gradients f32 "
              f"{r['grads_f32']:.3e} [{card}]", flush=True)
        check(bool(torch.isfinite(got[True]).all()), f"{name}: non-finite bf16 output")
        check(r["f32"] < VIT_F32_BOUND and r["grads_f32"] < VIT_F32_BOUND,
              f"{name}: f32 on the card vs f64 {r}")
        check(r["bf16"] < L2_BOUND, f"{name}: bf16 forward vs f64 {r['bf16']:.3e}")
        out[name] = r
        del model, cpu, grads, want_grads
        torch.cuda.empty_cache()
    return out


def conv_stack_window(name, model, shape, seed, card, profile=True) -> dict:
    """One 128^3 bf16 window of a conv-stack net through ``make_forward``,
    kernels against the plain path (``plain_convs``: QuickNAT's and DiNTS's
    convs are cuDNN's on both), launches by form (a FastConv net: ``conv``
    once per 3^3 conv, all wgmma; the others: no hand kernel), CUDA-event
    times (``LATE_ROUNDS``) and, with ``profile``, a profile."""
    stride1, stride2 = conv_sites(model)
    device = next(model.parameters()).device
    rng = np.random.RandomState(seed)
    window = torch.from_numpy(rng.randn(1, *shape, 4).astype(np.float32)).to(device)
    forward, got, rel, launches, forms = window_check(model, window)
    forms = forms_of(TRAIN_KERNELS)
    msg = (f"{name} window {shape} bf16: kernels vs plain path rel L2 {rel:.3e}; launches "
           f"{launches}; by form {forms}")
    print(msg, flush=True)
    check(got.shape == (1, *shape, 3) and bool(torch.isfinite(got).all()),
          f"{name} window output {tuple(got.shape)}")
    check(rel < L2_BOUND, f"{msg} > {L2_BOUND}")
    want = {k: 0 for k in launches}
    want["conv"] = stride1
    check(launches == want and stride2 == 0, f"{msg}: expected {want}")
    check_allowed_forms(f"{name} window", {("conv", "wgmma")})
    times = {"plain": [], "kernels": []}
    for which in LATE_ROUNDS:
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            times[which].append(cuda_ms(lambda: forward(window), reps=3))
    print(f"{name} window forward {shape} bf16: kernels {times['kernels']} ms, plain "
          f"{times['plain']} ms [{card}]", flush=True)
    out = dict(window_rel_l2=rel, window_launches=launches, window_forms=forms,
               window_ms=times)
    if profile:
        out["window_profile"] = profile_device(lambda: forward(window),
                                               f"{name} one {shape} bf16 window forward", card)
    del forward, window, got
    torch.cuda.empty_cache()
    return out


def conv_stack_step(name, model, criterion, images, labels, seed, card, optimizer) -> tuple:
    """One bf16 AMP train step at batch 1 after a warm-up step: launches by
    form (a FastConv net: ``conv`` once per 3^3 conv and once per input
    gradient but the first conv's, which reads the raw input; the others:
    none); (step launches, loss, forms, the step)."""
    from unet3d_tpu_torch.train.step import make_train_step
    stride1, _ = conv_sites(model)
    step = make_train_step(model, criterion, optimizer, amp=True, seed=seed)
    step(images, labels)  # warm-up: cuDNN plans, the allocator
    torch.cuda.synchronize()
    reset_launches()
    loss = float(step(images, labels))
    torch.cuda.synchronize()
    step_launches, forms = launch_counts(), forms_of(TRAIN_KERNELS)
    print(f"{name} train step: loss {loss:.6f}; launches {step_launches}; by form {forms}",
          flush=True)
    check(np.isfinite(loss), f"{name} train loss {loss}")
    want = {k: 0 for k in step_launches}
    want["conv"] = 2 * stride1 - 1 if stride1 else 0
    check(step_launches == want, f"{name} train step launches {step_launches}, expected {want}")
    check_allowed_forms(f"{name} train step", {("conv", "wgmma")})
    return step_launches, loss, forms, step


def phase13_net(index, name, model_cfg, device, seed, card):
    """One of the MONAI conv stacks at MONAI's widths in the BraTS config:
    (b) one 128^3 bf16 window (``conv_stack_window``); (c) one bf16 AMP train
    step at batch 1 (DiceLoss, Adam; ``conv_stack_step``), gradients against
    the plain path (f32, bf16: ``path_grads``, phase 11's rules), for
    F32_POLICY_STACKS the f32 step under torch's default TF32 flags
    (``default_tf32_flags``), step ms and peak memory (``LATE_ROUNDS``)
    and, for the nets with a hand kernel (KERNEL_STACKS), a profile."""
    from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.train.step import make_train_step
    from unet3d_tpu_torch.utils.config import load_json

    t0 = time.perf_counter()
    config = load_json(CONFIG)
    config["model"] = dict(model_cfg)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    stride1, _ = conv_sites(model)
    print(f"{name} {json.dumps(model_cfg)}: {n_params} params, {stride1} 3^3 FastConvs "
          f"[{card}]", flush=True)
    check((stride1 > 0) == (name in KERNEL_STACKS), f"{name}: {stride1} FastConvs")
    shape = tuple(config["dataset"]["desired_shape"])
    out = dict(params=n_params,
               **conv_stack_window(name, model, shape, seed + 110 + index, card))

    criterion = load_criterion_from_config(config)
    rng = np.random.RandomState(seed + 120 + index)
    images = rng.randn(1, 4, *shape).astype(np.float32)
    labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
    step_launches, loss, forms, step = conv_stack_step(
        name, model, criterion, images, labels, seed, card,
        build_optimizer_from_config(config, model.parameters()))
    grads = path_grads(model, criterion, images, labels, device, seed)
    check_path_grads(name, grads)
    if name in F32_POLICY_STACKS:
        out["f32_policy"] = default_tf32_flags(model, criterion, images, labels, device, seed)
    torch.cuda.empty_cache()
    step_times, peaks = {"plain": [], "kernels": []}, {}
    for which in LATE_ROUNDS:
        one = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-6),
                              amp=True, seed=seed)
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats()
            step_times[which].append(step_ms(one, images, labels, reps=3))
            peaks[which] = torch.cuda.max_memory_allocated() / 2**30
    step_profile = (profile_device(lambda: step(images, labels),
                                   f"{name} one bf16 train step", card)
                    if name in KERNEL_STACKS else {})
    print(f"{name} train step (bf16 AMP, batch 1, {shape}): kernels {step_times['kernels']} ms, "
          f"plain {step_times['plain']} ms; peak memory kernels {peaks['kernels']:.2f} GiB, "
          f"plain {peaks['plain']:.2f} GiB; {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    del model, step
    torch.cuda.empty_cache()
    return step_launches, dict(out, step_loss=loss, step_forms=forms, kernels_vs_plain=grads,
                               step_ms=step_times, peak_gib=peaks, step_profile=step_profile)


def phase13_variants(device, seed, card) -> dict:
    """QuickNAT's second window with both squeeze-and-excitation gates
    ("CSSE"), and one bf16 AMP train step of the DiNTS supernet
    (``TopologySearch`` on DiNTS's space, all five ops on every edge
    weighted by the architecture logits, which must receive gradients):
    neither launches a hand kernel."""
    from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.utils.config import load_json

    out = {}
    config = load_json(CONFIG)
    shape = tuple(config["dataset"]["desired_shape"])
    config["model"] = dict(QUICKNAT_CSSE_MODEL)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    out["quicknat_csse"] = dict(params=sum(p.numel() for p in model.parameters()),
                                **conv_stack_window("QuickNAT CSSE", model, shape,
                                                    seed + 130, card, profile=False))
    del model
    torch.cuda.empty_cache()
    config["model"] = dict(DINTS_SEARCH_MODEL)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    criterion = load_criterion_from_config(config)
    rng = np.random.RandomState(seed + 131)
    images = rng.randn(1, 4, *shape).astype(np.float32)
    labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
    optimizer = build_optimizer_from_config(config, model.parameters())
    torch.cuda.reset_peak_memory_stats()
    step_launches, loss, forms, step = conv_stack_step(
        "DiNTS supernet", model, criterion, images, labels, seed, card, optimizer)
    grads = {k: float(model.get_parameter(k).grad.abs().max())
             for k in ("log_alpha_a", "log_alpha_c")}
    check(all(v > 0 for v in grads.values()), f"DiNTS supernet: logits' gradients {grads}")
    ms = step_ms(step, images, labels, reps=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in model.parameters())
    print(f"DiNTS supernet ({n_params} params): train step (bf16 AMP, batch 1, {shape}) "
          f"{ms:.3f} ms, peak memory {peak:.2f} GiB, the logits' largest |gradient| {grads} "
          f"[{card}]", flush=True)
    out["dints_search"] = dict(params=n_params, step_loss=loss, step_launches=step_launches,
                               step_ms=ms, peak_gib=peak, logit_grads=grads)
    del model, step, optimizer
    torch.cuda.empty_cache()
    return out


def phase13_train_cli(device, seed, card, cases):
    """The train CLI on phase 8's cases and folds with BasicUNetPlusPlus
    (deep supervision: the four heads train), then the predict CLI on its
    checkpoint (``train_and_predict_cli``); every bf16 conv in the wgmma
    form."""
    return train_and_predict_cli(
        "BasicUNetPlusPlus", dict(CONV_STACKS[1][1], deep_supervision=True),
        BASIC_UNET_PP_CLI_DIR, "brats2020_basicunetpp", ("conv",),
        lambda: check_allowed_forms("BasicUNetPlusPlus train CLI", {("conv", "wgmma")}),
        device, seed, card, cases)


def bf16_conv_form(cin: int, cout: int) -> str:
    """The form a bf16 3^3 conv on an aligned x takes: wgmma for Cin % 4 ==
    0 and Cout % 8 == 0, else narrow (``ops/conv3d_kernel.kernel_form``)."""
    return "wgmma" if cin % 4 == 0 and cout % 8 == 0 else "narrow"


def bf16_s2_form(cin: int, cout: int) -> str:
    return "wgmma" if cin % 8 == 0 and cout % 8 == 0 else "narrow"


def expected_forms(calls) -> dict:
    """The launches by ``kernel/form`` that 3^3 FastConv calls (stride,
    Cin, Cout, the input needs a gradient) take in a bf16 forward and, with
    ``calls`` from a training forward, its backward: ``conv`` once per
    stride-1 call and once more (the input gradient, in/out swapped) where
    its input needs one; ``s2_wgrad`` once per stride-2 call."""
    out = {}
    for stride, cin, cout, needs_dx in calls:
        keys = []
        if stride == (1, 1, 1):
            keys.append(f"conv/{bf16_conv_form(cin, cout)}")
            if needs_dx:
                keys.append(f"conv/{bf16_conv_form(cout, cin)}")
        else:
            keys.append(f"s2_wgrad/{bf16_s2_form(cin, cout)}")
        for key in keys:
            out[key] = out.get(key, 0) + 1
    return out


@contextlib.contextmanager
def conv_calls(model):
    """Record each 3^3 FastConv call of ``model`` (its copies included) as
    (stride, Cin, Cout, whether its input needs a gradient)."""
    from unet3d_tpu_torch.models.layers import FastConv
    calls = []

    def hook(m, args):
        calls.append((m.strides, m.kernel.shape[3], m.kernel.shape[4], args[0].requires_grad))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, FastConv) and m.kernel_size == (3, 3, 3)]
    try:
        yield calls
    finally:
        for h in handles:
            h.remove()


def static_window_forms(model) -> dict:
    """A window's launches by ``kernel/form``: one ``conv`` per stride-1
    3^3 FastConv (no gradients: stride-2 sites launch nothing)."""
    from unet3d_tpu_torch.models.layers import FastConv
    return expected_forms([(m.strides, m.kernel.shape[3], m.kernel.shape[4], False)
                           for m in model.modules() if isinstance(m, FastConv)
                           and m.kernel_size == (3, 3, 3) and m.strides == (1, 1, 1)])


def globalnet_warp(model, window, card) -> dict:
    """GlobalNet at init: the head's zero kernel and identity bias give a
    DDF of exactly 0 and ``warp_image`` the window unchanged. Then a
    non-zero head (so the step's encoder gradients are not vacuous), the
    window's DDF and the warped window: finite, the window's shape."""
    from unet3d_tpu_torch.models.regunet import warp_image
    from unet3d_tpu_torch.predict.volumetric import make_forward
    ddf = make_forward(model, amp=True)(window)
    warped = warp_image(window, ddf)
    check(bool((ddf == 0).all()) and torch.equal(warped, window),
          f"GlobalNet at init: DDF max |d| {float(ddf.abs().max()):.3e}, warp changed the "
          "window")
    gen = torch.Generator(device=window.device).manual_seed(7)
    with torch.no_grad():
        fc = model.affine_head.fc.kernel
        fc.copy_(torch.randn(fc.shape, generator=gen, device=fc.device) * 1e-5)
    ddf = make_forward(model, amp=True)(window)
    warped = warp_image(window, ddf)
    moved = float(ddf.abs().max())
    print(f"GlobalNet: DDF at init exactly 0, warp_image the identity; with a non-zero head "
          f"max |DDF| {moved:.3f} voxels, warped window {tuple(warped.shape)} [{card}]",
          flush=True)
    check(moved > 0 and bool(torch.isfinite(warped).all()) and warped.shape == window.shape,
          f"GlobalNet warp: DDF {moved}, warped {tuple(warped.shape)}")
    return dict(ddf_max_voxels=moved)


def phase14_net(index, name, model_cfg, device, seed, card, profile=False):
    """One of the last MONAI conv nets at full width in the BraTS config:
    (b) one 128^3 bf16 window through ``make_forward`` against the plain path
    (``plain_convs``) within L2_BOUND, its launches by kernel and form as the
    3^3 FastConvs predict (``static_window_forms``: none for HighResNet and
    AHNet, whose convs are cuDNN's), times (``LATE_ROUNDS``);
    GlobalNet's DDF warps the window (``globalnet_warp``); (c) one bf16 AMP
    train step at batch 1 (the config's DiceLoss and Adam) after a warm-up:
    launches by form as its calls predict (``expected_forms``), the
    gradients and running statistics against the plain path
    (``path_grads_over_draws``), for F32_POLICY_LAST the f32 step under torch's
    default TF32 flags (``transformer_f32_policy`` through ``plain_convs``:
    the plain path within TF32_FLAGS_BOUND, the kernels within TF32_SHARE of
    TF32's effect), step ms and peak memory (``LATE_ROUNDS``) and, with
    ``profile`` (LocalNet), profiles of the window and the step."""
    import copy

    from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.train.step import make_train_step
    from unet3d_tpu_torch.utils.config import load_json

    t0 = time.perf_counter()
    config = load_json(CONFIG)
    config["model"] = dict(model_cfg)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    shape = tuple(config["dataset"]["desired_shape"])
    rng = np.random.RandomState(seed + 140 + index)
    window = torch.from_numpy(rng.randn(1, *shape, 4).astype(np.float32)).to(device)
    out = dict(params=n_params)
    if name == "GlobalNet":
        out["warp"] = globalnet_warp(model, window, card)
    forward, got, rel, launches, forms = window_check(model, window)
    forms = forms_of(TRAIN_KERNELS)
    want_forms = static_window_forms(model)
    msg = (f"{name} ({n_params} params) window {shape} bf16: kernels vs plain path rel L2 "
           f"{rel:.3e}; launches {launches}; by form {forms}, expected {want_forms}")
    print(msg, flush=True)
    channels = 3
    check(tuple(got.shape) == (1, *shape, channels) and bool(torch.isfinite(got).all()),
          f"{name} window output {tuple(got.shape)}")
    check(rel < L2_BOUND, f"{msg} > {L2_BOUND}")
    check(forms == want_forms and not launches["s2_wgrad"], f"{msg}: forms")
    times = {"plain": [], "kernels": []}
    for which in LATE_ROUNDS:
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            times[which].append(cuda_ms(lambda: forward(window), reps=3))
    print(f"{name} window forward {shape} bf16: kernels {times['kernels']} ms, plain "
          f"{times['plain']} ms [{card}]", flush=True)
    out.update(window_rel_l2=rel, window_launches=launches, window_forms=forms,
               window_ms=times)
    if profile:
        out["window_profile"] = profile_device(lambda: forward(window),
                                               f"{name} one {shape} bf16 window forward", card)
    del forward, got
    torch.cuda.empty_cache()

    criterion = load_criterion_from_config(config)
    images = np.ascontiguousarray(np.moveaxis(window.cpu().numpy(), -1, 1))
    labels = (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
    # the counted step and the gradients below start from the window's
    # weights: one Adam step at the config's lr moves each weight by ~lr, so
    # the Dense layers over 65,536 (VarAutoEncoder) and 524,288 (GlobalNet's
    # head) inputs move by ~65 and ~500: the VAE's exp(logvar / 2) overflows
    # and GlobalNet's DDF saturates the sigmoid, zeroing every gradient
    start = copy.deepcopy(model.state_dict())
    step = make_train_step(model, criterion, build_optimizer_from_config(
        config, model.parameters()), amp=True, seed=seed)
    step(images, labels)  # warm-up: cuDNN plans, the allocator
    model.load_state_dict(start)
    torch.cuda.synchronize()
    reset_launches()
    with conv_calls(model) as calls:
        loss = float(step(images, labels))
    torch.cuda.synchronize()
    model.load_state_dict(start)
    step_launches, step_forms = launch_counts(), forms_of(TRAIN_KERNELS)
    want_forms = expected_forms(calls)
    msg = (f"{name} train step: loss {loss:.6f}; launches {step_launches}; by form "
           f"{step_forms}, expected {want_forms}")
    print(msg, flush=True)
    check(np.isfinite(loss), f"{name} train loss {loss}")
    check(step_forms == want_forms, f"{msg}: forms")
    grads = path_grads_over_draws(model, criterion, images, labels, device, seed)
    check_path_grads(name, grads)
    if name in F32_POLICY_LAST:
        s = F32_POLICY_LAST[name]
        out["f32_policy"] = transformer_f32_policy(
            name, model, criterion, images[..., :s, :s, :s], labels[..., :s, :s, :s], device,
            plain=plain_convs)
    torch.cuda.empty_cache()
    step_times, peaks = {"plain": [], "kernels": []}, {}
    for which in LATE_ROUNDS:
        one = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-6),
                              amp=True, seed=seed)
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats()
            step_times[which].append(step_ms(one, images, labels, reps=3))
            peaks[which] = torch.cuda.max_memory_allocated() / 2**30
    step_profile = (profile_device(lambda: step(images, labels),
                                   f"{name} one bf16 train step", card)
                    if profile else {})
    print(f"{name} train step (bf16 AMP, batch 1, {shape}): kernels {step_times['kernels']} ms, "
          f"plain {step_times['plain']} ms; peak memory kernels {peaks['kernels']:.2f} GiB, "
          f"plain {peaks['plain']:.2f} GiB; {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    del model, step
    torch.cuda.empty_cache()
    return step_launches, dict(out, step_loss=loss, step_forms=step_forms,
                               kernels_vs_plain=grads, step_ms=step_times, peak_gib=peaks,
                               step_profile=step_profile)


def path_grads_over_draws(model, criterion, images, labels, device, seed) -> dict:
    """``path_grads``; for a net whose forward draws noise (VarAutoEncoder's
    latent sample) the mean of each distance over NOISE_DRAWS draws, both
    paths drawing alike in each (each draw's distances and the worst tensor
    of the draw farthest apart kept beside). Two bf16 evaluations of the VAE
    at 128^3 on an H100 lie ~1e-2 apart and each 1.1e-2-1.8e-2 from f32,
    the kernels 0.87-1.12 times as far as the plain path over five seeds
    (``tools/vae_grad_spread.py``): one draw's gap and ratio are noise, the
    mean is what the phase-5 bound and the BF16_EXCESS rule read."""
    from unet3d_tpu_torch.train.step import noise_generator
    if noise_generator(model, seed) is None:
        return path_grads(model, criterion, images, labels, device, seed)
    runs = [path_grads(model, criterion, images, labels, device, seed + i)
            for i in range(NOISE_DRAWS)]
    out = {}
    for dt in ("f32", "bf16"):
        out[dt] = dict(max(runs, key=lambda r: r[dt]["gradients"])[dt])
        for key in [k for k in out[dt] if not k.startswith("worst")]:
            out[dt][f"{key}_draws"] = [r[dt][key] for r in runs]
            out[dt][key] = _mean(out[dt][f"{key}_draws"])
    return out


def phase14_ahnet_trilinear(device, seed, card) -> dict:
    """AHNet's second window, in "trilinear" mode (``jax.image.resize``'s
    up-samples in bf16, no transposed convs): finite, launching no hand
    kernel, within L2_BOUND of the plain path."""
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.utils.config import load_json
    config = load_json(CONFIG)
    config["model"] = dict(AHNET_TRILINEAR_MODEL)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    shape = tuple(config["dataset"]["desired_shape"])
    window = torch.from_numpy(np.random.RandomState(seed + 150).randn(1, *shape, 4)
                              .astype(np.float32)).to(device)
    forward, got, rel, launches, _ = window_check(model, window)
    ms = cuda_ms(lambda: forward(window), reps=3)
    print(f"AHNet trilinear window {shape} bf16: rel L2 vs plain {rel:.3e}, launches "
          f"{launches}, {ms:.3f} ms [{card}]", flush=True)
    check(tuple(got.shape) == (1, *shape, 3) and bool(torch.isfinite(got).all())
          and not any(launches.values()) and rel < L2_BOUND,
          f"AHNet trilinear window {tuple(got.shape)} {launches} {rel}")
    del model, forward, got
    torch.cuda.empty_cache()
    return dict(window_rel_l2=rel, window_ms=ms)


def phase14_heads(device, seed, card) -> dict:
    """(d) The heads at their defaults (Regressor, Classifier,
    Discriminator, Critic on a (2, 128^3, 4) input; Generator from a (2,
    64) latent): one forward (f32, bf16 AMP) and one backward of
    ``sum(out * g)`` in f32 on the card against the same module in f64 on
    the CPU (f32 within HEAD_F32_BOUND; bf16 within L2_BOUND on the
    Generator's volume and on the features the other heads' last Dense
    reads, whose one or two outputs per item are printed beside) (its FastConvs through ``F.conv3d``; the eval path: the
    Discriminator's and Critic's dropout draws could not match across
    devices), with their kernel launches."""
    import copy

    from unet3d_tpu_torch.models.layers import init_parameters
    from unet3d_tpu_torch.models.registry import create_model
    from unet3d_tpu_torch.predict.volumetric import make_forward
    out = {}
    for i, (name, kwargs) in enumerate(LAST_HEADS):
        model = create_model(name, **kwargs)
        init_parameters(model, torch.Generator().manual_seed(seed + 160 + i))
        cpu = copy.deepcopy(model).double()
        model = model.to(device).eval()
        c, *grid = kwargs.get("in_shape", (64,))
        in_shape = (2, c) if name == "Generator" else (2, *grid, c)
        x = torch.from_numpy(np.random.RandomState(seed + 165 + i).randn(*in_shape)
                             .astype(np.float32))
        # the features the Dense ``final`` reads (a head's few outputs sum
        # ~10^5 bf16 products: their relative error is the sum's conditioning)
        feats = {}

        def keep(m, args, _):
            feats[args[0].dtype] = args[0].detach().double().cpu()

        hooks = [net.final.register_forward_hook(keep) for net in (model, cpu)
                 if hasattr(net, "final")]
        reset_launches()
        got = {amp: make_forward(model, amp=amp)(x.to(device)).float().cpu()
               for amp in (False, True)}
        xt = x.to(device).requires_grad_(True)
        params = list(model.parameters())
        output = model(xt)
        g = torch.from_numpy(np.random.RandomState(seed + 170 + i).randn(*output.shape)
                             .astype(np.float32))
        grads = torch.autograd.grad((output * g.to(device)).sum(), params + [xt])
        torch.cuda.synchronize()
        launches, forms = launch_counts(), forms_of(TRAIN_KERNELS)
        xd = x.double().requires_grad_(True)
        with plain_convs():  # the kernels take f32 and bf16 only
            with torch.no_grad():
                want = cpu(x.double())
            want_grads = torch.autograd.grad((cpu(xd) * g.double()).sum(),
                                             list(cpu.parameters()) + [xd])
        for hook in hooks:
            hook.remove()
        r = dict(f32=rel_l2_of([got[False]], [want]), bf16=rel_l2_of([got[True]], [want]),
                 grads_f32=rel_l2_of([t.cpu() for t in grads], want_grads),
                 launches=launches, forms=forms)
        if feats:
            r["bf16_features"] = rel_l2_of([feats[torch.bfloat16]], [feats[torch.float64]])
        print(f"{name} {tuple(got[False].shape)} on the card vs f64 on the CPU, rel L2: "
              f"forward f32 {r['f32']:.3e}, bf16 {r['bf16']:.3e} (the features the last "
              f"Dense reads: {r.get('bf16_features', r['bf16']):.3e}); gradients f32 "
              f"{r['grads_f32']:.3e}; launches {launches}, by form {forms} [{card}]",
              flush=True)
        check(bool(torch.isfinite(got[True]).all()), f"{name}: non-finite bf16 output")
        check(r["f32"] < HEAD_F32_BOUND and r["grads_f32"] < HEAD_F32_BOUND,
              f"{name}: f32 on the card vs f64 {r}")
        bf16 = r.get("bf16_features", r["bf16"])
        check(bf16 < L2_BOUND, f"{name}: bf16 forward vs f64 {bf16:.3e}")
        check(launches["conv"] > 0, f"{name}: the conv kernel was not launched")
        out[name] = r
        del model, cpu, grads, want_grads
        torch.cuda.empty_cache()
    return out


def phase14_train_cli(device, seed, card, cases):
    """(e) The train CLI on phase 8's cases and folds with LocalNet, then
    the predict CLI on its ``params`` + ``batch_stats`` checkpoint
    (``bn_train_and_predict_cli``); its bf16 convs in the wgmma form and,
    at the 3-channel extraction heads and their input gradients, the narrow
    form."""
    return bn_train_and_predict_cli(
        "LocalNet", LOCALNET_MODEL, LOCALNET_CLI_DIR, "brats2020_localnet", ("conv",),
        lambda: check_allowed_forms("LocalNet train CLI", {("conv", "wgmma"),
                                                           ("conv", "narrow")}),
        device, seed, card, cases)

class ProjectionLoss:
    """``sum(out * y)``: the targets are the cotangent (ResNetWithDecoder1D's
    signal has no classes)."""

    def __call__(self, out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return (out.float() * target).sum()


def classifier_objective(criterion, gs):
    """``path_grads``' objective for a classifier: the step's ``criterion``
    on the first output plus ``sum(e * g)`` of each further one (the
    hybrids' reconstruction, mu and logvar, which the train step's criterion
    does not read), through the train step's AMP forward (bf16 copies of
    the parameters, the buffers as they are)."""
    from torch.func import functional_call

    from unet3d_tpu_torch.train.step import amp_cast

    def objective(model, x, y, amp, rng):
        kwargs = {"train": True} if rng is None else {"train": True, "rng": rng}
        if amp:
            out = functional_call(model, amp_cast(dict(model.named_parameters())), (x,), kwargs)
        else:
            out = model(x, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        loss = criterion(outs[0], y)
        for e, g in zip(outs[1:], gs):
            loss = loss + (e.float() * g).sum()
        return loss

    return objective


def one_path_grads(name, model, objective, images, labels, device, seed) -> dict:
    """A net without a hand kernel has one path: its f32 and bf16 AMP
    training gradients of ``objective`` (the running statistics put back
    after each), finite; the bf16 ones' relative L2 from the f32 ones."""
    from unet3d_tpu_torch.train.step import noise_generator, prepare_batch
    params = list(model.parameters())
    start = [b.clone() for b in model.buffers()]
    grads = {}
    for amp in (False, True):
        x, y = prepare_batch(images, labels, device, amp)
        loss = objective(model, x, y, amp, noise_generator(model, seed))
        grads[amp] = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for b, b0 in zip(model.buffers(), start):
                b.copy_(b0)
    finite = all(bool(torch.isfinite(g).all()) for gs in grads.values() for g in gs)
    out = dict(bf16_vs_f32=rel_l2_of(grads[True], grads[False]))
    print(f"{name} gradients (one path: no hand kernel): finite {finite}; bf16 vs f32 rel L2 "
          f"{out['bf16_vs_f32']:.3e}", flush=True)
    check(finite, f"{name}: non-finite gradients")
    return out


def forward_all(model, amp: bool):
    """``make_forward``'s forward (bf16 copies of the parameters and buffers
    under ``amp``), every output of a tuple kept, each as f32."""
    import copy
    net = copy.deepcopy(model).to(torch.bfloat16) if amp else model
    net.eval()

    def forward(x):
        with torch.inference_mode():
            out = net(x.to(torch.bfloat16) if amp else x)
        return [t.float() for t in (out if isinstance(out, tuple) else (out,))]

    return forward


def classifier_input(name, seed, index, device):
    """Phase 15's batch: (2, 96^3, 1) NDHWC, flattened for the FCN."""
    rng = np.random.RandomState(seed + 200 + index)
    x = torch.from_numpy(rng.randn(CLASSIFIER_BATCH, *CLASSIFIER_SHAPE, 1)
                         .astype(np.float32)).to(device)
    return x.reshape(CLASSIFIER_BATCH, -1) if name == "FCN" else x


def phase15_net(index, name, model_cfg, device, seed, card):
    """One classifier at its published widths on phase 15's batch: (b) one
    bf16 and one f32 forward of every output (``forward_all``), kernels
    against the plain path (``plain_convs``) within L2_BOUND, launches by form
    (DenseNet121: ``conv`` once per dense layer, all wgmma;
    RegularizedResNet: ``conv``, its one-channel first conv in the narrow form
    and, under AMP, the f32 decoder's in tf32x3; the others: none), the
    bf16 ``make_forward`` window timed; (c) one bf16 AMP ``make_train_step``
    (CrossEntropyLoss on one-hot targets, ``ProjectionLoss`` for
    ResNetWithDecoder1D; Adam at MONAI's tutorial rate 1e-4) after a
    warm-up: launches by form (DenseNet121's as its calls predict, 116; the
    hybrid's ``conv`` and ``s2_wgrad``); the gradients of every output and
    the running statistics against the plain path (``path_grads`` with
    ``classifier_objective`` under cuDNN deterministic, phase 11's rules;
    where the f32 paths lie GRAD_BOUND_F32 or more apart, each dtype's
    kernels no further from the plain path's f64 gradients than F64_EXCESS
    times the plain path's); step ms, peak memory and a profile (the idle
    share). A net without a hand kernel runs one path: its forwards and its
    gradients (``one_path_grads``) finite."""
    import copy

    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.predict.volumetric import make_forward
    from unet3d_tpu_torch.train.losses import CrossEntropyLoss
    from unet3d_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    config = {"model": dict(model_cfg), "dataset": {"desired_shape": list(CLASSIFIER_SHAPE)}}
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    x = classifier_input(name, seed, index, device)
    kernels = name in CLASSIFIER_KERNEL_NETS
    n = CLASSIFIER_BATCH
    out = dict(params=n_params)
    bf16_allowed = {("conv", "wgmma"), ("conv", "narrow"), ("conv", "tf32x3")}
    outputs = {}
    for amp in (True, False):
        forward = forward_all(model, amp)
        torch.cuda.synchronize()
        reset_launches()
        got = forward(x)
        torch.cuda.synchronize()
        launches, forms = launch_counts(), forms_of(TRAIN_KERNELS)
        if kernels:
            with plain_convs():
                want = forward(x)
            check(launch_counts() == launches, f"{name}: the plain path launched a hand kernel")
        else:
            want = got  # one path: no hand kernel
        rel = max(rel_l2_of([g], [w]) for g, w in zip(got, want))
        dt = "bf16" if amp else "f32"
        msg = (f"{name} ({n_params} params) {dt} forward {tuple(x.shape)}: outputs "
               f"{[tuple(t.shape) for t in got]}, kernels vs plain path rel L2 {rel:.3e}; "
               f"launches {launches}; by form {forms}")
        print(msg, flush=True)
        check(all(bool(torch.isfinite(t).all()) for t in got), f"{msg}: not finite")
        check(rel < L2_BOUND, f"{msg} > {L2_BOUND}")
        check(not launches["s2_wgrad"] and not launches["winograd"], f"{msg}: launches")
        if name == "DenseNet121":
            want_forms = (static_window_forms(model) if amp
                          else {"conv/tf32x3": static_window_forms(model)["conv/wgmma"]})
            check(forms == want_forms, f"{msg}: forms, expected {want_forms}")
        elif kernels:
            check(launches["conv"] > 0, f"{msg}: the conv kernel was not launched")
            check_allowed_forms(f"{name} {dt} forward", bf16_allowed if amp else
                                {("conv", "tf32x3"), ("conv", "tf32x3_narrow")})
        else:
            check(not any(launches.values()), f"{msg}: a hand kernel was launched")
        out[f"{dt}_forward"] = dict(rel_l2=rel, launches=launches, forms=forms)
        outputs[dt] = [tuple(t.shape) for t in got]
        del forward, got, want
    first = outputs["bf16"][0]
    want_first = ((n, model_cfg["n_outputs"], 1) if name == "ResNetWithDecoder1D"
                  else (n, 2))
    check(first == want_first, f"{name}: output {first}, expected {want_first}")
    window = make_forward(model, amp=True)
    paths = LATE_ROUNDS if kernels else ("kernels",)
    times = {p: [] for p in set(paths)}
    for which in paths:
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            times[which].append(cuda_ms(lambda: window(x), reps=3))
    print(f"{name} bf16 forward {tuple(x.shape)} (make_forward): {times} ms [{card}]",
          flush=True)
    out["window_ms"] = times
    del window
    torch.cuda.empty_cache()

    rng = np.random.RandomState(seed + 220 + index)
    xn = x.cpu().numpy()
    images = xn if name == "FCN" else np.ascontiguousarray(np.moveaxis(xn, -1, 1))
    if name == "ResNetWithDecoder1D":
        criterion = ProjectionLoss()
        labels = (rng.randn(*first) / np.sqrt(first[1])).astype(np.float32)
    else:
        criterion = CrossEntropyLoss()
        labels = np.eye(2, dtype=np.float32)[rng.randint(2, size=n)]
    gs = [torch.from_numpy((rng.randn(*shape) / np.sqrt(np.prod(shape[1:])))
                           .astype(np.float32)).to(device) for shape in outputs["f32"][1:]]
    start = copy.deepcopy(model.state_dict())
    step = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-4),
                           amp=True, seed=seed)
    step(images, labels)  # warm-up: cuDNN plans, the allocator
    model.load_state_dict(start)
    torch.cuda.synchronize()
    reset_launches()
    with conv_calls(model) as calls:
        loss = float(step(images, labels))
    torch.cuda.synchronize()
    model.load_state_dict(start)
    step_launches, step_forms = launch_counts(), forms_of(TRAIN_KERNELS)
    msg = (f"{name} train step: loss {loss:.6f}; launches {step_launches}; by form "
           f"{step_forms}")
    print(msg, flush=True)
    check(np.isfinite(loss), f"{name} train loss {loss}")
    if name == "DenseNet121":
        want_forms = expected_forms(calls)
        check(step_forms == want_forms, f"{msg}: forms, expected {want_forms}")
    elif kernels:
        # the step's loss reads the logits alone, so the decoder's convs
        # take no input gradient: no count to predict but that both run
        check(step_launches["conv"] > 0 and step_launches["s2_wgrad"] > 0, f"{msg}: kernels")
        check_allowed_forms(f"{name} train step", bf16_allowed | {("s2_wgrad", "wgmma"),
                                                                  ("s2_wgrad", "narrow")})
    else:
        check(not any(step_launches.values()), f"{msg}: a hand kernel was launched")
    objective = classifier_objective(criterion, gs)
    if kernels:
        # cuDNN deterministic: the gap is the kernels', not cuDNN's own
        # run-to-run spread (which BatchNorm's invariances carry up too)
        with cudnn_deterministic():
            grads = path_grads(model, criterion, images, labels, device, seed,
                               objective=objective, f64=True)
        check_path_grads(name, grads)
    else:
        grads = one_path_grads(name, model, objective, images, labels, device, seed)
    torch.cuda.empty_cache()
    step_times, peaks = {p: [] for p in set(paths)}, {}
    for which in paths:
        one = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-6),
                              amp=True, seed=seed)
        with plain_convs() if which == "plain" else contextlib.nullcontext():
            torch.cuda.reset_peak_memory_stats()
            step_times[which].append(step_ms(one, images, labels, reps=3))
            peaks[which] = torch.cuda.max_memory_allocated() / 2**30
    model.load_state_dict(start)
    step_profile = (profile_device(lambda: step(images, labels),
                                   f"{name} one bf16 train step", card) if kernels else {})
    model.load_state_dict(start)
    print(f"{name} train step (bf16 AMP, batch {n}, {tuple(x.shape[1:])}): {step_times} ms; "
          f"peak memory {peaks} GiB; {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    del model, step, start
    torch.cuda.empty_cache()
    return step_launches, dict(out, step_loss=loss, step_forms=step_forms,
                               kernels_vs_plain=grads, step_ms=step_times, peak_gib=peaks,
                               step_profile=step_profile)


def phase15_large(device, seed, card) -> dict:
    """(d) The deepest and widest factories (``CLASSIFIERS_LARGE``): one bf16
    ``make_forward`` of phase 15's batch each, finite logits of shape (2,
    2), launches by form as the 3^3 FastConvs predict (DenseNet264: one
    ``conv`` a dense layer), timed."""
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.predict.volumetric import make_forward
    out = {}
    for i, (name, model_cfg) in enumerate(CLASSIFIERS_LARGE):
        config = {"model": dict(model_cfg), "dataset": {"desired_shape": list(CLASSIFIER_SHAPE)}}
        model = build_or_load_model_from_config(config, None, device, seed=seed)
        n_params = sum(p.numel() for p in model.parameters())
        x = classifier_input(name, seed, 10 + i, device)
        forward = make_forward(model, amp=True)
        reset_launches()
        y = forward(x)
        torch.cuda.synchronize()
        launches, forms = launch_counts(), forms_of(TRAIN_KERNELS)
        ms = cuda_ms(lambda: forward(x), reps=2)
        print(f"{name} ({n_params} params) bf16 forward {tuple(x.shape)}: logits "
              f"{tuple(y.shape)}, {ms:.3f} ms, launches by form {forms} [{card}]", flush=True)
        # DenseNet264's 130 dense layers run conv once each, the others none
        check(tuple(y.shape) == (CLASSIFIER_BATCH, 2) and bool(torch.isfinite(y).all())
              and forms == static_window_forms(model), f"{name}: logits {tuple(y.shape)}, "
              f"{forms}, expected {static_window_forms(model)}")
        out[name] = dict(params=n_params, ms=ms, forms=forms)
        del model, forward, y
        torch.cuda.empty_cache()
    return out


def icosphere(subdivisions: int):
    """Unit icosphere: vertices (V, 3) float32 and faces (F, 3) int32, each
    face split in four per subdivision (V = 10 * 4^n + 2)."""
    t = (1.0 + 5 ** 0.5) / 2
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
             (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
             (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
             (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
             (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                v = verts[a] + verts[b]
                verts.append(v / np.linalg.norm(v))
                mid[key] = len(verts) - 1
            return mid[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def write_gifti(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """A GIFTI surface of two GZip-Base64 DataArrays: the POINTSET and the
    TRIANGLE."""
    import base64
    import gzip

    def array(intent, data, dtype):
        text = base64.b64encode(gzip.compress(np.ascontiguousarray(data).tobytes())).decode()
        return (f'<DataArray Intent="{intent}" DataType="{dtype}" Dimensionality="2" '
                f'Dim0="{data.shape[0]}" Dim1="{data.shape[1]}" Encoding="GZipBase64Binary" '
                f'ArrayIndexingOrder="RowMajorOrder"><Data>{text}</Data></DataArray>')

    with open(path, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n<GIFTI Version="1.0" '
                'NumberOfDataArrays="2">'
                + array("NIFTI_INTENT_POINTSET", vertices.astype(np.float32),
                        "NIFTI_TYPE_FLOAT32")
                + array("NIFTI_INTENT_TRIANGLE", faces.astype(np.int32), "NIFTI_TYPE_INT32")
                + "</GIFTI>")


@contextlib.contextmanager
def quantizer_inputs(model):
    """Each ``Quantize`` of ``model``'s first forward in the block: its
    flattened input and its codes, {name: (flatten, codes)}."""
    from unet3d_tpu_torch.models.vqvae2 import Quantize
    seen, handles = {}, []
    for name, module in model.named_modules():
        if isinstance(module, Quantize):
            def hook(m, inp, out, name=name):
                if name not in seen:
                    seen[name] = (inp[0].detach().reshape(-1, m.dim).clone(),
                                  out[2].detach().reshape(-1).clone())
            handles.append(module.register_forward_hook(hook))
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def ema_reference(quantizer, before: dict, flatten, codes) -> dict:
    """The EMA update of one quantiser in f64 on the host, from the codebook
    of before and the forward's own flattened input and codes."""
    f = flatten.double().cpu().numpy()
    k, decay, eps = quantizer.n_embed, quantizer.decay, quantizer.eps
    ind = codes.cpu().numpy()
    counts = np.bincount(ind, minlength=k).astype(np.float64)
    sums = np.zeros((k, f.shape[1]))
    np.add.at(sums, ind, f)
    cluster = decay * before["cluster_size"] + (1 - decay) * counts
    avg = decay * before["embed_avg"] + (1 - decay) * sums.T
    n = cluster.sum()
    norm = (cluster + eps) / (n + k * eps) * n
    return {"cluster_size": cluster, "embed_avg": avg, "embed": avg / norm[None, :]}


def codebook_gap(model, before_sd, seen) -> float:
    """The worst relative L2 of the codebook the step left against
    ``ema_reference`` over both quantisers and their three buffers."""
    worst = 0.0
    for name, (flatten, codes) in seen.items():
        q = model.get_submodule(name)
        before = {b: before_sd[f"{name}.{b}"].double().cpu().numpy()
                  for b in ("cluster_size", "embed_avg", "embed")}
        want = ema_reference(q, before, flatten, codes)
        for b, w in want.items():
            got = getattr(q, b).double().cpu().numpy()
            worst = max(worst, float(np.linalg.norm(got - w) / np.linalg.norm(w)))
    return worst


def phase16_vqvae(device, seed, card) -> dict:
    """(a) VQVAE at the JAX defaults (channel 128, 2 res blocks of 32, 512
    codes of 64) on the BraTS window: a bf16 and an f32 forward (finite
    reconstruction, positive ``diff``; no hand kernel: cuDNN convs and
    plain matmuls), the bf16 ``make_forward`` timed and profiled; one
    ``make_train_step`` step in each dtype (MSELoss on the input plus
    ``diff``) with the codebook it leaves held against the EMA formula in
    f64 from the forward's own codes and inputs; the loss over
    ``VQ_LOSS_STEPS`` bf16 steps on the batch; step ms, peak, profile."""
    import copy

    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.predict.volumetric import make_forward
    from unet3d_tpu_torch.train.losses import MSELoss
    from unet3d_tpu_torch.train.step import make_train_step

    config = {"model": dict(VQVAE_MODEL), "dataset": {"desired_shape": list(VQVAE_SHAPE)}}
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.RandomState(seed + 300)
    x = torch.from_numpy(rng.randn(1, *VQVAE_SHAPE, 4).astype(np.float32)).to(device)
    out = dict(params=n_params)
    reset_launches()
    for amp in (True, False):
        rec, diff = forward_all(model, amp)(x)
        dt = "bf16" if amp else "f32"
        msg = (f"VQVAE ({n_params} params) {dt} forward {tuple(x.shape)}: reconstruction "
               f"{tuple(rec.shape)}, diff {float(diff):.6f}")
        print(msg, flush=True)
        check(tuple(rec.shape) == tuple(x.shape) and bool(torch.isfinite(rec).all())
              and np.isfinite(float(diff)) and float(diff) > 0, msg)
        out[f"{dt}_diff"] = float(diff)
    check(not any(launch_counts().values()), f"VQVAE forward launched {launch_counts()}")
    window = make_forward(model, amp=True)
    out["window_ms"] = cuda_ms(lambda: window(x), reps=3)
    out["window_profile"] = profile_device(lambda: window(x), "VQVAE one 128^3 bf16 window",
                                           card)
    print(f"VQVAE bf16 window {tuple(x.shape)}: {out['window_ms']:.3f} ms [{card}]",
          flush=True)
    del window
    images = np.ascontiguousarray(np.moveaxis(x.cpu().numpy(), -1, 1))
    criterion = MSELoss()
    start = copy.deepcopy(model.state_dict())
    for amp in (True, False):
        dt, dtype = ("bf16", torch.bfloat16) if amp else ("f32", torch.float32)
        model.load_state_dict(start)
        step = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-4),
                               amp=amp, seed=seed)
        with quantizer_inputs(model) as seen:
            loss = float(step(images, images))
        gap = codebook_gap(model, start, seen)
        msg = (f"VQVAE {dt} train step: loss {loss:.6f}; codebook vs the EMA formula in f64 "
               f"(the forward's codes and inputs): worst rel L2 {gap:.3e}; codes used "
               f"{[int(c.unique().numel()) for _, c in seen.values()]}")
        print(msg, flush=True)
        check(np.isfinite(loss), msg)
        check(gap < EMA_BOUNDS[dtype], f"{msg} > {EMA_BOUNDS[dtype]}")
        out[f"{dt}_step"] = dict(loss=loss, codebook_rel_l2=gap)
    model.load_state_dict(start)
    step = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=3e-4),
                           amp=True, seed=seed)
    curve = [float(step(images, images)) for _ in range(VQ_LOSS_STEPS)]
    print(f"VQVAE bf16 loss over {VQ_LOSS_STEPS} steps on one batch: {curve}", flush=True)
    check(all(np.isfinite(curve)) and curve[-1] < curve[0], f"VQVAE loss {curve}")
    model.load_state_dict(start)
    torch.cuda.reset_peak_memory_stats()
    out["step_ms"] = step_ms(step, images, images, reps=3)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["step_profile"] = profile_device(lambda: step(images, images),
                                         "VQVAE one bf16 train step", card)
    print(f"VQVAE train step (bf16 AMP, batch 1, 128^3): {out['step_ms']:.3f} ms; peak "
          f"{out['peak_gib']:.2f} GiB [{card}]", flush=True)
    out["loss_curve"] = curve
    del model, step, start
    torch.cuda.empty_cache()
    return out


def phase16_graphcmr(device, seed, card) -> dict:
    """(b) GraphCMR at the JAX defaults (5 layers of 256 channels, a 512-wide
    ResNet-18 encoder) on an icosphere of 10242 vertices (a GIFTI file the
    config's ``reference_filename`` names), batch 2 of one channel at 128^3:
    a bf16 and an f32 forward, the bf16 ``make_forward`` timed; one bf16
    ``make_train_step`` on ``sum(out * g)``: the running statistics finite
    and moved; step ms, peak, profiles."""
    import copy

    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.predict.volumetric import make_forward
    from unet3d_tpu_torch.train.step import make_train_step

    t0 = time.perf_counter()
    verts, faces = icosphere(GRAPH_CMR_SUBDIVISIONS)
    os.makedirs(GRAPH_CMR_DIR, exist_ok=True)
    surface = os.path.join(GRAPH_CMR_DIR, f"ico{GRAPH_CMR_SUBDIVISIONS}.surf.gii")
    write_gifti(surface, verts, faces)
    config = {"model": {"name": "GraphCMR", "reference_filename": surface},
              "dataset": {"desired_shape": list(GRAPH_CMR_SHAPE)}}
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    n_vertices = int(model.ref_vertices.shape[-1])
    n_params = sum(p.numel() for p in model.parameters())
    print(f"GraphCMR ({n_params} params): icosphere {len(verts)} vertices, {len(faces)} faces "
          f"(GIFTI read and adjacency {time.perf_counter() - t0:.1f} s); template "
          f"{model.ref_vertices.dtype} on {model.adjacency.device}", flush=True)
    check(n_vertices == 10242 and len(faces) == 20480
          and model.adjacency.device == device, "GraphCMR template")
    rng = np.random.RandomState(seed + 310)
    x = torch.from_numpy(rng.randn(GRAPH_CMR_BATCH, *GRAPH_CMR_SHAPE, 1)
                         .astype(np.float32)).to(device)
    out = dict(params=n_params, vertices=n_vertices)
    reset_launches()
    for amp in (True, False):
        (y,) = forward_all(model, amp)(x)
        dt = "bf16" if amp else "f32"
        msg = f"GraphCMR {dt} forward {tuple(x.shape)}: vertices {tuple(y.shape)}"
        print(msg, flush=True)
        check(tuple(y.shape) == (GRAPH_CMR_BATCH, 3, n_vertices)
              and bool(torch.isfinite(y).all()), msg)
    check(not any(launch_counts().values()), f"GraphCMR forward launched {launch_counts()}")
    window = make_forward(model, amp=True)
    out["window_ms"] = cuda_ms(lambda: window(x), reps=3)
    out["window_profile"] = profile_device(lambda: window(x), "GraphCMR one bf16 forward",
                                           card)
    print(f"GraphCMR bf16 forward {tuple(x.shape)}: {out['window_ms']:.3f} ms [{card}]",
          flush=True)
    del window
    images = np.ascontiguousarray(np.moveaxis(x.cpu().numpy(), -1, 1))
    labels = (rng.randn(GRAPH_CMR_BATCH, 3, n_vertices)
              / np.sqrt(3 * n_vertices)).astype(np.float32)
    start = copy.deepcopy(model.state_dict())
    stats0 = {k: b.clone() for k, b in model.named_buffers()}
    step = make_train_step(model, ProjectionLoss(),
                           torch.optim.Adam(model.parameters(), lr=1e-4), amp=True, seed=seed)
    loss = float(step(images, labels))
    moved = sum(int(not torch.equal(b, stats0[k])) for k, b in model.named_buffers())
    finite = all(bool(torch.isfinite(b).all()) for b in model.buffers())
    msg = (f"GraphCMR bf16 train step: loss {loss:.6f}; running statistics finite {finite}, "
           f"{moved} of {len(stats0)} moved")
    print(msg, flush=True)
    check(np.isfinite(loss) and finite and moved == len(stats0), msg)
    model.load_state_dict(start)
    torch.cuda.reset_peak_memory_stats()
    out["step_ms"] = step_ms(step, images, labels, reps=3)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["step_profile"] = profile_device(lambda: step(images, labels),
                                         "GraphCMR one bf16 train step", card)
    print(f"GraphCMR train step (bf16 AMP, batch {GRAPH_CMR_BATCH}, 128^3, {n_vertices} "
          f"vertices): {out['step_ms']:.3f} ms; peak {out['peak_gib']:.2f} GiB [{card}]",
          flush=True)
    out["step_loss"] = loss
    del model, step, start
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def launches_in_blocks(model, count):
    """``[n]``: the rise of ``count()`` over the outermost calls of
    ``model``'s remat blocks (``models/remat.remat_blocks``) while the
    context is open. Over a forward, these are the launches that remat's
    recompute runs again in the backward."""
    from unet3d_tpu_torch.models.remat import remat_blocks
    total, marks = [0], {}

    def pre(block, args):
        marks.setdefault(id(block), []).append(count())

    def post(block, args, out):
        start = marks[id(block)].pop()
        if not marks[id(block)]:   # a checkpointed block calls itself inside
            total[0] += count() - start

    handles = [h for b in remat_blocks(model)
               for h in (b.register_forward_pre_hook(pre), b.register_forward_hook(post))]
    try:
        yield total
    finally:
        for h in handles:
            h.remove()


def remat_run(model, criterion, images, labels, device, amp, seed):
    """One step's forward and backward (``forward_loss`` and
    ``autograd.grad``; the noise from the step's generator seeded with
    ``seed``): the gradients, the buffers it leaves, the launches and forms
    of the hand kernels, the peak memory, and the ``conv`` launches of the
    remat blocks' forward."""
    from unet3d_tpu_torch.train.step import forward_loss, noise_generator, prepare_batch
    params = [p for _, p in model.named_parameters()]
    x, y = prepare_batch(images, labels, device, amp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with launches_in_blocks(model, lambda: launch_counts()["conv"]) as in_blocks:
        loss = forward_loss(model, criterion, x, y, amp, noise_generator(model, seed))
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    return dict(loss=float(loss.detach()), grads=grads,
                buffers={k: b.clone() for k, b in model.named_buffers()},
                launches=launch_counts(), forms=forms_of(FAMILY_KERNELS),
                blocks_conv=in_blocks[0], peak=torch.cuda.max_memory_allocated() / 2**30)


def phase16_remat(device, seed, card) -> tuple:
    """(c) ``training.remat`` recomputing the whole model: SegResNetVAE
    (phase 10's config), SegResNetDS (phase 11's) and VQVAE (part a's), each
    built by the config factory with and without remat from one seed, one
    step each way in f32 and bf16 AMP on one batch with the noise drawn
    alike: the gradients within phase 5's bounds of each other, the state
    the step leaves (running statistics within 1e-4 / 1e-2; the codebook
    equal, cuDNN deterministic), the launches by form with and without remat
    (``conv`` exactly the step's without plus its remat blocks' forward
    launches, counted in the step without; ``s2_wgrad`` as often), peak
    memory lower with remat; VQVAE also with its root checkpointed as one
    block, so that the codebook update runs inside the checkpoint (remat's
    blocks leave ``Quantize``, a leaf, outside); SegResNetVAE's remat
    gradients, kernels against the plain path (``family_grads``); bf16 step
    ms each way and a profile of the remat step."""
    from unet3d_tpu_torch.config.factory import (build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.models.remat import checkpointed_blocks, remat_class
    from unet3d_tpu_torch.train.losses import MSELoss
    from unet3d_tpu_torch.train.step import make_train_step, prepare_batch
    from unet3d_tpu_torch.utils.config import load_json

    results, launches = {}, {}
    rng = np.random.RandomState(seed + 320)
    shape = REMAT_SHAPE
    for name, model_cfg in REMAT_NETS:
        config = load_json(CONFIG)
        config["model"] = dict(model_cfg)
        vq = name == "VQVAE"
        criterion = MSELoss() if vq else load_criterion_from_config(config)
        images = rng.randn(1, 4, *shape).astype(np.float32)
        labels = images if vq else (rng.rand(1, 3, *shape) > 0.5).astype(np.float32)
        # "root": the VQVAE checkpointed as one block, its codebook inside
        variants = ("remat", "root") if vq else ("remat",)
        models = {which: build_or_load_model_from_config(config, None, device, seed=seed,
                                                         remat=which == "remat")
                  for which in ("plain", *variants)}
        if vq:
            models["root"].__class__ = remat_class(type(models["root"]))
        check(all(checkpointed_blocks(models[which]) and models[which].state_dict().keys()
                  == models["plain"].state_dict().keys() for which in variants),
              f"{name}: remat model")
        start = {k: v.clone() for k, v in models["plain"].state_dict().items()}
        out = {}
        for amp in (False, True):
            dt, dtype = ("bf16", torch.bfloat16) if amp else ("f32", torch.float32)
            runs = {}
            with cudnn_deterministic():
                # each run once to warm up, then the one kept
                for which in ("plain", *variants) * 2:
                    models[which].load_state_dict(start)
                    runs[which] = remat_run(models[which], criterion, images, labels, device,
                                            amp, seed)
            names = [n for n, _ in models["plain"].named_parameters()]
            keys = sorted(runs["plain"]["buffers"])
            p = runs["plain"]["launches"]
            for which in variants:
                run = runs[which]
                rel, worst, worst_name = grad_gap(run["grads"], runs["plain"]["grads"], names)
                bound = GRAD_BOUND_BF16 if amp else GRAD_BOUND_F32
                if vq:
                    state_gap = max((float((run["buffers"][k] - runs["plain"]["buffers"][k])
                                           .abs().max()) for k in keys), default=0.0)
                else:
                    state_gap = rel_l2_of([run["buffers"][k] for k in keys],
                                          [runs["plain"]["buffers"][k] for k in keys]) \
                        if keys else 0.0
                label = f"{name} {dt} step, {'root as one block' if which == 'root' else 'remat'}"
                msg = (f"{label} vs not: loss {run['loss']:.6f} / {runs['plain']['loss']:.6f}; "
                       f"gradients rel L2 {rel:.3e} (worst {worst_name} {worst:.3e}); "
                       f"{'codebook max abs' if vq else 'statistics rel L2'} {state_gap:.3e}; "
                       f"launches {run['launches']} / {p} (remat blocks' forward conv "
                       f"{runs['plain']['blocks_conv']}); by form {run['forms']} / "
                       f"{runs['plain']['forms']}; peak {run['peak']:.2f} / "
                       f"{runs['plain']['peak']:.2f} GiB [{card}]")
                print(msg, flush=True)
                check(rel < bound, f"{msg}: gradients > {bound}")
                check(state_gap == 0.0 if vq else state_gap < BN_STATS_BOUNDS[dtype],
                      f"{msg}: state after the step")
                if which == "root":   # one checkpoint around the whole forward keeps the peak
                    out[f"{dt}_root"] = dict(grad_rel_l2=rel, state_gap=state_gap,
                                             peak_gib=run["peak"])
                    continue
                r = run["launches"]
                check(r["conv"] == p["conv"] + runs["plain"]["blocks_conv"]
                      and run["blocks_conv"] == runs["plain"]["blocks_conv"]
                      and r["s2_wgrad"] == p["s2_wgrad"]
                      and (vq or runs["plain"]["blocks_conv"] > 0),
                      f"{msg}: the recompute's conv launches")
                check(run["peak"] < runs["plain"]["peak"], f"{msg}: peak memory")
                if name == "SegResNetVAE":
                    check(r["s2_wgrad"] > 0, f"{msg}: s2_wgrad not launched")
                    if amp:
                        check_family_forms(f"SegResNetVAE {dt} remat step")
                    else:
                        check_allowed_forms(f"SegResNetVAE {dt} remat step",
                                            {("conv", "tf32x3"), ("s2_wgrad", "tf32x3")})
                out[dt] = dict(
                    loss=[run["loss"], runs["plain"]["loss"]], grad_rel_l2=rel,
                    state_gap=state_gap, launches_remat=r, launches_plain=p,
                    blocks_conv=runs["plain"]["blocks_conv"], forms_remat=run["forms"],
                    forms_plain=runs["plain"]["forms"], peak_gib_remat=run["peak"],
                    peak_gib_plain=runs["plain"]["peak"])
            if amp:
                launches[name] = runs["remat"]["launches"]
            del runs
            torch.cuda.empty_cache()
        model = models["remat"]
        if name == "SegResNetVAE":
            for amp, bound in ((False, GRAD_BOUND_F32), (True, GRAD_BOUND_BF16)):
                model.load_state_dict(start)
                x, y = prepare_batch(images, labels, device, amp)
                grel, worst, worst_name = family_grads(model, criterion, x, y, amp, seed)
                msg = (f"SegResNetVAE remat gradients {'bf16' if amp else 'f32'}, kernels vs "
                       f"plain path: rel L2 {grel:.3e}; worst {worst_name} {worst:.3e}")
                print(msg, flush=True)
                check(grel < bound, f"{msg} > {bound}")
                out[f"kernels_vs_plain_{'bf16' if amp else 'f32'}"] = grel
        times = {}
        for which in ("plain", "remat", "remat", "plain"):
            models[which].load_state_dict(start)
            one = make_train_step(models[which], criterion,
                                  torch.optim.Adam(models[which].parameters(), lr=1e-6),
                                  amp=True, seed=seed)
            times.setdefault(which, []).append(step_ms(one, images, labels, reps=3))
        model.load_state_dict(start)
        one = make_train_step(model, criterion, torch.optim.Adam(model.parameters(), lr=1e-6),
                              amp=True, seed=seed)
        out["step_profile_remat"] = profile_device(lambda: one(images, labels),
                                                   f"{name} one bf16 remat train step", card)
        print(f"{name} bf16 train step (batch 1, {shape}): remat {times['remat']} ms, without "
              f"{times['plain']} ms [{card}]", flush=True)
        out["step_ms"] = times
        results[name] = out
        del models, model, one, start
        torch.cuda.empty_cache()
    return launches, results


def dp_model(model_cfg, device, seed):
    """The BraTS config's model (its model section ``model_cfg`` when given)
    built by the config factory from ``seed``, and the config's criterion."""
    from unet3d_tpu_torch.config.factory import (build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.utils.config import load_json
    config = load_json(CONFIG)
    if model_cfg is not None:
        config["model"] = dict(model_cfg)
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    return model, load_criterion_from_config(config)


def dp_batch(seed):
    """Phase 17's global batch: DP_BATCH items of 4 x 128^3, 3 labels."""
    shape = (128, 128, 128)
    rng = np.random.RandomState(seed + 70)
    return (torch.from_numpy(rng.randn(DP_BATCH, 4, *shape).astype(np.float32)),
            torch.from_numpy((rng.rand(DP_BATCH, 3, *shape) > 0.5).astype(np.float32)))


def dp_step(model, criterion, amp, mesh=None, lr=1.0):
    """``make_train_step`` with SGD at ``lr``, or ``make_sharded_train_step``
    on ``mesh`` fed this rank's share of each global batch."""
    from unet3d_tpu_torch.parallel.mesh import make_sharded_train_step, shard_batch
    from unet3d_tpu_torch.train.step import make_train_step
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    if mesh is None:
        return make_train_step(model, criterion, opt, amp=amp)
    step = make_sharded_train_step(model, criterion, opt, mesh, amp=amp)
    return lambda images, labels: step(shard_batch(images, mesh), shard_batch(labels, mesh))


def dp_update(model, criterion, images, labels, amp, mesh=None) -> dict:
    """One SGD step (lr 1) from the model's weights, which are put back
    after it: each parameter's update and each buffer after the step (f32,
    on the host), the loss and the training kernels' launches in the step."""
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = dp_step(model, criterion, amp, mesh)
    torch.cuda.synchronize()
    reset_launches()
    loss = float(step(images, labels))
    torch.cuda.synchronize()
    launches = launch_counts()
    out = dict(loss=loss, launches={k: launches[k] for k in TRAIN_KERNELS},
               updates={k: (p.detach() - before[k]).float().cpu()
                        for k, p in model.named_parameters()},
               buffers={k: b.detach().float().cpu() for k, b in model.named_buffers()})
    model.load_state_dict(before)
    return out


def dict_gap(got: dict, want: dict) -> float:
    """Relative L2 of ``got`` against ``want`` over all their tensors."""
    diff = sum(float((got[k] - want[k]).double().square().sum()) for k in want)
    norm = sum(float(want[k].double().square().sum()) for k in want)
    return (diff / norm) ** 0.5


@contextlib.contextmanager
def timed_all_reduce(spans):
    """Each gradient all-reduce of the sharded step (``parallel.mesh.
    average_gradients``) timed by the host clock between synchronisations."""
    from unet3d_tpu_torch.parallel import mesh as mesh_module
    real = mesh_module.average_gradients

    def timed(model, loss, mesh, *whole):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(model, loss, mesh, *whole)
        torch.cuda.synchronize()
        spans.append((time.perf_counter() - t0) * 1e3)
        return out

    mesh_module.average_gradients = timed
    try:
        yield
    finally:
        mesh_module.average_gradients = real


def dp_step_ms(model, criterion, images, labels, amp, mesh=None, steps=DP_TIMED_STEPS):
    """ms per step (host clock, synchronised) over ``steps`` steps at a tiny
    lr after one warm-up, and the gradient all-reduce's ms per step (None
    without a mesh)."""
    step = dp_step(model, criterion, amp, mesh, lr=1e-9)
    step(images, labels)
    spans = []
    with timed_all_reduce(spans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(images, labels)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps, (sum(spans) / len(spans) if spans else None)


def phase17_world1(device, seed, card) -> tuple:
    """(a) The sharded step at world size 1 over NCCL against the plain
    step from the same weights (bf16 AMP, batch 2): the updates, the
    launches, step and all-reduce ms, a profile of the sharded step."""
    from unet3d_tpu_torch.parallel import launch
    from unet3d_tpu_torch.parallel.mesh import make_mesh

    model, criterion = dp_model(None, device, seed)
    images, labels = dp_batch(seed)
    plain = [dp_update(model, criterion, images, labels, True) for _ in range(2)]
    spread = dict_gap(plain[1]["updates"], plain[0]["updates"])

    def world1():
        mesh = make_mesh()
        sharded = dp_update(model, criterion, images, labels, True, mesh)
        times, spans = {"plain": [], "sharded": []}, []
        for which in ("plain", "sharded", "sharded", "plain"):
            ms, span = dp_step_ms(model, criterion, images, labels, True,
                                  mesh if which == "sharded" else None)
            times[which].append(ms)
            if span is not None:
                spans.append(span)
        step = dp_step(model, criterion, True, mesh, lr=1e-9)
        profile = profile_device(lambda: step(images, labels),
                                 "one bf16 sharded train step (world size 1, NCCL)", card)
        return dict(mesh.shape), sharded, times, spans, profile

    shape, sharded, times, spans, profile = launch.launch(
        world1, (), launch.Plan(1, {"data": 1}, {}), device=device, backend="nccl")[0]
    gap = dict_gap(sharded["updates"], plain[0]["updates"])
    bound = max(2 * spread, DP_WORLD1_FLOOR)
    n_grad = sum(v.numel() for v in sharded["updates"].values())
    print(f"data parallel (a) world size 1 over NCCL, mesh {shape}, batch {DP_BATCH} bf16: "
          f"updates vs make_train_step rel L2 {gap:.3e} (plain run-to-run {spread:.3e}, bound "
          f"{bound:.1e}); launches sharded {sharded['launches']} plain {plain[0]['launches']}; "
          f"step ms sharded {times['sharded']} plain {times['plain']}; all-reduce {spans} ms "
          f"of {4 * (n_grad + 1)} bytes a step [{card}]", flush=True)
    check(gap <= bound, f"world size 1: updates rel L2 {gap:.3e} > {bound:.1e}")
    check(sharded["launches"] == plain[0]["launches"],
          f"world size 1 launches {sharded['launches']} != {plain[0]['launches']}")
    check(all(sharded["launches"][k] > 0 for k in TRAIN_KERNELS),
          f"a kernel was not launched in the sharded step: {sharded['launches']}")
    check(np.isfinite(sharded["loss"]) and abs(sharded["loss"] - plain[0]["loss"]) < 1e-3,
          f"sharded loss {sharded['loss']} vs {plain[0]['loss']}")
    del model
    torch.cuda.empty_cache()
    return sharded["launches"], dict(
        update_rel_l2=gap, plain_run_to_run=spread,
        step_ms={k: sum(v) / len(v) for k, v in times.items()}, step_ms_runs=times,
        all_reduce_ms=spans, all_reduce_bytes=4 * (n_grad + 1), profile=profile)


def phase17_rank(path, seed):
    """One of (b)'s and (c)'s two ranks (a spawned process sharing the card
    over gloo): its share of the global batch through the sharded step, the
    updates and statistics against the single-process references saved in
    ``path``; its launches, bf16 step ms and all-reduce ms."""
    from unet3d_tpu_torch.parallel import distributed
    from unet3d_tpu_torch.parallel.mesh import make_mesh, shard_batch

    device = distributed.rank_device()
    ref = torch.load(path)
    mesh = make_mesh()
    images, labels = ref["images"], ref["labels"]
    model, criterion = dp_model(None, device, seed)
    out = {"rank": mesh.rank, "items": shard_batch(torch.arange(DP_BATCH), mesh).tolist(),
           "state": state_digest(model)}
    for name, amp in (("f32", False), ("bf16", True)):
        run = dp_update(model, criterion, images, labels, amp, mesh)
        out[name] = dict_gap(run["updates"], {k[len(name) + 1:]: v for k, v in ref.items()
                                              if k.startswith(name + "/")})
        out[f"launches_{name}"] = run["launches"]
    out["step_ms"], out["all_reduce_ms"] = dp_step_ms(model, criterion, images, labels, True,
                                                      mesh)
    del model
    torch.cuda.empty_cache()
    ds_model, ds_criterion = dp_model(SEGRESNET_DS_MODEL, device, seed)
    run = dp_update(ds_model, ds_criterion, images, labels, False, mesh)
    out["stats"] = dict_gap(run["buffers"], {k[len("stats/"):]: v for k, v in ref.items()
                                             if k.startswith("stats/")})
    return out


def phase17_two_ranks(device, seed, card) -> tuple:
    """(b) and (c): the single-process batch-2 references here, then two
    ranks sharing the card over gloo (``phase17_rank``). Every step starts
    from the seeded initial weights (``dp_update`` puts them back), which
    every run reaches bit for bit: the ranks' ``state_digest`` is checked
    against the reference's. The f32 updates still vary from run to run with
    the step's own atomics (the kernels' f32 statistics), which the bound's
    spread term measures."""
    from unet3d_tpu_torch.parallel import launch

    images, labels = dp_batch(seed)
    ref = {"images": images, "labels": labels}
    model, criterion = dp_model(None, device, seed)
    state = state_digest(model)  # the seeded initial weights, the same every run
    plain = {}
    for name, amp in (("f32", False), ("bf16", True)):
        plain[name] = dp_update(model, criterion, images, labels, amp)
        ref.update({f"{name}/{k}": v for k, v in plain[name]["updates"].items()})
    # the f32 kernels' own run-to-run spread (their statistics' atomics through
    # the leaky-ReLU kinks): two ranks cannot come nearer than the step to itself
    spread = dict_gap(dp_update(model, criterion, images, labels, False)["updates"],
                      plain["f32"]["updates"])
    bounds = dict(DP_BOUNDS, f32=max(DP_BOUNDS["f32"], 2 * spread))
    plain_ms, _ = dp_step_ms(model, criterion, images, labels, True)
    del model
    ds_model, ds_criterion = dp_model(SEGRESNET_DS_MODEL, device, seed)
    ref.update({f"stats/{k}": v for k, v in dp_update(
        ds_model, ds_criterion, images, labels, False)["buffers"].items()})
    del ds_model
    torch.cuda.empty_cache()
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    path = os.path.join(DP_DIR, "references.pt")
    torch.save(ref, path)
    t0 = time.perf_counter()
    ranks = launch.launch(phase17_rank, (path, seed), launch.Plan(2, {"data": 2}, {}),
                          device=torch.device("cuda", device.index or 0), backend="gloo")
    seconds = time.perf_counter() - t0
    shutil.rmtree(DP_DIR, ignore_errors=True)
    for r in ranks:
        print(f"data parallel (b, c) rank {r['rank']} of 2 over gloo on one card, items "
              f"{r['items']}: updates vs the batch-{DP_BATCH} step rel L2 f32 {r['f32']:.3e} "
              f"bf16 {r['bf16']:.3e}; SegResNetDS running statistics (f32) {r['stats']:.3e}; "
              f"launches {r['launches_bf16']}; bf16 step {r['step_ms']:.1f} ms (two processes "
              f"on one card, not a scaling figure), all-reduce {r['all_reduce_ms']:.1f} ms; "
              f"weights {r['state']} [{card}]", flush=True)
        check(r["state"] == state, f"rank {r['rank']} weights {r['state']} != the "
              f"reference's {state}")
        for name in ("f32", "bf16"):
            check(r[name] <= bounds[name],
                  f"rank {r['rank']} {name} updates rel L2 {r[name]:.3e} > {bounds[name]:.1e}")
            check(r[f"launches_{name}"] == plain[name]["launches"],
                  f"rank {r['rank']} {name} launches {r[f'launches_{name}']} != "
                  f"{plain[name]['launches']}")
        check(r["stats"] <= DP_STATS_BOUND,
              f"rank {r['rank']} running statistics rel L2 {r['stats']:.3e} > {DP_STATS_BOUND}")
    check(sorted(i for r in ranks for i in r["items"]) == list(range(DP_BATCH)),
          f"the ranks' items {[r['items'] for r in ranks]}")
    print(f"data parallel (b, c): the two ranks' run {seconds:.1f} s (spawn, library load, "
          f"steps); the single-process batch-{DP_BATCH} f32 step's run-to-run spread "
          f"{spread:.3e} (f32 bound {bounds['f32']:.1e}), its bf16 step {plain_ms:.1f} ms; "
          f"weights {state} [{card}]", flush=True)
    return ranks[0]["launches_bf16"], dict(
        ranks=[{k: v for k, v in r.items() if not k.startswith("launches_")} for r in ranks],
        plain_f32_run_to_run=spread, plain_step_ms=plain_ms, seconds=seconds, state=state)


def phase17_train_cli(card, cases) -> tuple:
    """(d) The train CLI with ``--ngpus 2`` on the one card: clamped to one
    rank (world size 1 over NCCL), one epoch on two of phase 8's cases, the
    log written once, the training kernels launched."""
    from unet3d_tpu_torch.scripts import train as train_cli
    from unet3d_tpu_torch.train.train import read_training_log
    from unet3d_tpu_torch.utils.config import dump_json, load_json

    shutil.rmtree(DP_CLI_DIR, ignore_errors=True)
    os.makedirs(DP_CLI_DIR)
    config = load_json(CONFIG)
    for key in ("cross_validation", "bratsvalidation_filenames"):
        config.pop(key, None)
    config["training_filenames"] = cases[:2]
    config["training"]["n_epochs"] = 1
    config_file = os.path.join(DP_CLI_DIR, "dp.json")
    dump_json(config, config_file)
    out = os.path.join(DP_CLI_DIR, "out")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    result = train_cli.main(["--config_filename", config_file, "--output_dir", out,
                             "--ngpus", "2", "--n_examples", "0"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: launch_counts()[k] for k in TRAIN_KERNELS}
    rows = read_training_log(os.path.join(out, "dp", "training_log.csv"))
    files = sorted(os.listdir(os.path.join(out, "dp")))
    print(f"data parallel (d) train CLI --ngpus 2 on {torch.cuda.device_count()} card: world "
          f"size {result['world_size']}, log {rows}, files {files}, launches {launches}, "
          f"{seconds:.1f} s [{card}]", flush=True)
    check(result["world_size"] == 1, f"--ngpus 2 on one card ran {result['world_size']} ranks")
    check(len(rows) == 1 and np.isfinite(rows[0][1]), f"train CLI log {rows}")
    check(all(launches[k] > 0 for k in TRAIN_KERNELS), f"train CLI launches {launches}")
    shutil.rmtree(DP_CLI_DIR, ignore_errors=True)
    return launches, dict(seconds=seconds, log=rows)



def halo_counts() -> dict:
    """Launches of each kernel's D-halo mode by pads (``"conv_stats(1, 0)"``)."""
    from unet3d_tpu_torch.ops import conv3d_kernel, s2_wgrad_kernel
    return {f"{v}{pads}": n for (v, pads), n in sorted(
        {**conv3d_kernel.HALO_LAUNCHES, **s2_wgrad_kernel.HALO_LAUNCHES}.items())}


def halo_by_kernel(counts: dict) -> dict:
    """``halo_counts`` summed by kernel."""
    return {v: sum(n for k, n in counts.items() if k.startswith(v + "("))
            for v in TRAIN_KERNELS}


def halo_bound(variant, d_in, d_out, hw, cin, cout, dtype=torch.bfloat16):
    """bound_ms of a 3x3x3 conv variant in the D-halo mode: ``d_in`` planes of
    x read, ``d_out`` planes of y written, hw x hw each."""
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (hw * hw * (d_in * cin + d_out * cout) + 27 * cin * cout)
    nbytes += (8 * cout if variant != "conv" else 0) + (8 * cin if variant == "block_stats"
                                                         else 0)
    return bound_ms(2.0 * d_out * hw * hw * 27 * cin * cout, nbytes, dtype)


def phase18_kernels(device, gen) -> dict:
    """Each kernel's D-halo mode against its plain version at the BraTS
    DynUNet's slab shapes of two ranks (HALO_SHAPES, S2_HALO_SHAPES; bf16
    and f32, phase 2's bounds), the bf16 calls timed beside the plain
    composition (the activation, F.pad on D, cuDNN, the statistics), one
    PyTorch call (cuDNN's conv on the padded input: the conv alone) and
    the bound."""
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W
    from unet3d_tpu_torch.ops.conv3d import conv3d_torch, pad_d
    from unet3d_tpu_torch.utils.device import full_f32

    kernel = {"conv": K.conv3x3x3, "conv_stats": K.conv3x3x3_with_stats,
              "block_stats": K.conv3x3x3_block_with_stats}
    plain = {"conv": K.conv3d_reference, "conv_stats": K.conv3d_with_stats_reference,
             "block_stats": K.conv3d_block_with_stats_reference}
    report = {}
    for label, depth, hw, cin, cout, variant, pads in HALO_SHAPES:
        d_in = depth + 2 - sum(pads)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(1, d_in, hw, hw, cin, device=device, generator=gen).to(dtype)
            w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
                 / (27 * cin) ** 0.5).to(dtype)
            inv = torch.rand(1, cin, device=device, generator=gen) + 0.5
            shift = torch.randn(1, cin, device=device, generator=gen) * 0.3
            args = (x, w, inv, shift) if variant == "block_stats" else (x, w)
            got = kernel[variant](*args, pads=pads)
            want = plain[variant](*args, pads=pads)
            got_y = got if variant == "conv" else got[0]
            want_y = want if variant == "conv" else want[0]
            torch.cuda.synchronize()
            check(got_y.shape[1] == depth, f"{label}: {got_y.shape[1]} planes, not {depth}")
            rel = rel_max(got_y, want_y)
            msg = (f"halo {variant:11s} {label:34s} pads {pads} {str(dtype)[6:]:8s} "
                   f"{K.kernel_form(x, w):6s} y rel {rel:.3e}")
            check(rel < BOUNDS[dtype], f"{msg} > {BOUNDS[dtype]}")
            if variant != "conv":
                s_err = stats_err(*got)
                msg += f" stats rel {s_err:.3e}"
                check(s_err < STATS_BOUND, f"{msg} > {STATS_BOUND}")
            if dtype == torch.bfloat16:
                xp = pad_d(x, pads)

                def composition():
                    z = x
                    if variant == "block_stats":
                        z = F.leaky_relu(x * inv[:, None, None, None, :].to(x.dtype)
                                         + shift[:, None, None, None, :].to(x.dtype), 0.01)
                    y = conv3d_torch(pad_d(z, pads), w, (1, 1, 1), ((0, 0), (1, 1), (1, 1)))
                    return y if variant == "conv" else (y, *K.instance_stats(y))

                wn, xn = w.permute(4, 3, 0, 1, 2).contiguous(), xp.permute(0, 4, 1, 2, 3)
                ms = device_ms(lambda: kernel[variant](*args, pads=pads))
                plain_ms = device_ms(composition)
                library_ms = device_ms(lambda: F.conv3d(xn, wn, padding=(0, 1, 1)))
                bms, bound_by = halo_bound(variant, d_in, depth, hw, cin, cout)
                msg += (f" | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv3d "
                        f"{library_ms:.3f} ms, bound {bms:.3f} ms ({bound_by}, "
                        f"{bms / ms:.1%})")
                if label == HALO_TIMED_AT[variant]:
                    report[variant] = dict(
                        ms=ms, plain_ms=plain_ms, shape=f"{label} pads {pads}",
                        bound_ms=bms, bound_by=bound_by, library_ms=library_ms,
                        max_abs_err=(got_y.float() - want_y.float()).abs().max().item())
            print(msg, flush=True)
            del x, w, got, want
    for label, depth, hw, cin, cout, pad_lo in S2_HALO_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(1, depth + 1 - pad_lo, hw, hw, cin, device=device,
                            generator=gen).to(dtype)
            g = torch.randn(1, depth // 2, hw // 2, hw // 2, cout, device=device,
                            generator=gen).to(dtype)
            got, want = W.s2_wgrad(x, g, pad_lo), W.s2_wgrad_reference(x, g, pad_lo)
            torch.cuda.synchronize()
            rel = rel_max(got, want)
            msg = (f"halo s2_wgrad {label:34s} pad_lo {pad_lo} {str(dtype)[6:]:8s} "
                   f"{W.kernel_form(x, g):5s} rel {rel:.3e}")
            check(rel < S2_BOUND, f"{msg} > {S2_BOUND}")
            if dtype == torch.bfloat16:
                xn = pad_d(x, (pad_lo, 1)).permute(0, 4, 1, 2, 3)
                gn = g.permute(0, 4, 1, 2, 3)

                def cudnn_dw():
                    with full_f32(gn):
                        return torch.nn.grad.conv3d_weight(xn, (cout, cin, 3, 3, 3), gn,
                                                           stride=2, padding=(0, 1, 1))
                ms = device_ms(lambda: W.s2_wgrad(x, g, pad_lo))
                plain_ms = device_ms(cudnn_dw)
                half = (depth // 2) * (hw // 2) ** 2
                bms, bound_by = bound_ms(2.0 * half * 27 * cin * cout,
                                         2 * (x[0, ..., 0].numel() * cin + half * cout)
                                         + 4 * 27 * cin * cout)
                msg += (f" | kernel {ms:.3f} ms, cuDNN (on x padded) {plain_ms:.3f} ms, bound "
                        f"{bms:.3f} ms ({bound_by}, {bms / ms:.1%})")
                report.setdefault("s2_wgrad", dict(
                    ms=ms, plain_ms=plain_ms, library_ms=plain_ms,
                    shape=f"{label} pad_lo {pad_lo}", bound_ms=bms, bound_by=bound_by,
                    max_abs_err=(got - want).abs().max().item()))
            print(msg, flush=True)
            del x, g, got, want
    torch.cuda.empty_cache()
    return report


def space_batch(seed):
    """Phase 18's inputs: one 4 x 128^3 window, and a batch of one item
    with 3 binary labels."""
    rng = np.random.RandomState(seed + 80)
    shape = SPACE_SHAPE
    return (torch.from_numpy(rng.randn(1, *shape, 4).astype(np.float32)),
            torch.from_numpy(rng.randn(1, 4, *shape).astype(np.float32)),
            torch.from_numpy((rng.rand(1, 3, *shape) > 0.5).astype(np.float32)))


def phase18_rank(path, seed):
    """One of (a)'s and (b)'s two ranks (a spawned process sharing the card
    over gloo, ``{"space": 2}``): the window's forward on its D slab,
    gathered, and one bf16 train step, against the single-device references
    in ``path``; launches by kernel and by halo mode and pads."""
    from unet3d_tpu_torch.parallel import distributed
    from unet3d_tpu_torch.parallel.mesh import make_mesh, make_sharded_forward

    device = distributed.rank_device()
    ref = torch.load(path)
    mesh = make_mesh({"space": SPACE_RANKS})
    model, criterion = dp_model(None, device, seed)
    forward = make_sharded_forward(model, mesh, amp=True)
    window = ref["window"].to(device)
    forward(window)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    got = forward(window).float().cpu()
    torch.cuda.synchronize()
    out = {"rank": mesh.space_rank, "window_launches": dict(launch_counts()),
           "window_halo": halo_counts(), "window_ms": cuda_ms(lambda: forward(window), reps=3)}
    want = ref["forward"]
    out["window"] = float((got - want).norm() / want.norm())
    out["window_shape"] = list(got.shape)
    del forward
    run = dp_update(model, criterion, ref["images"], ref["labels"], True, mesh)
    out["bf16"] = dict_gap(run["updates"], {k[5:]: v for k, v in ref.items()
                                            if k.startswith("bf16/")})
    out["launches_bf16"], out["halo_bf16"] = run["launches"], halo_counts()
    out["loss"] = run["loss"]
    out["step_ms"], out["all_reduce_ms"] = dp_step_ms(model, criterion, ref["images"],
                                                      ref["labels"], True, mesh)
    return out


def phase18_space(device, seed, card) -> tuple:
    """(a) and (b): the single-device references here (the bf16 window
    forward; the bf16 step's updates, twice for its own spread), then two
    ranks sharing the card over gloo on ``{"space": 2}``
    (``phase18_rank``)."""
    from unet3d_tpu_torch.parallel import launch
    from unet3d_tpu_torch.predict.volumetric import make_forward

    window, images, labels = space_batch(seed)
    model, criterion = dp_model(None, device, seed)
    forward = make_forward(model, amp=True)
    ref = {"window": window, "images": images, "labels": labels,
           "forward": forward(window.to(device)).float().cpu()}
    del forward
    plain = dp_update(model, criterion, images, labels, True)
    ref.update({f"bf16/{k}": v for k, v in plain["updates"].items()})
    spread = dict_gap(dp_update(model, criterion, images, labels, True)["updates"],
                      plain["updates"])
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(SPACE_DIR, ignore_errors=True)
    os.makedirs(SPACE_DIR)
    path = os.path.join(SPACE_DIR, "references.pt")
    torch.save(ref, path)
    t0 = time.perf_counter()
    ranks = launch.launch(phase18_rank, (path, seed),
                          launch.Plan(SPACE_RANKS, {"space": SPACE_RANKS}, {}),
                          device=torch.device("cuda", device.index or 0), backend="gloo")
    seconds = time.perf_counter() - t0
    shutil.rmtree(SPACE_DIR, ignore_errors=True)
    for r in ranks:
        print(f"space axis (a) rank {r['rank']} of {SPACE_RANKS} over gloo on one card: the "
              f"128^3 bf16 window on 64 planes, gathered, vs the single-device forward rel L2 "
              f"{r['window']:.3e} (bound {L2_BOUND}); launches {r['window_launches']}, halo "
              f"modes {r['window_halo']}; {r['window_ms']:.1f} ms a window (two processes "
              f"on one card) [{card}]", flush=True)
        print(f"space axis (b) rank {r['rank']}: one bf16 step (batch 1), updates vs the "
              f"single-device step rel L2 {r['bf16']:.3e} (bound {SPACE_BF16_BOUND}; the "
              f"single-device bf16 step's own run-to-run spread {spread:.3e}); loss "
              f"{r['loss']:.6f} vs {plain['loss']:.6f}; launches {r['launches_bf16']} (single "
              f"device {plain['launches']}), halo modes {r['halo_bf16']}; step "
              f"{r['step_ms']:.1f} ms, all-reduce {r['all_reduce_ms']:.1f} ms [{card}]",
              flush=True)
        check(r["window_shape"] == [1, *SPACE_SHAPE, 3], f"window shape {r['window_shape']}")
        check(r["window"] <= L2_BOUND, f"rank {r['rank']} window rel L2 {r['window']:.3e}")
        check(r["bf16"] <= SPACE_BF16_BOUND,
              f"rank {r['rank']} bf16 updates rel L2 {r['bf16']:.3e} > {SPACE_BF16_BOUND}")
        check(np.isfinite(r["loss"]) and abs(r["loss"] - plain["loss"]) < 1e-2,
              f"rank {r['rank']} loss {r['loss']} vs {plain['loss']}")
    # rank 0 holds the volume's first planes: its stride-2 convs have no
    # plane below and run s2_wgrad with pad_lo 1, the SAME mode
    halo = {k: sum(halo_by_kernel(r["halo_bf16"])[k] for r in ranks) for k in TRAIN_KERNELS}
    window_halo = {k: sum(halo_by_kernel(r["window_halo"])[k] for r in ranks)
                   for k in PREDICT_KERNELS}
    print(f"space axis (a, b): the two ranks' run {seconds:.1f} s (spawn, library load, "
          f"forwards, steps); halo-mode launches of the two ranks' steps {halo}, windows "
          f"{window_halo} [{card}]", flush=True)
    check(all(halo[k] > 0 for k in TRAIN_KERNELS),
          f"a kernel's halo mode was not launched in the ranks' steps: {halo}")
    check(all(window_halo[k] > 0 for k in PREDICT_KERNELS),
          f"a halo mode was not launched in the ranks' windows: {window_halo}")
    return halo, dict(ranks=ranks, plain_bf16_run_to_run=spread, seconds=seconds,
                      plain_loss=plain["loss"])


def phase18_predict_cli(card, cases) -> dict:
    """(c) The predict CLI at ``--ngpus 2`` on the one card: JAX's default
    plan, the space axis, clamped to one rank; one of phase 8's cases, the
    seeded model (no checkpoint), sigmoid."""
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.scripts import predict
    from unet3d_tpu_torch.utils.config import dump_json, load_json

    shutil.rmtree(SPACE_CLI_DIR, ignore_errors=True)
    os.makedirs(SPACE_CLI_DIR)
    config = load_json(CONFIG)
    config["test_filenames"] = [{"image": cases[0]["image"]}]
    config_file = os.path.join(SPACE_CLI_DIR, "space.json")
    dump_json(config, config_file)
    plan = predict.predict_plan(config, {"n_gpus": 2}, "cuda")
    out = os.path.join(SPACE_CLI_DIR, "out")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    predict.main(["--config_filename", config_file, "--model_filename",
                  os.path.join(SPACE_CLI_DIR, "none.npz"), "--output_directory", out,
                  "--group", "test", "--activation", "sigmoid", "--ngpus", "2"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: launch_counts()[k] for k in PREDICT_KERNELS}
    written = sorted(os.listdir(os.path.join(out, "predictions")))
    print(f"space axis (c) predict CLI --ngpus 2 on {torch.cuda.device_count()} card: plan "
          f"{plan.mesh} ({plan.nprocs} rank), wrote {written}, launches {launches}, "
          f"{seconds:.1f} s [{card}]", flush=True)
    check(plan.mesh == {"space": 1} and plan.nprocs == 1, f"predict plan {plan}")
    check(len(written) == 1, f"predict CLI wrote {written}")
    data = nifti.load(os.path.join(out, "predictions", written[0]))[0]
    check(bool(np.isfinite(data).all()) and 0.0 <= data.min() and data.max() <= 1.0,
          "predict CLI output not finite or outside [0, 1]")
    check(all(launches[k] > 0 for k in PREDICT_KERNELS), f"predict CLI launches {launches}")
    shutil.rmtree(SPACE_CLI_DIR, ignore_errors=True)
    return dict(plan=plan.mesh, seconds=seconds, launches=launches)


def phase18_sppin(device, seed, card) -> dict:
    """(d) The SPPIN config's bf16 train step (its DynUNet, 4 -> 1 channels,
    192^3, batch 2, AMP, DiceLoss, Adam) at world size 1: the peak of
    allocated device memory in the step (after a warm-up step), its ms."""
    from unet3d_tpu_torch.config.factory import (build_optimizer_from_config,
                                                 build_or_load_model_from_config,
                                                 load_criterion_from_config)
    from unet3d_tpu_torch.train.step import make_train_step
    from unet3d_tpu_torch.utils.config import load_json

    config = load_json(SPPIN_CONFIG)
    shape = tuple(config["dataset"]["desired_shape"])
    batch = int(config["training"]["batch_size"])
    model = build_or_load_model_from_config(config, None, device, seed=seed)
    step = make_train_step(model, load_criterion_from_config(config),
                           build_optimizer_from_config(config, model.parameters()),
                           amp=bool(config["training"]["amp"]), seed=seed)
    rng = np.random.RandomState(seed + 90)
    images = torch.from_numpy(rng.randn(batch, 4, *shape).astype(np.float32))
    labels = torch.from_numpy((rng.rand(batch, 1, *shape) > 0.5).astype(np.float32))
    step(images, labels)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(step(images, labels))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = torch.cuda.get_device_properties(device).total_memory / 2 ** 30
    print(f"space axis (d) SPPIN config bf16 train step at world size 1: batch {batch} of "
          f"{shape}, loss {loss:.6f}, {ms:.1f} ms, peak allocated {peak:.2f} GiB of the "
          f"card's {total:.1f} GiB [{card}]", flush=True)
    check(np.isfinite(loss), f"SPPIN step loss {loss}")
    del model, step
    torch.cuda.empty_cache()
    return dict(shape=list(shape), batch=batch, loss=loss, step_ms=ms, peak_gib=peak,
                card_gib=total)


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
    t_start = t_phase = time.perf_counter()

    def phase_done(n: int) -> None:
        """Prints phase ``n``'s seconds and the smoke's so far."""
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {n} {now - t_phase:.1f} s; the smoke so far {now - t_start:.1f} s",
              flush=True)
        t_phase = now

    # phase 0
    card = card_line()
    print(card, flush=True)
    device = require_cuda()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"sm_{''.join(map(str, sm_version(device)))}, {torch.cuda.get_device_name(0)}",
          flush=True)
    # no TF32 flag is set: the phases run under torch's defaults, as a user
    # runs the CLIs, and the port's own policy keeps f32 full f32
    phase_done(0)
    # phase 1
    t0 = time.perf_counter()
    load_library()
    print(f"kernel build {time.perf_counter() - t0:.1f} s", flush=True)
    phase_done(1)
    # phase 2
    gen = torch.Generator(device=device).manual_seed(args.seed)
    report = phase2(device, gen)
    s2_tf32_rows = phase2_backward(device, gen, report)
    s2_tf32_rows += phase2_s2_tf32x3(device, gen)
    narrow_report = phase2_narrow(device, gen)
    narrow_tf32_report = phase2_narrow(device, gen, torch.float32)
    s2_narrow_report = phase2_s2_narrow(device, gen)
    phase2_winograd(device, gen, report)
    phase_done(2)
    # phase 3
    model, launches, seconds, window_profile = phase3(device, args.seed, card)
    phase_done(3)
    # phase 4
    window_ms = phase4(model, launches, device, args.seed, card)
    del model
    torch.cuda.empty_cache()
    phase_done(4)
    # phase 5
    train_launches, training = phase5(device, args.seed, card)
    phase_done(5)
    # phase 6
    cli_launches, cli = phase6_cli(args.seed, card)
    phase_done(6)
    # phase 7
    strategy_launches, strategy = phase7_strategy_step(device, args.seed, card)
    phase_done(7)
    # phase 8
    train_cli_launches, train_cli, cases = phase8_train_cli(device, args.seed, card)
    torch.cuda.empty_cache()
    phase_done(8)
    # phase 9
    res_launches, res = phase9_train_cli_res(device, args.seed, card, cases)
    phase_done(9)
    # phase 10
    family_rows = phase10_kernels(device, gen)
    segresnet_launches, segresnet = phase10_segresnet(device, args.seed, card)
    segresnet_cli_launches, segresnet_cli = phase10_train_cli(device, args.seed, card, cases)
    family = phase10_family(device, args.seed, card)
    phase_done(10)
    # phase 11
    bn_rows = phase10_kernels(device, gen, BN_CONV_SHAPES, BN_S2_SHAPES, "BatchNorm nets")
    segresnet_ds_launches, segresnet_ds = phase11_segresnet_ds(device, args.seed, card)
    segresnet_ds_cli_launches, segresnet_ds_cli = phase11_train_cli(device, args.seed, card,
                                                                    cases)
    bn_nets = phase11_nets(device, args.seed, card)
    phase_done(11)
    # phase 12
    transformer_rows = phase10_kernels(device, gen, TRANSFORMER_CONV_SHAPES, [], "transformers")
    transformer_launches, transformers = {}, {}
    for name, model_cfg in TRANSFORMERS:
        transformer_launches[name], transformers[name] = phase12_transformer(
            name, model_cfg, device, args.seed, card)
    swin_cli_launches, swin_cli = phase12_train_cli(device, args.seed, card, cases)
    vits = phase12_vits(device, args.seed, card)
    phase_done(12)
    # phase 13
    stack_rows = phase10_kernels(device, gen, CONV_STACK_SHAPES, [], "conv stacks")
    stack_launches, stacks = {}, {}
    for i, (name, model_cfg) in enumerate(CONV_STACKS):
        stack_launches[name], stacks[name] = phase13_net(i, name, model_cfg, device,
                                                         args.seed, card)
    stacks.update(phase13_variants(device, args.seed, card))
    pp_cli_launches, pp_cli = phase13_train_cli(device, args.seed, card, cases)
    phase_done(13)
    # phase 14
    last_rows = phase10_kernels(device, gen, LAST_CONV_SHAPES, LAST_S2_SHAPES,
                                "last conv nets")
    last_launches, last_nets = {}, {}
    for i, (name, model_cfg) in enumerate(LAST_CONV_NETS):
        last_launches[name], last_nets[name] = phase14_net(
            i, name, model_cfg, device, args.seed, card, profile=name == "LocalNet")
    last_nets["AHNet trilinear"] = phase14_ahnet_trilinear(device, args.seed, card)
    heads = phase14_heads(device, args.seed, card)
    localnet_cli_launches, localnet_cli = phase14_train_cli(device, args.seed, card, cases)
    phase_done(14)
    # phase 15
    classifier_rows = phase10_kernels(device, gen, DENSENET_CONV_SHAPES, [], "classifiers")
    classifier_launches, classifiers = {}, {}
    for i, (name, model_cfg) in enumerate(CLASSIFIERS):
        classifier_launches[name], classifiers[name] = phase15_net(
            i, name, model_cfg, device, args.seed, card)
    classifiers["large"] = phase15_large(device, args.seed, card)
    phase_done(15)
    # phase 16
    vqvae = phase16_vqvae(device, args.seed, card)
    graph_cmr = phase16_graphcmr(device, args.seed, card)
    remat_launches, remat = phase16_remat(device, args.seed, card)
    shutil.rmtree(GRAPH_CMR_DIR, ignore_errors=True)
    phase_done(16)
    # phase 17
    dp_launches, dp_world1 = phase17_world1(device, args.seed, card)
    dp_rank_launches, dp_ranks = phase17_two_ranks(device, args.seed, card)
    dp_cli_launches, dp_cli = phase17_train_cli(card, cases)
    phase_done(17)
    # phase 18
    halo_report = phase18_kernels(device, gen)
    space_halo, space = phase18_space(device, args.seed, card)
    space["predict_cli"] = phase18_predict_cli(card, cases)
    shutil.rmtree(TRAIN_CLI_DIR, ignore_errors=True)
    space["sppin"] = phase18_sppin(device, args.seed, card)
    phase_done(18)
    check(not any(m in sys.modules for m in ("jax", "unet3d_tpu")),
          "the port imported jax")
    # launches: the training path's (phase 5; phase 7 for the Winograd
    # variants, which run only under the strategy); launches_predict: the
    # prediction path's (phase 3; the CLI under the strategy for Winograd);
    # launches_train_cli: the train CLI's training (phase 8);
    # launches_train_cli_res_remat: its first run with the residual DynUNet,
    # remat and 2 microbatches (phase 9); launches_segresnet: one bf16 train
    # step of SegResNetVAE (phase 10b), and family_shapes the kernel at the
    # Myronenko family's new shapes (phase 10); launches_segresnet_ds: one
    # bf16 train step of SegResNetDS (phase 11a, by form in
    # forms_segresnet_ds), launches_train_cli_segresnet_ds its train CLI run
    # (phase 11b), and bn_net_shapes the kernel at the BatchNorm nets' new
    # shapes (phase 11); launches_unetr and launches_swin_unetr: one bf16
    # train step of each (phase 12a), launches_train_cli_swin_unetr the
    # SwinUNETR train CLI run (phase 12b), and transformer_shapes the three
    # variants at the transformers' sites (phase 12); launches_basicunet and
    # launches_basicunetplusplus: one bf16 train step of each (phase 13c),
    # launches_train_cli_basicunetplusplus its train CLI run (phase 13d), and
    # conv_stack_shapes the conv kernel at their UpCats' sites (phase 13a);
    # launches_localnet, launches_regunet, launches_globalnet and
    # launches_autoencoder: one bf16 train step of each (phase 14c),
    # launches_train_cli_localnet its train CLI run (phase 14e), and
    # last_conv_net_shapes the conv kernel and s2_wgrad at their new sites
    # (phase 14a); launches_densenet121 and launches_regularizedresnet: one
    # bf16 train step of each (phase 15c), and classifier_shapes the conv
    # kernel at DenseNet121's conv2 sites (phase 15a); launches_segresnet_remat
    # and launches_segresnet_ds_remat: one bf16 step's forward and backward
    # of each under whole-model remat (phase 16c); launches_data_parallel:
    # the bf16 sharded step at world size 1 over NCCL (phase 17a),
    # launches_data_parallel_rank one of two ranks' share of it (phase 17b)
    # and launches_train_cli_data_parallel the train CLI's epoch at --ngpus 2
    # (phase 17d); launches_space_rank: one of two ranks' bf16 step on the
    # space axis (phase 18b), all four kernels in the SAME form and, in the
    # entries named "_halo", the two ranks' launches in their D-halo modes
    # (launches_by_pads, each rank's; the windows' in
    # launches_window_by_pads, phase 18a)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = [{"name": v, "route": "cuda", "source": SOURCES[v],
                "replaces": REPLACES[v], "launches": train_launches[v],
                "launches_predict": launches[v], "launches_train_cli": train_cli_launches[v],
                "launches_train_cli_res_remat": res_launches[v],
                "launches_segresnet": segresnet_launches[v],
                "launches_segresnet_ds": segresnet_ds_launches[v],
                "launches_train_cli_segresnet_ds": segresnet_ds_cli_launches[v],
                "launches_unetr": transformer_launches["UNETR"][v],
                "launches_swin_unetr": transformer_launches["SwinUNETR"][v],
                "launches_train_cli_swin_unetr": swin_cli_launches[v],
                "launches_basicunet": stack_launches["BasicUNet"][v],
                "launches_basicunetplusplus": stack_launches["BasicUNetPlusPlus"][v],
                "launches_train_cli_basicunetplusplus": pp_cli_launches[v],
                "launches_localnet": last_launches["LocalNet"][v],
                "launches_regunet": last_launches["RegUNet"][v],
                "launches_globalnet": last_launches["GlobalNet"][v],
                "launches_autoencoder": last_launches["AutoEncoder"][v],
                "launches_train_cli_localnet": localnet_cli_launches[v],
                "launches_densenet121": classifier_launches["DenseNet121"][v],
                "launches_regularizedresnet": classifier_launches["RegularizedResNet"][v],
                "launches_segresnet_remat": remat_launches["SegResNetVAE"][v],
                "launches_segresnet_ds_remat": remat_launches["SegResNetDS"][v],
                "launches_data_parallel": dp_launches[v],
                "launches_data_parallel_rank": dp_rank_launches[v],
                "launches_train_cli_data_parallel": dp_cli_launches[v],
                "launches_space_rank": space["ranks"][0]["launches_bf16"][v],
                **{k: report[v][k] for k in keys}}
               for v in TRAIN_KERNELS]
    for entry in kernels:
        rows = [r for r in family_rows if r["name"] == entry["name"]]
        if rows:
            entry["family_shapes"] = rows
        rows = [r for r in bn_rows if r["name"] == entry["name"]]
        if rows:
            entry["bn_net_shapes"] = rows
            entry["forms_segresnet_ds"] = {k: n for k, n in segresnet_ds["step_forms"].items()
                                           if k.startswith(entry["name"] + "/")}
        rows = [r for r in transformer_rows if r["name"] == entry["name"]]
        if rows:
            entry["transformer_shapes"] = rows
        rows = [r for r in stack_rows if r["name"] == entry["name"]]
        if rows:
            entry["conv_stack_shapes"] = rows
        rows = [r for r in last_rows if r["name"] == entry["name"]]
        if rows:
            entry["last_conv_net_shapes"] = rows
        rows = [r for r in classifier_rows if r["name"] == entry["name"]]
        if rows:
            entry["classifier_shapes"] = rows
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
    # the narrow form (conv3d_narrow.cu): launches in LocalNet's bf16 train
    # step (phase 14c; its window's in launches_localnet_window) and in each
    # other net that takes it (window / bf16 step of phases 10, 11, 14 and
    # 15; the LocalNet train CLI's run, phase 14e); its time at the U-Nets'
    # first-conv input gradient (32 -> 4 @128^3), every narrow row of phases
    # 10, 11 and 14 in narrow_shapes, and phase 2's ragged, misaligned and
    # D-halo cases in ragged_and_halo
    narrow_rows = [r for r in family_rows + bn_rows + last_rows if r["form"] == "narrow"]
    conv_narrow = next(r for r in narrow_rows if r["shape"] == NARROW_CONV_AT)

    def narrow_of(forms) -> int:
        return forms.get("conv/narrow", 0)
    kernels += [{"name": "conv_narrow", "route": "cuda", "source": NARROW_SOURCE,
                 "replaces": REPLACES["conv"],
                 "launches": narrow_of(last_nets["LocalNet"]["step_forms"]),
                 "launches_localnet_window": narrow_of(last_nets["LocalNet"]["window_forms"]),
                 **{f"launches_{name.lower()}": [narrow_of(last_nets[name]["window_forms"]),
                                                 narrow_of(last_nets[name]["step_forms"])]
                    for name in ("RegUNet", "AutoEncoder")},
                 **{f"launches_{name.lower()}": [narrow_of(family[name]["window_forms"]),
                                                 narrow_of(family[name]["step_forms"])]
                    for name in ("UNet3D", "AutoImplantUNet")},
                 "launches_monai_unet": [narrow_of(bn_nets["UNet"]["window_forms"]),
                                         narrow_of(bn_nets["UNet"]["step_forms"])],
                 "launches_regularizedresnet": [
                     narrow_of(classifiers["RegularizedResNet"]["bf16_forward"]["forms"]),
                     narrow_of(classifiers["RegularizedResNet"]["step_forms"])],
                 "launches_train_cli_localnet": narrow_of(localnet_cli["forms"]),
                 **{k: conv_narrow[k] for k in keys},
                 "narrow_shapes": narrow_rows, "ragged_and_halo": narrow_report}]
    # the narrow form's f32 instantiation (conv3d_narrow.cu, tf32x3_narrow):
    # launches in MONAI UNet's f32 training forward and backward (phase 11,
    # its f32 run's 3-channel convs), its time at UNet's 3 -> 3 @128^3 in f32
    # and the RegUNet head's input gradient in tf32x3_narrow_shapes, phase
    # 2's ragged, misaligned and D-halo cases in ragged_and_halo; bound_ms
    # the 3xTF32 bound, f32_bound_ms the f32 CUDA-core one
    tf32_narrow_rows = [r for r in bn_rows + last_rows if r["form"] == "tf32x3_narrow"]
    kernels += [{"name": "conv_tf32x3_narrow", "route": "cuda", "source": NARROW_SOURCE,
                 "replaces": REPLACES["conv"],
                 "launches": bn_nets["UNet"]["step_forms"].get("conv/tf32x3_narrow", 0),
                 **{k: tf32_narrow_rows[0][k] for k in keys + ("f32_bound_ms",)},
                 "tf32x3_narrow_shapes": tf32_narrow_rows,
                 "ragged_and_halo": narrow_tf32_report}]
    # s2_wgrad's f32 form (s2_wgrad_tf32x3.cu): launches in the f32 DynUNet
    # step (phase 5), its time at level 0 (64 -> 96 @128^3) and every f32 row
    # of phase 2 in s2_shapes; bound_ms the 3xTF32 bound, f32_bound_ms the
    # f32 CUDA-core one, library_ms cuDNN's f32 dw with TF32 off
    kernels += [{"name": "s2_wgrad_tf32x3", "route": "cuda", "source": S2_TF32X3_SOURCE,
                 "replaces": REPLACES["s2_wgrad"],
                 "launches": training["f32_step_forms"].get("s2_wgrad/tf32x3", 0),
                 **{k: report["s2_wgrad_tf32x3"][k] for k in keys + ("f32_bound_ms",)},
                 "s2_shapes": s2_tf32_rows}]
    # Winograd-DH's f32 form (winograd_tf32x3.cu): launches in phase 7's f32
    # gradients under the strategy, times at the bf16 rows' sites (phase 2);
    # bound_ms the 3xTF32 bound, f32_bound_ms the f32 CUDA-core one,
    # library_ms F.conv3d with TF32 off (the conv alone), direct_ms the direct
    # tf32x3 kernel
    kernels += [{"name": f"{v}_tf32x3", "route": "cuda", "source": WINO_TF32X3_SOURCE,
                 "replaces": REPLACES[v],
                 "launches": strategy["f32_forms"].get(f"{v}/tf32x3", 0),
                 **{k: report[f"{v}_tf32x3"][k] for k in keys + ("f32_bound_ms",)},
                 "direct_ms": report[f"{v}_tf32x3"]["direct_ms"]}
                for v in STRATEGY_KERNELS]
    # s2_wgrad's narrow form (s2_wgrad.cu): launches in MONAI UNet's bf16
    # step (phase 11, its 4 -> 16 first stride-2 conv) and in the
    # AutoEncoder's (phase 14, 4 -> 4); its time at UNet's 4 -> 16 @128^3,
    # both sites in narrow_shapes, phase 2's ragged, misaligned and D-halo
    # cases' largest error in ragged_and_halo; plain_ms the plain version
    # (cuDNN's f32 dw), library_ms cuDNN's bf16 dw
    s2_narrow = s2_narrow_report["rows"][0]
    kernels += [{"name": "s2_wgrad_narrow", "route": "cuda", "source": S2_NARROW_SOURCE,
                 "replaces": REPLACES["s2_wgrad"],
                 "launches": bn_nets["UNet"]["step_forms"].get("s2_wgrad/narrow", 0),
                 "launches_autoencoder":
                     last_nets["AutoEncoder"]["step_forms"].get("s2_wgrad/narrow", 0),
                 **{k: s2_narrow[k] for k in keys},
                 "narrow_shapes": s2_narrow_report["rows"],
                 "ragged_and_halo": {k: s2_narrow_report[k] for k in ("worst_rel", "cases")}}]
    kernels += [{"name": f"{v}_halo", "route": "cuda", "source": SOURCES[v],
                 "replaces": REPLACES[v], "launches": space_halo[v],
                 "launches_by_pads": [{k: n for k, n in r["halo_bf16"].items()
                                       if k.startswith(v + "(")} for r in space["ranks"]],
                 "launches_window_by_pads": [{k: n for k, n in r["window_halo"].items()
                                              if k.startswith(v + "(")}
                                             for r in space["ranks"]],
                 **{k: halo_report[v][k] for k in keys}}
                for v in TRAIN_KERNELS]
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
    print(f"segresnet_ds: {json.dumps(dict(kernel_shapes=bn_rows, **segresnet_ds))} [{card}]")
    print(f"segresnet_ds train cli: "
          f"{json.dumps(dict(segresnet_ds_cli, launches=segresnet_ds_cli_launches))} [{card}]")
    print(f"batchnorm nets: {json.dumps(bn_nets)} [{card}]")
    print(f"transformers: {json.dumps(dict(kernel_shapes=transformer_rows, **transformers))} "
          f"[{card}]")
    print(f"swin_unetr train cli: {json.dumps(dict(swin_cli, launches=swin_cli_launches))} "
          f"[{card}]")
    print(f"vits: {json.dumps(vits)} [{card}]")
    print(f"conv stacks: {json.dumps(dict(kernel_shapes=stack_rows, **stacks))} [{card}]")
    print(f"basicunetplusplus train cli: "
          f"{json.dumps(dict(pp_cli, launches=pp_cli_launches))} [{card}]")
    print(f"last conv nets: {json.dumps(dict(kernel_shapes=last_rows, heads=heads, **last_nets))} "
          f"[{card}]")
    print(f"localnet train cli: "
          f"{json.dumps(dict(localnet_cli, launches=localnet_cli_launches))} [{card}]")
    print(f"classifiers: {json.dumps(dict(kernel_shapes=classifier_rows, **classifiers))} "
          f"[{card}]")
    print(f"vqvae: {json.dumps(vqvae)} [{card}]")
    print(f"graph_cmr: {json.dumps(graph_cmr)} [{card}]")
    print(f"whole-model remat: {json.dumps(remat)} [{card}]")
    print(f"data parallel: {json.dumps(dict(world1=dp_world1, two_ranks=dp_ranks, cli=dp_cli))} "
          f"[{card}]")
    print(f"space axis: {json.dumps(dict(space, kernel_shapes=halo_report))} [{card}]")
    print(f"smoke wall time {time.perf_counter() - t_start:.1f} s [{card}]")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

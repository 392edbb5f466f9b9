"""Training engine: epoch driver with CSV log, resume, early stop, checkpoints.

Counterpart of ``unet3d_tpu/train/train.py``, with the same CSV log, resume,
scheduler replay, early stopping, NaN stop and checkpoint family (latest every
epoch, ``_best`` on improvement, ``_{epoch}`` every N, a rolling window of the
last N). The steps close over the model and optimizer (``train/step.py``), so
the engine passes batches, and the scheduler writes each epoch's learning rate
into the optimizer. Losses are read one step late: the host prepares batch
i + 1 while the device still runs step i. ``save_optimizer`` writes the
optimizer state each epoch in the JAX package's format
(``model_optimizer.npz``) and restores it on resume, before the scheduler's
replay.

In a data-parallel run (``parallel/``) each rank runs the engine on its
share of each batch: the steps return the global batch's loss, a batch is
weighted by its global size (``global_batch_size``; ``whole_batch`` goes to
the step as ``whole``), the epoch's losses come from rank 0 so every rank
takes the same decisions (early stop, best checkpoint, scheduler), and only
rank 0 writes the log, checkpoints and optimizer file; the others wait for
it at the end of each epoch.
"""
from __future__ import annotations

import csv
import os
import shutil
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from unet3d_tpu_torch.parallel.distributed import (barrier, broadcast_floats,
                                                  is_primary_host)
from unet3d_tpu_torch.train.checkpoint import (load_opt_state, save_checkpoint,
                                               save_opt_state)
from unet3d_tpu_torch.train.meters import AverageMeter, ProgressMeter
from unet3d_tpu_torch.train.optim import (ReduceLROnPlateau, Scheduler,
                                          get_learning_rate, set_learning_rate)

TRAINING_LOG_HEADER = ["epoch", "loss", "lr", "val_loss"]


def read_training_log(filename: str) -> List[List[float]]:
    with open(filename) as f:
        reader = csv.reader(f)
        next(reader)
        return [[float(v) if v not in ("", "None") else float("nan") for v in row]
                for row in reader]


def write_training_log(rows: List[List[float]], filename: str) -> None:
    """Full rewrite each epoch, one row per epoch; None and NaN are empty."""
    with open(filename, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(TRAINING_LOG_HEADER)
        for row in rows:
            writer.writerow([("" if v is None or (isinstance(v, float) and np.isnan(v))
                              else v) for v in row])


def remove_file(filename: str) -> None:
    if os.path.exists(filename):
        os.remove(filename)


def forced_copy(source: str, target: str) -> None:
    remove_file(target)
    shutil.copy(source, target)


def append_to_filename(filename: str, what_to_append) -> str:
    dirname, basename = os.path.split(filename)
    name, extension = basename.split(".", 1)
    return os.path.join(dirname, f"{name}_{what_to_append}.{extension}")


FIRST_STEP_HINT = (
    "The first training step failed to run (input shape {shape}). If this is "
    "an out-of-memory failure, reduce the dataset 'desired_shape' in "
    "increments of 16 (keep each dim divisible by 2^#downsample levels), set "
    "\"remat\": true in the training config to recompute activations in the "
    "backward pass, or split each batch with \"gradient_accumulation_steps\".")


def run_step(step: Callable, batch) -> tuple:
    """``step`` on a batch: (its loss, the batch's global item count); a
    data-parallel rank's batch passes ``whole``."""
    images = batch["image"]
    n = batch.get("global_batch_size", images.shape[0])
    if "whole_batch" in batch:
        return step(images, batch["label"], whole=batch["whole_batch"]), n
    return step(images, batch["label"]), n


def epoch_training(train_loader, train_step: Callable, epoch: int,
                   samples_per_epoch: Optional[int] = None,
                   print_freq: int = 1) -> float:
    """One pass over the training loader; returns the mean loss. A failure
    of the first step of the first epoch carries the out-of-memory hint."""
    batch_time = AverageMeter("Time", ":6.3f")
    data_time = AverageMeter("Data", ":6.3f")
    losses = AverageMeter("Loss", ":.4e")
    progress = ProgressMeter(len(train_loader), [batch_time, data_time, losses],
                             prefix=f"Epoch: [{epoch}]")
    end = time.time()
    n_seen = 0
    pending = None  # (device loss, batch size), read one step late
    for i, batch in enumerate(train_loader):
        data_time.update(time.time() - end)
        try:
            loss, n = run_step(train_step, batch)
        except Exception as error:
            if i == 0 and epoch <= 1:
                raise RuntimeError(FIRST_STEP_HINT.format(
                    shape=tuple(batch["image"].shape))) from error
            raise
        if pending is not None:
            losses.update(float(pending[0]), pending[1])
        pending = (loss, n)
        n_seen += n
        batch_time.update(time.time() - end)
        end = time.time()
        if print_freq and i % print_freq == 0:
            progress.display(i)
        if samples_per_epoch is not None and n_seen >= samples_per_epoch:
            break
    if pending is not None:
        losses.update(float(pending[0]), pending[1])
    return losses.avg


def epoch_validation(val_loader, eval_step: Callable, print_freq: int = 1) -> float:
    """No-grad pass over the validation loader; returns the mean loss."""
    batch_time = AverageMeter("Time", ":6.3f")
    losses = AverageMeter("Loss", ":.4e")
    progress = ProgressMeter(len(val_loader), [batch_time, losses],
                             prefix="Validation: ")
    end = time.time()
    pending = None
    for i, batch in enumerate(val_loader):
        loss, n = run_step(eval_step, batch)
        if pending is not None:
            losses.update(float(pending[0]), pending[1])
        pending = (loss, n)
        batch_time.update(time.time() - end)
        end = time.time()
        if print_freq and i % print_freq == 0:
            progress.display(i)
    if pending is not None:
        losses.update(float(pending[0]), pending[1])
    return losses.avg


def run_training(train_step: Callable, eval_step: Optional[Callable],
                 model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 n_epochs: int, training_loader, validation_loader,
                 training_log_filename: str, model_filename: str,
                 metric_to_monitor: str = "val_loss",
                 early_stopping_patience: Optional[int] = None,
                 save_best: bool = False,
                 save_every_n_epochs: Optional[int] = None,
                 save_last_n_models: Optional[int] = None,
                 scheduler: Optional[Scheduler] = None,
                 samples_per_epoch: Optional[int] = None,
                 training_iterations_per_epoch: int = 1,
                 save_optimizer: bool = False) -> torch.nn.Module:
    """Train ``model`` (in place, through ``train_step``) for up to
    ``n_epochs``, resuming after the last epoch of an existing log (with the
    optimizer state of ``<model>_optimizer.npz`` under ``save_optimizer``)."""
    if str(model_filename).endswith(".orbax"):
        raise NotImplementedError("orbax checkpoints are not ported (see ROADMAP.md)")
    names = [name for name, _ in model.named_parameters()]
    optimizer_filename = append_to_filename(model_filename, "optimizer")
    training_log: List[List[float]] = []
    if os.path.exists(training_log_filename):
        training_log.extend(read_training_log(training_log_filename))
        start_epoch = int(training_log[-1][0]) + 1
    else:
        start_epoch = 1
    metric_col = TRAINING_LOG_HEADER.index(metric_to_monitor)

    if save_optimizer and start_epoch > 1 and os.path.exists(optimizer_filename):
        load_opt_state(optimizer, names, optimizer_filename)

    # fast-forward the scheduler through the logged epochs
    if scheduler is not None and start_epoch > 1:
        for i in range(1, start_epoch):
            if isinstance(scheduler, ReduceLROnPlateau):
                scheduler.step(training_log[i - 1][metric_col])
            else:
                scheduler.step()
        set_learning_rate(optimizer, scheduler.lr)

    for epoch in range(start_epoch, n_epochs + 1):
        if training_log:
            metric = np.asarray(training_log, dtype=np.float64)[:, metric_col]
            # an all-NaN metric falls through to the NaN stop
            if (early_stopping_patience and not np.all(np.isnan(metric))
                    and np.nanargmin(metric) <= len(training_log) - early_stopping_patience):
                print(f"Early stopping patience {early_stopping_patience} has been reached.")
                break
            if np.isnan(metric[-1]):
                print("Stopping as invalid results were returned.")
                break

        epoch_losses = []
        for it in range(training_iterations_per_epoch):
            training_loader.set_epoch(epoch * training_iterations_per_epoch + it)
            epoch_losses.append(epoch_training(training_loader, train_step, epoch,
                                               samples_per_epoch=samples_per_epoch))
        loss = float(np.mean(epoch_losses))

        val_loss = None
        if validation_loader is not None and eval_step is not None:
            val_loss = epoch_validation(validation_loader, eval_step)
        loss, val_loss = broadcast_floats([loss, val_loss])

        lr = scheduler.lr if scheduler is not None else get_learning_rate(optimizer)
        training_log.append([epoch, loss, lr, val_loss])
        primary = is_primary_host()
        if primary:
            write_training_log(training_log, training_log_filename)
        metric_history = np.asarray(training_log, dtype=np.float64)[:, metric_col]
        min_epoch = (-1 if np.all(np.isnan(metric_history))
                     else int(np.nanargmin(metric_history)))

        if scheduler is not None:
            if isinstance(scheduler, ReduceLROnPlateau):
                scheduler.step(val_loss if validation_loader is not None else loss)
            else:
                scheduler.step()
            set_learning_rate(optimizer, scheduler.lr)

        if primary:
            save_checkpoint(model, model_filename)
            if save_optimizer:
                save_opt_state(optimizer, names, optimizer_filename)
            if save_best and min_epoch == len(training_log) - 1:
                forced_copy(model_filename, append_to_filename(model_filename, "best"))
            if save_every_n_epochs and (epoch % save_every_n_epochs) == 0:
                forced_copy(model_filename, append_to_filename(model_filename, epoch))
            if save_last_n_models is not None and save_last_n_models > 1:
                if not save_every_n_epochs or ((epoch - save_last_n_models)
                                               % save_every_n_epochs) != 0:
                    remove_file(append_to_filename(model_filename,
                                                   epoch - save_last_n_models))
                forced_copy(model_filename, append_to_filename(model_filename, epoch))
        barrier()
    return model

"""Train and eval steps (counterpart of ``unet3d_tpu/train/step.py``).

A step takes a host batch in the (B, C, D, H, W) layout, moves it to the
model's device as NDHWC, and returns the loss as a device tensor without
waiting for it: the training engine reads it one step late.

bf16 AMP with f32 master weights: the forward runs on bf16 copies of every f32
parameter (norm scale and bias included, as the JAX step casts the whole
parameter tree), through ``torch.func.functional_call``, so the gradients
reach the f32 masters through the cast and the optimizer updates those.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from unet3d_tpu_torch.predict.volumetric import to_ndhwc


def from_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> contiguous (B, C, D, H, W)."""
    return x.permute(0, 4, 1, 2, 3).contiguous()


def amp_cast(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """bf16 copies of the f32 tensors of ``params``; others pass through."""
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in params.items()}


def compute_criterion(criterion: Callable, output: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """The loss; a deep-supervision stack (heads on axis 1, one more axis than
    the target) is weighted 1/2^i, normalised, as nnU-Net does."""
    if output.dim() == target.dim() + 1:
        n = output.shape[1]
        weights = [0.5 ** i for i in range(n)]
        total = sum(weights)
        return sum((w / total) * criterion(output[:, i], target)
                   for i, w in enumerate(weights))
    return criterion(output, target)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def prepare_batch(images, labels, device: torch.device, amp: bool):
    """Host (B, C, D, H, W) images / labels -> NDHWC device tensors: images
    in bf16 under ``amp``, else f32; labels in f32."""
    x = to_ndhwc(torch.as_tensor(np.asarray(images)).to(device))
    y = torch.as_tensor(np.asarray(labels)).to(device)
    if y.dim() == 5:
        y = to_ndhwc(y)
    return x.to(torch.bfloat16 if amp else torch.float32), y.float()


def forward_loss(model: torch.nn.Module, criterion: Callable, x: torch.Tensor,
                 y: torch.Tensor, amp: bool) -> torch.Tensor:
    """The training forward and its loss; under ``amp`` on bf16 copies of the
    f32 parameters."""
    if amp:
        params = amp_cast(dict(model.named_parameters()))
        out = functional_call(model, params, (x,), {"train": True})
    else:
        out = model(x, train=True)
    return compute_criterion(criterion, out, y)


def make_train_step(model: torch.nn.Module, criterion: Callable,
                    optimizer: torch.optim.Optimizer, amp: bool = False) -> Callable:
    """``step(images, labels) -> loss``: forward, backward, one optimizer
    update of the (f32) parameters."""
    device = _device(model)

    def step(images, labels) -> torch.Tensor:
        x, y = prepare_batch(images, labels, device, amp)
        optimizer.zero_grad(set_to_none=True)
        loss = forward_loss(model, criterion, x, y, amp)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_eval_step(model: torch.nn.Module, criterion: Callable,
                   inferer: Optional[Callable] = None, amp: bool = False) -> Callable:
    """``step(images, labels) -> loss`` without gradients, the forward
    optionally through an inferer (e.g. sliding window); ``amp`` runs it on
    bf16 copies of the parameters."""
    device = _device(model)

    def step(images, labels) -> torch.Tensor:
        x, y = prepare_batch(images, labels, device, amp)
        with torch.no_grad():
            params = dict(model.named_parameters())
            if amp:
                params = amp_cast(params)

            def forward(z: torch.Tensor) -> torch.Tensor:
                return functional_call(model, params, (z,))

            out = inferer(x, forward) if inferer is not None else forward(x)
            return compute_criterion(criterion, out, y)

    return step

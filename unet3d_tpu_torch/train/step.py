"""Train and eval steps (counterpart of ``unet3d_tpu/train/step.py``).

A step takes a batch in the (B, C, D, H, W) layout, on the host (numpy or
tensors) or already on the model's device (``data/prefetch.py``), moves it
there as NDHWC, and returns the loss as a device tensor without waiting for
it: the training engine reads it one step late.

bf16 AMP with f32 master weights: the forward runs on bf16 copies of every f32
parameter (norm scale and bias included, as the JAX step casts the whole
parameter tree), through ``torch.func.functional_call``, so the gradients
reach the f32 masters through the cast and the optimizer updates those. The
buffers (a BatchNorm's running ``mean`` and ``var``, the ``batch_stats``
collection; VQVAE's ``codebook``) stay f32 in training, as the JAX step casts
only ``params``: the training forward normalises with the batch's f32
statistics and updates the running averages (the EMA codebook) in place,
once per forward. The eval step casts them to bf16 with the parameters, as
the JAX ``amp_cast`` casts every f32 leaf.

A model whose forward takes ``rng`` (the dropout and VAE noise of the
Myronenko family) draws its training noise from a ``torch.Generator`` on the
model's device, seeded from the run's seed (``noise_generator``): the train
step owns it and passes it to every forward, as the JAX step splits its
``dropout`` and ``sample`` keys each step. Eval draws nothing.

``grad_accum`` > 1 splits each batch into that many equal microbatches (the
JAX step's scan): one forward and backward each, the gradients summed in f32
in the masters' ``.grad``, divided once by the count, one optimizer update,
and the loss the mean of the microbatches'. Each microbatch normalises with
its own statistics and updates the running averages (and codebook) the one
before left, as the scan carries ``batch_stats`` and ``codebook``.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call

from unet3d_tpu_torch.predict.volumetric import to_ndhwc
from unet3d_tpu_torch.utils.device import as_tensor


def from_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> contiguous (B, C, D, H, W)."""
    return x.permute(0, 4, 1, 2, 3).contiguous()


def amp_cast(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """bf16 copies of the f32 tensors of ``params``; others pass through."""
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in params.items()}


def compute_criterion(criterion: Callable, output, target: torch.Tensor) -> torch.Tensor:
    """The loss of ``output`` or of a model's ``(output, *extras)``.

    A ``wants_extras`` criterion (VAELoss) takes the first two extras as
    ``mu`` / ``logvar``; otherwise every scalar extra is an auxiliary loss
    term the model computed, added to the criterion's value, and other extras
    are ignored. A deep-supervision stack (heads on axis 1, one more axis
    than the target) is weighted 1/2^i, normalised, as nnU-Net does."""
    extras = ()
    if isinstance(output, tuple):
        output, *extras = output
    if getattr(criterion, "wants_extras", False):
        if len(extras) >= 2:
            return criterion(output, target, mu=extras[0], logvar=extras[1])
        return criterion(output, target)
    if output.dim() == target.dim() + 1:
        n = output.shape[1]
        weights = [0.5 ** i for i in range(n)]
        total = sum(weights)
        loss = sum((w / total) * criterion(output[:, i], target)
                   for i, w in enumerate(weights))
    else:
        loss = criterion(output, target)
    for e in extras:
        if isinstance(e, torch.Tensor) and e.dim() == 0:
            loss = loss + e.to(loss.dtype)
    return loss


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def noise_generator(model: torch.nn.Module, seed: int = 0) -> Optional[torch.Generator]:
    """A generator on the model's device seeded with ``seed`` for a model
    whose forward draws noise (takes ``rng``), else None."""
    if "rng" not in inspect.signature(model.forward).parameters:
        return None
    return torch.Generator(device=_device(model)).manual_seed(seed)


def prepare_batch(images, labels, device: torch.device, amp: bool):
    """(B, C, D, H, W) images / labels -> NDHWC tensors on ``device``: images
    in bf16 under ``amp``, else f32; labels in f32. Other ranks pass as they
    are (a classifier's ``(B, classes)`` targets, the FCN's ``(B, features)``
    inputs, which the JAX step's transpose refuses). A batch already on the
    device in that dtype is taken as it is; casts happen on the device."""
    x = as_tensor(images).to(device).to(torch.bfloat16 if amp else torch.float32)
    y = as_tensor(labels).to(device).float()
    return (to_ndhwc(x) if x.dim() == 5 else x), (to_ndhwc(y) if y.dim() == 5 else y)


def forward_loss(model: torch.nn.Module, criterion: Callable, x: torch.Tensor,
                 y: torch.Tensor, amp: bool,
                 rng: Optional[torch.Generator] = None,
                 forward_wrapper: Optional[Callable] = None) -> torch.Tensor:
    """The training forward and its loss; under ``amp`` on bf16 copies of the
    f32 parameters (the buffers stay the model's own, f32). ``rng`` goes to a
    forward that draws noise; ``forward_wrapper`` maps the forward (a
    function of x) to the one that runs (the space axis's,
    ``parallel/mesh.space_forward``)."""
    kwargs = {"train": True}
    if rng is not None:
        kwargs["rng"] = rng
    if amp:
        params = amp_cast(dict(model.named_parameters()))

        def forward(z):
            return functional_call(model, params, (z,), kwargs)
    else:
        def forward(z):
            return model(z, **kwargs)
    if forward_wrapper is not None:
        forward = forward_wrapper(forward)
    return compute_criterion(criterion, forward(x), y)


def accumulate_gradients(model: torch.nn.Module, criterion: Callable,
                         x: torch.Tensor, y: torch.Tensor, amp: bool,
                         grad_accum: int = 1,
                         rng: Optional[torch.Generator] = None,
                         forward_wrapper: Optional[Callable] = None) -> torch.Tensor:
    """Forward and backward of the batch into the parameters' ``.grad``, in
    ``grad_accum`` equal microbatches (contiguous slices of the batch axis,
    as the kernels take them), the gradients summed in f32 and divided once
    by the count; returns the mean loss, detached. ``forward_wrapper`` as
    ``forward_loss``'s."""
    if grad_accum <= 1:
        loss = forward_loss(model, criterion, x, y, amp, rng, forward_wrapper)
        loss.backward()
        return loss.detach()
    n = x.shape[0]
    if n % grad_accum:
        raise ValueError(f"batch size {n} is not divisible by "
                         f"gradient_accumulation_steps={grad_accum}")
    m = n // grad_accum
    total = None
    for i in range(grad_accum):
        loss = forward_loss(model, criterion, x[i * m:(i + 1) * m],
                            y[i * m:(i + 1) * m], amp, rng, forward_wrapper)
        loss.backward()
        loss = loss.detach().float()
        total = loss if total is None else total + loss
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(grad_accum)
    return total / grad_accum


def make_train_step(model: torch.nn.Module, criterion: Callable,
                    optimizer: torch.optim.Optimizer, amp: bool = False,
                    grad_accum: int = 1, seed: int = 0) -> Callable:
    """``step(images, labels) -> loss``: forward, backward (in ``grad_accum``
    microbatches), one optimizer update of the (f32) parameters; a model
    that draws noise draws it from the step's ``noise_generator(model,
    seed)``."""
    device = _device(model)
    rng = noise_generator(model, seed)

    def step(images, labels) -> torch.Tensor:
        x, y = prepare_batch(images, labels, device, amp)
        optimizer.zero_grad(set_to_none=True)
        loss = accumulate_gradients(model, criterion, x, y, amp, grad_accum, rng)
        optimizer.step()
        return loss

    return step


def make_eval_step(model: torch.nn.Module, criterion: Callable,
                   inferer: Optional[Callable] = None, amp: bool = False,
                   forward_wrapper: Optional[Callable] = None) -> Callable:
    """``step(images, labels) -> loss`` without gradients, the forward
    optionally through an inferer (e.g. sliding window); ``amp`` runs it on
    bf16 copies of the parameters and buffers (the running statistics);
    ``forward_wrapper`` as ``forward_loss``'s, around each forward the
    inferer makes."""
    device = _device(model)

    def step(images, labels) -> torch.Tensor:
        x, y = prepare_batch(images, labels, device, amp)
        with torch.no_grad():
            variables = {**dict(model.named_parameters()), **dict(model.named_buffers())}
            if amp:
                variables = amp_cast(variables)

            def forward(z: torch.Tensor) -> torch.Tensor:
                return functional_call(model, variables, (z,))

            if forward_wrapper is not None:
                forward = forward_wrapper(forward)
            out = inferer(x, forward) if inferer is not None else forward(x)
            return compute_criterion(criterion, out, y)

    return step

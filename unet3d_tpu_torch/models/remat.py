"""Whole-model rematerialisation: ``training.remat`` for every net, the JAX
package's ``nn.remat`` of the whole module (and of each block in DynUNet,
whose blocks are the ones checkpointed here).

The whole forward is recomputed in the backward, one block at a time:
``whole_model_remat(model)`` checkpoints each block of ``model`` (each child
of the root that has children of its own; the elements of a root
``ModuleList`` / ``ModuleDict``), so the forward keeps the blocks' inputs and
the backward recomputes each block's activations when it reaches it. (One
checkpoint around the whole forward would recompute every activation at
once before the first gradient: the same peak as no remat.) The root's own
operations and its leaf children (a lone conv or norm, whose input is kept
anyway) run as they are. A block becomes an instance of a subclass of its
class (``remat_class``: one per class, named as it) whose forward, with
gradients on, runs the original forward inside ``torch.utils.checkpoint``.
The module tree, and so ``state_dict``'s keys, stay as they are, as
``nn.remat`` keeps the variable tree; without gradients (eval,
``make_forward``, the predict CLI) every forward is the plain one.

JAX's remat is functional: the recompute sees the variables of before the
forward, and the forward's state updates come out once. The checkpointed
function keeps that here:

- the parameters the forward runs on (the bf16 copies under the AMP train
  step's ``functional_call``) enter it as inputs, so the recompute in the
  backward, when the module holds its f32 masters again, runs on them too;
- the buffers (BatchNorm's running statistics, VQVAE's codebook) are
  snapshot before the forward, and every run of the function, the forward
  and each recompute, gets fresh copies of the snapshot to update in place:
  the recompute reads the state of before, as the forward did, and takes the
  same codes and statistics; the forward's copies are written into the
  module's buffers once, after it returns, and the recompute's are dropped;
- a ``torch.Generator`` passed to the forward (the dropout masks and VAE
  samples) is set back to its state of before the forward for each
  recompute, and to its current state after it, so the recompute draws the
  forward's noise and the draws that follow are unchanged. torch's global
  generators are not saved (``preserve_rng_state=False``): the port draws
  no noise from them.

- the space axis's state (``parallel/distributed.space_state``: whether
  the block ran on D slabs, or whole in a replicated level) is the
  forward's in every recompute, which runs its halo exchanges and
  statistics' sums again, in the same order on every rank.

A recompute may stop early, once it has rebuilt what the backward needs
(the checkpoint's ``early_stop``); the generators and the forward flag are
put back in ``finally``.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Type

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from unet3d_tpu_torch.parallel.distributed import restored_space, space_state

_CLASSES: Dict[type, type] = {}


def whole_model_remat(model: torch.nn.Module, on: bool = True) -> torch.nn.Module:
    """``model``, now recomputed block by block in the backward (in place:
    each block's class becomes the remat subclass of its class), or with
    ``on`` False back to the plain forward."""
    for block in remat_blocks(model):
        checkpointed = getattr(type(block), "checkpointed", False)
        if on and not checkpointed:
            block.__class__ = remat_class(type(block))
        elif checkpointed and not on:
            block.__class__ = type(block).__bases__[0]
    return model


def remat_blocks(model: torch.nn.Module) -> List[torch.nn.Module]:
    """The children of ``model`` that have children of their own, the
    elements of a ``ModuleList`` / ``ModuleDict`` child taken as children."""
    blocks = []
    for child in model.children():
        units = (child.children() if isinstance(child, (torch.nn.ModuleList,
                                                        torch.nn.ModuleDict))
                 else (child,))
        blocks += [m for m in units if next(m.children(), None) is not None]
    return blocks


def checkpointed_blocks(model: torch.nn.Module) -> List[str]:
    """The names of ``model``'s modules that ``whole_model_remat`` made
    recompute in the backward."""
    return [name for name, m in model.named_modules() if getattr(type(m), "checkpointed", False)]


def remat_class(cls: Type[torch.nn.Module]) -> type:
    """The subclass of ``cls`` whose forward is checkpointed when gradients
    are on (made once per class, named as ``cls``)."""
    if cls not in _CLASSES:
        base_forward = cls.forward

        @functools.wraps(base_forward)
        def forward(self, *args, **kwargs):
            if self._remat_running or not torch.is_grad_enabled():
                return base_forward(self, *args, **kwargs)
            return _checkpointed(self, args, kwargs)

        _CLASSES[cls] = type(cls.__name__, (cls,), {
            "forward": forward, "checkpointed": True, "_remat_running": False,
            "__module__": cls.__module__, "__qualname__": cls.__qualname__})
    return _CLASSES[cls]


def _checkpointed(model: torch.nn.Module, args: tuple, kwargs: dict):
    named = list(model.named_parameters())
    names, params = [n for n, _ in named], [p for _, p in named]
    buffers = dict(model.named_buffers())
    before = {k: b.detach().clone() for k, b in buffers.items()}
    generators = [v for v in (*args, *kwargs.values()) if isinstance(v, torch.Generator)]
    start = [g.get_state() for g in generators]
    at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    updated: Dict[str, torch.Tensor] = {}
    runs = [0]
    space = space_state()

    def run(*inputs):
        call_args = list(args)
        for i, t in zip(at, inputs):
            call_args[i] = t
        state = {k: v.clone() for k, v in before.items()}
        variables = {**dict(zip(names, inputs[len(at):])), **state}
        recompute, runs[0] = runs[0] > 0, runs[0] + 1
        now = [g.get_state() for g in generators] if recompute else []
        for g, s in zip(generators if recompute else (), start):
            g.set_state(s)
        model._remat_running = True
        try:
            with restored_space(space):
                out = functional_call(model, variables, tuple(call_args), kwargs)
        finally:
            model._remat_running = False
            for g, s in zip(generators, now):
                g.set_state(s)
        if not recompute:
            updated.update(state)
        return out

    out = checkpoint(run, *(args[i] for i in at), *params, use_reentrant=False,
                     preserve_rng_state=False)
    with torch.no_grad():
        for k, v in updated.items():
            buffers[k].copy_(v)
    return out

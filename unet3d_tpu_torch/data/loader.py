"""Batching data loader with threaded prefetch (a copy of
``unet3d_tpu/data/loader.py``, numpy and threads).

Replaces the reference's torch/MONAI ``DataLoader``
(`unet3d/scripts/script_utils.py:124-129`: shuffle / num_workers / pin_memory /
prefetch_factor) with host-side thread parallelism over the sample pipeline;
``n_workers`` maps to the thread pool width. Batches are numpy, or torch
tensors for the keys ``transfer_dtype`` casts to a torch dtype (bf16 under
AMP: ``config/factory.py``); ``data/prefetch.py`` moves them to the GPU.
"""
from __future__ import annotations

import copy
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np
import torch

# a dead producer is noticed within this many seconds of the consumer's wait
_POLL_SECONDS = 1.0


def _stack_batch(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    batch: Dict[str, Any] = {}
    first = samples[0]
    for key in first:
        if key in ("image", "label"):
            batch[key] = np.stack([np.asarray(s[key]) for s in samples])
        else:
            batch[key] = [s[key] for s in samples]
    return batch


def collate_flatten(batch: Dict[str, Any], max_dims: int = 5) -> Dict[str, Any]:
    """Flatten >5D stacked arrays into the batch dimension.

    Parity: `unet3d/train/training_utils.py:230-240` — patch-stack datasets
    produce (B, P, C, D, H, W); training consumes (B*P, C, D, H, W).
    """
    out = dict(batch)
    for key in ("image", "label"):
        arr = out.get(key)
        if arr is not None and arr.ndim > max_dims:
            out[key] = arr.reshape((-1,) + arr.shape[arr.ndim - max_dims + 1:])
    return out


def collate_5d_flatten(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten down to 5D (`training_utils.py:238-240`)."""
    return collate_flatten(batch, max_dims=5)


class DataLoader:
    """Iterates dicts with stacked ``image``/``label`` arrays plus per-item meta.

    ``transfer_dtype`` maps batch keys to torch dtypes applied after
    stacking, so batches cross the host->device link compact: a torch dtype
    (e.g. ``{"image": torch.bfloat16}``, which numpy lacks) makes the key a
    torch tensor of that dtype. Floating arrays only.

    ``share`` (a data-parallel rank's: ``parallel.mesh.local_items`` for its
    mesh) maps a global batch's item count to the positions of this rank's
    items, or None for a batch that runs whole: every rank walks the same
    global order (``seed + epoch``) and loads only its items of each batch,
    which carries ``global_batch_size`` and ``whole_batch``.
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 1, seed: int = 0, prefetch_factor: int = 2,
                 drop_last: bool = False, transfer_dtype=None, collate=None,
                 share=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(int(num_workers), 1)
        self.seed = seed
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.drop_last = drop_last
        self.transfer_dtype = dict(transfer_dtype or {})
        for key, dtype in self.transfer_dtype.items():
            if dtype is not None and not isinstance(dtype, torch.dtype):
                raise TypeError(f"transfer_dtype[{key!r}] is {dtype!r}: a torch dtype")
        # multi-sample datasets (RandSpatialCropSamplesD) default to
        # collate_flatten so (B, S, C, D, H, W) folds to (B*S, ...)
        if collate is None and getattr(dataset, "multi_sample", False):
            collate = collate_flatten
        self.collate = collate
        self.share = share
        self.cases = None  # (rank, ranks): rank_cases' deal
        self.epoch = 0

    def rank_cases(self, rank: int, ranks: int) -> "DataLoader":
        """A copy of this loader over the cases ``rank``, ``rank + ranks``,
        ... of its order (case i to rank i mod ranks), for prediction."""
        out = copy.copy(self)
        out.cases = (rank, ranks)
        return out

    def _load(self, idxs) -> Dict[str, Any]:
        """The batch of the items at ``idxs`` (a global batch's: its
        rank's share under ``share``)."""
        if self.share is None:
            return self._stack([self.dataset[int(i)] for i in idxs])
        mine = self.share(len(idxs))
        batch = self._stack([self.dataset[int(i)]
                             for i in (idxs if mine is None else idxs[mine])])
        batch.update(global_batch_size=len(idxs), whole_batch=mine is None)
        return batch

    def _stack(self, samples) -> Dict[str, Any]:
        batch = _stack_batch(samples)
        if self.collate is not None:
            batch = self.collate(batch)
        for key, dtype in self.transfer_dtype.items():
            arr = batch.get(key)
            # floating only: integer class-index labels must ship untouched
            if arr is None or dtype is None or not np.issubdtype(arr.dtype, np.floating):
                continue
            batch[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
        return batch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.cases is not None:
            n = len(range(self.cases[0], n, self.cases[1]))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.cases is not None:
            order = order[self.cases[0]::self.cases[1]]
        return order

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._index_order()
        batches: List[np.ndarray] = [order[i:i + self.batch_size]
                                     for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_workers <= 1:
            for idxs in batches:
                yield self._load(idxs)
            return
        # Threaded pipeline: samples are produced by a pool, batches assembled
        # in order. Submission is lazy — at most num_workers + prefetch_factor
        # batches are in flight at once, so a slow consumer bounds host memory
        # to that window instead of accumulating the whole epoch in futures.
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        stop = threading.Event()
        max_inflight = self.num_workers + self.prefetch_factor

        def producer():
            batch_iter = iter(batches)
            pending: "deque" = deque()

            def put(item) -> bool:
                # Interruptible put: a consumer that stops iterating sets
                # ``stop`` and this returns False instead of blocking forever.
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        pass
                return False

            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                while not stop.is_set():
                    while len(pending) < max_inflight:
                        idxs = next(batch_iter, None)
                        if idxs is None:
                            break
                        pending.append(pool.submit(self._load, idxs))
                    if not pending:
                        put(("done", None))
                        return
                    fut = pending.popleft()
                    try:
                        item = ("ok", fut.result())
                    except Exception as error:  # propagate to the consumer
                        for f in pending:  # don't wait on queued batches
                            f.cancel()
                        pending.clear()
                        put(("error", error))
                        return
                    if not put(item):
                        break
                # Early stop: drop queued work (running tasks finish on their own).
                for fut in pending:
                    fut.cancel()

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                try:
                    kind, payload = out_q.get(timeout=_POLL_SECONDS)
                except queue.Empty:
                    # a producer that died without a message must not hang us
                    if not thread.is_alive() and out_q.empty():
                        raise RuntimeError("the loader's producer ended without a batch")
                    continue
                if kind == "done":
                    break
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()
            try:  # unblock a producer parked in put()
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10)


_COLLATE_REGISTRY = {
    "collate_flatten": collate_flatten,
    "collate_5d_flatten": collate_5d_flatten,
}


def build_loader(dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 1, pin_memory: bool = False,
                 prefetch_factor: int = 2, seed: int = 0,
                 transfer_dtype=None, collate=None, share=None) -> DataLoader:
    """Factory with the reference's DataLoader kwarg surface; ``pin_memory`` is
    accepted for parity (``data/prefetch.py`` always copies through pinned
    memory).
    ``collate`` may be a callable or a registered name (collate_flatten /
    collate_5d_flatten, `training_utils.py:230-240`)."""
    del pin_memory
    if isinstance(collate, str):
        if collate not in _COLLATE_REGISTRY:
            raise ValueError(f"collate {collate!r} is not supported; "
                             f"known: {sorted(_COLLATE_REGISTRY)}")
        collate = _COLLATE_REGISTRY[collate]
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      num_workers=num_workers, prefetch_factor=prefetch_factor,
                      seed=seed, transfer_dtype=transfer_dtype, collate=collate,
                      share=share)

"""Double-buffered host -> GPU transfer of a loader's batches (counterpart of
``unet3d_tpu/data/prefetch.py``).

While the GPU runs step i, a background thread takes batch i + 1 from the
loader, copies its arrays into pinned host memory and issues their copies to
the device on a side stream, without blocking, and records an event. The
consumer's stream waits on that event before it uses the batch, and each
tensor is marked as used on the consumer's stream (``record_stream``) so that
the caching allocator does not hand its memory out again while a step still
reads it. Each batch gets fresh device buffers.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Sequence

import torch

from unet3d_tpu_torch.utils.device import as_tensor

# a dead worker is noticed within this many seconds of the consumer's wait
_POLL_SECONDS = 1.0


class DevicePrefetcher:
    """Wrap a batch iterable; yield batches whose array keys are tensors on
    ``device``.

    ``depth`` bounds the batches held ahead of the consumer (device memory
    held ahead is ``depth`` batches). Errors in the loader reach the
    consumer; a consumer that stops iterating stops the worker. ``len``,
    ``set_epoch``, ``dataset`` and ``batch_size`` are the loader's. On a CPU
    device the arrays are only made tensors: nothing is pinned or copied.
    """

    def __init__(self, loader, device, keys: Sequence[str] = ("image", "label"),
                 depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        self.keys = tuple(keys)
        self.depth = max(int(depth), 1)

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    @property
    def dataset(self):
        return getattr(self.loader, "dataset", None)

    @property
    def batch_size(self):
        return getattr(self.loader, "batch_size", None)

    def _put(self, batch: Dict[str, Any], stream) -> tuple:
        """The batch with its arrays as tensors on the device, and the event
        that marks their copies done (None on a CPU device)."""
        out = dict(batch)
        present = [k for k in self.keys if out.get(k) is not None]
        if self.device.type != "cuda":
            for key in present:
                out[key] = as_tensor(out[key])
            return out, None
        pinned = {k: self._pinned(out[k]) for k in present}
        ready = torch.cuda.Event()
        with torch.cuda.stream(stream):
            for key, host in pinned.items():
                out[key] = host.to(self.device, non_blocking=True)
            ready.record(stream)
        return out, ready

    def _pinned(self, array) -> torch.Tensor:
        """``array`` as a tensor in pinned host memory."""
        return as_tensor(array).pin_memory()

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def put(item) -> bool:
            # Interruptible put: a consumer that stops iterating sets ``stop``
            # and this returns False instead of blocking forever.
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(("ok", self._put(batch, stream))):
                        return
                put(("done", None))
            except BaseException as error:  # propagate to the consumer
                put(("error", error))

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                try:
                    kind, payload = out_q.get(timeout=_POLL_SECONDS)
                except queue.Empty:
                    if not thread.is_alive() and out_q.empty():
                        raise RuntimeError("the prefetch worker ended without a batch")
                    continue
                if kind == "done":
                    break
                if kind == "error":
                    raise payload
                batch, ready = payload
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    for key in self.keys:
                        if isinstance(batch.get(key), torch.Tensor):
                            batch[key].record_stream(consumer)
                yield batch
        finally:
            stop.set()
            try:  # unblock a worker parked in put()
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=10)

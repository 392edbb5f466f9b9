"""The port's device prefetcher: the JAX package's prefetcher cases
(tests/test_prefetch.py) on the CPU, where batches only become tensors, and
on a GPU (``cuda``), where they are copied from pinned memory on a side
stream. Every test that iterates the threaded prefetcher runs under a
bounded wait, so a hang fails that test instead of stalling the run. This
file imports no JAX, so that its ``cuda`` test also runs where JAX's model
libraries are missing.
"""
import threading
import time

import numpy as np
import pytest
import torch

from unet3d_tpu_torch.data.prefetch import DevicePrefetcher

WAIT_SECONDS = 60


def bounded(fn, seconds=WAIT_SECONDS):
    """``fn()`` in a daemon thread; fails (instead of hanging) when it has
    not returned within ``seconds``. Returns its result, raises its error."""
    result = {}

    def target():
        try:
            result["value"] = fn()
        except BaseException as error:  # re-raised in the test's thread
            result["error"] = error

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(seconds)
    if thread.is_alive():
        pytest.fail(f"still running after {seconds} s: a hang")
    if "error" in result:
        raise result["error"]
    return result.get("value")


class FakeLoader:
    def __init__(self, n=4, shape=(2, 1, 4, 4, 4), label_ndim=5, fail_at=None):
        self.n = n
        self.shape = shape
        self.label_ndim = label_ndim
        self.fail_at = fail_at
        self.epoch = None
        self.batch_size = shape[0]
        self.dataset = list(range(n))

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        rng = np.random.RandomState(0)
        for i in range(self.n):
            if self.fail_at is not None and i == self.fail_at:
                raise RuntimeError("boom")
            yield {"image": rng.rand(*self.shape).astype(np.float32),
                   "label": rng.rand(*self.shape[: self.label_ndim]).astype(np.float32),
                   "subject_id": [f"s{i}"]}


def test_batches_arrive_as_tensors_and_bit_identical():
    expected = list(FakeLoader())
    got = bounded(lambda: list(DevicePrefetcher(FakeLoader(), "cpu")))
    assert len(got) == len(expected)
    for g, e in zip(got, expected):
        assert isinstance(g["image"], torch.Tensor) and isinstance(g["label"], torch.Tensor)
        assert g["subject_id"] == e["subject_id"]  # non-array keys untouched
        np.testing.assert_array_equal(g["image"].numpy(), e["image"])
        np.testing.assert_array_equal(g["label"].numpy(), e["label"])


def test_train_loop_bit_identical_through_prefetcher():
    def run(loader):
        acc = torch.zeros(())
        for batch in loader:
            acc = acc + torch.sum(torch.as_tensor(batch["image"]) * 2.0
                                  + torch.as_tensor(batch["label"]))
        return float(acc)

    assert run(FakeLoader()) == bounded(lambda: run(DevicePrefetcher(FakeLoader(), "cpu")))


def test_prefetcher_proxies_len_epoch_dataset():
    base = FakeLoader(n=3)
    pf = DevicePrefetcher(base, "cpu")
    assert len(pf) == 3
    pf.set_epoch(7)
    assert base.epoch == 7
    assert pf.dataset is base.dataset
    assert pf.batch_size == base.batch_size


def test_prefetcher_error_propagates():
    def consume():
        it = iter(DevicePrefetcher(FakeLoader(fail_at=1), "cpu"))
        next(it)
        with pytest.raises(RuntimeError, match="boom"):
            next(it)
    bounded(consume)


def test_prefetcher_consumer_break_does_not_hang():
    before = threading.active_count()

    def consume():
        for i, _ in enumerate(DevicePrefetcher(FakeLoader(n=50), "cpu", depth=1)):
            if i == 1:
                break
    bounded(consume)
    deadline = time.time() + 15
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


class RecordingPrefetcher(DevicePrefetcher):
    """Records whether each host copy was pinned, and times each batch's
    copies by events on the side stream."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pinned, self.copies = [], []

    def _put(self, batch, stream):
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

    def copy_ms(self):
        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in self.copies]


@pytest.mark.cuda
def test_prefetcher_copies_from_pinned_memory_onto_the_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    pf = RecordingPrefetcher(FakeLoader(), "cuda")
    expected = list(FakeLoader())
    got = bounded(lambda: [{k: v.cpu() if isinstance(v, torch.Tensor) else v
                            for k, v in b.items()} for b in pf])
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g["image"].numpy(), e["image"])
    assert len(pf.copies) == len(expected)
    assert len(pf.pinned) == 2 * len(expected) and all(pf.pinned)


@pytest.mark.cuda
def test_prefetcher_keeps_bf16_torch_batches_bf16_on_the_gpu():
    """A compact batch (bf16 tensors, as the loader ships them under AMP)
    reaches the GPU in bf16 through pinned memory, equal to its host copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")

    class Bf16Loader(FakeLoader):
        def __iter__(self):
            for batch in super().__iter__():
                yield {k: torch.from_numpy(v).to(torch.bfloat16) if k != "subject_id" else v
                       for k, v in batch.items()}

    expected = list(Bf16Loader())
    pf = RecordingPrefetcher(Bf16Loader(), "cuda", depth=1)
    got = bounded(lambda: [(b["image"].dtype, b["image"].device.type, b["image"].cpu(),
                            b["label"].cpu()) for b in pf])
    for (dtype, device, image, label), e in zip(got, expected):
        assert (dtype, device) == (torch.bfloat16, "cuda")
        assert torch.equal(image, e["image"]) and torch.equal(label, e["label"])
    assert len(pf.pinned) == 2 * len(expected) and all(pf.pinned)
    assert all(ms >= 0 for ms in pf.copy_ms())

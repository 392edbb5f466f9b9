"""Progress meters: wall-clock tracing of the training loop.

Counterpart of ``unet3d_tpu/train/meters.py``; ``device_memory_stats`` reads
``torch.cuda.memory_stats``.
"""
from __future__ import annotations

import torch


class AverageMeter:
    """Computes and stores the average and current value (`training_utils.py:156-178`)."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    """Prints '[batch/total] meter meter ...' lines (`training_utils.py:181-195`)."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.batch_fmtstr = self._get_batch_fmtstr(num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(meter) for meter in self.meters]
        print("\t".join(entries), flush=True)

    @staticmethod
    def _get_batch_fmtstr(num_batches: int) -> str:
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"


def human_readable_size(size, decimal_places: int = 1) -> str:
    """Parity: `training_utils.py:222-227`."""
    for unit in ["B", "KiB", "MiB", "GiB", "TiB"]:
        if size < 1024.0:
            break
        size /= 1024.0
    return f"{size:.{decimal_places}f}{unit}"


def device_memory_stats() -> dict:
    """Per-CUDA-device memory in use, at peak and in total, human-readable;
    empty without a CUDA device."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": human_readable_size(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": human_readable_size(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": human_readable_size(torch.cuda.get_device_properties(i).total_memory),
        }
    return stats


"""Label-map <-> one-hot codec, with grouped labels and hierarchy decoding.

Counterpart of ``unet3d_tpu/ops/one_hot.py`` in torch: label values come
from the config, so each channel is a vectorised compare; decoding is a
masked argmax and a table lookup. Layout: channel-first ``(n_labels, D, H,
W)``. Inputs may be numpy arrays or tensors; outputs are tensors on the
input's device.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from unet3d_tpu_torch.utils.device import as_tensor

Label = Union[int, float]
Labels = Sequence[Union[Label, Sequence[Label]]]


def _isclose(a: torch.Tensor, value: float, atol: float = 1e-8,
             rtol: float = 1e-5) -> torch.Tensor:
    """Torch-style isclose: |a - b| <= atol + rtol * |b|."""
    return torch.abs(a - value) <= (atol + rtol * abs(value))


def label_map_to_one_hot(label_map, labels: Labels = None, n_labels: int = None,
                         dtype=torch.uint8, round_values: bool = True) -> torch.Tensor:
    """Encode a label map ``(1, D, H, W)`` or ``(D, H, W)`` into
    ``(n_labels, D, H, W)``. A list entry that is itself a list groups several
    label values into one channel (the BraTS hierarchy)."""
    label_map = as_tensor(label_map)
    if label_map.dim() == 4:
        if label_map.shape[0] != 1:
            raise ValueError(f"Expected single-channel label map, got shape "
                             f"{tuple(label_map.shape)}")
        label_map = label_map[0]
    if labels is None:
        if n_labels is None:
            raise ValueError("Provide labels or n_labels")
        labels = list(range(1, n_labels + 1))
    label_map = label_map.float()
    if round_values:
        label_map = torch.round(label_map)
    channels = []
    for entry in labels:
        members = entry if isinstance(entry, (list, tuple)) else [entry]
        chan = torch.zeros(label_map.shape, dtype=torch.bool, device=label_map.device)
        for label in members:
            chan = chan | _isclose(label_map, float(label))
        channels.append(chan)
    return torch.stack(channels).to(dtype)


def mask_encoding(one_hot: torch.Tensor, n_labels: int, threshold: float = 0.5,
                  sum_then_threshold: bool = False) -> torch.Tensor:
    """Foreground mask over the first ``n_labels`` channels."""
    if sum_then_threshold:
        return torch.sum(one_hot[:n_labels], dim=0) > threshold
    return torch.any(one_hot[:n_labels] > threshold, dim=0)


def _assign_labels(one_hot: torch.Tensor, mask: torch.Tensor,
                   labels: Sequence[Label], dtype) -> torch.Tensor:
    """Masked argmax, then index -> label lookup."""
    winner = torch.argmax(one_hot[:len(labels)], dim=0)
    table = torch.tensor([float(v) for v in labels], dtype=torch.float32,
                         device=one_hot.device)
    label_map = table[winner].to(dtype)
    return torch.where(mask, label_map, torch.zeros((), dtype=dtype,
                                                    device=one_hot.device))


def _decode_hierarchy(one_hot: torch.Tensor, labels: Sequence[Label],
                      threshold: float, dtype) -> torch.Tensor:
    """Progressive roi-AND decode for nested hierarchies (BraTS WT > TC > ET)."""
    roi = torch.ones(one_hot.shape[1:], dtype=torch.bool, device=one_hot.device)
    label_map = torch.zeros(one_hot.shape[1:], dtype=dtype, device=one_hot.device)
    for index, label in enumerate(labels):
        roi = roi & (one_hot[index] > threshold)
        label_map = torch.where(roi, torch.tensor(label, dtype=dtype,
                                                  device=one_hot.device), label_map)
    return label_map


def one_hot_to_label_map(one_hot, labels: Labels, threshold: float = 0.5,
                         sum_then_threshold: bool = False, dtype=torch.int16,
                         label_hierarchy: bool = False) -> torch.Tensor:
    """Decode ``(n_labels, D, H, W)`` activations into a label map. With
    all-list ``labels`` each group decodes into its own volume, stacked
    channel-first."""
    one_hot = as_tensor(one_hot)
    if label_hierarchy:
        flat = [v[0] if isinstance(v, (list, tuple)) else v for v in labels]
        return _decode_hierarchy(one_hot, flat, threshold, dtype)
    if len(labels) > 0 and all(isinstance(v, (list, tuple)) for v in labels):
        label_maps = []
        i = 0
        for group in labels:
            segment = one_hot[i:i + len(group)]
            mask = mask_encoding(segment, len(group), threshold, sum_then_threshold)
            label_maps.append(_assign_labels(segment, mask, list(group), dtype))
            i += len(group)
        return torch.stack(label_maps)
    mask = mask_encoding(one_hot, len(labels), threshold, sum_then_threshold)
    return _assign_labels(one_hot, mask, list(labels), dtype)


def binary_erosion_3x3(binary) -> torch.Tensor:
    """One iteration of 6-connected binary erosion (scipy's default
    structuring element) over the last three axes, outside the volume false."""
    b = as_tensor(binary).bool()
    out = b
    for axis in range(b.dim() - 3, b.dim()):
        n = b.shape[axis]
        edge = torch.zeros_like(b.narrow(axis, 0, 1))
        forward = torch.cat([b.narrow(axis, 1, n - 1), edge], dim=axis)
        backward = torch.cat([edge, b.narrow(axis, 0, n - 1)], dim=axis)
        out = out & forward & backward
    return out


def estimate_binary_contour(binary) -> torch.Tensor:
    """A mask XOR its erosion: its one-voxel-thick boundary."""
    b = as_tensor(binary).bool()
    return b ^ binary_erosion_3x3(b)


def add_one_hot_encoding_contours(one_hot) -> torch.Tensor:
    """Append a contour channel per channel of a channel-first one-hot
    encoding (doubles the channel count, as the ``add_contours`` option
    doubles ``n_outputs``)."""
    one_hot = as_tensor(one_hot)
    contours = estimate_binary_contour(one_hot > 0)
    return torch.cat([one_hot, contours.to(one_hot.dtype)], dim=0)

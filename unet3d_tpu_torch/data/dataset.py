"""Segmentation dataset: the per-sample pipeline (counterpart of
``unet3d_tpu/data/dataset.py``), in the JAX package's order:

    load (multi-file channel concat) -> [orientation] -> one-hot labels ->
    [crop foreground] -> shape stage (random crop | resample-resize |
    pad-or-crop) -> spatial augmentations -> normalisation -> intensity
    augmentations

The deterministic prefix (through the non-random shape stage) is cacheable:
``SegmentationDatasetPersistent`` caches it on disk in the JAX package's
format v2 (one ``.npy`` per volume and a ``.meta.json`` commit marker, read
back with mmap) under the same content + config key, so a cache written by
either package is read by the other. The random stages draw their parameters
from a per-sample ``np.random.RandomState`` seeded as the JAX package seeds
it, and run their voxel math in torch on the CPU (``data/transforms.py``).

Each sample logs its seconds at DEBUG, the prefix (read and preprocess, or
the cache read) apart from the random stages (with the normalisation between
them), in the record's ``sample_seconds`` attribute.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from unet3d_tpu_torch.data.io import load_image
from unet3d_tpu_torch.data.transforms import RandSpatialCropD, build_transform
from unet3d_tpu_torch.ops import crop as crop_ops
from unet3d_tpu_torch.ops import normalize as normalize_ops
from unet3d_tpu_torch.ops.affine import resize_affine
from unet3d_tpu_torch.ops.one_hot import label_map_to_one_hot
from unet3d_tpu_torch.ops.resample import resize_bucketed

logger = logging.getLogger(__name__)

_NORMALIZATION_ALIASES = {
    "zero_mean": "normalize_intensity",
    "NormalizeIntensityD": "normalize_intensity",
    "NormalizeIntensityd": "normalize_intensity",
    "NormalizeIntensity": "normalize_intensity",
    "ScaleIntensityD": "scale_intensity",
    "ScaleIntensityd": "scale_intensity",
    "ScaleIntensity": "scale_intensity",
    "ScaleIntensityRangeD": "scale_intensity_range",
    "ScaleIntensityRanged": "scale_intensity_range",
    "ScaleIntensityRange": "scale_intensity_range",
    "ScaleIntensityRangePercentilesD": "scale_intensity_range_percentiles",
    "ScaleIntensityRangePercentilesd": "scale_intensity_range_percentiles",
    "ScaleIntensityRangePercentiles": "scale_intensity_range_percentiles",
    "ThresholdIntensityD": "threshold_intensity",
    "ThresholdIntensityd": "threshold_intensity",
    "ThresholdIntensity": "threshold_intensity",
    "ShiftIntensityD": "shift_intensity",
    "ShiftIntensityd": "shift_intensity",
    "ShiftIntensity": "shift_intensity",
}


def _resolve_normalization(name: str):
    fn_name = _NORMALIZATION_ALIASES.get(name, name)
    if hasattr(normalize_ops, fn_name):
        return getattr(normalize_ops, fn_name)
    raise ValueError(f"{name} normalization method not yet implemented")


def apply_normalization(image, normalization, normalization_kwargs):
    """One name, or a list of names with per-name kwargs; returns f32 numpy."""
    if normalization is None:
        return image
    kwargs = normalization_kwargs or {}
    if isinstance(normalization, str):
        image = _resolve_normalization(normalization)(image, **kwargs)
    else:
        for name in normalization:
            image = _resolve_normalization(name)(image, **kwargs.get(name, {}))
    return np.asarray(image, dtype=np.float32)


class SegmentationDataset:
    """The JAX dataset: its constructor, prefix, random stages and seeds."""

    def __init__(self, filenames: Sequence[Dict[str, Any]], labels=None,
                 inference: Any = "auto", desired_shape: Optional[Sequence[int]] = None,
                 normalization: Any = "zero_mean", normalization_kwargs: Optional[dict] = None,
                 crop_foreground: bool = False, foreground_percentile: float = 0.1,
                 random_crop: bool = False, resample: bool = False,
                 intensity_augmentations: Optional[List[dict]] = None,
                 spatial_augmentations: Optional[List[dict]] = None,
                 orientation: Optional[str] = None, reader=None, verbose: bool = False,
                 base_seed: int = 0):
        del reader, verbose  # API parity
        self.filenames = list(filenames)
        if inference == "auto":
            inference = "label" not in self.filenames[0]
        self.inference = bool(inference)
        if not self.inference and labels is None:
            raise ValueError("Must set 'labels' for segmentation dataset when not "
                             "in inference mode.")
        self.labels = labels
        self.desired_shape = tuple(desired_shape) if desired_shape else None
        self.normalization = normalization
        self.normalization_kwargs = normalization_kwargs
        self.crop_foreground = crop_foreground
        self.foreground_percentile = foreground_percentile
        self.random_crop = random_crop
        self.resample = resample
        self.orientation = orientation
        self.base_seed = base_seed
        self.epoch = 0
        self.spatial_transforms = [build_transform(s) for s in (spatial_augmentations or [])]
        self.intensity_transforms = [build_transform(s)
                                     for s in (intensity_augmentations or [])]
        self.random_cropper = (RandSpatialCropD(roi_size=self.desired_shape)
                               if self.random_crop and self.desired_shape else None)

    def __len__(self) -> int:
        return len(self.filenames)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-epoch augmentation stream."""
        self.epoch = epoch

    def _deterministic_prefix(self, item: Dict[str, Any]) -> Dict[str, Any]:
        """load -> orient -> one-hot -> crop-foreground -> non-random shape stage."""
        image = load_image(item["image"], reorder=bool(self.orientation),
                           axcodes=self.orientation or "RAS", dtype=np.float32)
        label_data = None
        if not self.inference and "label" in item:
            label_vol = load_image(item["label"], reorder=bool(self.orientation),
                                   axcodes=self.orientation or "RAS")
            label_data = np.asarray(label_map_to_one_hot(
                np.asarray(label_vol.data), labels=self.labels), dtype=np.float32)
        data = np.asarray(image.data, dtype=np.float32)
        affine = image.affine

        if self.crop_foreground:
            data, affine, label_data, _ = crop_ops.crop_foreground(
                data, affine, label=label_data,
                foreground_percentile=self.foreground_percentile, margin=1)

        if self.desired_shape and not self.random_crop:
            if self.resample:
                true_shape = data.shape[-3:]
                affine = resize_affine(affine, true_shape, self.desired_shape)
                data = np.asarray(resize_bucketed(data, true_shape, self.desired_shape,
                                                  mode="trilinear"))
                if label_data is not None:
                    label_data = np.asarray(resize_bucketed(
                        label_data, true_shape, self.desired_shape, mode="nearest"))
            else:
                data, affine = crop_ops.pad_or_crop(data, self.desired_shape, affine=affine)
                if label_data is not None:
                    label_data = crop_ops.pad_or_crop(label_data, self.desired_shape)

        out = {"image": data, "affine": affine, "source_filename": item["image"]}
        if label_data is not None:
            out["label"] = label_data
        return out

    @property
    def multi_sample(self) -> bool:
        """True when a transform emits several patches per input sample
        (RandSpatialCropSamplesD): samples are then (S, C, D, H, W) and the
        loader collates with ``collate_flatten``."""
        return any(getattr(t, "num_samples", 1) > 1 for t in self.spatial_transforms)

    def _random_stages(self, sample: Dict[str, Any], index: int) -> Dict[str, Any]:
        """random crop -> spatial augmentations (multi-sample ones fan out)
        -> normalisation -> intensity augmentations, each patch as f32 numpy."""
        rng = np.random.RandomState(
            (self.base_seed * 1_000_003 + self.epoch * 10_007 + index) % (2 ** 31))
        image = sample["image"]
        label = sample.get("label")
        if self.random_cropper is not None:
            image, label = self.random_cropper(rng, image, label)
        pairs = [(image, label)]
        for t in self.spatial_transforms:
            if getattr(t, "num_samples", 1) > 1:
                fanned = []
                for im, lb in pairs:
                    fanned.extend(t.samples(rng, im, lb))
                pairs = fanned
            else:
                pairs = [t(rng, im, lb) for im, lb in pairs]
        images, labels = [], []
        for im, lb in pairs:
            im = apply_normalization(im, self.normalization, self.normalization_kwargs)
            for t in self.intensity_transforms:
                im, _ = t(rng, im, lb)
            images.append(np.asarray(im, dtype=np.float32))
            labels.append(None if lb is None else np.asarray(lb, dtype=np.float32))
        if len(images) == 1:
            image_out, label_out = images[0], labels[0]
        else:  # (S, C, D, H, W): collate_flatten's input shape
            image_out = np.stack(images)
            label_out = None if labels[0] is None else np.stack(labels)
        out = {"image": image_out, "affine": sample["affine"],
               "source_filename": sample["source_filename"]}
        if label_out is not None:
            out["label"] = label_out
        return out

    def __getitem__(self, index: int) -> Dict[str, Any]:
        t0 = time.perf_counter()
        sample = self._deterministic_prefix(self.filenames[index])
        t1 = time.perf_counter()
        out = self._random_stages(sample, index)
        seconds = {"index": index, "preprocess": t1 - t0,
                   "augment": time.perf_counter() - t1}
        logger.debug("sample %d: preprocess %.3f s, augment %.3f s", index,
                     seconds["preprocess"], seconds["augment"],
                     extra={"sample_seconds": seconds})
        return out


class SegmentationDatasetPersistent(SegmentationDataset):
    """The deterministic prefix cached on disk (the JAX format v2 and key)."""

    def __init__(self, filenames, cache_dir: str, **kwargs):
        super().__init__(filenames, **kwargs)
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    @staticmethod
    def _file_signatures(item: Dict[str, Any]):
        """(path, size, mtime_ns) of every input file, so that rewriting a
        source in place invalidates its entry."""
        sigs = []
        stack = [item]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, (list, tuple)):
                stack.extend(node)
            elif isinstance(node, str) and os.path.exists(node):
                st = os.stat(node)
                sigs.append((node, st.st_size, st.st_mtime_ns))
        return sorted(sigs)

    def _cache_key(self, item: Dict[str, Any]) -> str:
        spec = {"item": item, "files": self._file_signatures(item),
                "labels": self.labels,
                "desired_shape": self.desired_shape, "crop": self.crop_foreground,
                "fg_pct": self.foreground_percentile, "random_crop": self.random_crop,
                "resample": self.resample, "orientation": self.orientation,
                "inference": self.inference}
        return hashlib.sha1(json.dumps(spec, sort_keys=True, default=str).encode()).hexdigest()

    def _deterministic_prefix(self, item: Dict[str, Any]) -> Dict[str, Any]:
        key = os.path.join(self.cache_dir, self._cache_key(item))
        meta_path = key + ".meta.json"
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                out = {"image": np.load(key + ".image.npy", mmap_mode="r"),
                       "affine": np.asarray(meta["affine"], dtype=np.float64),
                       "source_filename": meta["source_filename"]}
                if meta["has_label"]:
                    out["label"] = np.load(key + ".label.npy", mmap_mode="r")
                return out
            except Exception as error:  # corrupt cache entry: recompute
                logging.warning("Ignoring corrupt cache entry %s (%s)", meta_path, error)
        legacy = key + ".npz"  # format v1
        if os.path.exists(legacy):
            try:
                with np.load(legacy, allow_pickle=True) as data:
                    out = {"image": data["image"], "affine": data["affine"],
                           "source_filename": data["source_filename"].tolist()}
                    if "label" in data.files:
                        out["label"] = data["label"]
                    return out
            except Exception as error:  # corrupt cache entry: recompute
                logging.warning("Ignoring corrupt cache entry %s (%s)", legacy, error)
        out = super()._deterministic_prefix(item)
        pid = os.getpid()
        for name in ("image", "label"):
            if name in out:
                tmp = f"{key}.{name}.tmp{pid}.npy"
                np.save(tmp, np.asarray(out[name]))
                os.replace(tmp, f"{key}.{name}.npy")
        meta = {"affine": np.asarray(out["affine"], dtype=np.float64).tolist(),
                "source_filename": out["source_filename"],
                "has_label": "label" in out}
        tmp = f"{meta_path}.tmp{pid}"
        with open(tmp, "w") as f:
            json.dump(meta, f)  # written last: commits the entry
        os.replace(tmp, meta_path)
        return out


DATASET_REGISTRY = {
    "SegmentationDataset": SegmentationDataset,
    "SegmentationDatasetPersistent": SegmentationDatasetPersistent,
}


def load_dataset_class(dataset_config: dict, cache_dir: Optional[str] = None):
    """Resolve ``dataset.name`` and give a Persistent dataset ``cache_dir``."""
    name = dataset_config.get("name", "SegmentationDatasetPersistent")
    if name not in DATASET_REGISTRY:
        raise ValueError(f"Dataset class {name} is not supported")
    cls = DATASET_REGISTRY[name]
    if name.endswith("Persistent") and cache_dir is not None:
        import functools
        return functools.partial(cls, cache_dir=cache_dir)
    return cls


def validate_filenames(filenames: Sequence[Dict[str, Any]], raise_on_missing: bool = False):
    """Skip (with a warning) items whose files are missing, or raise."""
    valid = []
    for item in filenames:
        paths = []
        for key in ("image", "label"):
            v = item.get(key)
            if v is None:
                continue
            paths.extend(v if isinstance(v, (list, tuple)) else [v])
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            if raise_on_missing:
                raise FileNotFoundError(f"Missing data files: {missing}")
            warnings.warn(f"Skipping {item}: missing files {missing}")
            continue
        valid.append(item)
    return valid

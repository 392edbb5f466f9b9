"""Filename-list construction helpers.

Parity: `unet3d/utils/filenames.py` — the template / paired / multisource /
hcp-classic constructors (:16-171) and the config-driven ``generate_filenames``
dispatch, plus subject-id loading (:174-177). The reference emits positional
rows ``[features, feature_sub_volumes, targets, target_sub_volumes,
subject_id]``; here each row is the framework's dict schema (``image`` /
``label`` + optional ``feature_sub_volumes`` / ``target_sub_volumes`` /
``surface`` / ``subject_id`` keys). ``load_dataset_class`` lives in
`unet3d_tpu_torch/data/dataset.py`. A copy of
``unet3d_tpu/data/filenames.py`` (numpy-free host code), so the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Union


def _format_templates(templates, directory: str = "", **kwargs):
    """Parity: `filenames.py:91-95`."""
    if isinstance(templates, str):
        return os.path.join(directory, templates).format(**kwargs)
    return [os.path.join(directory, t).format(**kwargs) for t in templates]


def _exists(filenames) -> bool:
    if filenames is None:
        return True
    if isinstance(filenames, str):
        filenames = [filenames]
    return all(os.path.exists(fn) for fn in filenames)


def generate_filenames_from_templates(
        subject_ids: Sequence[str],
        feature_templates: Union[str, Sequence[str]],
        target_templates: Union[str, Sequence[str], None] = None,
        feature_sub_volumes=None, target_sub_volumes=None,
        raise_if_not_exists: bool = False, directory: str = "",
        skip_targets: bool = False) -> List[Dict[str, object]]:
    """Expand "{subject}"-style templates into the filenames-list schema.

    Parity: `filenames.py:103-127` including the skip-missing-subject
    semantics ("{}" and "{subject}" placeholders both accepted).

    Example::

        generate_filenames_from_templates(
            ["sub01", "sub02"],
            feature_templates=["data/{subject}/t1.nii.gz", "data/{subject}/t2.nii.gz"],
            target_templates="data/{subject}/seg.nii.gz")
    """
    if isinstance(feature_templates, str):
        feature_templates = [feature_templates]
    filenames = []
    for subject in subject_ids:
        images = [os.path.join(directory, t).format(subject=subject)
                  for t in feature_templates]
        entry: Dict[str, object] = {
            "image": images if len(images) > 1 else images[0],
            "subject_id": subject}
        if target_templates is not None and not skip_targets:
            entry["label"] = _format_templates(target_templates, directory,
                                               subject=subject)
        if feature_sub_volumes is not None:
            entry["feature_sub_volumes"] = feature_sub_volumes
        if target_sub_volumes is not None:
            entry["target_sub_volumes"] = target_sub_volumes
        if _exists(entry["image"]) and (skip_targets or _exists(entry.get("label"))):
            filenames.append(entry)
        elif raise_if_not_exists:
            missing = [p for group in (entry["image"], entry.get("label"))
                       for p in ([group] if isinstance(group, str) else group or [])
                       if not os.path.exists(p)]
            raise FileNotFoundError(f"Missing files for {subject}: {missing}")
        else:
            # reference semantics: silently skip subjects with missing files
            # ONLY when any file is absent; complete subjects were appended
            continue
    return filenames


def generate_filenames_from_multisource_templates(
        subject_ids: Dict[str, Sequence[str]], feature_templates: Dict,
        target_templates: Dict, feature_sub_volumes: Optional[Dict] = None,
        target_sub_volumes: Optional[Dict] = None,
        raise_if_not_exists: bool = False,
        directory: str = "") -> Dict[str, List[Dict[str, object]]]:
    """Per-dataset template expansion (parity: `filenames.py:130-144`)."""
    out = {}
    for dataset in subject_ids:
        out[dataset] = generate_filenames_from_templates(
            subject_ids[dataset], feature_templates[dataset],
            target_templates[dataset],
            feature_sub_volumes[dataset] if feature_sub_volumes else None,
            target_sub_volumes[dataset] if target_sub_volumes else None,
            raise_if_not_exists=raise_if_not_exists, directory=directory)
    return out


def _n_volumes(filename: str) -> int:
    from unet3d_tpu_torch.data.nifti import load
    data = load(filename)[0]
    return int(data.shape[-1]) if data.ndim == 4 else 1


def generate_paired_filenames(directory: str, subject_ids: Sequence[str],
                              group: str, keys: Dict, basename: str,
                              additional_feature_basename: Optional[str] = None,
                              raise_if_not_exists: bool = False
                              ) -> List[Dict[str, object]]:
    """Pairs of acquisitions predicting each other, one row per sub-volume in
    each direction (parity: `filenames.py:49-88`)."""
    rows: List[Dict[str, object]] = []
    pair = keys["all"]
    pair_key = list(pair.keys())[0]
    volume_numbers: Dict[str, range] = {}
    for subject_id in [str(s) for s in subject_ids]:
        template = os.path.join(directory, subject_id, basename)
        additional = None
        if additional_feature_basename is not None:
            additional = os.path.join(directory, subject_id,
                                      additional_feature_basename)
            if not os.path.exists(additional):
                if raise_if_not_exists:
                    raise FileNotFoundError(additional)
                continue
        for key in keys[group]:
            for value in keys[group][key]:
                fn1 = template.format(**{key: value, pair_key: pair[pair_key][0]})
                fn2 = template.format(**{key: value, pair_key: pair[pair_key][1]})
                if not (os.path.exists(fn1) and os.path.exists(fn2)):
                    if raise_if_not_exists:
                        raise FileNotFoundError(fn1 if not os.path.exists(fn1)
                                                else fn2)
                    continue
                if value not in volume_numbers:
                    volume_numbers[value] = range(_n_volumes(fn1))
                for vol in volume_numbers[value]:
                    for src, dst in ((fn1, fn2), (fn2, fn1)):
                        if additional is not None:
                            rows.append({"image": [additional, src],
                                         "feature_sub_volumes": [0, vol + 1],
                                         "label": dst,
                                         "target_sub_volumes": [vol],
                                         "subject_id": subject_id})
                        else:
                            rows.append({"image": src,
                                         "feature_sub_volumes": [vol],
                                         "label": dst,
                                         "target_sub_volumes": [vol],
                                         "subject_id": subject_id})
    return rows


def generate_hcp_filenames(directory: str, surface_basename_template,
                           target_basenames, feature_basenames, subject_ids,
                           hemispheres) -> List[Dict[str, object]]:
    """HCP surface-metric rows (parity: `filenames.py:16-46`)."""
    rows: List[Dict[str, object]] = []
    for subject_id in [str(s) for s in subject_ids]:
        subject_dir = os.path.join(directory, subject_id)
        if isinstance(feature_basenames, str):
            features = os.path.join(subject_dir, feature_basenames)
            if not os.path.exists(features):
                continue
        else:
            features = [os.path.join(subject_dir, fbn) for fbn in feature_basenames]
        surfaces = None
        if surface_basename_template is not None:
            surfaces = [os.path.join(subject_dir, surface_basename_template.format(
                hemi=hemi, subject_id=subject_id)) for hemi in hemispheres]
        if isinstance(target_basenames, str):
            metrics = os.path.join(subject_dir, target_basenames)
            if "{}" in metrics:
                metrics = metrics.format(subject_id)
            if not os.path.exists(metrics):
                continue
        elif target_basenames is not None:
            metrics = [os.path.join(subject_dir, mbn.format(subject_id))
                       for mbn in target_basenames]
        else:
            metrics = None
        row: Dict[str, object] = {"image": features, "subject_id": subject_id}
        if surfaces is not None:
            row["surface"] = surfaces
        if metrics is not None:
            row["label"] = metrics
        rows.append(row)
    return rows


def load_subject_ids_into_config(config: Dict, name: str,
                                 directory: str = "") -> None:
    """Fill ``config[name]`` from ``config["subjects_filename"]`` (a JSON of
    per-group subject-id lists). Parity: `filenames.py:174-177`."""
    if "subjects_filename" in config:
        with open(os.path.join(directory, config["subjects_filename"])) as f:
            subjects = json.load(f)
        config[name] = subjects[name]


def generate_filenames(config: Dict, name: str, directory: str = "",
                       skip_targets: bool = False,
                       raise_if_not_exists: bool = False):
    """Config-driven dispatch (parity: `filenames.py:147-171`):
    ``config["generate_filenames"]`` in {classic, paired, templates,
    multisource_templates}, kwargs in ``config["generate_filenames_kwargs"]``.
    """
    if name not in config:
        load_subject_ids_into_config(config, name, directory)
    mode = config.get("generate_filenames", "classic")
    if mode == "classic":
        return generate_hcp_filenames(
            directory, config.get("surface_basename_template"),
            config["target_basenames"], config["feature_basenames"],
            config[name], config.get("hemispheres"))
    if mode == "paired":
        return generate_paired_filenames(
            directory, config[name], name,
            raise_if_not_exists=raise_if_not_exists,
            **config["generate_filenames_kwargs"])
    if mode == "multisource_templates":
        return generate_filenames_from_multisource_templates(
            config[name], raise_if_not_exists=raise_if_not_exists,
            **config["generate_filenames_kwargs"])
    if mode == "templates":
        return generate_filenames_from_templates(
            config[name], raise_if_not_exists=raise_if_not_exists,
            skip_targets=skip_targets, directory=directory,
            **config["generate_filenames_kwargs"])
    raise ValueError(f"Unknown generate_filenames mode: {mode}")


def load_subject_ids(filename_or_list) -> List[str]:
    """Subject ids from an inline list or a text file with one id per line.

    Parity: `unet3d/utils/filenames.py:174-177`.
    """
    if isinstance(filename_or_list, (list, tuple)):
        return list(filename_or_list)
    with open(filename_or_list) as f:
        return [line.strip() for line in f if line.strip()]


def discover_subject_dirs(directory: str, image_glob: str = "*.nii*",
                          label_keyword: Optional[str] = "seg") -> List[Dict[str, object]]:
    """One entry per subject sub-directory; files matching ``label_keyword``
    become the label, the rest become (sorted) image channels — the BraTS
    directory convention (`examples/brats2020` recipe)."""
    filenames = []
    for subject_folder in sorted(glob.glob(os.path.join(directory, "*"))):
        if not os.path.isdir(subject_folder):
            continue
        files = sorted(glob.glob(os.path.join(subject_folder, image_glob)))
        label = None
        if label_keyword:
            for i, fn in enumerate(files):
                if label_keyword in os.path.basename(fn).lower():
                    label = files.pop(i)
                    break
        entry: Dict[str, object] = {"image": files if len(files) > 1 else files[0]}
        if label is not None:
            entry["label"] = label
        filenames.append(entry)
    return filenames

"""The port's copy of the filename helpers (``data/filenames.py``) against
the JAX package's, on the same directories: equal rows from every helper."""
import os

import numpy as np
import pytest

from unet3d_tpu.data import filenames as jax_filenames
from unet3d_tpu.data import nifti as jax_nifti

from unet3d_tpu_torch.data import filenames


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "w").write("")
    return path


def _both(name, *args, **kwargs):
    got = getattr(filenames, name)(*args, **kwargs)
    want = getattr(jax_filenames, name)(*args, **kwargs)
    assert got == want
    return got


@pytest.fixture
def subjects(tmp_path):
    d = str(tmp_path)
    for s in ("s1", "s2"):
        for fn in (f"{s}/t1.nii.gz", f"{s}/t2.nii.gz", f"{s}/seg.nii.gz"):
            _touch(os.path.join(d, fn))
    return d


def test_templates_match_jax(subjects):
    out = _both("generate_filenames_from_templates", ["s1", "s2", "s3"],
                feature_templates=["{subject}/t1.nii.gz", "{subject}/t2.nii.gz"],
                target_templates="{subject}/seg.nii.gz", directory=subjects)
    assert [row["subject_id"] for row in out] == ["s1", "s2"]  # s3 skipped
    _both("generate_filenames_from_templates", ["s1"], "{subject}/t1.nii.gz",
          directory=subjects, skip_targets=True)
    for module in (filenames, jax_filenames):
        with pytest.raises(FileNotFoundError, match="s3"):
            module.generate_filenames_from_templates(
                ["s3"], os.path.join(subjects, "{subject}.nii.gz"),
                raise_if_not_exists=True)


def test_subject_ids_and_discovery_match_jax(subjects, tmp_path):
    fn = str(tmp_path / "ids.txt")
    open(fn, "w").write("sub01\nsub02\n\n")
    assert _both("load_subject_ids", fn) == ["sub01", "sub02"]
    _both("load_subject_ids", ["a", "b"])
    out = _both("discover_subject_dirs", subjects)
    assert len(out) == 2 and out[0]["label"].endswith("seg.nii.gz")


@pytest.mark.parametrize("skip_targets", [False, True])
def test_config_dispatch_matches_jax(tmp_path, skip_targets):
    d = str(tmp_path)
    for s in ("s1", "s2"):
        _touch(os.path.join(d, f"{s}_t1.nii.gz"))
        _touch(os.path.join(d, f"{s}_seg.nii.gz"))
    config = {"generate_filenames": "templates",
              "generate_filenames_kwargs": {"feature_templates": "{subject}_t1.nii.gz",
                                            "target_templates": "{subject}_seg.nii.gz"},
              "training": ["s1", "s2"]}
    out = _both("generate_filenames", config, "training", directory=d,
                skip_targets=skip_targets)
    assert len(out) == 2 and all(("label" in row) != skip_targets for row in out)


def test_multisource_paired_and_hcp_match_jax(tmp_path):
    d = str(tmp_path)
    _touch(os.path.join(d, "x1.nii.gz"))
    _touch(os.path.join(d, "y1.nii.gz"))
    _both("generate_filenames_from_multisource_templates", {"dsA": ["1"]},
          feature_templates={"dsA": "x{subject}.nii.gz"},
          target_templates={"dsA": "y{subject}.nii.gz"}, directory=d)
    os.makedirs(os.path.join(d, "sub1"))
    vol = np.random.RandomState(0).rand(4, 4, 4, 2).astype(np.float32)
    for run in ("run1", "run2"):
        jax_nifti.save(os.path.join(d, "sub1", f"bold_{run}.nii.gz"), vol, np.eye(4))
    rows = _both("generate_paired_filenames", d, ["sub1"], "training",
                 keys={"all": {"pair": ["run1", "run2"]}, "training": {"task": ["rest"]}},
                 basename="bold_{pair}.nii.gz")
    assert len(rows) == 4  # 2 sub-volumes x 2 directions
    _touch(os.path.join(d, "100206", "T1w.nii.gz"))
    _touch(os.path.join(d, "100206", "100206_curvature.nii.gz"))
    rows = _both("generate_hcp_filenames", d,
                 surface_basename_template="{hemi}.white.{subject_id}.surf.gii",
                 target_basenames="{}_curvature.nii.gz", feature_basenames="T1w.nii.gz",
                 subject_ids=["100206", "999999"], hemispheres=["L", "R"])
    assert len(rows) == 1

"""The port's train CLI: its flags against the JAX CLI's, the device it
needs, the options it refuses, cross-validation, ``--dry_run``, ``--debug``
and ``--batch_size``, on copies of the fixture case at 16^3 on the CPU (see
tests/test_torch_train_cli.py for the parity of a training run).
"""
import json
import os
import warnings

import pytest
import torch

from unet3d_tpu.scripts import train as jax_train

from unet3d_tpu_torch.scripts import train
from unet3d_tpu_torch.train.train import read_training_log

from test_torch_train_cli import small_brats_config


def _write(root, config, name="small.json"):
    path = os.path.join(str(root), name)
    json.dump(config, open(path, "w"))
    return path


@pytest.fixture
def config_file(tmp_path):
    config = small_brats_config(str(tmp_path), n_train=2, n_val=1, test=False)
    config["training"]["n_epochs"] = 1
    return _write(tmp_path, config)


def test_parser_takes_the_jax_flags():
    args = ["--config_filename", "c.json"]
    assert vars(train.parse_args(args)) == vars(jax_train.parse_args(args))
    full = args + ["--output_dir", "o", "--setup_crossval_only", "--pretrained_model_filename",
                   "m.npz", "--batch_size", "3", "--debug", "--nthreads", "2", "--ngpus", "2",
                   "--pin_memory", "--mesh", "data2", "--dry_run", "--n_examples", "0",
                   "--machine_config_filename", "mc.json"]
    assert vars(train.parse_args(full)) == vars(jax_train.parse_args(full))


def test_train_without_a_gpu_raises_unless_given_the_cpu(config_file, tmp_path, monkeypatch):
    """No silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config_filename", config_file])
    assert not os.path.exists(os.path.join(str(tmp_path), "small", "training_log.csv"))


@pytest.mark.parametrize("flags,training", [
    (["--ngpus", "2"], {}), (["--mesh", "data2"], {}),
    ([], {"checkpoint_backend": "orbax"}), ([], {"gradient_accumulation_steps": 2}),
    ([], {"remat": True}), ([], {"save_optimizer": True})],
    ids=["ngpus", "mesh", "orbax", "grad-accum", "remat", "save-optimizer"])
def test_unported_options_raise(tmp_path, flags, training):
    config = small_brats_config(str(tmp_path), n_train=1, n_val=0, test=False)
    config["training"].update(training)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--config_filename", _write(tmp_path, config)] + flags, device="cpu")
    assert not os.path.exists(os.path.join(str(tmp_path), "small", "training_log.csv"))


def test_cross_validation_trains_every_fold(tmp_path):
    config = small_brats_config(str(tmp_path), n_train=4, n_val=0, test=False)
    config["training"]["n_epochs"] = 1
    config["cross_validation"] = {"folds": 2, "seed": 25}
    config_file = _write(tmp_path, config)
    assert train.main(["--config_filename", config_file, "--setup_crossval_only"],
                      device="cpu") == []
    work = os.path.join(str(tmp_path), "small")
    assert sorted(os.listdir(work)) == ["fold1.json", "fold2.json"]
    folds = train.main(["--config_filename", config_file], device="cpu")
    assert [r["work_dir"] for r in folds] == [os.path.join(work, f"fold{i}") for i in (1, 2)]
    seen = []
    for i, result in enumerate(folds):
        fold = json.load(open(os.path.join(work, f"fold{i + 1}.json")))
        assert len(fold["training_filenames"]) == len(fold["validation_filenames"]) == 2
        seen += [c["label"] for c in fold["validation_filenames"]]
        assert len(read_training_log(os.path.join(result["work_dir"],
                                                  "training_log.csv"))) == 1
        assert len(result["predictions"]["validation"]) == 2
    assert sorted(seen) == sorted(c["label"] for c in config["training_filenames"])


def test_dry_run_reports_one_step_without_training(config_file, tmp_path):
    with pytest.warns(RuntimeWarning, match="batch size"):
        report = train.main(["--config_filename", config_file, "--dry_run",
                             "--batch_size", "2"], device="cpu")
    work = os.path.join(str(tmp_path), "small")
    assert json.load(open(os.path.join(work, "compile_report.json"))) == report
    assert report == {"backend": "cpu", "mesh": None,
                      "images": [[2, 2, 16, 16, 16], "float32"],
                      "labels": [[2, 3, 16, 16, 16], "float32"], "amp": False,
                      "gradient_accumulation_steps": 1}
    assert not os.path.exists(os.path.join(work, "model.npz"))
    assert not os.path.exists(os.path.join(work, "training_log.csv"))


def test_debug_raises_on_a_missing_file_and_ends_with_the_call(tmp_path):
    config = small_brats_config(str(tmp_path), n_train=1, n_val=0, test=False)
    config["training_filenames"].append({"image": [str(tmp_path / "missing.nii.gz")],
                                         "label": str(tmp_path / "missing_seg.nii.gz")})
    config_file = _write(tmp_path, config)
    filters = list(warnings.filters)
    with pytest.raises(FileNotFoundError, match="missing"):
        train.main(["--config_filename", config_file, "--debug"], device="cpu")
    assert warnings.filters == filters  # the error filter ended with the call
    with pytest.warns(UserWarning, match="missing"):
        report = train.main(["--config_filename", config_file, "--dry_run"], device="cpu")
    assert report["images"][0][0] == 1

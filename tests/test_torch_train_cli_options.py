"""The port's train CLI: its flags against the JAX CLI's, the device it
needs, the options it refuses (the space and model mesh axes and orbax
only), the options it
took over from the JAX CLI (gradient accumulation with its checks, remat,
the optimizer state, flexible pretrained loading), cross-validation,
``--dry_run``, ``--debug`` and ``--batch_size``, on copies of the fixture
case at 16^3 on the CPU (see tests/test_torch_train_cli.py and
tests/test_torch_train_cli_resume.py for the parity of training runs).
"""
import json
import math
import os
import warnings

import numpy as np
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
    (["--ngpus", "2", "--mesh", "space2"], {}), (["--mesh", "data1,space2"], {}),
    (["--mesh", "model2"], {}), ([], {"checkpoint_backend": "orbax"})],
    ids=["ngpus", "mesh", "model", "orbax"])
def test_unported_options_raise(tmp_path, flags, training):
    """What the CLI does not run raises before any rank starts: a ``model``
    axis, orbax checkpoints, and a ``space`` axis for a net without a space
    form, VNet (DynUNet and UNet3D have one: ``tests/test_torch_space_cli.py``;
    the other nets that do: ``tests/test_torch_space_nets.py``)."""
    config = small_brats_config(str(tmp_path), n_train=1, n_val=0, test=False)
    config["training"].update(training)
    if any("space" in f for f in flags):
        config["model"] = {"name": "VNet", "in_channels": 2, "out_channels": 3}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--config_filename", _write(tmp_path, config)] + flags, device="cpu")
    assert not os.path.exists(os.path.join(str(tmp_path), "small", "training_log.csv"))


@pytest.mark.parametrize("training", [
    {"gradient_accumulation_steps": 2, "batch_size": 2}, {"remat": True},
    {"save_optimizer": True}],
    ids=["grad-accum", "remat", "save-optimizer"])
def test_refused_options_now_train(tmp_path, training):
    """The options the CLI refused before they were ported train one epoch
    through the CLI on the CPU; ``save_optimizer`` writes the optimizer file
    in the JAX package's format."""
    config = small_brats_config(str(tmp_path), n_train=2, n_val=0, test=False)
    config["training"].update(n_epochs=1, **training)
    result = train.main(["--config_filename", _write(tmp_path, config)], device="cpu")
    rows = read_training_log(os.path.join(result["work_dir"], "training_log.csv"))
    assert len(rows) == 1 and all(map(math.isfinite, rows[0][:3]))
    optimizer_file = os.path.join(result["work_dir"], "model_optimizer.npz")
    assert os.path.exists(optimizer_file) == bool(training.get("save_optimizer"))
    assert result["model"].remat == bool(training.get("remat"))
    if os.path.exists(optimizer_file):
        with np.load(optimizer_file) as data:
            assert int(data[".count"]) == 2 and ".hyperparams['learning_rate']" in data


def test_batch_criterion_with_accumulation_raises_like_jax(tmp_path):
    config = small_brats_config(str(tmp_path), n_train=2, n_val=0, test=False)
    config["training"].update(gradient_accumulation_steps=2, batch_size=2)
    config["loss"]["batch"] = True
    with pytest.raises(ValueError, match="batch=True"):
        train.main(["--config_filename", _write(tmp_path, config)], device="cpu")
    config["loss"].update(batch=False, reduction="sum")
    config["training"]["n_epochs"] = 1
    with pytest.warns(RuntimeWarning, match="reduction='sum'"):
        train.main(["--config_filename", _write(tmp_path, config, "sum.json")],
                   device="cpu")


def test_pretrained_checkpoint_of_other_shapes_loads_flexibly(tmp_path):
    """A checkpoint of a 1-output model (the SPPIN head) fine-tunes the
    3-output config: tiled onto the new head, as the JAX CLI loads it."""
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
    from unet3d_tpu_torch.models.layers import init_parameters
    from unet3d_tpu_torch.models.registry import create_model
    from unet3d_tpu_torch.train.checkpoint import save_checkpoint
    config = small_brats_config(str(tmp_path), n_train=1, n_val=0, test=False)
    model_kwargs = {k: v for k, v in config["model"].items() if k != "name"}
    source = create_model("DynUNet", **{**model_kwargs, "out_channels": 1})
    init_parameters(source, torch.Generator().manual_seed(1))
    pretrained = str(tmp_path / "pretrained.npz")
    save_checkpoint(source, pretrained)
    report = train.main(["--config_filename", _write(tmp_path, config), "--dry_run",
                         "--pretrained_model_filename", pretrained], device="cpu")
    assert report["images"][0] == [1, 2, 16, 16, 16]
    model = build_or_load_model_from_config(config, pretrained, torch.device("cpu"),
                                            strict=False)
    head = model.output_block.kernel.detach()
    assert head.shape[-1] == 3
    for k in range(3):
        assert torch.equal(head[..., k], source.output_block.kernel.detach()[..., 0])
    with pytest.raises(ValueError, match="shape mismatch"):
        build_or_load_model_from_config(config, pretrained, torch.device("cpu"))


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


def test_dry_run_reports_gradient_accumulation(tmp_path):
    config = small_brats_config(str(tmp_path), n_train=2, n_val=0, test=False)
    config["training"].update(gradient_accumulation_steps=2, batch_size=2, remat=True)
    report = train.main(["--config_filename", _write(tmp_path, config), "--dry_run"],
                        device="cpu")
    assert report["gradient_accumulation_steps"] == 2
    assert report["images"][0][0] == 2


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

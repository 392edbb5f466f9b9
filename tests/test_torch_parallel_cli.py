"""The port's CLIs on two data-parallel ranks (``--ngpus 2``: two gloo
processes on the CPU under ``device="cpu"``) against the same CLIs on one
device.

One config (the BraTS config cut to the fixture case at 16^3, SGD, batch 2
and validation batch 2 over 3 training, 3 validation and 3 test cases: each
epoch's second batch of one case runs whole on both ranks), trained for 2
epochs both ways: the training log within 1e-5, the checkpoint's every
tensor within 1e-5 of its largest value (sum orders differ), each group's
predictions the single-device run's files, each written once (rank r writes
the cases r, r + 2, ...). The predict CLI at ``n_gpus: 2`` (JAX's default
plan for this DynUNet: ``{"space": 2}``, each rank half of D) writes the
single-device files; ``--dry_run`` reports the ``{"data": 2}`` mesh and the
global batch; the JAX CLI's batch-divisibility error, and the port's for
microbatches that the data axis does not divide, come before any rank
starts; a rank that is not rank 0 writes no log or checkpoint.
"""
import json
import os

import numpy as np
import pytest
import torch

from unet3d_tpu_torch.data.io import load_image
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.scripts import predict, train
from unet3d_tpu_torch.train import losses, optim, step
from unet3d_tpu_torch.train import train as engine
from unet3d_tpu_torch.train.checkpoint import load_checkpoint
from unet3d_tpu_torch.train.train import read_training_log

SAME = 1e-5


def _read(filename):
    return np.asarray(load_image(filename).data)


def _config(root):
    from test_torch_train_cli import copy_case, small_brats_config
    config = small_brats_config(root, n_train=3, n_val=3, test=False)
    config["test_filenames"] = [{"image": copy_case(root, f"test{i}")["image"]}
                                for i in range(3)]
    config["training"].update(batch_size=2, validation_batch_size=2)
    path = os.path.join(root, "small.json")
    json.dump(config, open(path, "w"))
    return path, config


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_cli"))
    path, config = _config(root)
    args = ["--config_filename", path, "--n_examples", "0"]
    one = train.main(args + ["--output_dir", os.path.join(root, "one")], device="cpu")
    two = train.main(args + ["--output_dir", os.path.join(root, "two"), "--ngpus", "2"],
                     device="cpu")
    return root, config, one, two


def test_training_matches_the_single_device_run(runs):
    root, _, one, two = runs
    assert two["world_size"] == 2 and two["work_dir"] == os.path.join(root, "two", "small")
    want = read_training_log(os.path.join(one["work_dir"], "training_log.csv"))
    got = read_training_log(os.path.join(two["work_dir"], "training_log.csv"))
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=SAME)
    for name in ("model.npz", "model_best.npz"):
        a = load_checkpoint(os.path.join(one["work_dir"], name))
        b = load_checkpoint(os.path.join(two["work_dir"], name))
        assert set(a) == set(b)
        for key in a:
            scale = float(np.abs(a[key]).max()) or 1.0
            np.testing.assert_allclose(b[key], a[key], rtol=SAME, atol=SAME * scale,
                                       err_msg=key)
    assert sorted(os.listdir(two["work_dir"])) == sorted(os.listdir(one["work_dir"]))


@pytest.mark.parametrize("group", ["validation", "test"])
def test_predictions_are_the_single_device_files(runs, group):
    _, _, one, two = runs
    want, got = one["predictions"][group], two["predictions"][group]
    assert len(got) == len(set(got)) == 3
    assert [os.path.basename(f) for f in got] == [os.path.basename(f) for f in want]
    for a, b in zip(want, got):
        np.testing.assert_allclose(_read(b), _read(a),
                                   rtol=1e-5, atol=1e-5)


def test_predict_cli_on_two_ranks(runs, tmp_path):
    root, config, one, _ = runs
    model = os.path.join(one["work_dir"], "model.npz")
    files = {}
    for n in (1, 2):
        files[n] = predict.run_inference(dict(config), str(tmp_path / f"n{n}"), model, "test",
                                         "sigmoid", {"n_gpus": n}, device="cpu")
    assert [os.path.basename(f) for f in files[2]] == [os.path.basename(f) for f in files[1]]
    assert sorted(os.listdir(tmp_path / "n2" / "predictions")) == sorted(
        os.listdir(tmp_path / "n1" / "predictions"))
    for a, b in zip(files[1], files[2]):
        np.testing.assert_allclose(_read(b), _read(a),
                                   rtol=1e-5, atol=1e-5)


def test_dry_run_on_two_ranks(runs, tmp_path):
    root = runs[0]
    report = train.main(["--config_filename", os.path.join(root, "small.json"), "--output_dir",
                         str(tmp_path), "--n_examples", "0", "--mesh", "data2", "--dry_run"],
                        device="cpu")
    assert report["mesh"] == {"data": 2}
    assert report["images"][0] == [2, 2, 16, 16, 16]
    assert json.load(open(tmp_path / "small" / "compile_report.json")) == report
    assert not os.path.exists(tmp_path / "small" / "training_log.csv")


@pytest.mark.parametrize("cli", ["train", "predict"])
def test_without_a_gpu_the_clis_raise_before_any_rank(runs, tmp_path, monkeypatch, cli):
    root, config, one, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if cli == "train":
            train.main(["--config_filename", os.path.join(root, "small.json"),
                        "--output_dir", str(tmp_path), "--ngpus", "2"])
        else:
            predict.run_inference(dict(config), str(tmp_path), os.path.join(
                one["work_dir"], "model.npz"), "test", None, {"n_gpus": 2})
    assert not os.path.exists(tmp_path / "small" / "training_log.csv")


def test_batch_divisibility_error_comes_first(runs, tmp_path):
    root = runs[0]
    with pytest.raises(ValueError, match="data axis"):
        train.main(["--config_filename", os.path.join(root, "small.json"), "--output_dir",
                    str(tmp_path), "--ngpus", "2", "--batch_size", "3"], device="cpu")
    assert not os.path.exists(tmp_path / "small" / "training_log.csv")


def test_microbatches_must_divide_over_the_data_axis(runs, tmp_path):
    """Batch 2 in 2 microbatches on 2 ranks: each microbatch of one item
    would run whole on both ranks, so the CLI refuses it before any rank
    starts."""
    root, config = runs[0], json.loads(json.dumps(runs[1]))
    config["training"]["gradient_accumulation_steps"] = 2
    path = str(tmp_path / "small.json")
    json.dump(config, open(path, "w"))
    with pytest.raises(ValueError, match="microbatches does not divide"):
        train.main(["--config_filename", path, "--output_dir", str(tmp_path / "out"),
                    "--ngpus", "2"], device="cpu")
    assert not os.path.exists(tmp_path / "out" / "small" / "training_log.csv")


@pytest.mark.parametrize("batch, axis, accum, error", [
    (4, 2, 1, None), (8, 2, 2, None), (4, 2, 2, None),
    (3, 2, 1, r"is not divisible by the mesh's data axis \(2\); pick a mesh whose"),
    (2, 4, 1, r"\(e\.g\. --mesh data2,space2\)"),
    (6, 2, 2, r"gradient_accumulation_steps=2 microbatches does not divide over the "
              r"mesh's data axis \(2\); pick a batch size that 4 divides")])
def test_check_batch_divides(batch, axis, accum, error):
    if error is None:
        train.check_batch_divides(batch, axis, accum)
    else:
        with pytest.raises(ValueError, match=error):
            train.check_batch_divides(batch, axis, accum)


class _Loader(list):
    def set_epoch(self, epoch):
        pass


@pytest.mark.parametrize("primary", [True, False], ids=["rank0", "rank1"])
def test_only_rank_0_writes(tmp_path, monkeypatch, primary):
    monkeypatch.setattr(engine, "is_primary_host", lambda: primary)
    model = create_model("DynUNet", in_channels=1, out_channels=1, spatial_dims=3,
                         strides=[[1, 1, 1], [2, 2, 2]], filters=[4, 4],
                         kernel_size=[[3, 3, 3]] * 2, upsample_kernel_size=[[2, 2, 2]])
    init_parameters(model, torch.Generator().manual_seed(0))
    opt = optim.build_optimizer("SGD", model.parameters(), lr=0.1)
    criterion = losses.DiceLoss(sigmoid=True)
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(1, 1, 8, 8, 8).astype(np.float32),
             "label": (rng.rand(1, 1, 8, 8, 8) > 0.5).astype(np.float32)}
    engine.run_training(step.make_train_step(model, criterion, opt),
                        step.make_eval_step(model, criterion), model, opt, 2,
                        _Loader([batch]), _Loader([batch]), str(tmp_path / "log.csv"),
                        str(tmp_path / "model.npz"), save_best=True, save_optimizer=True,
                        save_every_n_epochs=1)
    written = sorted(os.listdir(tmp_path))
    assert written == (["log.csv", "model.npz", "model_1.npz", "model_2.npz",
                        "model_best.npz", "model_optimizer.npz"] if primary else [])

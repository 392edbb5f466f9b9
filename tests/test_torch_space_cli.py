"""The port's CLIs on the space axis (two gloo processes on the CPU under
``device="cpu"``, each holding half of every volume's D planes) against the
same CLIs on one device.

The BraTS config cut to the fixture case at 16^3 (the DynUNet of
``tests/test_torch_train_cli.py``: filters 4, 8, 16, so at ``space2`` every
level is D-sharded), SGD, batch 2 over 2 training, 1 validation and 1 test
case, one epoch: ``train.main(... --mesh space2)`` against the
single-device run, the log within 1e-5, the checkpoint's every tensor within
1e-5 of its largest value (the statistics are summed in another order),
each group's predictions (made on the space axis too) the single-device
files within 1e-5, written once. (The predict CLI at ``n_gpus: 2`` takes
JAX's default plan, ``{"space": 2}``, for this DynUNet:
``tests/test_torch_parallel_cli.py::test_predict_cli_on_two_ranks`` holds
its files to the single-device run's.)
"""
import json
import os

import numpy as np
import pytest

from unet3d_tpu_torch.data.io import load_image
from unet3d_tpu_torch.scripts import train
from unet3d_tpu_torch.train.checkpoint import load_checkpoint
from unet3d_tpu_torch.train.train import read_training_log

SAME = 1e-5


def _read(filename):
    return np.asarray(load_image(filename).data)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_train_cli import small_brats_config

    root = str(tmp_path_factory.mktemp("space_cli"))
    config = small_brats_config(root)
    config["training"].update(batch_size=2, n_epochs=1)
    path = os.path.join(root, "small.json")
    json.dump(config, open(path, "w"))
    args = ["--config_filename", path, "--n_examples", "0"]
    one = train.main(args + ["--output_dir", os.path.join(root, "one")], device="cpu")
    two = train.main(args + ["--output_dir", os.path.join(root, "two"), "--mesh", "space2"],
                     device="cpu")
    return root, config, one, two


def test_training_matches_the_single_device_run(runs):
    root, _, one, two = runs
    assert two["world_size"] == 2 and two["work_dir"] == os.path.join(root, "two", "small")
    want = read_training_log(os.path.join(one["work_dir"], "training_log.csv"))
    got = read_training_log(os.path.join(two["work_dir"], "training_log.csv"))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=SAME)
    a = load_checkpoint(os.path.join(one["work_dir"], "model.npz"))
    b = load_checkpoint(os.path.join(two["work_dir"], "model.npz"))
    assert set(a) == set(b)
    for key in a:
        scale = float(np.abs(a[key]).max()) or 1.0
        np.testing.assert_allclose(b[key], a[key], rtol=SAME, atol=SAME * scale, err_msg=key)
    assert sorted(os.listdir(two["work_dir"])) == sorted(os.listdir(one["work_dir"]))


@pytest.mark.parametrize("group", ["validation", "test"])
def test_predictions_are_the_single_device_files(runs, group):
    _, _, one, two = runs
    want, got = one["predictions"][group], two["predictions"][group]
    assert len(got) == len(set(got)) == len(want) == 1
    assert [os.path.basename(f) for f in got] == [os.path.basename(f) for f in want]
    for a, b in zip(want, got):
        np.testing.assert_allclose(_read(b), _read(a), rtol=SAME, atol=SAME)


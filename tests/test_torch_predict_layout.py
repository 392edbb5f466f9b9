"""The mesh the port's train CLI predicts on after training on several
ranks (``scripts/predict.train_predict_layout``), as JAX's train CLI
re-lays its devices (``unet3d_tpu/scripts/train.py``: ``explicit_data_only``
and ``make_mesh({"space": n_devices})``): ``{"space": N}`` for a net with a
space form unless the mesh spec names no ``space`` axis; the data layout,
with a log line, for a net without one. A pure function: no rank is
spawned here (``tests/test_torch_parallel_cli.py`` and
``tests/test_torch_space_cli.py`` hold the CLI's own runs to it)."""
import logging

import pytest

from unet3d_tpu_torch.scripts.predict import train_predict_layout


@pytest.mark.parametrize("name", ["DynUNet", "UNet3D", "SegResNetVAE", "SegResNetDS"])
@pytest.mark.parametrize("spec, want", [
    (None, {"space": 2}),            # --ngpus 2: JAX re-lays the ranks on space
    ("data2", {"data": 2}),          # an explicit data-only mesh keeps its layout
    ("data1,space2", {"space": 2}),  # a spec with a space axis: whole cases on space
])
def test_space_form_nets(name, spec, want, caplog):
    with caplog.at_level(logging.WARNING):
        assert train_predict_layout(name, spec, 2) == want
    assert "no form for the 'space' mesh axis" not in caplog.text


@pytest.mark.parametrize("spec, logged", [(None, True), ("data2", False)])
def test_other_nets_keep_the_data_layout(spec, logged, caplog):
    with caplog.at_level(logging.WARNING):
        assert train_predict_layout("VNet", spec, 2) == {"data": 2}
    assert ("VNet has no form for the 'space' mesh axis" in caplog.text) == logged


def test_a_space_spec_on_a_larger_world():
    assert train_predict_layout("DynUNet", {"data": 2, "space": 2}, 4) == {"space": 4}

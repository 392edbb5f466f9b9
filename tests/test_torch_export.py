"""The port's export and serving path against the JAX package's.

A tiny DynUNet (2 -> 3 channels, filters 4 and 8, 8^3) is initialised in
JAX, converted through ``convert.py`` and exported by both packages; the
same numpy inputs go to the JAX artifact, the port's loaded artifact and
the port's eager forward. Tolerances: against JAX, f32 atol 2e-4 / rtol
1e-3 and bf16 AMP relative L2 2e-2, those of tests/test_torch_dynunet.py
(instance norms over few voxels, other sum orders, other bf16 rounding
points); the port's artifact against its own eager forward atol 1e-6 /
rtol 1e-5 (the same operators in the same order). The artifacts' graphs
hold the hand kernels as ``unet3d_tpu_torch::`` operator nodes, whose CPU
implementation is the plain version. On the card:
tests/test_torch_export_kernels.py.
"""
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu.config import factory as jax_factory
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.predict import export as jax_export
from unet3d_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.ops import conv3d as conv_ops
from unet3d_tpu_torch.ops import winograd_kernel
from unet3d_tpu_torch.predict.export import (MAGIC, export_forward, load_exported,
                                             save_exported)
from unet3d_tpu_torch.predict.sliding_window import SlidingWindowInferer
from unet3d_tpu_torch.predict.volumetric import make_forward, to_ndhwc
from unet3d_tpu_torch.scripts import export as export_cli

MODEL_KWARGS = dict(in_channels=2, out_channels=3, spatial_dims=3,
                    strides=[[1, 1, 1], [2, 2, 2]], filters=[4, 8],
                    kernel_size=[[3, 3, 3]] * 2, upsample_kernel_size=[[2, 2, 2]],
                    deep_supervision=False)
SHAPE = (8, 8, 8, 2)
F32 = dict(atol=2e-4, rtol=1e-3)
SELF = dict(atol=1e-6, rtol=1e-5)
KERNEL_OPS = ("unet3d_tpu_torch.conv3x3x3.default",
              "unet3d_tpu_torch.conv3x3x3_stats.default",
              "unet3d_tpu_torch.conv3x3x3_block_stats.default",
              "unet3d_tpu_torch.winograd3x3x3.default",
              "unet3d_tpu_torch.winograd3x3x3_stats.default")


def _flat(variables):
    # imported here, as tests/test_torch_winograd.py does
    from flax.traverse_util import flatten_dict
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(variables).items()}


def _x(batch, seed=0):
    return np.random.RandomState(seed).randn(batch, 2, 8, 8, 8).astype(np.float32)


def _eager(model, x, amp=False, activation=None):
    """The port's eager forward on NCDHW numpy, NCDHW out."""
    out = make_forward(model, amp=amp)(to_ndhwc(torch.from_numpy(x)))
    if activation == "sigmoid":
        out = torch.sigmoid(out)
    return out.permute(0, 4, 1, 2, 3).numpy()


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _targets(exported):
    """call_function targets of an artifact's graph, by name, with counts."""
    counts = {}
    for node in exported.program.graph.nodes:
        if node.op == "call_function":
            counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    return counts


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """The JAX tiny DynUNet, its variables and checkpoint, the port's copy."""
    model = jax_create_model("DynUNet", **MODEL_KWARGS)
    variables = jax.jit(lambda r: model.init(r, jnp.zeros((1, *SHAPE)), False))(
        jax.random.PRNGKey(0))
    root = tmp_path_factory.mktemp("export")
    ckpt = str(root / "model.npz")
    jax_save_checkpoint(variables, ckpt)
    port = load_jax_variables(create_model("DynUNet", **MODEL_KWARGS), _flat(variables))
    return model, variables, port.eval(), ckpt, root


@pytest.fixture(scope="module")
def dynamic(nets):
    """Both packages' dynamic-batch f32 artifacts, saved and loaded."""
    model, variables, port, _, root = nets
    exported = export_forward(port, SHAPE, device="cpu")
    path, jax_path = str(root / "port.u3dexp"), str(root / "jax.u3dexp")
    header = save_exported(exported, path, metadata={"model": {"name": "DynUNet"}})
    jax_export.save_exported(jax_export.export_forward(model, variables, SHAPE), jax_path)
    return dict(exported=exported, header=header, path=path, served=load_exported(path, "cpu"),
                jax_path=jax_path, jax_served=jax_export.load_exported(jax_path))


def test_round_trip_with_a_dynamic_batch(nets, dynamic):
    port, header, served = nets[2], dynamic["header"], dynamic["served"]
    assert header["format"] == "unet3d_tpu_torch.export" and header["version"] == 1
    assert header["nr_devices"] == 1 and header["platforms"] == ["cpu"]
    assert header["in_avals"] == ["float32[batch,2,8,8,8]"]
    assert header["out_avals"] == ["float32[batch,3,8,8,8]"]
    assert header["entry_layout"] == "ncdhw" and header["conv_strategy"] is None
    assert header["torch"] == torch.__version__ and header["model"] == {"name": "DynUNet"}
    assert served.metadata == header and served.device == torch.device("cpu")
    with open(dynamic["path"], "rb") as f:
        assert f.read(len(MAGIC)) == MAGIC
    for batch in (1, 3):
        x = _x(batch, seed=batch)
        got = served(x)
        assert got.dtype == torch.float32 and tuple(got.shape) == (batch, 3, 8, 8, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(dynamic["jax_served"](x)), **F32)
        np.testing.assert_allclose(got.numpy(), _eager(port, x), **SELF)


_LOAD_ALONE = """
import sys
import numpy as np
from unet3d_tpu_torch.predict.export import load_exported
out = load_exported(sys.argv[1], "cpu")(np.zeros((1, 2, 8, 8, 8), np.float32))
assert tuple(out.shape) == (1, 3, 8, 8, 8), out.shape
leaked = sorted(m for m in sys.modules if m.startswith("unet3d_tpu_torch.models")
                or m.split(".")[0] in ("jax", "unet3d_tpu"))
assert not leaked, leaked
"""


def test_artifact_runs_without_the_model_code(dynamic):
    """A fresh process that imports only predict/export.py loads and runs
    the artifact: no module of the models, no JAX."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _LOAD_ALONE, dynamic["path"]], cwd=root,
                         env=dict(env, PYTHONPATH=root), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_graph_holds_one_kernel_node_per_site(nets, dynamic, monkeypatch):
    """One conv3x3x3_stats / block_stats node per 3^3 stride-1 site (the
    eager forward's calls of the kernel wrappers) and no aten convolution
    at such a site."""
    port = nets[2]
    sites = []
    for name in ("conv3x3x3_with_stats", "conv3x3x3_block_with_stats"):
        fn = getattr(conv_ops, name)
        monkeypatch.setattr(conv_ops, name, lambda *a, _fn=fn, _n=name: sites.append(_n)
                            or _fn(*a))
    _eager(port, _x(1))
    counts = _targets(dynamic["exported"])
    # input_block.conv1 and upsample0's conv1; the two blocks' conv2 and
    # the bottleneck's (its conv1 has stride 2)
    assert counts["unet3d_tpu_torch.conv3x3x3_stats.default"] == \
        sites.count("conv3x3x3_with_stats") == 2
    assert counts["unet3d_tpu_torch.conv3x3x3_block_stats.default"] == \
        sites.count("conv3x3x3_block_with_stats") == 3
    assert sum(counts.get(op, 0) for op in KERNEL_OPS) == len(sites)
    for node in dynamic["exported"].program.graph.nodes:
        if node.op == "call_function" and "convolution" in str(node.target):
            weight, stride, transposed = node.args[1], node.args[3], node.args[6]
            assert not (tuple(weight.meta["val"].shape[2:]) == (3, 3, 3)
                        and list(stride) == [1, 1, 1] and not transposed), node.format_node()


def test_fixed_batch_and_activation(nets, tmp_path):
    port = nets[2]
    path = str(tmp_path / "fixed.u3dexp")
    header = save_exported(export_forward(port, SHAPE, activation="sigmoid", batch_size=2),
                           path)
    assert header["in_avals"] == ["float32[2,2,8,8,8]"] and header["activation"] == "sigmoid"
    served = load_exported(path, "cpu")
    x = _x(2, seed=7)
    got = served(x).numpy()
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, _eager(port, x, activation="sigmoid"), **SELF)
    with pytest.raises(ValueError, match="shape"):   # the wrong batch is refused
        served(x[:1])
    with pytest.raises(TypeError, match="dtype"):
        served(x.astype(np.complex64))


def test_amp_against_jax(nets, tmp_path):
    model, variables, port, _, _ = nets
    path = str(tmp_path / "amp.u3dexp")
    save_exported(export_forward(port, SHAPE, amp=True), path)
    served = load_exported(path, "cpu")
    assert served.metadata["amp"] is True
    assert all(n.args[0].meta["val"].dtype == torch.bfloat16
               for n in served.program.graph.nodes
               if n.op == "call_function" and str(n.target) in KERNEL_OPS)
    jax_served = jax_export.load_exported(_saved_jax(
        jax_export.export_forward(model, variables, SHAPE, amp=True), tmp_path / "jamp"))
    x = _x(2, seed=2)
    got = served(x).numpy()
    assert got.dtype == np.float32
    assert _rel_l2(got, np.asarray(jax_served(x))) < 2e-2
    np.testing.assert_allclose(got, _eager(port, x, amp=True), **SELF)


def _saved_jax(exported, path):
    jax_export.save_exported(exported, str(path))
    return str(path)


def test_ndhwc_entry_layout(nets, dynamic, tmp_path):
    port = nets[2]
    path = str(tmp_path / "ndhwc.u3dexp")
    save_exported(export_forward(port, SHAPE, activation="sigmoid", entry_layout="ndhwc"),
                  path)
    served = load_exported(path, "cpu")
    assert served.metadata["entry_layout"] == "ndhwc"
    assert served.metadata["in_avals"] == ["float32[batch,8,8,8,2]"]
    x = _x(2, seed=4)
    got = served(np.transpose(x, (0, 2, 3, 4, 1)))
    assert tuple(got.shape) == (2, 8, 8, 8, 3)
    np.testing.assert_allclose(got.permute(0, 4, 1, 2, 3).numpy(),
                               _eager(port, x, activation="sigmoid"), **SELF)
    assert served.ndhwc_forward() is served
    # the channel-first artifact's adapter gives the same NDHWC output
    adapter = dynamic["served"].ndhwc_forward()
    assert adapter.device == torch.device("cpu")
    np.testing.assert_allclose(
        torch.sigmoid(adapter(to_ndhwc(torch.from_numpy(x)))).numpy(), got.numpy(), **SELF)
    with pytest.raises(ValueError, match="entry_layout"):
        export_forward(port, SHAPE, entry_layout="nchw")


def test_loader_refuses_other_files(dynamic, tmp_path):
    bogus = str(tmp_path / "bogus")
    with open(bogus, "wb") as f:
        f.write(b"not an artifact")
    with pytest.raises(ValueError, match="bad magic"):
        load_exported(bogus, "cpu")
    with pytest.raises(ValueError, match="JAX StableHLO artifact.*unet3d-torch-export"):
        load_exported(dynamic["jax_path"], "cpu")


def test_winograd_strategy_is_frozen_into_the_graph(nets, dynamic, monkeypatch, tmp_path):
    """UNET3D_TPU_CONV=winograd at export, the gate lowered so the tiny net
    has Winograd sites: the graph holds winograd3x3x3_stats nodes, the header
    records the strategy, and the output agrees with JAX's artifact exported
    under the strategy (on the CPU JAX's Winograd kernel is TPU-only, so its
    strategy artifact is its XLA conv's, which the port's Winograd matches
    in f32 within the bound above) and with the port's eager strategy forward;
    the strategy unset after the export changes nothing."""
    model, variables, port, _, _ = nets
    monkeypatch.setattr(winograd_kernel, "_MIN_WINOGRAD_CHANNELS", 4)
    monkeypatch.setattr(winograd_kernel, "_MIN_WINOGRAD_VOXELS", 4 ** 3)
    monkeypatch.setenv("UNET3D_TPU_CONV", "winograd")
    exported = export_forward(port, SHAPE)
    path = str(tmp_path / "winograd.u3dexp")
    header = save_exported(exported, path)
    assert header["conv_strategy"] == "winograd"
    counts = _targets(exported)
    # input_block.conv2 (4 channels at 8^3), the bottleneck's conv2 (8 at
    # 4^3), upsample0's conv1 (16 at 8^3) and conv2
    assert counts["unet3d_tpu_torch.winograd3x3x3_stats.default"] == 4
    x = _x(2, seed=5)
    want_eager = _eager(port, x)
    jax_served = jax_export.load_exported(_saved_jax(
        jax_export.export_forward(model, variables, SHAPE), tmp_path / "jwino"))
    monkeypatch.delenv("UNET3D_TPU_CONV")
    got = load_exported(path, "cpu")(x).numpy()
    np.testing.assert_allclose(got, want_eager, **SELF)
    np.testing.assert_allclose(got, np.asarray(jax_served(x)), **F32)
    assert _targets(dynamic["exported"]).get("unet3d_tpu_torch.winograd3x3x3_stats.default") is None


def test_tuple_output_net_gives_its_first_element(tmp_path):
    kwargs = dict(n_features=2, base_width=8, encoder_blocks=[1, 2], input_shape=[16] * 3,
                  n_reduced_latent_feature_maps=4, vae_features=8)
    net = create_model("VariationalAutoEncoder", **kwargs)
    from unet3d_tpu_torch.models.layers import init_parameters
    init_parameters(net, torch.Generator().manual_seed(3))
    net.eval()
    path = str(tmp_path / "vae.u3dexp")
    save_exported(export_forward(net, (16, 16, 16, 2)), path)
    x = np.random.RandomState(8).randn(1, 2, 16, 16, 16).astype(np.float32)
    got = load_exported(path, "cpu")(x).numpy()
    with torch.no_grad():
        out = net(to_ndhwc(torch.from_numpy(x)))
    assert isinstance(out, tuple)
    np.testing.assert_allclose(got, out[0].permute(0, 4, 1, 2, 3).numpy(), **SELF)


def _config(root, model_cfg, **extra):
    config = {"model": model_cfg, "loss": {"name": "DiceLoss", "sigmoid": True},
              "dataset": {"desired_shape": [8, 8, 8]}, **extra}
    path = str(root / "config.json")
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def test_export_cli_agrees_with_jax_cli(nets, tmp_path, monkeypatch):
    from unet3d_tpu.scripts.export import main as jax_export_main
    _, variables, port, ckpt, _ = nets
    # the JAX CLI initialises its parameter template eagerly (a compile per
    # op, ~20 s on the CPU) before the strict load overwrites every value:
    # hand it the jitted init's tree, as tests/test_torch_cli.py does
    monkeypatch.setattr(jax_factory, "init_params", lambda *args, **kwargs: variables)
    cfg = _config(tmp_path, {"name": "DynUNet", **MODEL_KWARGS})
    out, jax_out = str(tmp_path / "cli.u3dexp"), str(tmp_path / "jax_cli.u3dexp")
    header = export_cli.main(["--config_filename", cfg, "--model_filename", ckpt,
                              "--output_filename", out], device="cpu")
    jax_export_main(["--config_filename", cfg, "--model_filename", ckpt,
                     "--output_filename", jax_out])
    served = load_exported(out, "cpu")
    # activation from the loss section, the model config in the header
    assert header["activation"] == served.metadata["activation"] == "sigmoid"
    assert served.metadata["model"]["name"] == "DynUNet"
    x = _x(2, seed=9)
    got = served(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_export.load_exported(jax_out)(x)), **F32)
    np.testing.assert_allclose(got, _eager(port, x, activation="sigmoid"), **SELF)


def test_predict_cli_serves_the_artifact(tmp_path):
    """predict --model_filename model.u3dexp (UNet3D, as tests/test_export.py
    runs JAX's CLI): the activation folded in, the files the checkpoint run
    writes; a conflicting --activation raises."""
    from unet3d_tpu_torch.data import nifti
    from unet3d_tpu_torch.data.io import load_image
    from unet3d_tpu_torch.scripts.predict import main as predict_main
    from unet3d_tpu_torch.train.checkpoint import save_checkpoint
    from unet3d_tpu_torch.config.factory import build_or_load_model_from_config

    rng = np.random.RandomState(0)
    test_fns = []
    for i in range(2):
        fn = str(tmp_path / f"img{i}.nii.gz")
        nifti.save(fn, rng.rand(8, 8, 8).astype(np.float32), np.eye(4))
        test_fns.append({"image": fn})
    model_cfg = {"name": "UNet3D", "n_features": 1, "base_width": 2,
                 "encoder_blocks": [1, 1], "n_outputs": 1}
    cfg = _config(tmp_path, model_cfg, test_filenames=test_fns)
    with open(cfg) as f:
        config = json.load(f)
    config["dataset"].update(name="SegmentationDataset", labels=[1],
                             normalization="zero_mean", resample=True)
    with open(cfg, "w") as f:
        json.dump(config, f)
    ckpt = str(tmp_path / "model.npz")
    save_checkpoint(build_or_load_model_from_config(config, None, torch.device("cpu"),
                                                    seed=1), ckpt)
    artifact = str(tmp_path / "model.u3dexp")
    export_cli.main(["--config_filename", cfg, "--model_filename", ckpt,
                     "--output_filename", artifact], device="cpu")
    served_dir, direct_dir = str(tmp_path / "served"), str(tmp_path / "direct")
    predict_main(["--config_filename", cfg, "--output_directory", served_dir,
                  "--model_filename", artifact, "--group", "test", "--ngpus", "2"],
                 device="cpu")
    predict_main(["--config_filename", cfg, "--output_directory", direct_dir,
                  "--model_filename", ckpt, "--group", "test", "--activation", "sigmoid"],
                 device="cpu")
    preds = sorted(os.listdir(os.path.join(served_dir, "predictions")))
    assert len(preds) == 2
    assert preds == sorted(os.listdir(os.path.join(direct_dir, "predictions")))
    for name in preds:
        served = load_image(os.path.join(served_dir, "predictions", name))
        direct = load_image(os.path.join(direct_dir, "predictions", name))
        assert np.asarray(served.data).min() >= 0.0 and np.asarray(served.data).max() <= 1.0
        np.testing.assert_allclose(np.asarray(served.data), np.asarray(direct.data),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(served.affine, direct.affine)
    with pytest.raises(ValueError, match="folded into"):
        predict_main(["--config_filename", cfg, "--output_directory", served_dir,
                      "--model_filename", artifact, "--group", "test",
                      "--activation", "softmax"], device="cpu")


def _post(url, body):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, body)) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as error:
        return error.code, error.read()


def test_http_server(nets, dynamic):
    from unet3d_tpu_torch.scripts.serve import build_server
    port = nets[2]
    server = build_server(dynamic["path"], port=0, max_body_bytes=1 << 20,
                          device="cpu")
    host, port_number = server.server_address
    url = f"http://{host}:{port_number}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"{url}/health") as r:
            assert r.status == 200
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["format"] == "unet3d_tpu_torch.export"
        x = _x(2, seed=11)
        buf = io.BytesIO()
        np.save(buf, x)
        code, body = _post(f"{url}/predict", buf.getvalue())
        assert code == 200
        np.testing.assert_allclose(np.load(io.BytesIO(body)), _eager(port, x), **SELF)
        assert _post(f"{url}/predict", b"not npy")[0] == 400
        wrong = io.BytesIO()
        np.save(wrong, x[:, :1])                      # one channel of two
        assert _post(f"{url}/predict", wrong.getvalue())[0] == 400
        assert _post(f"{url}/nowhere", buf.getvalue())[0] == 404
        with pytest.raises(urllib.error.HTTPError) as error:
            urllib.request.urlopen(f"{url}/nowhere")
        assert error.value.code == 404
        big = io.BytesIO()
        np.save(big, np.zeros((1, 2, 64, 64, 64), np.float32))  # 2 MiB > 1 MiB
        assert _post(f"{url}/predict", big.getvalue())[0] == 413
        with urllib.request.urlopen(f"{url}/health") as r:
            assert r.status == 200
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_sliding_window_over_the_artifact(nets, dynamic):
    """An ROI-shaped artifact drives the sliding-window inferer, as the
    in-process forward does."""
    port = nets[2]
    inferer = SlidingWindowInferer(roi_size=(8, 8, 8), overlap=0.5, mode="gaussian")
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 12, 12, 12, 2).astype(np.float32))
    got = inferer(x, dynamic["served"].ndhwc_forward())
    want = inferer(x, make_forward(port))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_refusals(nets, dynamic, tmp_path):
    port, ckpt = nets[2], nets[3]
    cfg = _config(tmp_path, {"name": "DynUNet", **MODEL_KWARGS})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        export_cli.main(["--config_filename", cfg, "--model_filename", ckpt,
                         "--output_filename", str(tmp_path / "m.u3dexp"),
                         "--mesh", "space2"], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        export_forward(port, SHAPE, mesh={"data": 2})
    with pytest.raises(ValueError, match="platforms"):
        export_forward(port, SHAPE, platforms=("cpu", "tpu"))
    if torch.cuda.is_available():
        return  # the GPU paths: tests/test_torch_export_kernels.py
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(dynamic["path"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main(["--config_filename", cfg, "--model_filename", ckpt,
                         "--output_filename", str(tmp_path / "m.u3dexp")])

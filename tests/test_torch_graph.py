"""The port's GraphCMR and its GIFTI surface against the JAX package's.

The template is an icosphere (12 vertices subdivided once: 42 vertices, 80
faces, ``icosphere``). Structure at the JAX defaults (5 layers of 256
channels, a 512-wide ResNet-18 encoder; ``jax.eval_shape``): the port's
``params`` and ``batch_stats`` names and shapes are JAX's, and the template
(``ref_vertices``, the dense adjacency) is in neither ``state_dict`` nor the
buffers. Numerics at 1 layer of 16 channels, 32 encoder outputs, on (2,
16^3, 1) inputs through ``tests/test_torch_resnet.py``'s ``Classifier``
harness (the eval and training forwards and running statistics against
JAX's f32 and f64 runs, f32 gradients of ``sum(out * g)`` within 1e-4,
the bf16 eval forward, the graph blocks' gradients and the statistics no
further from JAX's f32 results than 1.25 times JAX's bf16 ones or within
2e-2: the encoder's bf16 gradients at this size are noise in both
packages); the dtype of every
module's output under the train step's AMP cast (the f32 template promotes
the bf16 features, so every graph block runs in f32), the template kept f32
through the inference cast and ``.to``, ``load_surface`` on GIFTI files of
both encodings, and a JAX ``.npz`` loaded strictly.
"""
import base64
import copy
import functools
import gzip

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from unet3d_tpu.models import graph as jax_graph
from unet3d_tpu.train import checkpoint as jax_ckpt

from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
from unet3d_tpu_torch.convert import load_jax_variables, model_variables
from unet3d_tpu_torch.models import graph
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.predict.volumetric import make_forward
from unet3d_tpu_torch.train.checkpoint import load_checkpoint

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import bn_init
from test_torch_myronenko import _cast, _flat, _x
from test_torch_resnet import (Classifier, check_bf16, check_forwards, check_grads_f32,
                               check_structure)


def icosphere(subdivisions: int):
    """Unit icosphere: vertices (V, 3) float32 and faces (F, 3), each face
    split in four per subdivision (V = 10 * 4^n + 2)."""
    t = (1.0 + 5 ** 0.5) / 2
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
             (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
             (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
             (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
             (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                v = verts[a] + verts[b]
                verts.append(v / np.linalg.norm(v))
                mid[key] = len(verts) - 1
            return mid[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


VERTS, FACES = icosphere(1)
REF = np.ascontiguousarray(VERTS.T)                       # (3, V)
ADJ = jax_graph.faces_to_adjacency_matrix(len(VERTS), FACES)
KWARGS = dict(n_layers=1, n_channels=16, encoder_outputs=32)
SHAPE = (2, 16, 16, 16, 1)


def test_icosphere_and_adjacency_match_jax():
    """42 vertices and 80 faces; the port's adjacency is JAX's (edges and
    self-loops 1, rows normalised), symmetric in its pattern."""
    assert VERTS.shape == (42, 3) and FACES.shape == (80, 3)
    got = graph.faces_to_adjacency_matrix(len(VERTS), FACES)
    np.testing.assert_array_equal(got, ADJ)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)
    assert np.array_equal(got > 0, (got > 0).T) and int((got > 0).sum()) == 42 + 2 * 120


def test_structure_matches_jax():
    """At the defaults the port's ``params`` and ``batch_stats`` keys and
    shapes are JAX's and load strictly; the template is no variable."""
    check_structure("GraphCMR", dict(ref_vertices=REF, adjacency_matrix=ADJ), (1, 16, 16, 16, 1))
    model = create_model("GraphCMR", ref_vertices=REF, adjacency_matrix=ADJ)
    names = set(model.state_dict()) | {n for n, _ in model.named_buffers()}
    assert not any("ref" in n or "adjacency" in n for n in names)
    assert sum(p.numel() for p in model.parameters()) > 30e6


def graph_variables(jmod, x, seed=0):
    """``bn_init``'s variables with the graph layers' weights normal with
    variance 1 / fan-in (``W`` (out, in), ``weight`` (in, out)) and their
    biases 0.1 normal."""
    variables = bn_init(jmod, x, seed)
    rng = np.random.RandomState(seed + 5)
    flat = {}
    for k, v in flatten_dict(variables).items():
        if k[-1] == "W":
            v = rng.randn(*v.shape) / np.sqrt(v.shape[1])
        elif k[-1] == "weight":
            v = rng.randn(*v.shape) / np.sqrt(v.shape[0])
        elif k[-1] in ("b", "bias") and k[-2] != "encoder":
            v = 0.1 * rng.randn(*v.shape)
        flat[k] = jnp.asarray(np.asarray(v, np.float32))
    return unflatten_dict(flat)


@functools.lru_cache(maxsize=None)
def _case():
    jmod = jax_graph.GraphCMR(ref_vertices=REF, adjacency_matrix=ADJ, **KWARGS)
    c = Classifier(jmod, lambda: graph.GraphCMR(ref_vertices=REF, adjacency_matrix=ADJ,
                                                **KWARGS),
                   _x(*SHAPE, seed=1))
    c.variables = graph_variables(jmod, c.x)
    c.flat = _flat(c.variables)
    return c


def test_forwards_match_jax():
    check_forwards(_case())


def test_f32_gradients_match_jax():
    check_grads_f32(_case())


def test_bf16_forward_gradients_and_statistics_match_jax():
    """``check_bf16``'s rules on the bf16 eval forward, the running
    statistics and the graph blocks' gradients. The encoder's bf16
    gradients at 16^3 are noise in both packages (layers 3 and 4 of the
    ResNet see 1^3 at batch 2: each BatchNorm two values a channel, which
    bf16 often rounds equal; JAX's own lie ~96% from its f32 ones), so they
    are held in f32 here and, with the graph blocks' inputs, at 32^3 in
    ``tests/test_torch_resnet.py``."""
    c = _case()
    graph_keys = sorted(k for k in c.jax["grads"] if not k.startswith("encoder."))
    full = c.jax
    c.jax = dict(full, grads={k: full["grads"][k] for k in graph_keys},
                 grads_bf16={k: full["grads_bf16"][k] for k in graph_keys})
    try:
        check_bf16(c)
    finally:
        c.jax = full


def test_amp_dtype_flow_matches_jax():
    """Under the train step's AMP cast (bf16 parameters and input, f32
    running statistics) the ResNet encoder returns bf16 features; the f32
    template promotes them in the concatenation, so every graph block, norm
    and linear returns f32 in both packages."""
    c = _case()
    variables = {"params": _cast(c.variables["params"]),
                 "batch_stats": c.variables["batch_stats"]}
    _, state = jax.jit(lambda v, xv: c.jmod.apply(
        v, xv, True, capture_intermediates=True, mutable=["intermediates", "batch_stats"]))(
        variables, jnp.asarray(c.x).astype(jnp.bfloat16))
    want = {".".join(p[:-1]) or "<model>": str(v[0].dtype)
            for p, v in flatten_dict(state["intermediates"]).items() if p[-1] == "__call__"}
    model = c.port()
    got, handles = {}, []
    for name, module in model.named_modules():
        def hook(m, inp, o, name=name):
            got[name or "<model>"] = str(o.dtype).replace("torch.", "")
        handles.append(module.register_forward_hook(hook))
    params = {k: p.to(torch.bfloat16) for k, p in model.named_parameters()}
    with torch.no_grad():
        functional_call(model, params, (torch.from_numpy(c.x).to(torch.bfloat16),),
                        {"train": True})
    common = sorted(set(want) & set(got))
    assert len(common) > 40
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    assert got["encoder"] == got["encoder.layer4_block1"] == "bfloat16"
    assert {got[k] for k in ("gc_lin", "gc_block0.conv", "gc_block1.norm2", "shape_block1",
                             "shape_norm", "shape_out", "<model>")} == {"float32"}


def test_template_stays_f32_off_the_variables():
    """The inference cast (``make_forward``'s copy in bf16) and ``.to``
    leave the template f32; it moves with the module; the eval forward
    on bf16 parameters matches the model's own cast by hand."""
    c = _case()
    model = c.port()
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    assert bf16.encoder.conv1.kernel.dtype == torch.bfloat16
    assert bf16.ref_vertices.dtype == bf16.adjacency.dtype == torch.float32
    np.testing.assert_array_equal(bf16.adjacency.numpy(), ADJ)
    moved = copy.deepcopy(model).to("cpu", torch.float64)
    assert moved.adjacency.dtype == torch.float32 and moved.gc_lin.W.dtype == torch.float64
    meta = copy.deepcopy(model).to("meta").to(torch.bfloat16)   # a cast keeps the device
    assert meta.adjacency.device.type == meta.ref_vertices.device.type == "meta"
    assert meta.adjacency.dtype == torch.float32
    x = torch.from_numpy(c.x)
    got = make_forward(model, amp=True)(x)
    with torch.no_grad():
        want = bf16(x.to(torch.bfloat16))
    assert got.shape == (2, 3, 42) and torch.equal(got, want.float())


def _gifti(path, vertices, faces, encoding):
    """A minimal GIFTI surface: a POINTSET and a TRIANGLE DataArray."""
    def array(intent, data, dtype):
        raw = np.ascontiguousarray(data).tobytes()
        if encoding == "GZipBase64Binary":
            raw = gzip.compress(raw)
        text = base64.b64encode(raw).decode() if encoding != "ExternalFileBinary" else ""
        return (f'<DataArray Intent="{intent}" DataType="{dtype}" Dimensionality="2" '
                f'Dim0="{data.shape[0]}" Dim1="{data.shape[1]}" Encoding="{encoding}" '
                f'ArrayIndexingOrder="RowMajorOrder"><Data>{text}</Data></DataArray>')
    with open(path, "w") as f:
        f.write('<?xml version="1.0" encoding="UTF-8"?>\n<GIFTI Version="1.0" '
                'NumberOfDataArrays="2">'
                + array("NIFTI_INTENT_POINTSET", vertices.astype(np.float32),
                        "NIFTI_TYPE_FLOAT32")
                + array("NIFTI_INTENT_TRIANGLE", faces.astype(np.int32), "NIFTI_TYPE_INT32")
                + "</GIFTI>")


@pytest.mark.parametrize("encoding", ["Base64Binary", "GZipBase64Binary"])
def test_load_surface_matches_jax(tmp_path, encoding):
    """Both encodings read the vertices (3, V) and the adjacency as JAX's
    reader does; a config's ``reference_filename`` reaches GraphCMR."""
    path = str(tmp_path / "ico.surf.gii")
    _gifti(path, VERTS, FACES, encoding)
    vertices, adjacency = graph.load_surface(path)
    want_vertices, want_adjacency = jax_graph.load_surface(path)
    np.testing.assert_array_equal(vertices, want_vertices)
    np.testing.assert_array_equal(vertices, REF)
    np.testing.assert_array_equal(adjacency, want_adjacency)
    config = {"model": dict(name="GraphCMR", reference_filename=path, **KWARGS),
              "dataset": {"desired_shape": [16, 16, 16]}}
    model = build_or_load_model_from_config(config, None, torch.device("cpu"))
    np.testing.assert_array_equal(model.adjacency.numpy(), ADJ)
    assert model.encoder.conv1.kernel.shape[-2] == 1   # the config's one channel


def test_external_encoding_raises_in_both(tmp_path):
    path = str(tmp_path / "external.surf.gii")
    _gifti(path, VERTS, FACES, "ExternalFileBinary")
    for reader in (graph.load_surface, jax_graph.load_surface):
        with pytest.raises(ValueError, match="ExternalFileBinary"):
            reader(path)
    with pytest.raises(ValueError, match="reference_filename"):
        create_model("GraphCMR")


def test_jax_checkpoint_loads_strictly(tmp_path):
    """The JAX ``.npz`` (``params`` and ``batch_stats``) loads strictly,
    every array equal, and carries no template."""
    c = _case()
    path = str(tmp_path / "graph.npz")
    jax_ckpt.save_checkpoint(c.variables, path)
    flat = load_checkpoint(path)
    model = load_jax_variables(c.make_port(), flat, strict=True)
    ours = model_variables(model)
    assert set(ours) == set(flat) and {k.split("/")[0] for k in flat} == {"params",
                                                                          "batch_stats"}
    for key, value in flat.items():
        np.testing.assert_array_equal(ours[key], value)

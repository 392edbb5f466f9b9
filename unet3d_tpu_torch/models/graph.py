"""GraphCMR: a 3D ResNet-18 image encoder and graph-conv blocks that
regress per-vertex coordinates of a template surface (counterpart of
``unet3d_tpu/models/graph.py``), with the surface's GIFTI reader and its
faces -> adjacency construction.

The template's ``ref_vertices`` (3, V) and its dense row-normalised
adjacency (V, V) are constants of the module, not variables: they are in
neither ``state_dict`` nor ``named_buffers()``, so no checkpoint carries
them and no AMP cast reaches them (JAX's ``amp_cast`` never sees them
either). They move with ``.to(device)`` and stay f32 there. The ResNet's
features (bf16 under AMP) meet the f32 template in the concatenation, so
every graph block runs in f32 on bf16 parameters, as in JAX.

The graph blocks keep their activations channels-last, (B, V, C): a
``GraphLinear`` is a channel matmul, a ``GraphConvolution`` the adjacency
product ``A @ (X @ W)`` (a dense matmul, f32 in full f32), a GroupNorm
``layers.group_norm`` over (V, C / groups). The output is (B, 3, V), as
JAX's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import GroupNorm, _result_type
from unet3d_tpu_torch.models.resnet import resnet_18
from unet3d_tpu_torch.ops.conv3d import channel_matmul


def faces_to_adjacency_matrix(n_vertices: int, faces) -> np.ndarray:
    """Row-normalised vertex adjacency from triangle faces: 1 on each edge
    (both ways) and on the diagonal, each row divided by its sum (the
    standard GCN adjacency; the reference's sparse one has zero values)."""
    adj = np.zeros((n_vertices, n_vertices), dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
    for i, j in ((0, 1), (1, 2), (0, 2)):
        adj[faces[:, i], faces[:, j]] = 1.0
        adj[faces[:, j], faces[:, i]] = 1.0
    np.fill_diagonal(adj, 1.0)
    row_sum = adj.sum(axis=1, keepdims=True)
    return adj / np.maximum(row_sum, 1.0)


def load_surface(surface_filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """``(vertices (3, V), adjacency (V, V))`` of a GIFTI surface: the
    minimal XML reader of the JAX package. The POINTSET array is the
    vertices, the TRIANGLE array the faces; each DataArray must be
    Base64Binary or GZipBase64Binary (another encoding raises)."""
    import base64
    import gzip
    import xml.etree.ElementTree as ET

    tree = ET.parse(surface_filename)
    arrays = {}
    for darray in tree.iter("DataArray"):
        intent = darray.get("Intent")
        dims = [int(darray.get(f"Dim{i}"))
                for i in range(int(darray.get("Dimensionality")))]
        dtype = np.float32 if darray.get("DataType") == "NIFTI_TYPE_FLOAT32" else np.int32
        encoding = darray.get("Encoding")
        if encoding not in ("Base64Binary", "GZipBase64Binary"):
            raise ValueError(
                f"GIFTI DataArray encoding {encoding!r} in {surface_filename} is "
                "not supported; re-encode the surface as Base64Binary or "
                "GZipBase64Binary (e.g. nibabel save with default encoding)")
        raw = base64.b64decode(darray.find("Data").text)
        if encoding == "GZipBase64Binary":
            raw = gzip.decompress(raw)
        arrays[intent] = np.frombuffer(raw, dtype=dtype).reshape(dims)
    vertices = arrays["NIFTI_INTENT_POINTSET"].astype(np.float32)
    faces = arrays["NIFTI_INTENT_TRIANGLE"]
    return vertices.T, faces_to_adjacency_matrix(len(vertices), faces)


class GraphLinear(nn.Module):
    """A 1x1 conv on the graph: ``x @ W^T + b`` over channels-last ``x``;
    ``W`` (out, in) and ``b`` uniform(-1 / (in * out), 1 / (in * out)).
    Computed in the result type of x and the parameters."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(out_channels, in_channels))
        self.b = nn.Parameter(torch.empty(out_channels))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        stdv = 1.0 / math.prod(self.W.shape)
        with torch.no_grad():
            self.W.uniform_(-stdv, stdv, generator=generator)
            self.b.uniform_(-stdv, stdv, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = _result_type(x, self.W, self.b)
        return channel_matmul(x.to(dtype), self.W.to(dtype).t()) + self.b.to(dtype)


class GraphConvolution(nn.Module):
    """Kipf's GCN layer ``A @ (x @ weight) + bias`` on (B, V, in) ``x``;
    ``weight`` (in, out) and ``bias`` uniform(-6 / sqrt(in + out), same)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        stdv = 6.0 / math.sqrt(sum(self.weight.shape))
        with torch.no_grad():
            self.weight.uniform_(-stdv, stdv, generator=generator)
            self.bias.uniform_(-stdv, stdv, generator=generator)

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
        dtype = _result_type(x, self.weight, self.bias, adjacency)
        support = channel_matmul(x.to(dtype), self.weight.to(dtype))        # (B, V, out)
        b, v, o = support.shape
        # one (V, V) @ (V, B * out) product for the whole batch
        out = channel_matmul(adjacency.to(dtype), support.transpose(0, 1).reshape(v, b * o))
        return out.reshape(v, b, o).transpose(0, 1) + self.bias.to(dtype)


def _norm(channels: int) -> GroupNorm:
    return GroupNorm(channels, max(channels // 8, 1), eps=1e-5)


class GraphResBlock(nn.Module):
    """Pre-activation bottleneck: GroupNorm -> ReLU -> ``lin1`` (to half the
    width) -> GroupNorm -> ReLU -> ``conv`` (the graph conv) -> GroupNorm ->
    ReLU -> ``lin2``, plus the input (``skip_conv``'d where the width
    changes)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        half = out_channels // 2
        self.pre_norm = _norm(in_channels)
        self.lin1 = GraphLinear(in_channels, half)
        self.norm1 = _norm(half)
        self.conv = GraphConvolution(half, half)
        self.norm2 = _norm(half)
        self.lin2 = GraphLinear(half, out_channels)
        self.project = in_channels != out_channels
        if self.project:
            self.skip_conv = GraphLinear(in_channels, out_channels)

    def forward(self, x: torch.Tensor, adjacency: torch.Tensor) -> torch.Tensor:
        y = self.lin1(torch.relu(self.pre_norm(x)))
        y = self.conv(torch.relu(self.norm1(y)), adjacency)
        y = self.lin2(torch.relu(self.norm2(y)))
        return (self.skip_conv(x) if self.project else x) + y


class GraphCMR(nn.Module):
    """3D image (NDHWC, ``input_channels`` wide) -> per-vertex coordinates
    (B, ``output_features``, V).

    The template is ``ref_vertices`` (3, V) and ``adjacency_matrix`` (V, V),
    or the GIFTI surface ``reference_filename`` when either is missing.
    ``n_outputs`` is accepted and unused, as in JAX. ``input_channels`` is
    the port's: Flax infers the encoder's input width from the input (the
    config factory fills it from the config)."""

    def __init__(self, ref_vertices=None, adjacency_matrix=None,
                 reference_filename: Optional[str] = None, n_layers: int = 5,
                 n_channels: int = 256, output_features: int = 3,
                 encoder_outputs: int = 512, n_outputs: Optional[int] = None,
                 input_channels: int = 1):
        super().__init__()
        if reference_filename is not None and (ref_vertices is None
                                               or adjacency_matrix is None):
            ref_vertices, adjacency_matrix = load_surface(reference_filename)
        if ref_vertices is None or adjacency_matrix is None:
            raise ValueError("GraphCMR needs ref_vertices and adjacency_matrix, or a "
                             "reference_filename")
        self.ref_vertices = torch.as_tensor(np.asarray(ref_vertices, np.float32))
        self.adjacency = torch.as_tensor(np.asarray(adjacency_matrix, np.float32))
        self.n_layers = n_layers
        self.encoder = resnet_18(n_outputs=encoder_outputs, n_features=input_channels)
        self.gc_lin = GraphLinear(3 + encoder_outputs, 2 * n_channels)
        self.gc_block0 = GraphResBlock(2 * n_channels, n_channels)
        for i in range(n_layers):
            self.add_module(f"gc_block{i + 1}", GraphResBlock(n_channels, n_channels))
        self.shape_block0 = GraphResBlock(n_channels, 64)
        self.shape_block1 = GraphResBlock(64, 32)
        self.shape_norm = GroupNorm(32, 32 // 8, eps=1e-5)
        self.shape_out = GraphLinear(32, output_features)

    def _apply(self, fn, recurse=True):
        # the constants move with the module (to the device ``fn`` gives a
        # tensor of theirs) and stay f32
        super()._apply(fn, recurse)
        device = fn(torch.empty(0, device=self.adjacency.device)).device
        self.ref_vertices = self.ref_vertices.to(device)
        self.adjacency = self.adjacency.to(device)
        return self

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        feats = self.encoder(x, train)                                  # (B, E)
        batch, n_vertices = x.shape[0], self.ref_vertices.shape[-1]
        dtype = _result_type(feats, self.ref_vertices)
        ref = self.ref_vertices.t().to(dtype).expand(batch, n_vertices, 3)
        y = torch.cat([ref, feats.to(dtype)[:, None, :].expand(-1, n_vertices, -1)], -1)
        y = self.gc_lin(y)                                              # (B, V, 2C)
        adjacency = self.adjacency
        for i in range(self.n_layers + 1):
            y = getattr(self, f"gc_block{i}")(y, adjacency)
        y = self.shape_block1(self.shape_block0(y, adjacency), adjacency)
        y = self.shape_out(torch.relu(self.shape_norm(y)))
        return y.transpose(1, 2).contiguous()

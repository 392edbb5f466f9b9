"""DiNTS (counterpart of ``unet3d_tpu/models/dints.py``): He et al. 2021's
differentiable topology, MONAI's ``DiNTS`` with its ``TopologyInstance``
and ``TopologySearch`` spaces.

The spaces are the JAX package's, copied (they are plain Python and numpy;
the port imports nothing of ``unet3d_tpu``): a grid of ``num_blocks``
layers by ``num_depths`` resolutions (depth d at 1 / 2**(d + 1) of the
input with ``use_downsample``, ``16 * channel_mul * 2**d`` channels), each
layer's ``3 * num_depths - 2`` edges (``_edges``) from depth d -+ 1 or d of
the layer before; ``TopologySearch``'s numpy analysis (``get_prob_a``,
``get_topology_entropy``, ``get_ram_cost_usage``) and its Viterbi
``decode`` to an ``arch_code``.

The network on NDHWC, with the Flax module names:

- stems: a stride-2 3-cubed conv (pads 1, 1) + instance norm with
  ``use_downsample``, then per deeper depth relu -> stride-2 conv -> norm;
- retrain (``TopologyInstance``): each active edge ``b{b}_e{e}`` a
  resolution adapter (relu -> stride-2 conv -> norm down; the x2 trilinear
  resize -> 1-cubed conv -> norm up; a 1-cubed conv where the width
  differs) and its op's relu -> conv -> norm stages (``skip_connect``,
  ``conv_3x3x3`` or a pseudo-3D pair, SAME = k // 2 per axis); each depth
  the sum of its incoming edges in edge order, or dark (None) without any;
- search (``TopologySearch``): every edge's adapter ``b{b}_e{e}_adapt``
  and all five ops (``b{b}_e{e}_op{op}``), weighted by ``softmax(log_alpha_c)``
  and ``sigmoid(log_alpha_a)``, root parameters of the model, in the
  parameters' dtype (bf16 under AMP, as in the JAX step);
- decoder: each live depth relu -> 1-cubed conv to ``filters[0]`` ->
  trilinear resize to depth 0's size, summed, norm, relu; with
  ``use_downsample`` the kernel = stride = 2 transposed conv (Flax's
  ``nn.ConvTranspose`` with SAME, the subpixel form with its taps flipped)
  + norm + relu; the 1-cubed ``output`` conv.

Every conv is Flax ``nn.Conv`` in the JAX package (XLA, no Pallas), so here
it is ``layers.Conv`` on cuDNN, f32 in full f32. The instance norms are
Flax's ``GroupNorm`` with one group per channel and eps 1e-5. The resize is
``jax.image.resize``'s "trilinear" (``_resize``): half-pixel centres,
weights renormalised at the edges, an output in the input's dtype.
"""
from __future__ import annotations

import collections.abc
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import Conv, GroupNorm, SubpixelConvTranspose, _result_type
from unet3d_tpu_torch.ops.interpolate import image_resize

# op index -> (kernel factorization list); each entry is one ReLU-conv-IN stage
_OPS: Tuple[Tuple[Tuple[int, int, int], ...], ...] = (
    (),                                    # 0: skip_connect
    (((3, 3, 3)),),                        # 1: conv_3x3x3
    ((3, 3, 1), (1, 1, 3)),                # 2: P3D A
    ((3, 1, 3), (1, 3, 1)),                # 3: P3D B
    ((1, 3, 3), (3, 1, 1)),                # 4: P3D C
)
_OP_NAMES = ("skip_connect", "conv_3x3x3", "conv_3x3x1", "conv_3x1x3",
             "conv_1x3x3")


def _edges(num_depths: int) -> List[Tuple[int, int]]:
    """Edge list (src_depth, dst_depth) in MONAI's enumeration order."""
    out = []
    for dst in range(num_depths):
        for src in (dst - 1, dst, dst + 1):
            if 0 <= src < num_depths:
                out.append((src, dst))
    return out


@dataclass
class TopologyInstance:
    """Decoded topology: which edges exist and which op each runs.

    ``arch_code``: optional ``(arch_code_a, arch_code_c)`` —
    ``arch_code_a[block][edge]`` in {0,1} activation,
    ``arch_code_c[block][edge]`` op index into the 3D op set. ``None`` =
    full topology, all edges ``conv_3x3x3``.
    """
    arch_code: Optional[Any] = None
    channel_mul: float = 1.0
    num_blocks: int = 6
    num_depths: int = 3
    use_downsample: bool = True
    spatial_dims: int = 3
    edges: List[Tuple[int, int]] = field(init=False)
    code_a: List[List[int]] = field(init=False)
    code_c: List[List[int]] = field(init=False)

    def __post_init__(self):
        if self.spatial_dims != 3:
            raise NotImplementedError("TopologyInstance: 3D only")
        self.edges = _edges(self.num_depths)
        n_e = len(self.edges)
        if self.arch_code is None:
            self.code_a = [[1] * n_e for _ in range(self.num_blocks)]
            self.code_c = [[1] * n_e for _ in range(self.num_blocks)]
        else:
            code_a, code_c = self.arch_code
            self.code_a = [[int(v) for v in row] for row in code_a]
            self.code_c = [[int(v) for v in row] for row in code_c]
            if len(self.code_a) != self.num_blocks or any(
                    len(r) != n_e for r in self.code_a):
                raise ValueError(
                    f"arch_code_a must be [{self.num_blocks} x {n_e}]")
        # Reachability semantics (DiNTS §3.3): a node is active after block b
        # iff it received >=1 active input edge in block b; an active edge may
        # only source from an active node; each block needs >=1 active edge.
        # (Nodes may go dark — the decoder aggregation skips them.)
        active = set(range(self.num_depths))
        self.node_active: List[List[bool]] = [
            [True] * self.num_depths]
        for b, row in enumerate(self.code_a):
            nxt = set()
            for e, a in enumerate(row):
                if not a:
                    continue
                src, dst = self.edges[e]
                if src not in active:
                    raise ValueError(
                        f"arch_code block {b}: edge {e} ({src}->{dst}) sources "
                        f"from depth {src}, which has no active input path")
                nxt.add(dst)
            if not nxt:
                raise ValueError(f"arch_code block {b}: no active edges")
            active = nxt
            self.node_active.append(
                [d in active for d in range(self.num_depths)])

    @property
    def filter_nums(self) -> List[int]:
        return [int(16 * self.channel_mul * 2 ** d)
                for d in range(self.num_depths)]


@dataclass
class TopologySearch:
    """Differentiable DiNTS search space (MONAI ``TopologySearch`` analog).

    Construct ``DiNTS(dints_space=TopologySearch(...))`` (or via config with
    ``dints_space={"search": True, ...}``): the network then carries
    ``log_alpha_a`` (num_blocks, n_edges) edge-activation logits and
    ``log_alpha_c`` (num_blocks, n_edges, n_ops) op logits as parameters and
    computes the fully-weighted supernet forward. The post-search methods
    below are host-side numpy (they take the trained logit arrays, the
    model's ``log_alpha_a`` / ``log_alpha_c`` or the JAX checkpoint's
    ``params/log_alpha_*``).
    """
    channel_mul: float = 1.0
    num_blocks: int = 6
    num_depths: int = 3
    use_downsample: bool = True
    spatial_dims: int = 3
    edges: List[Tuple[int, int]] = field(init=False)

    def __post_init__(self):
        if self.spatial_dims != 3:
            raise NotImplementedError("TopologySearch: 3D only")
        self.edges = _edges(self.num_depths)

    @property
    def filter_nums(self) -> List[int]:
        return [int(16 * self.channel_mul * 2 ** d)
                for d in range(self.num_depths)]

    # ---- host-side numpy analysis / decode -------------------------------

    def get_prob_a(self, log_alpha_a) -> "np.ndarray":
        """Edge-activation probabilities: sigmoid(log_alpha_a)."""
        a = np.asarray(log_alpha_a, dtype=np.float64)
        return 1.0 / (1.0 + np.exp(-a))

    def _node_io_probs(self, probs_a):
        """P(node d receives input at block b) and P(node d emits at block b)."""
        p = np.asarray(probs_a, dtype=np.float64)
        n_d = self.num_depths
        p_in = np.zeros((self.num_blocks, n_d))
        p_out = np.zeros((self.num_blocks, n_d))
        for b in range(self.num_blocks):
            for e, (src, dst) in enumerate(self.edges):
                p_in[b, dst] = 1 - (1 - p_in[b, dst]) * (1 - p[b, e])
                p_out[b, src] = 1 - (1 - p_out[b, src]) * (1 - p[b, e])
        return p_in, p_out

    def get_topology_entropy(self, log_alpha_a) -> float:
        """Topology consistency regularizer (He et al. 2021 Eq. 5): the
        cross-entropy between "node d is written at block b" and "node d is
        read at block b+1" — low when activation flows are consistent."""
        probs_a = self.get_prob_a(log_alpha_a)
        p_in, p_out = self._node_io_probs(probs_a)
        eps = 1e-5
        ent = 0.0
        for b in range(self.num_blocks - 1):
            w = np.clip(p_in[b], eps, 1 - eps)        # written at block b
            r = np.clip(p_out[b + 1], eps, 1 - eps)   # read at block b+1
            ent += float(np.sum(-(w * np.log(r) + (1 - w) * np.log(1 - r))))
        return ent

    def get_ram_cost_usage(self, in_size, log_alpha_a,
                           full: bool = False) -> float:
        """Expected activation memory of the decoded net in GB.

        ``in_size``: (batch, in_channels, D, H, W). Per edge: output voxels x
        channels x (number of materialized tensors for the op mix) x 4 bytes,
        weighted by the edge's activation probability (or 1 when ``full``)."""
        probs_a = self.get_prob_a(log_alpha_a)
        if full:
            probs_a = np.ones_like(probs_a)
        batch = int(in_size[0])
        spatial = [int(s) for s in in_size[2:5]]
        stem = 2 if self.use_downsample else 1
        # materialized tensors per op (adapter out + each conv stage out)
        op_tensors = np.array([1.0 + len(ops) for ops in _OPS])
        mean_tensors = float(op_tensors.mean())
        total = 0.0
        for b in range(self.num_blocks):
            for e, (src, dst) in enumerate(self.edges):
                scale = stem * 2 ** dst
                voxels = batch * np.prod([s // scale for s in spatial])
                total += (probs_a[b, e] * voxels * self.filter_nums[dst]
                          * mean_tensors * 4)
        return float(total / 2 ** 30)

    def decode(self, log_alpha_a, log_alpha_c):
        """Extract the max-probability feasible topology (Viterbi DP over
        node-activation states, the paper's topology decoding).

        Returns ``(arch_code_a, arch_code_c, node_a)``: 0/1 edge activations
        (num_blocks, n_edges), per-edge op indices (argmax of the op logits),
        and the (num_blocks+1, num_depths) node-activation mask. The codes
        construct a valid ``TopologyInstance``.
        """
        probs_a = self.get_prob_a(log_alpha_a)
        w_c = np.asarray(log_alpha_c, dtype=np.float64)
        w_c = np.exp(w_c - w_c.max(-1, keepdims=True))
        w_c = w_c / w_c.sum(-1, keepdims=True)
        op_idx = w_c.argmax(-1)                       # (blocks, edges)
        # edge score couples activation prob with op confidence
        p_e = np.clip(probs_a * w_c.max(-1), 1e-5, 1 - 1e-5)

        n_d = self.num_depths
        states = [frozenset(s for s in range(n_d) if (m >> s) & 1)
                  for m in range(1, 2 ** n_d)]

        def transition(b, s_prev, s_next):
            """Best edge subset for block b given boundary states; returns
            (score, active_edge_list) or None if infeasible."""
            active, score = [], 0.0
            covered = {d: [] for d in s_next}
            for e, (src, dst) in enumerate(self.edges):
                valid = src in s_prev and dst in s_next
                if valid and p_e[b, e] > 0.5:
                    active.append(e)
                    covered[dst].append(e)
                    score += np.log(p_e[b, e])
                else:
                    score += np.log(1 - p_e[b, e])
                    if valid:
                        covered[dst].append(-e - 1)   # candidate, inactive
            for dst, cands in covered.items():
                if any(c >= 0 for c in cands):
                    continue
                if not cands:
                    return None                       # dst unreachable
                # force the best candidate on (flip its contribution)
                best = max((-c - 1 for c in cands), key=lambda e: p_e[b, e])
                active.append(best)
                score += np.log(p_e[b, best]) - np.log(1 - p_e[b, best])
            return score, sorted(active)

        full = frozenset(range(n_d))
        # Viterbi: dp[state] = (score, path, edge_sets)
        dp = {full: (0.0, [full], [])}
        for b in range(self.num_blocks):
            nxt = {}
            for s_prev, (sc, path, sets) in dp.items():
                for s_next in states:
                    tr = transition(b, s_prev, s_next)
                    if tr is None:
                        continue
                    cand = (sc + tr[0], path + [s_next], sets + [tr[1]])
                    if s_next not in nxt or cand[0] > nxt[s_next][0]:
                        nxt[s_next] = cand
            dp = nxt
        _, path, edge_sets = max(dp.values(), key=lambda v: v[0])

        n_e = len(self.edges)
        arch_code_a = [[1 if e in es else 0 for e in range(n_e)]
                       for es in edge_sets]
        arch_code_c = [[int(op_idx[b, e]) for e in range(n_e)]
                       for b in range(self.num_blocks)]
        node_a = [[1 if d in s else 0 for d in range(n_d)] for s in path]
        return arch_code_a, arch_code_c, node_a



def _resize(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``jax.image.resize(x, spatial * factor, "trilinear")`` on NDHWC ``x``
    (``ops/interpolate.image_resize``)."""
    return image_resize(x, (factor,) * 3, "trilinear")


def _add_adapter(parent: nn.Module, in_channels: int, features: int, resize: int) -> None:
    """The edge's resolution and width adapter: ``down`` / ``down_norm``,
    ``up`` / ``up_norm`` or ``adapt`` on ``parent``, as Flax names them."""
    if resize == 1:
        parent.down = Conv(in_channels, features, 3, 2, 1, use_bias=False)
        parent.down_norm = GroupNorm(features, features)
    elif resize == -1:
        parent.up = Conv(in_channels, features, 1, use_bias=False)
        parent.up_norm = GroupNorm(features, features)
    elif in_channels != features:
        parent.adapt = Conv(in_channels, features, 1, use_bias=False)


def _adapt(parent: nn.Module, x: torch.Tensor, resize: int) -> torch.Tensor:
    if resize == 1:
        return parent.down_norm(parent.down(torch.relu(x)))
    if resize == -1:
        return parent.up_norm(parent.up(_resize(x, 2)))
    if hasattr(parent, "adapt"):
        return parent.adapt(x)
    return x


def _add_op(parent: nn.Module, features: int, op_index: int) -> None:
    for i, k in enumerate(_OPS[op_index]):
        parent.add_module(f"conv{i}", Conv(features, features, tuple(k), padding="SAME",
                                           use_bias=False))
        parent.add_module(f"norm{i}", GroupNorm(features, features))


def _op(parent: nn.Module, x: torch.Tensor, op_index: int) -> torch.Tensor:
    for i in range(len(_OPS[op_index])):
        x = getattr(parent, f"norm{i}")(getattr(parent, f"conv{i}")(torch.relu(x)))
    return x


class _EdgeAdapter(nn.Module):
    """Search mode: the adapter all of an edge's candidate ops share."""

    def __init__(self, in_channels: int, features: int, resize: int):
        super().__init__()
        self.resize = resize
        _add_adapter(self, in_channels, features, resize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _adapt(self, x, self.resize)


class _OpStack(nn.Module):
    """Search mode: one candidate op's stages, after the adapter."""

    def __init__(self, features: int, op_index: int):
        super().__init__()
        self.op_index = op_index
        _add_op(self, features, op_index)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _op(self, x, self.op_index)


class _CellOp(nn.Module):
    """Retrain mode: one edge, its adapter and its op."""

    def __init__(self, in_channels: int, features: int, op_index: int, resize: int):
        super().__init__()
        self.op_index, self.resize = op_index, resize
        _add_adapter(self, in_channels, features, resize)
        _add_op(self, features, op_index)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _op(self, _adapt(self, x, self.resize), self.op_index)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, in x's dtype."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def _space(dints_space, use_downsample: bool):
    """``None`` (the full default topology), a mapping (``"search": true``
    gives ``TopologySearch``, else ``TopologyInstance`` of the other keys)
    or a space object."""
    if dints_space is None:
        return TopologyInstance(use_downsample=use_downsample)
    if isinstance(dints_space, collections.abc.Mapping):
        kwargs = dict(dints_space)
        if kwargs.pop("search", False):
            return TopologySearch(**kwargs)
        return TopologyInstance(**kwargs)
    return dints_space


class DiNTS(nn.Module):
    """MONAI ``DiNTS`` over a ``TopologyInstance`` (retrain) or a
    ``TopologySearch`` (the supernet); ``dints_space=None`` builds the
    default full topology, so the net is constructible from a JSON config.
    ``act_name``, ``norm_name`` and ``node_a`` are accepted and not read,
    as in JAX."""

    def __init__(self, dints_space: Optional[Any] = None, in_channels: int = 1,
                 num_classes: int = 1, act_name: str = "RELU", norm_name: str = "INSTANCE",
                 spatial_dims: int = 3, use_downsample: bool = True,
                 node_a: Optional[Any] = None):
        super().__init__()
        if spatial_dims != 3:
            raise NotImplementedError("unet3d_tpu_torch DiNTS is 3D")
        space = self.space = _space(dints_space, use_downsample)
        self.search = isinstance(space, TopologySearch)
        filters = space.filter_nums
        width = in_channels
        if space.use_downsample:
            self.stem = Conv(in_channels, filters[0], 3, 2, 1, use_bias=False)
            self.stem_norm = GroupNorm(filters[0], filters[0])
            width = filters[0]
        widths = [width]
        for d in range(1, space.num_depths):
            self.add_module(f"stem_down{d}", Conv(widths[-1], filters[d], 3, 2, 1,
                                                  use_bias=False))
            self.add_module(f"stem_norm{d}", GroupNorm(filters[d], filters[d]))
            widths.append(filters[d])
        n_ops = len(_OPS)
        if self.search:
            n_e = len(space.edges)
            self.log_alpha_a = nn.Parameter(torch.empty(space.num_blocks, n_e))
            self.log_alpha_c = nn.Parameter(torch.empty(space.num_blocks, n_e, n_ops))
        live = [True] * space.num_depths
        for b in range(space.num_blocks):
            for e, (src, dst) in enumerate(space.edges):
                if self.search:
                    self.add_module(f"b{b}_e{e}_adapt",
                                    _EdgeAdapter(widths[src], filters[dst], dst - src))
                    for op in range(1, n_ops):
                        self.add_module(f"b{b}_e{e}_op{op}", _OpStack(filters[dst], op))
                elif space.code_a[b][e]:
                    self.add_module(f"b{b}_e{e}", _CellOp(widths[src], filters[dst],
                                                          space.code_c[b][e], dst - src))
            widths = list(filters)
            if not self.search:
                live = space.node_active[b + 1]
        self.live = list(live)
        for d in range(space.num_depths):
            if live[d]:
                self.add_module(f"head_proj{d}", Conv(widths[d], filters[0], 1,
                                                      use_bias=False))
        self.head_norm = GroupNorm(filters[0], filters[0])
        if space.use_downsample:
            self.head_up = SubpixelConvTranspose(filters[0], filters[0], (2, 2, 2))
            self.head_up_norm = GroupNorm(filters[0], filters[0])
        self.output = Conv(filters[0], num_classes, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        space = self.space
        need = 2 ** (space.num_depths - 1 + int(space.use_downsample))
        if any(d % need for d in x.shape[1:4]):
            raise ValueError(f"DiNTS: spatial dims {tuple(x.shape[1:4])} must be divisible "
                             f"by {need}")
        h = x
        if space.use_downsample:
            h = self.stem_norm(self.stem(h))
        states: List[Optional[torch.Tensor]] = [h]
        for d in range(1, space.num_depths):
            h = getattr(self, f"stem_norm{d}")(getattr(self, f"stem_down{d}")(torch.relu(h)))
            states.append(h)
        if self.search:
            p_a = torch.sigmoid(self.log_alpha_a)
            w_c = _softmax(self.log_alpha_c)
        for b in range(space.num_blocks):
            incoming: List[List[torch.Tensor]] = [[] for _ in range(space.num_depths)]
            for e, (src, dst) in enumerate(space.edges):
                if self.search:
                    y0 = getattr(self, f"b{b}_e{e}_adapt")(states[src])
                    acc = w_c[b, e, 0] * y0  # op 0: skip_connect
                    for op in range(1, len(_OPS)):
                        acc = acc + w_c[b, e, op] * getattr(self, f"b{b}_e{e}_op{op}")(y0)
                    incoming[dst].append(p_a[b, e] * acc)
                elif space.code_a[b][e]:
                    incoming[dst].append(getattr(self, f"b{b}_e{e}")(states[src]))
            # summed in edge order from 0, as Python's sum; no input: dark
            states = [sum(vs) if vs else None for vs in incoming]
        outs = []
        for d, s in enumerate(states):
            if s is None:
                continue
            y = getattr(self, f"head_proj{d}")(torch.relu(s))
            if d > 0:
                y = _resize(y, 2 ** d)
            outs.append(y)
        y = torch.relu(self.head_norm(sum(outs)))
        if space.use_downsample:
            # Flax's ConvTranspose computes in the result type of x and its
            # parameters; the subpixel form casts its kernel to x's
            y = y.to(_result_type(y, self.head_up.kernel, self.head_up.bias))
            y = torch.relu(self.head_up_norm(self.head_up(y)))
        return self.output(y)

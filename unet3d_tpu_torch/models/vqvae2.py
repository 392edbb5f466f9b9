"""3D VQ-VAE-2 (counterpart of ``unet3d_tpu/models/vqvae2.py``): a
two-level vector-quantised autoencoder with EMA codebooks.

- ``enc_b`` halves the input twice (4-cubed stride-2 convs with (1, 1)
  pads), ``enc_t`` once more; each ends in ``n_res_block`` ``ResBlock``s
  and a ReLU. ``ResBlock`` adds ``relu(x)``, not ``x`` (the reference's
  in-place ReLU), and its ``conv2`` goes back to the input width.
- ``quantize_t`` codes the top level; ``dec_t`` decodes it (the
  overlapping 4-cubed stride-2 transposed conv, Flax's unflipped kernel) and
  its output joins ``enc_b`` for ``quantize_b``; ``dec`` decodes both
  levels (``upsample_t`` brings the top codes to the bottom's grid).
- The forward returns ``(reconstruction, diff)``: ``diff`` the commitment
  loss of both levels, a scalar the train step's criterion adds.

Every conv is Flax's ``nn.Conv`` (XLA's in the JAX package), so here it is
``layers.Conv`` on cuDNN (and ``transposed_conv`` the cuDNN transposed
conv); each runs in the result type of its input and its parameters. The
quantiser's distances, argmin and EMA sums are plain matrix products (f32
in full f32, ``utils/device.full_f32``).

Each ``Quantize`` keeps its codebook (``embed`` (dim, n_embed),
``cluster_size``, ``embed_avg``) in buffers of the ``codebook`` collection
(``convert.py``). With ``train`` the forward updates them in place, once,
under ``torch.no_grad()``, from the codes the old ``embed`` gave: the
codebook gets no gradient. The train step casts only parameters, so under
AMP the codebook stays f32 there and the code lookup promotes the
quantised tensors to f32 (the decoders then run in f32 on bf16
parameters, as in JAX); the inference cast makes it bf16 with the rest.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from unet3d_tpu_torch.models.layers import Conv, _result_type, transposed_conv
from unet3d_tpu_torch.parallel.distributed import data_size, sum_over_data
from unet3d_tpu_torch.utils.device import full_f32


class Quantize(nn.Module):
    """EMA vector quantiser on channels-last ``x`` of ``dim`` channels.

    The distances ``|f|^2 - 2 f.E + |E|^2`` are taken in the result type of
    ``x`` and the codebook, their argmin (the first of equal ones) picks the
    codes, and the quantised values are the codebook's columns. In training
    the one-hot codes take ``x``'s dtype (bf16 under AMP, so the counts and
    sums round to bf16 before they meet the f32 averages, as in JAX):
    ``cluster_size = decay * cluster_size + (1 - decay) * counts``,
    ``embed_avg = decay * embed_avg + (1 - decay) * f^T onehot``, and
    ``embed`` the averages over the Laplace-smoothed counts; in a
    data-parallel step the counts and sums are the global batch's, summed
    over the data axis, so every rank's codebook moves alike. Returns the
    straight-through output ``x + sg(q - x)``, ``diff = mean((sg(q) -
    x)^2)`` and the codes."""

    BUFFER_COLLECTION = "codebook"

    def __init__(self, dim: int, n_embed: int, decay: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.dim, self.n_embed, self.decay, self.eps = dim, n_embed, decay, eps
        self.register_buffer("embed", torch.zeros(dim, n_embed))
        self.register_buffer("cluster_size", torch.zeros(n_embed))
        self.register_buffer("embed_avg", torch.zeros(dim, n_embed))

    def init_own_parameters(self, generator: torch.Generator) -> None:
        """JAX's initialisers: ``embed`` a standard normal, ``cluster_size``
        zeros, ``embed_avg`` a copy of ``embed`` (not an alias)."""
        with torch.no_grad():
            self.embed.normal_(generator=generator)
            self.cluster_size.zero_()
            self.embed_avg.copy_(self.embed)

    def forward(self, x: torch.Tensor, train: bool = False):
        flatten = x.detach().reshape(-1, self.dim)
        embed = self.embed
        with torch.no_grad(), full_f32(flatten, embed):
            dtype = _result_type(flatten, embed)
            dist = ((flatten * flatten).sum(1, keepdim=True)
                    - 2.0 * (flatten.to(dtype) @ embed.to(dtype))
                    + (embed * embed).sum(0, keepdim=True))
            embed_ind = dist.argmin(1)
            quantize = self.embed_code(embed_ind, embed)
            if train:
                self._update(flatten, embed_ind)
        embed_ind = embed_ind.reshape(x.shape[:-1])
        quantize = quantize.reshape(*x.shape[:-1], self.dim)
        diff = (quantize - x).square().mean()
        return x + (quantize - x).detach(), diff, embed_ind

    def _update(self, flatten: torch.Tensor, embed_ind: torch.Tensor) -> None:
        onehot = torch.nn.functional.one_hot(embed_ind, self.n_embed).to(flatten.dtype)
        # JAX rounds (1 - decay) to the counts' dtype (a weak-typed scalar)
        rate = torch.full((), 1 - self.decay, dtype=flatten.dtype, device=flatten.device)
        counts, sums = onehot.sum(0), flatten.t() @ onehot
        if data_size() > 1:  # the global batch's, summed in f32
            counts, sums = (sum_over_data(t.float()).to(t.dtype) for t in (counts, sums))
        new_cluster = self.cluster_size * self.decay + rate * counts
        new_avg = self.embed_avg * self.decay + rate * sums
        n = new_cluster.sum()
        normalized = (new_cluster + self.eps) / (n + self.n_embed * self.eps) * n
        self.cluster_size.copy_(new_cluster)
        self.embed_avg.copy_(new_avg)
        self.embed.copy_(new_avg / normalized[None, :])

    @staticmethod
    def embed_code(embed_id: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
        """The codebook's columns for the codes ``embed_id``: (..., dim)."""
        return embed.t()[embed_id]


class ResBlock(nn.Module):
    """``relu(x) + conv2(relu(conv1(relu(x))))``: 3-cubed SAME ``conv1`` to
    ``channel``, 1-cubed ``conv2`` back to the input width."""

    def __init__(self, in_channels: int, channel: int):
        super().__init__()
        self.conv1 = Conv(in_channels, channel, 3, 1, "SAME")
        self.conv2 = Conv(channel, in_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(x)
        return out + self.conv2(torch.relu(self.conv1(out)))


class Encoder(nn.Module):
    """The stride-4 (two 4-cubed stride-2 convs) or stride-2 (one)
    downsampling stack, a 3-cubed conv, the res blocks, a ReLU."""

    def __init__(self, in_channels: int, channel: int, n_res_block: int,
                 n_res_channel: int, stride: int):
        super().__init__()
        if stride not in (2, 4):
            raise ValueError(f"Unsupported stride {stride}")
        self.stride, self.n_res_block = stride, n_res_block
        self.down1 = Conv(in_channels, channel // 2, 4, 2, 1)
        if stride == 4:
            self.down2 = Conv(channel // 2, channel, 4, 2, 1)
            self.conv = Conv(channel, channel, 3, 1, "SAME")
        else:
            self.conv = Conv(channel // 2, channel, 3, 1, "SAME")
        for i in range(n_res_block):
            self.add_module(f"res{i}", ResBlock(channel, n_res_channel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.down1(x))
        if self.stride == 4:
            x = torch.relu(self.down2(x))
        x = self.conv(x)
        for i in range(self.n_res_block):
            x = getattr(self, f"res{i}")(x)
        return torch.relu(x)


class Decoder(nn.Module):
    """A 3-cubed conv, the res blocks, a ReLU, then one (stride 2) or two
    (stride 4, a ReLU between) 4-cubed stride-2 transposed convs."""

    def __init__(self, in_channels: int, out_channel: int, channel: int, n_res_block: int,
                 n_res_channel: int, stride: int):
        super().__init__()
        if stride not in (2, 4):
            raise ValueError(f"Unsupported stride {stride}")
        self.stride, self.n_res_block = stride, n_res_block
        self.conv = Conv(in_channels, channel, 3, 1, "SAME")
        for i in range(n_res_block):
            self.add_module(f"res{i}", ResBlock(channel, n_res_channel))
        if stride == 4:
            self.up1 = transposed_conv(channel, channel // 2, 4, 2)
            self.up2 = transposed_conv(channel // 2, out_channel, 4, 2)
        else:
            self.up1 = transposed_conv(channel, out_channel, 4, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        for i in range(self.n_res_block):
            x = getattr(self, f"res{i}")(x)
        x = self.up1(torch.relu(x))
        if self.stride == 4:
            x = self.up2(torch.relu(x))
        return x


class VQVAE(nn.Module):
    """Two-level VQ-VAE on NDHWC input of ``in_channel`` channels; returns
    ``(reconstruction, diff)``. The JAX module infers its encoder's input
    width from the input; the port builds it for ``in_channel``, the width
    it reconstructs."""

    def __init__(self, in_channel: int = 3, channel: int = 128, n_res_block: int = 2,
                 n_res_channel: int = 32, embed_dim: int = 64, n_embed: int = 512,
                 decay: float = 0.99):
        super().__init__()
        self.enc_b = Encoder(in_channel, channel, n_res_block, n_res_channel, stride=4)
        self.enc_t = Encoder(channel, channel, n_res_block, n_res_channel, stride=2)
        self.quantize_conv_t = Conv(channel, embed_dim, 1)
        self.quantize_t = Quantize(embed_dim, n_embed, decay)
        self.dec_t = Decoder(embed_dim, embed_dim, channel, n_res_block, n_res_channel,
                             stride=2)
        self.quantize_conv_b = Conv(embed_dim + channel, embed_dim, 1)
        self.quantize_b = Quantize(embed_dim, n_embed, decay)
        self.upsample_t = transposed_conv(embed_dim, embed_dim, 4, 2)
        self.dec = Decoder(2 * embed_dim, in_channel, channel, n_res_block, n_res_channel,
                           stride=4)

    def encode(self, x: torch.Tensor, train: bool = False):
        """``(quant_t, quant_b, diff_t + diff_b, id_t, id_b)``."""
        enc_b = self.enc_b(x)
        enc_t = self.enc_t(enc_b)
        quant_t, diff_t, id_t = self.quantize_t(self.quantize_conv_t(enc_t), train)
        dec_t = self.dec_t(quant_t)
        enc_b = torch.cat(_promoted(dec_t, enc_b), dim=-1)
        quant_b, diff_b, id_b = self.quantize_b(self.quantize_conv_b(enc_b), train)
        return quant_t, quant_b, diff_t + diff_b, id_t, id_b

    def decode(self, quant_t: torch.Tensor, quant_b: torch.Tensor) -> torch.Tensor:
        upsampled = self.upsample_t(quant_t)
        return self.dec(torch.cat(_promoted(upsampled, quant_b), dim=-1))

    def decode_code(self, code_t: torch.Tensor, code_b: torch.Tensor) -> torch.Tensor:
        """The reconstruction of the codes ``code_t`` / ``code_b`` (the
        codebooks' columns, decoded)."""
        return self.decode(Quantize.embed_code(code_t, self.quantize_t.embed),
                           Quantize.embed_code(code_b, self.quantize_b.embed))

    def forward(self, x: torch.Tensor, train: bool = False) -> Tuple[torch.Tensor,
                                                                      torch.Tensor]:
        quant_t, quant_b, diff, _, _ = self.encode(x, train)
        return self.decode(quant_t, quant_b), diff


def _promoted(*tensors: torch.Tensor):
    """``tensors`` in their result type (``jnp.concatenate`` promotes)."""
    dtype = _result_type(*tensors)
    return [t.to(dtype) for t in tensors]

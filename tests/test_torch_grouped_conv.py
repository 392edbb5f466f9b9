"""The grouped convolution of ``layers.Conv`` (``groups``, Flax's
``feature_group_count``) against ``jax.lax.conv_general_dilated``.

The kernel keeps Flax's DHWIO layout with ``Cin / groups`` on I; torch's
grouped weight is ``(Cout, Cin / groups, ...)`` and both packages order the
outputs by group, so the permute of an ungrouped kernel serves. Pinned for
ResNeXt's 32 groups (64 -> 64 channels, 3-cubed, stride 2, pads (1, 1))
and EfficientNet's depthwise conv (one group per channel, 5-cubed, stride 2,
TF's "same" pads: (1, 2) on an even size) on (2, 8^3, C) inputs, in f32
(forward relative L2 1e-5, gradients of ``sum(y * g)`` for the input and
the kernel 1e-4: ``cudnn_conv`` and ``_FullF32Conv`` with ``groups``) and in
bf16 (within 2e-2 of JAX's f32 results), one jitted JAX computation a case.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet3d_tpu_torch.convert import load_jax_variables
from unet3d_tpu_torch.models.layers import Conv

from test_torch_myronenko import _rel, _x

F32, F32_GRAD, BF16 = 1e-5, 1e-4, 2e-2
CASES = {
    # ResNeXt's conv2 at 32 groups: 2 input and 2 output channels a group
    "resnext": dict(channels=64, out=64, groups=32, kernel=3, pads=((1, 1),) * 3),
    # EfficientNet's depthwise conv, TF "same" at stride 2 on 8: (1, 2)
    "depthwise": dict(channels=16, out=16, groups=16, kernel=5, pads=((1, 2),) * 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_conv_matches_lax(case):
    c = CASES[case]
    x = _x(2, 8, 8, 8, c["channels"], seed=1)
    w = _x(*(c["kernel"],) * 3, c["channels"] // c["groups"], c["out"], seed=2)
    w /= np.sqrt(np.prod(w.shape[:-1]))
    g = _x(2, 4, 4, 4, c["out"], seed=3)

    def conv(a, k):
        return jax.lax.conv_general_dilated(
            a, k, (2, 2, 2), c["pads"], dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            feature_group_count=c["groups"])

    def both(a, k, cot):
        out = {}
        for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            y, pull = jax.vjp(conv, a.astype(dt), k.astype(dt))
            out[name] = (y.astype(jnp.float32), *(t.astype(jnp.float32)
                                                  for t in pull(cot.astype(dt))))
        return out

    want = jax.jit(both)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    padding = "SAME" if case == "depthwise" else 1
    layer = Conv(c["channels"], c["out"], c["kernel"], 2, padding, use_bias=False,
                 groups=c["groups"])
    assert tuple(layer.kernel.shape) == w.shape
    load_jax_variables(layer, {"params/kernel": w}, strict=True)
    ref = [np.asarray(t) for t in want["f32"]]
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        net = layer if dtype == torch.float32 else Conv(
            c["channels"], c["out"], c["kernel"], 2, padding, use_bias=False,
            groups=c["groups"]).to(dtype)
        if net is not layer:
            with torch.no_grad():
                net.kernel.copy_(layer.kernel)
        y = net(xt)
        y.backward(torch.from_numpy(g).to(dtype))
        got = [y.detach().float().numpy(), xt.grad.float().numpy(),
               net.kernel.grad.float().numpy()]
        if name == "f32":
            assert _rel(got[0], ref[0]) < F32
            assert _rel(got[1], ref[1]) < F32_GRAD and _rel(got[2], ref[2]) < F32_GRAD
        else:
            theirs = [np.asarray(t) for t in want["bf16"]]
            for ours, jax_bf16, r in zip(got, theirs, ref):
                assert _rel(ours, r) < max(BF16, 1.25 * _rel(jax_bf16, r))


def test_groups_must_divide_the_channels():
    with pytest.raises(ValueError, match="groups"):
        Conv(6, 8, 3, groups=4)

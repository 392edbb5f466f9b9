"""The port's SwinUNETR under bf16 AMP against the JAX package's, on
``test_torch_swin_unetr.py``'s net and input (feature 6, depths (2, 2, 1,
1), heads (1, 2, 2, 2), window 7 on 32^3: padded, clamped and shifted
windows), through ``tests/test_torch_batchnorm.py``'s helpers: the first
AMP train step's gradients no further from JAX's f32 ones than 1.25x
JAX's own bf16 gradients; the AMP eval step's bf16 output within 2e-2 of
JAX's f32 output, JAX's own bf16 distance allowed for; every module's
output dtype as Flax's captured intermediates, eval (bf16 parameters) and
training: WindowAttention's scores are f32 from the scale on and its
softmax runs in f32 before the cast back to bf16 (UNETR's stays bf16).
"""
import pytest

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import check_amp_eval_step, check_dtype_flow, check_grads
from test_torch_swin_unetr import _net


def test_amp_gradients_match_jax():
    check_grads(_net(), True)


def test_amp_eval_step_matches_jax():
    check_amp_eval_step(_net())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_dtype_flow_matches_jax(train):
    check_dtype_flow(_net(), train)

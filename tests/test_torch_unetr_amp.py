"""The port's UNETR under bf16 AMP against the JAX package's, on
``test_torch_unetr.py``'s net and input (hidden 32, mlp 64, 2 heads, 4
layers, feature 4, residual blocks, 32^3, batch 2), through
``tests/test_torch_batchnorm.py``'s helpers: the first AMP train step's
gradients no further from JAX's f32 ones than 1.25x JAX's own bf16
gradients; the AMP eval step's bf16 output within 2e-2 of JAX's f32
output, JAX's own bf16 distance allowed for; every module's output dtype
as Flax's captured intermediates, eval (bf16 parameters) and training:
the attention's scores and softmax stay bf16 (SwinUNETR's run in f32).
"""
import pytest

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import check_amp_eval_step, check_dtype_flow, check_grads
from test_torch_unetr import _net


def test_amp_gradients_match_jax():
    check_grads(_net(), True)


def test_amp_eval_step_matches_jax():
    check_amp_eval_step(_net())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_dtype_flow_matches_jax(train):
    check_dtype_flow(_net(), train)

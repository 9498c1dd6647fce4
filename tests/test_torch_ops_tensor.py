"""The port's tensor ops (``mxnet_tpu_torch/ops/tensor.py``) against the
JAX package's, through ``test_torch_ops_elemwise.run_case`` (forward
values and dtype, the gradient of every marked input, the symbol's JSON,
shapes and types; tolerances in that file's docstring), over
``test_torch_op_cases.TENSOR``.  Inputs avoid ties where the op picks an
element (``max``, ``argmax``, ``topk``, ``sort``), since the two
libraries may break them differently."""
import pytest

from test_torch_op_cases import TENSOR
from test_torch_ops_elemwise import run_case


@pytest.mark.parametrize("case", sorted(TENSOR))
def test_tensor_op(case):
    op, arrays, attrs, grad = TENSOR[case]
    run_case(op, arrays, attrs, grad=grad)

"""The port's layer ops (``mxnet_tpu_torch/ops/nn.py``: the ops this
slice adds, and Convolution / Pooling in the NHWC layout) against the
JAX package's, through ``test_torch_ops_elemwise.run_case`` (forward
values and dtype, the gradient of every marked input, the symbol's JSON,
shapes and types; tolerances in that file's docstring, and 1e-5
absolute as well for the convolutions, which sum up to 36 products a
value).  The cases are ``test_torch_op_cases.NN``; the loss heads
ignore the head gradient on both sides, so their cases hold the
reference's own gradients."""
import pytest

from test_torch_op_cases import CONV_OPS, NN
from test_torch_ops_elemwise import TOL, run_case


@pytest.mark.parametrize("case", sorted(NN))
def test_nn_op(case):
    op, arrays, attrs, grad = NN[case]
    tol = (1e-5, 1e-5) if op in CONV_OPS else TOL
    run_case(op, arrays, attrs, grad=grad, tol=tol)

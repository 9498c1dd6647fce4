"""Two ``Module`` training steps of the port's deep BatchNorm nets —
Inception-BN, ResNeXt-50 and Inception-v3 (cut before its Dropout) —
against the JAX package on the CPU, through
``test_torch_zoo.two_steps_match_jax``, whose docstring states the
tolerances and what was measured (a file of its own so that the two
halves of the zoo's checks run on two test workers)."""
import pytest

import mxnet_tpu_torch as mt
from test_torch_zoo import two_steps_match_jax


@pytest.fixture(autouse=True, scope="module")
def _host_context():
    """Arrays made without a context go to the host: the port's default
    context is the card."""
    with mt.cpu():
        yield


@pytest.mark.parametrize("name,cut", [("inception_bn", False),
                                      ("resnext", False),
                                      ("inception_v3", True)])
def test_module_two_steps_match_jax(name, cut):
    two_steps_match_jax(name, cut)

"""Contrib namespace — the port of ``mxnet_tpu/contrib`` (reference:
python/mxnet/contrib/).

``contrib.autograd`` re-exports the core tape (the reference keeps
autograd in contrib at v0.9.5); ``contrib.tensorboard`` holds the
TensorBoard logging callback.
"""
from .. import autograd  # contrib.autograd API lives in core autograd
from . import tensorboard

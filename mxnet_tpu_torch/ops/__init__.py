"""Operator library of the port — registers, on import, the ops of
``mxnet_tpu/ops/elemwise.py``, ``tensor.py``, ``nn.py``, ``sample.py``,
``contrib_ops.py``, ``spatial.py`` and ``moe.py``, the attention and
fused LM ops, the fused RNN op and the optimizer update ops
(``operator.py`` registers ``Custom``).  Kernel modules load their CUDA
libraries only when a kernel is first launched."""
from . import (attention, contrib_ops, elemwise, fused_lm, moe, nn,
               optimizer_ops, rnn_op, sample, spatial, tensor)

_registered = False


def register_all():
    global _registered
    if _registered:
        return
    _registered = True
    elemwise.register_all()
    tensor.register_all()
    nn.register_all()
    attention.register_all()
    fused_lm.register_all()
    rnn_op.register_all()
    optimizer_ops.register_all()
    sample.register_all()
    contrib_ops.register_all()
    spatial.register_all()
    moe.register_all()


register_all()

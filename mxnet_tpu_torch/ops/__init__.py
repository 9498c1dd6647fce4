"""Operator library of the port — registers the ops of the serving and
training paths (the attention LM, the image-classification zoo, the RNN
cells and the fused RNN op) and the optimizer update ops on import.
Kernel modules load their CUDA libraries only when a kernel is first
launched."""
from . import (attention, elemwise, fused_lm, nn, optimizer_ops, rnn_op,
               tensor)

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


register_all()

"""Operator library of the port — registers the ops of the LM's serving
and training paths on import.  Kernel modules load their CUDA libraries
only when a kernel is first launched."""
from . import attention, elemwise, fused_lm, nn, tensor

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


register_all()

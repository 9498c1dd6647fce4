"""TrainStep — one whole training step: forward, backward, optimizer
update (the counterpart of ``mxnet_tpu/train_step.py``'s
``CompiledTrainStep`` on its per-parameter update path, step body
``:707-748``).

The JAX package compiles the step into one donated XLA program with its
own master-weight store.  PyTorch runs eagerly, so the port's step reads
the executor group's parameter tensors as the f32 masters and updates
them in place through the module's :class:`~mxnet_tpu_torch.optimizer.
Updater`, whose state (momentum) is therefore the same whether a step
ran here or through ``Module.update``: there is no store to hand off or
flush.  No jit and no donation; CUDA graphs are later work.

The compute-dtype rule is the JAX package's (``:640-650``): with a
``compute_dtype``, floating parameters and DATA inputs are cast to it
(labels keep their dtype), uint8 data is cast to it (or f32), gradients
return in the masters' dtype.  That rule casts an LM's float token ids
too, and bf16 holds integers exactly only up to 256: train such models
in f32 (``ROADMAP.md`` lists the fault).
"""
from __future__ import annotations

import torch

from .executor import forward_backward
from .ndarray import torch_dtype

__all__ = ["TrainStep"]


class TrainStep:
    """Forward + backward (autograd) + SGD-style update over one
    executor group, in place."""

    def __init__(self, exec_group, updater, compute_dtype=None):
        self._group = exec_group
        self._updater = updater
        exe = exec_group.exec_
        self._grad_names = [n for n in exec_group.param_names
                            if exe.grad_req.get(n, "null") == "write"]
        # optimizer bookkeeping is keyed by the param's index in the group,
        # as on the eager path
        self._grad_indices = [exec_group.param_names.index(n)
                              for n in self._grad_names]
        self._cdtype = (None if compute_dtype in (None, "", "float32")
                        else torch_dtype(compute_dtype))

    def _cast(self, v):
        if self._cdtype is not None and v.is_floating_point():
            return v.to(self._cdtype)
        if v.dtype == torch.uint8:
            return v.to(self._cdtype or torch.float32)
        return v

    def run(self, data_batch):
        """One step on ``data_batch``; returns the outputs (tensors)."""
        group = self._group
        group.load_data_batch(data_batch)
        exe = group.exec_
        data_names = set(group.data_names)
        label_names = set(group.label_names)
        env = {}
        for n, arr in exe.arg_dict.items():
            v = arr.data
            if n not in label_names and (n in data_names
                                         or n in group.param_names):
                v = self._cast(v)
            env[n] = v
        aux = {n: a.data for n, a in exe.aux_dict.items()}
        outs, new_aux, grads = forward_backward(
            exe._symbol, env, aux, self._grad_names, exe._octx)
        exe._set_aux(new_aux)
        exe.set_grads(grads)
        self._updater.update_multi(
            self._grad_indices, [exe.grad_dict[n] for n in self._grad_names],
            [exe.arg_dict[n] for n in self._grad_names])
        exe.set_outputs(outs)
        return outs

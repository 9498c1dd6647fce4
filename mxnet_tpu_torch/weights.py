"""Parameters between the JAX package and the port.

:func:`params_from_jax` takes the JAX package's parameters — numpy
arrays (or anything ``np.asarray`` reads) keyed by ``arg:``/``aux:``
names or bare names — and returns the port's ``{name: torch.Tensor}``
on a chosen device, so both packages compute the same thing from the
same numbers.  :func:`params_to_numpy` is the way back: the port's
parameters (``Module.get_params()``'s NDArrays, or tensors) as numpy
arrays, for comparing the two packages after training steps.
``.params`` files are read by :func:`~mxnet_tpu_torch.ndarray.load`
and :func:`~mxnet_tpu_torch.model.load_checkpoint`.
"""
from __future__ import annotations

import numpy as np
import torch

from .context import resolve_device

__all__ = ["params_from_jax", "params_to_numpy", "to_tensors"]


def _strip(name):
    for prefix in ("arg:", "aux:"):
        if name.startswith(prefix):
            return name[len(prefix):]
    return name


def to_tensors(params, device):
    """``{name: tensor}`` on ``device`` (a ``torch.device``) from a dict of
    tensors or arrays, ``arg:``/``aux:`` prefixes dropped."""
    out = {}
    for key, value in params.items():
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, copy=True))
        out[_strip(key)] = value.to(device)
    return out


def params_from_jax(arg_params, aux_params=None, device=None):
    """The JAX package's ``(arg_params, aux_params)`` as the port's
    tensors on ``device`` (default: the card; pass ``device="cpu"`` for
    the host)."""
    merged = dict(arg_params)
    for key, value in (aux_params or {}).items():
        merged["aux:" + _strip(key)] = value
    return to_tensors(merged, resolve_device(device))


def params_to_numpy(arg_params, aux_params=None):
    """``{name: np.ndarray}`` (f32 for bf16) from the port's parameters —
    dicts of NDArrays or tensors; aux entries keyed ``aux:<name>``, the
    form :func:`params_from_jax` reads."""
    def host(v):
        t = v.data if hasattr(v, "asnumpy") else v
        t = t.detach()
        # a copy: under the slab plan a parameter is a view of a slab the
        # next step updates in place
        return np.array((t.float() if t.dtype == torch.bfloat16 else t)
                        .cpu().numpy(), copy=True)

    out = {k: host(v) for k, v in arg_params.items()}
    out.update({"aux:" + k: host(v) for k, v in (aux_params or {}).items()})
    return out

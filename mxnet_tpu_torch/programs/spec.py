"""ProgramSpec — one serving program's registration record (counterpart
of ``mxnet_tpu/programs/spec.py``).

A call site registers (name, program, abstract args, trace counters,
identity extras) once and gets :meth:`ProgramSpec.fingerprint`: a
content address over the program's name, the torch and CUDA versions,
the device kind, the abstract args' shapes and dtypes, the caller's
extras and a digest of the kernel sources (``csrc/*.cu*``).  Two hosts
with equal keys run the same program on the same kernels.

The reference's HLO probes (``artifact``, ``cost``, ``lowered``,
``compiled``) have no counterpart yet: a CUDA graph has no text to lint
or price.
"""
from __future__ import annotations

import functools
import glob
import hashlib
import json
import os
import weakref

import torch

from ..cuda_build import CSRC

__all__ = ["ProgramSpec", "kernel_digest", "device_kind"]


@functools.lru_cache(maxsize=None)
def kernel_digest():
    """blake2b digest of every kernel source and header under ``csrc/``
    (file names and contents)."""
    h = hashlib.blake2b(digest_size=16)
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()


def device_kind(device):
    """The card's name for a CUDA device, else the device type."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return device.type if device is not None else None
    return torch.cuda.get_device_name(device)


def _resolve(v):
    return v() if callable(v) else v


def _leaf_sigs(x, out):
    """Shape and dtype of every tensor leaf of a nested args structure
    (tuples, lists, dicts by sorted key); other leaves by type name."""
    if isinstance(x, dict):
        for k in sorted(x):
            _leaf_sigs(x[k], out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _leaf_sigs(v, out)
    elif isinstance(x, torch.Tensor):
        out.append([list(x.shape), str(x.dtype)])
    else:
        out.append(None if x is None else type(x).__name__)
    return out


class ProgramSpec:
    """One registered serving program.

    Parameters
    ----------
    name : str
        The program's registry name (``paged_decode_step``, ...).
    fn : callable
        The program (a :class:`~mxnet_tpu_torch.programs.graphs.
        GraphProgram`).
    owner : object, optional
        The live object that runs the program; held weakly, so a spec
        never pins a model's parameters.
    abstract_args : tuple or callable, optional
        The program's arguments as tensors on the ``meta`` device (only
        their shapes and dtypes are read); a callable is resolved lazily.
    trace_count, expected_traces
        Captures so far and how many the serving loop expects; values or
        callables.
    device : torch.device or str, optional
        Where the program runs: its kind enters the fingerprint.
    fingerprint_extra : dict or callable, optional
        What changes the program but not its argument shapes (the symbol
        digest, the decode knobs).
    """

    def __init__(self, name, fn, *, owner=None, abstract_args=None,
                 trace_count=None, expected_traces=1, device=None,
                 fingerprint_extra=None):
        self.name = name
        self.fn = fn
        self._owner = weakref.ref(owner) if owner is not None else None
        self._abstract_args = abstract_args
        self._trace_count = trace_count
        self._expected_traces = expected_traces
        self._device = device
        self._fingerprint_extra = fingerprint_extra

    def owner(self):
        return self._owner() if self._owner is not None else None

    def avals(self, args=None):
        """The abstract args (None while the lazy supplier says the
        program is not runnable yet)."""
        return args if args is not None else _resolve(self._abstract_args)

    def trace_count(self):
        return _resolve(self._trace_count)

    def expected_traces(self):
        return _resolve(self._expected_traces)

    def fingerprint(self, args=None, device=None):
        """Content address of the program at ``args`` (or the spec's
        abstract args): equal keys mean the same name, torch and CUDA
        versions, device kind, argument shapes and dtypes, extras and
        kernel sources."""
        args = self.avals(args)
        if args is None:
            return None
        payload = {
            "name": self.name,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": device_kind(device if device is not None
                                  else self._device),
            "leaves": _leaf_sigs(args, []),
            "kernels": kernel_digest(),
            "extra": _resolve(self._fingerprint_extra),
        }
        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()

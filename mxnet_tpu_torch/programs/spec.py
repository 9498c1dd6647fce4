"""ProgramSpec — one serving program's registration record (counterpart
of ``mxnet_tpu/programs/spec.py``).

A call site registers (name, program, abstract args, trace counters,
identity extras) once and gets :meth:`ProgramSpec.fingerprint`: a
content address over the program's name, the torch and CUDA versions,
the device kind, the abstract args' shapes and dtypes, the caller's
extras and a digest of the kernel sources (``csrc/*.cu*``).  Two hosts
with equal keys run the same program on the same kernels.

:meth:`ProgramSpec.artifact` traces the program's body (the Python the
:class:`~mxnet_tpu_torch.programs.graphs.GraphProgram` captures) through
the one artifact function,
:func:`~mxnet_tpu_torch.analysis.artifact_from_export`;
:meth:`ProgramSpec.cost` prices it from that graph
(:func:`~mxnet_tpu_torch.analysis.cost.program_cost`), and
:meth:`ProgramSpec.donated_leaves` counts the buffers of the argument
positions the program updates in place (``donate_argnums``).  The
reference's ``lowered`` / ``compiled`` probes have no counterpart: a
CUDA graph has no text.

The probing helpers (:func:`probing`, :func:`probe_artifact`,
:func:`probe_cost`) are the one copy of the guard every probe runs
under: the owner's ``_probing`` flag is set, and every kernel launch
counter, path marker and :data:`~mxnet_tpu_torch.programs.graphs.
GRAPH_STATS` entry is restored afterwards, so a probe counts as neither
a capture nor a launch.
"""
from __future__ import annotations

import contextlib
import functools
import glob
import hashlib
import json
import os
import weakref

import torch

from ..base import MXNetError
from ..cuda_build import CSRC

__all__ = ["ProgramSpec", "kernel_digest", "device_kind", "probing",
           "probe_artifact", "probe_cost"]


@contextlib.contextmanager
def probing(owner=None):
    """A probe's scope: ``owner._probing`` set (when an owner is given),
    and every kernel launch counter, path marker and graph statistic
    restored on the way out, so a probe is never a capture or a
    launch."""
    from .graphs import GRAPH_STATS, _launch_counters, _path_markers

    saved = [(d, dict(d)) for d in _launch_counters() + _path_markers()
             + (GRAPH_STATS,)]
    if owner is not None:
        owner._probing = True
    try:
        yield
    finally:
        if owner is not None:
            owner._probing = False
        for d, v in saved:
            d.clear()
            d.update(v)


def probe_artifact(owner, fn, args, name, refine=None, **kw):
    """:func:`~mxnet_tpu_torch.analysis.artifact_from_export` of ``fn``
    (a body, or an ``nn.Module``) at ``args`` under :func:`probing`;
    ``refine`` an optional post-hook on the artifact."""
    from ..analysis.artifact import artifact_from_export

    with probing(owner):
        art = artifact_from_export(fn, args, name, **kw)
    return refine(art) if refine is not None else art


def probe_cost(owner, fn, args, autograd=False):
    """The static FLOPs and bytes of ``fn`` at ``args``
    (:func:`~mxnet_tpu_torch.analysis.cost.program_cost`) under
    :func:`probing`."""
    from ..analysis.cost import program_cost

    with probing(owner):
        return program_cost(fn, args, autograd=autograd)


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
    program : callable, optional
        ``program(args) -> (module, example_args)``: the body to export
        at the abstract args, for an owner whose body takes them in
        another form (the weights as buffers); by default a
        :class:`~mxnet_tpu_torch.programs.graphs.GraphProgram`'s
        ``body`` called on the args as they are.
    donate_argnums : tuple of int
        The argument positions whose buffers the program updates in
        place: :meth:`donated_leaves` counts their tensors.
    autograd : bool
        The body calls autograd (a training step): traced by ``make_fx``
        into one graph.
    partition_rules : list, optional
        The ``(regex, axes)`` rules the program's named parameters were
        placed by (:mod:`~mxnet_tpu_torch.programs.partition`); they
        enter the fingerprint.
    mesh_shape : dict or callable, optional
        ``{axis: size}`` of the mesh the program runs one rank of: it
        enters the fingerprint and the artifact.
    artifact_meta : dict or callable, optional
        Metadata every artifact of the program carries (a mesh rank's
        ``sharding_coverage``).
    """

    def __init__(self, name, fn, *, owner=None, abstract_args=None,
                 trace_count=None, expected_traces=1, device=None,
                 fingerprint_extra=None, program=None, donate_argnums=(),
                 autograd=False, partition_rules=None, mesh_shape=None,
                 artifact_meta=None):
        self.name = name
        self.fn = fn
        self._owner = weakref.ref(owner) if owner is not None else None
        self._abstract_args = abstract_args
        self._trace_count = trace_count
        self._expected_traces = expected_traces
        self._device = device
        self._fingerprint_extra = fingerprint_extra
        self._program = program
        self.donate_argnums = tuple(donate_argnums or ())
        self._autograd = autograd
        self.partition_rules = partition_rules
        self._mesh_shape = mesh_shape
        self._artifact_meta = artifact_meta

    @property
    def mesh_shape(self):
        return _resolve(self._mesh_shape)

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
        versions, device kind, argument shapes and dtypes, partition
        rules, extras and kernel sources."""
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
            "rules": [[p, [str(a) for a in s]]
                      for p, s in (self.partition_rules or [])],
            "extra": _resolve(self._fingerprint_extra),
        }
        if self.mesh_shape is not None:
            payload["mesh"] = self.mesh_shape
        blob = json.dumps(payload, sort_keys=True, default=str)
        return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()

    def donated_leaves(self, args):
        """Tensors of the argument positions in ``donate_argnums`` (the
        buffers the program updates in place), counted over ``args``."""
        return sum(isinstance(x, list) for i in self.donate_argnums
                   if i < len(args) for x in _leaf_sigs(args[i], []))

    def _module(self, args):
        from ..analysis.artifact import BufferModule
        from .graphs import GraphProgram

        if self._program is not None:
            return self._program(args)
        if isinstance(self.fn, GraphProgram):
            return BufferModule(self.fn.body), tuple(args)
        raise MXNetError("program %r has no body to export" % self.name)

    def artifact(self, args=None, name=None, **extra_meta):
        """:class:`~mxnet_tpu_torch.analysis.ProgramArtifact` of the
        program's body at ``args`` (or the spec's abstract args; ``meta``
        tensors do), traced on fake tensors under :func:`probing`; None
        before the program is runnable."""
        args = self.avals(args)
        if args is None:
            return None
        module, example = self._module(args)
        extra_meta = dict(_resolve(self._artifact_meta) or {}, **extra_meta)
        return probe_artifact(
            self.owner(), module, example, name or self.name,
            autograd=self._autograd, mesh_shape=self.mesh_shape,
            donated_leaves=self.donated_leaves(args),
            trace_count=self.trace_count(),
            expected_traces=self.expected_traces() or 1,
            fingerprint=self.fingerprint(args), **extra_meta)

    def cost(self, args=None):
        """``{"flops", "bytes", "collective_bytes", "gather_bytes",
        "sort_scatter_bytes"}`` of the program at ``args`` (or the
        spec's abstract args), from its traced graph; None before the
        program is runnable."""
        args = self.avals(args)
        if args is None:
            return None
        module, example = self._module(args)
        return probe_cost(self.owner(), module, example,
                          autograd=self._autograd)

    def register_roofline(self, accounting=None, name=None):
        """Attach :meth:`cost` as the program's lazy static-cost prober in
        ``accounting`` (``obs.programs`` by default) under ``name`` (the
        spec's).  The prober holds the spec by a weak reference, and the
        spec its owner weakly, so registering never keeps the model
        alive: once the spec is gone the prober returns None."""
        from .. import obs as _obs

        acc = accounting if accounting is not None else _obs.programs
        ref = weakref.ref(self)
        acc.register_static(
            name or self.name,
            lambda: (ref().cost() if ref() is not None else None))

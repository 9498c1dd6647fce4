"""ProgramArtifact — one program's static surfaces, bundled (the port of
``mxnet_tpu/analysis/artifact.py``).

The reference traces a jitted function into a jaxpr, lowers it to
StableHLO and compiles it.  The port traces a program with
``torch.export`` (non-strict: the Python runs once over fake tensors, so
nothing is computed and no kernel launches) into an
``ExportedProgram``.  The text forms map so:

==================  ==============================================
reference           here
==================  ==============================================
``jaxpr_text``      ``graph_text``: the exported graph's code
``stablehlo_text``  ``exported_text``: ``str(exported_program)``
``compiled_text``   ``compiled_text``: always None (a CUDA graph has
                    no text)
==================  ==============================================

The metadata fields are the reference's.  Every hand-written kernel is
a torch operator (``mxnet_tpu_torch::fused_fwd`` / ``::fused_bwd`` (A /
F), ``::paged_decode`` (B), ``::flash_fwd`` / ``::flash_bwd_dq`` /
``::flash_bwd_dkv`` (C / D / E), ``::multi_tensor_update`` (B1)), so a
graph traced on any device holds them as nodes; :func:`kernel_ops`
counts them — the counterpart of the reference's "the program must
contain a ``pallas_call``" check.

:func:`artifact_from_export` is the one function behind every export and
artifact surface, so the way a program is traced cannot diverge between
them.  A program without autograd (the serving steps, which write their
pools, lengths and tokens in place; a forward) goes through
``torch.export.export``: the exported graph keeps those writes as
in-place operations on its inputs.  A program whose body calls
autograd (``autograd=True``: the training and evaluation steps) is
traced by ``make_fx`` on fake tensors into one flat graph of ATen
operators and the kernels' operators — forward, the registered
backwards (kernel F for A, D and E for C) and the update (B1) with its
in-place writes in the operator's schema.  Either way nothing is
computed and no input is written.

The graph itself (``ProgramArtifact.graph_module``) is what the passes
read (:mod:`.graph_parse`): :meth:`ProgramArtifact.parsed` parses it
once.  ``written_inputs`` in :meth:`ProgramArtifact.describe` are the
program's inputs the graph writes in place (the counterpart of compiled
HLO's ``input_output_alias``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

__all__ = ["ProgramArtifact", "BufferModule", "artifact_from_export",
           "kernel_ops", "KERNEL_NAMESPACE"]

# the namespace the kernels' operators are registered under
KERNEL_NAMESPACE = "mxnet_tpu_torch"
_KERNEL_CALL = re.compile(r"torch\.ops\.%s\.(\w+)\." % KERNEL_NAMESPACE)


@dataclass
class ProgramArtifact:
    """Static views and metadata of one program.

    ``program`` is the ``torch.export.ExportedProgram`` itself (what
    :func:`save_program` writes); it takes no part in comparisons or
    :meth:`describe`."""

    name: str
    graph_text: str = None
    exported_text: str = None
    compiled_text: str = None
    # buffers the program updates in place (the reference's donated
    # leaves: the state a step consumes)
    donated_leaves: int = 0
    # intended compute dtype of the program's hot math
    compute_dtype: str = None
    # mesh axis sizes the program was built under (no mesh in the port)
    mesh_shape: dict = None
    # retrace contract: captures so far against the signatures the
    # program legitimately needs
    trace_count: int = None
    expected_traces: int = 1
    # content address of the program when known (ProgramSpec.fingerprint)
    fingerprint: str = None
    meta: dict = field(default_factory=dict)
    program: object = field(default=None, repr=False, compare=False)
    # the traced graph (a torch.fx.GraphModule) and the program inputs
    # its tracer reports written besides the graph's in-place nodes
    graph_module: object = field(default=None, repr=False, compare=False)
    mutated_inputs: tuple = field(default=(), repr=False, compare=False)
    _parsed: dict = field(default=None, repr=False, compare=False)

    def parsed(self):
        """:func:`~.graph_parse.parse_graph` of the graph (once); None
        for an artifact without one."""
        if self._parsed is None and self.graph_module is not None:
            from .graph_parse import parse_graph

            self._parsed = parse_graph(self.graph_module,
                                       self.mutated_inputs)
        return self._parsed

    def describe(self):
        return {
            "name": self.name,
            "has_graph": self.graph_text is not None,
            "has_exported": self.exported_text is not None,
            "has_compiled": self.compiled_text is not None,
            "donated_leaves": self.donated_leaves,
            "compute_dtype": self.compute_dtype,
            "mesh_shape": self.mesh_shape,
            "trace_count": self.trace_count,
            "expected_traces": self.expected_traces,
            "fingerprint": self.fingerprint,
            "kernel_ops": kernel_ops(self),
            "written_inputs": len((self.parsed() or {}).get(
                "written_inputs", ())),
        }


class BufferModule(torch.nn.Module):
    """``fn(*args, env=...)`` as a module whose buffers are ``env``'s
    tensors (the weights: the exported program's state rather than its
    inputs); with ``env`` None, ``fn(*args)``."""

    def __init__(self, fn, env=None):
        super().__init__()
        self._fn = fn
        self._keys = None
        if env is not None:
            self._keys = {}
            for name, t in env.items():
                key = base = re.sub(r"\W", "_", name) or "p"
                i = 0
                while key in self._buffers:
                    i += 1
                    key = "%s_%d" % (base, i)
                self.register_buffer(key, t)
                self._keys[name] = key

    def forward(self, *args):
        if self._keys is None:
            return self._fn(*args)
        env = {n: getattr(self, k) for n, k in self._keys.items()}
        return self._fn(*args, env=env)


def _flatten(x, leaves):
    """Append ``x``'s leaves (through tuples, lists and named tuples);
    return its structure."""
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return None


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    typ, kids = spec
    vals = [_unflatten(k, it) for k in kids]
    if typ is list:
        return vals
    return typ(*vals) if hasattr(typ, "_fields") else typ(vals)


class _FlatInputs(torch.nn.Module):
    """``module`` over nested arguments as a module of its tensor leaves
    alone: other leaves (None, numbers, a generator) are fixed at the
    example's values."""

    def __init__(self, module, example_args):
        super().__init__()
        self.inner = module
        self._leaves = []
        self._specs = [_flatten(a, self._leaves) for a in example_args]
        self._tensor_at = [i for i, x in enumerate(self._leaves)
                           if isinstance(x, torch.Tensor)]

    def tensors(self):
        return tuple(self._leaves[i] for i in self._tensor_at)

    def forward(self, *tensors):
        leaves = list(self._leaves)
        for i, t in zip(self._tensor_at, tensors):
            leaves[i] = t
        it = iter(leaves)
        return self.inner(*[_unflatten(s, it) for s in self._specs])


def _export(module, example_args):
    """``torch.export.export`` of ``module`` at ``example_args`` (nested;
    only tensor leaves become inputs), under ``no_grad``, with every
    kernel path marker restored afterwards (the trace runs the ops'
    Python, which sets them)."""
    from ..programs.graphs import _path_markers

    if not isinstance(module, torch.nn.Module):
        module = BufferModule(module)
    flat = _FlatInputs(module, example_args)
    markers = _path_markers()
    saved = [dict(m) for m in markers]
    try:
        with torch.no_grad():
            return torch.export.export(flat, flat.tensors(), strict=False)
    finally:
        for m, s in zip(markers, saved):
            m.update(s)


def _trace_fx(module, example_args):
    """``make_fx`` of ``module`` at ``example_args`` on fake tensors: one
    flat graph of ATen and kernel operators, autograd's backward
    included (a body that turns autograd on itself traces its
    ``torch.autograd.grad`` as the backward's operators).  The module
    holds no tensors of its own (its state arrives as arguments); every
    kernel path marker is restored afterwards."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from ..programs.graphs import _path_markers

    if not isinstance(module, torch.nn.Module):
        module = BufferModule(module)
    flat = _FlatInputs(module, example_args)
    markers = _path_markers()
    saved = [dict(m) for m in markers]
    try:
        return make_fx(flat, tracing_mode="fake")(*flat.tensors())
    finally:
        for m, s in zip(markers, saved):
            m.update(s)


def _mutated_inputs(ep):
    """Placeholder names of the inputs an exported program's signature
    reports mutated."""
    sig = ep.graph_signature
    names = set(getattr(sig, "user_inputs_to_mutate", {}).values())
    buffers = set(getattr(sig, "buffers_to_mutate", {}).values())
    for spec in sig.input_specs:
        target = getattr(spec, "target", None)
        if target in buffers:
            names.add(spec.arg.name)
    return tuple(sorted(names))


def artifact_from_export(module, example_args, name, donated_leaves=0,
                         compute_dtype=None, mesh_shape=None,
                         trace_count=None, expected_traces=1,
                         fingerprint=None, autograd=False, **meta):
    """Trace ``module`` (an ``nn.Module``, or a callable) at
    ``example_args`` and bundle the result as a
    :class:`ProgramArtifact`: with ``torch.export``, or, with
    ``autograd`` (a body that calls ``torch.autograd.grad``: the
    training steps), with ``make_fx`` into one graph (:func:`_trace_fx`).

    ``example_args`` may nest tuples, lists and named tuples
    (``QuantKV``); their tensor leaves are the program's inputs, in
    order, and any other leaf is fixed at its value.  Real tensors,
    ``meta`` tensors (shapes and dtypes alone) or a mix with the
    module's buffers on one device all do: the trace runs on fake
    copies, so nothing is computed, no kernel launches and no input is
    written."""
    if autograd:
        gm = _trace_fx(module, example_args)
        return ProgramArtifact(
            name=name, graph_text=gm.code, exported_text=str(gm.graph),
            compiled_text=None, donated_leaves=donated_leaves,
            compute_dtype=compute_dtype, mesh_shape=mesh_shape,
            trace_count=trace_count, expected_traces=expected_traces,
            fingerprint=fingerprint, meta=meta, program=gm,
            graph_module=gm)
    ep = _export(module, example_args)
    return ProgramArtifact(
        name=name, graph_text=ep.graph_module.code, exported_text=str(ep),
        compiled_text=None, donated_leaves=donated_leaves,
        compute_dtype=compute_dtype, mesh_shape=mesh_shape,
        trace_count=trace_count, expected_traces=expected_traces,
        fingerprint=fingerprint, meta=meta, program=ep,
        graph_module=ep.graph_module, mutated_inputs=_mutated_inputs(ep))


def kernel_ops(artifact):
    """``{operator: node count}`` of the kernels' operators
    (``mxnet_tpu_torch::*``) in the artifact's graph — e.g.
    ``{"fused_fwd": 10, "flash_fwd": 2}``; ``{}`` for a graph of plain
    versions only."""
    counts = {}
    for op in _KERNEL_CALL.findall(artifact.graph_text or ""):
        counts[op] = counts.get(op, 0) + 1
    return counts

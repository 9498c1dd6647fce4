"""Retrace auditing — new captures become a checked invariant (the port
of ``mxnet_tpu/analysis/retrace.py``).

A program must be captured exactly once per distinct argument
signature: a second capture at the "same" shapes means the signature
drifted — a dtype changed, a buffer was rebound (a
:class:`~mxnet_tpu_torch.programs.graphs.GraphProgram` binds its bound
arguments by pointer), a Python static changed.  Each new capture
re-records the whole program mid-loop.

:class:`RetraceAuditor` wraps a callable or a ``GraphProgram``: it
records the abstract signature of every call and counts traces — a
``GraphProgram``'s own captures, or, for a plain callable, each call at
a signature not seen before (the counterpart of a jit cache miss) — so
after driving the program it can say not just *that* it retraced but
*what differed* between the colliding signatures.  The steps carry the
same counters built in (``CompiledTrainStep.trace_count``,
``DecodePredictor.trace_counts``).
"""
from __future__ import annotations

import torch

__all__ = ["RetraceAuditor", "arg_signature", "signature_diff"]


def _leaves(x, out):
    if isinstance(x, dict):
        for k in sorted(x):
            _leaves(x[k], out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    else:
        out.append(x)
    return out


def arg_signature(args, kwargs=None):
    """Flatten a call's arguments into a hashable abstract signature: one
    ``(shape, dtype, device)`` triple per tensor leaf, ``("static",
    repr, None)`` for any other leaf."""
    sig = []
    for leaf in _leaves((args, kwargs or {}), []):
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(int(d) for d in leaf.shape),
                        str(leaf.dtype).replace("torch.", ""),
                        str(leaf.device)))
        else:
            sig.append(("static", repr(leaf), None))
    return tuple(sig)


def signature_diff(a, b):
    """Human-readable leaf-wise differences between two signatures."""
    diffs = []
    if len(a) != len(b):
        diffs.append("leaf count %d != %d" % (len(a), len(b)))
    for i, (la, lb) in enumerate(zip(a, b)):
        if la == lb:
            continue
        parts = []
        for name, va, vb in zip(("shape", "dtype", "device"), la, lb):
            if va != vb:
                parts.append("%s %s -> %s" % (name, va, vb))
        diffs.append("leaf %d: %s" % (i, "; ".join(parts)))
    return diffs


class RetraceAuditor:
    """Wrap a callable (or a ``GraphProgram``) so its traces and call
    signatures are recorded.

    Usage::

        auditor = RetraceAuditor(program)
        auditor.wrapped(state, x); auditor.wrapped(state, x2)
        rec = auditor.record()
        assert rec["traces"] == len(rec["unique_signatures"])

    ``wrapped`` records the call's signature (:meth:`observe`) and runs
    the callable.  ``traces`` counts a ``GraphProgram``'s captures
    during the audited calls, or, for a plain callable, the calls at a
    signature not seen before; ``diffs`` pinpoints which leaf's shape,
    dtype or device moved between consecutive new signatures.
    """

    def __init__(self, fn, name=None):
        from ..programs.graphs import GraphProgram

        self._fn = fn
        self.name = name or getattr(fn, "name", None) \
            or getattr(fn, "__name__", "fn")
        self.traces = 0
        self.calls = 0
        self.signatures = []
        is_program = isinstance(fn, GraphProgram)

        def wrapped(*args, **kwargs):
            sig = arg_signature(args, kwargs)
            seen = sig in self.signatures
            self.observe(*args, **kwargs)
            if is_program:
                before = fn.traces
                out = fn(*args, **kwargs)
                self.traces += fn.traces - before
                return out
            if not seen:
                self.traces += 1
            return fn(*args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        self.wrapped = wrapped

    def observe(self, *args, **kwargs):
        """Record one call's signature."""
        self.calls += 1
        self.signatures.append(arg_signature(args, kwargs))

    def record(self, expected_traces=1):
        """Summary dict for ``ProgramArtifact.meta['retrace']``."""
        unique = []
        for sig in self.signatures:
            if sig not in unique:
                unique.append(sig)
        diffs = []
        for prev, cur in zip(unique, unique[1:]):
            diffs.append(signature_diff(prev, cur))
        return {
            "name": self.name,
            "traces": self.traces,
            "calls": self.calls,
            "unique_signatures": len(unique),
            "expected_traces": expected_traces,
            "diffs": diffs,
        }

"""The live program registry (the live half of
``mxnet_tpu/programs/registry.py``).

Every :class:`~mxnet_tpu_torch.programs.spec.ProgramSpec` a call site
registers, latest wins per name, held weakly: the registering object
owns its specs, and a collected owner's entries disappear.
:func:`trace_report` folds their capture counters into one view.  The
reference's canonical lint catalog goes with ``analysis/``, which the
port does not have yet.
"""
from __future__ import annotations

import weakref

__all__ = ["ProgramRegistry", "REGISTRY", "register", "get", "names",
           "trace_report"]


class ProgramRegistry:
    """Name -> live :class:`ProgramSpec`."""

    def __init__(self):
        self._specs = {}        # name -> weakref to ProgramSpec

    def register(self, spec):
        """Register (or refresh) a spec; returns it."""
        self._specs[spec.name] = weakref.ref(spec)
        return spec

    def get(self, name):
        ref = self._specs.get(name)
        spec = ref() if ref is not None else None
        if ref is not None and spec is None:
            del self._specs[name]
        return spec

    def names(self):
        return sorted(n for n in list(self._specs)
                      if self.get(n) is not None)

    def trace_report(self):
        """``{name: {"trace_count", "expected_traces"}}`` over every live
        spec whose owner is still alive."""
        out = {}
        for name in self.names():
            spec = self.get(name)
            if spec is None or (spec._owner is not None
                                and spec.owner() is None):
                continue
            out[name] = {"trace_count": spec.trace_count(),
                         "expected_traces": spec.expected_traces()}
        return out


REGISTRY = ProgramRegistry()

# module-level conveniences bound to the process-wide registry
register = REGISTRY.register
get = REGISTRY.get
names = REGISTRY.names
trace_report = REGISTRY.trace_report

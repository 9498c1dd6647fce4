"""The program registry — live specs + the canonical lint catalog (the
port of ``mxnet_tpu/programs/registry.py``).

* **Live programs** — every :class:`~mxnet_tpu_torch.programs.spec.
  ProgramSpec` a call site registers, latest wins per name, held weakly:
  the registering object owns its specs, and a collected owner's entries
  disappear.  :func:`trace_report` folds their capture counters into one
  view.
* **Canonical programs** — the programs ``tools/mxlint_torch.py``
  audits.  ``analysis/programs.py`` registers build groups here (a
  build function drives a real workload and returns ``[(name, artifact),
  ...]``); the tool enumerates :func:`canonical_names` and calls
  :func:`build_canonical`.  ``build_canonical(names, device=...)``
  hands the device to every build function (the card by default, as every
  entry point).
"""
from __future__ import annotations

import weakref

from ..base import MXNetError

__all__ = ["ProgramRegistry", "REGISTRY", "register", "get", "names",
           "register_canonical", "canonical_names", "canonical_groups",
           "build_canonical", "trace_report"]


class ProgramRegistry:
    """Name -> live :class:`ProgramSpec`, plus the canonical build
    catalog the lint enumerates."""

    def __init__(self):
        self._specs = {}        # name -> weakref to ProgramSpec
        self._canonical = []    # ordered canonical names
        self._groups = {}       # name -> (group_key, build, availability)

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


    # ------------------------------------------------------------------
    # canonical catalog (the mxlint_torch surface)
    # ------------------------------------------------------------------
    def register_canonical(self, names, build, availability=None):
        """Register a build group producing the canonical programs
        ``names`` (in catalog order).  ``build(want, device)`` receives
        the subset of its names requested and the device, and returns
        ``[(name, artifact), ...]``; ``availability()`` returns None when
        buildable, else a human-readable reason (surfaced as a note)."""
        key = tuple(names)
        for name in names:
            if name in self._groups:
                raise MXNetError("canonical program %r registered twice"
                                 % name)
            self._canonical.append(name)
            self._groups[name] = (key, build, availability)

    def canonical_names(self):
        return tuple(self._canonical)

    def canonical_groups(self, names=None):
        """The build groups covering ``names`` (default: all), in
        catalog order, each as the tuple of its requested names."""
        want = list(names) if names else list(self._canonical)
        groups = []
        for name in self._canonical:
            key = self._groups[name][0]
            sub = tuple(n for n in key if n in want)
            if sub and sub not in groups:
                groups.append(sub)
        return groups

    def build_canonical(self, names=None, device=None):
        """Build the requested canonical artifacts (default: all) on
        ``device`` (None: the card).

        Returns ``(artifacts, notes)`` — ``notes`` maps unbuildable
        programs to the reason, so the caller surfaces the gap instead
        of silently auditing a smaller set."""
        want = list(names) if names else list(self._canonical)
        unknown = [n for n in want if n not in self._groups]
        if unknown:
            raise MXNetError("unknown canonical program(s) %s; known: %s"
                             % (unknown, list(self._canonical)))
        artifacts, notes, done = [], {}, set()
        for name in want:
            key, build, availability = self._groups[name]
            if key in done:
                continue
            done.add(key)
            group_want = [n for n in key if n in want]
            if availability is not None:
                reason = availability()
                if reason is not None:
                    for n in group_want:
                        notes[n] = reason
                    continue
            built = dict(build(group_want, device))
            missing = [n for n in group_want if n not in built]
            if missing:
                raise MXNetError("canonical build of %s did not "
                                 "produce %s" % (list(key), missing))
            for n in group_want:
                art = built[n]
                art.name = n
                artifacts.append(art)
        order = {n: i for i, n in enumerate(self._canonical)}
        artifacts.sort(key=lambda a: order.get(a.name, len(order)))
        return artifacts, notes


REGISTRY = ProgramRegistry()

# module-level conveniences bound to the process-wide registry
register = REGISTRY.register
get = REGISTRY.get
names = REGISTRY.names
register_canonical = REGISTRY.register_canonical
canonical_names = REGISTRY.canonical_names
canonical_groups = REGISTRY.canonical_groups
build_canonical = REGISTRY.build_canonical
trace_report = REGISTRY.trace_report

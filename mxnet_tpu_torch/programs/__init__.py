"""Serving programs: captured CUDA graphs, their specs and the live
registry (the counterpart of ``mxnet_tpu/programs``).

* :mod:`.graphs` — :class:`GraphProgram` (one CUDA graph per argument
  signature, replayed; a capture is the counterpart of a trace),
  :data:`GRAPH_STATS` and :func:`eager` (the counterpart of
  ``jax.disable_jit()``);
* :mod:`.spec` — :class:`ProgramSpec` and its fingerprint;
* :mod:`.registry` — the weakly held live registry and its trace report.

The reference's AOT cache (``programs/aot.py``'s on-disk executables)
has no counterpart: a CUDA graph cannot be serialized, and the kernel
build cache covers the compile half of a cold start.  Partition rules
(``programs/partition.py``) come with the port's parallelism.
"""
from . import graphs, registry, spec
from .graphs import GRAPH_STATS, GraphPool, GraphProgram, eager
from .registry import REGISTRY, ProgramRegistry
from .spec import ProgramSpec

__all__ = ["GRAPH_STATS", "GraphPool", "GraphProgram", "ProgramRegistry",
           "ProgramSpec", "REGISTRY", "eager", "graphs", "registry",
           "spec"]

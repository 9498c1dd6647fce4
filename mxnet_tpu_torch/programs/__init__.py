"""Serving programs: captured CUDA graphs, their specs and the live
registry (the counterpart of ``mxnet_tpu/programs``).

* :mod:`.graphs` — :class:`GraphProgram` (one CUDA graph per argument
  signature, replayed; a capture is the counterpart of a trace),
  :data:`GRAPH_STATS` and :func:`eager` (the counterpart of
  ``jax.disable_jit()``);
* :mod:`.spec` — :class:`ProgramSpec` (its fingerprint, artifact, cost
  and donated leaves) and the probing helpers (:func:`probing`,
  :func:`probe_artifact`, :func:`probe_cost`);
* :mod:`.registry` — the weakly held live registry, its trace report,
  and the canonical lint catalog (``register_canonical``,
  ``build_canonical``);
* :mod:`.aot` — the program-cache directory (``cache_dir``), where the
  tuning cache (``ops/tuning.py``) keeps its records;
* :mod:`.partition` — regex partition rules over named parameter trees
  (:func:`match_partition_rules`, :func:`build_shardings` with torch's
  placements, :func:`rules_from_plan`).

The reference's AOT executables (``programs/aot.py``'s ``save`` /
``load``, ``AotDispatch``, ``AOT_STATS``) have no counterpart: a CUDA
graph cannot be serialized, and the kernel build cache covers the
compile half of a cold start; deployment goes through ``torch.export``.
"""
from . import aot, graphs, partition, registry, spec
from .graphs import GRAPH_STATS, GraphPool, GraphProgram, eager
from .partition import build_shardings, match_partition_rules, \
    rules_from_plan
from .registry import REGISTRY, ProgramRegistry
from .spec import ProgramSpec, probe_artifact, probe_cost, probing

__all__ = ["GRAPH_STATS", "GraphPool", "GraphProgram", "ProgramRegistry",
           "ProgramSpec", "REGISTRY", "aot", "build_shardings", "eager",
           "graphs", "match_partition_rules", "partition",
           "probe_artifact", "probe_cost", "probing", "registry",
           "rules_from_plan", "spec"]

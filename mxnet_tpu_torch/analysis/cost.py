"""Static roofline cost of one program — FLOPs and traffic bytes (the
port of ``mxnet_tpu/analysis/cost.py``).

The reference prices a program from its lowered StableHLO; the port
from its traced graph (:func:`~.graph_parse.parse_graph`):

* **FLOPs**: every dot-like node by its formula, the kernels' operators
  by theirs (:data:`~.graph_parse.KERNEL_FLOPS`);
* **bytes**: the program's arguments and outputs (every operand read
  once, every result written once), plus its collective payloads, plus
  2x each materialized gather and sort / scatter result (one write, one
  re-read) — the reference's floor.

Everything here is a trace on fake tensors: nothing is computed and no
kernel launches.
"""
from __future__ import annotations

import torch

__all__ = ["artifact_cost", "aval_bytes", "program_cost"]


def aval_bytes(tree):
    """Total bytes of every tensor leaf in ``tree`` (nested tuples,
    lists and dicts; ``meta`` tensors do), sized through the analysis
    width table."""
    from .graph_parse import value_bytes

    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            total += value_bytes(x)
    return total


def program_cost(fn, args, autograd=False):
    """``{"flops", "bytes", "collective_bytes", "gather_bytes",
    "sort_scatter_bytes"}`` of ``fn`` (a callable or ``nn.Module``) at
    ``args``, from one trace (:func:`~.artifact.artifact_from_export`;
    ``autograd`` for a body that calls autograd).  Callers holding
    capture counters wrap this in ``programs.spec.probing``."""
    from .artifact import artifact_from_export

    parsed = artifact_from_export(fn, args, "cost",
                                  autograd=autograd).parsed()
    coll = parsed["collectives"]["total"]["bytes"]
    gath = parsed["gather"]["bytes"]
    srtsc = parsed["sort_scatter"]["total"]["bytes"]
    return {"flops": int(parsed["flops"]),
            "bytes": int(parsed["io_bytes"]) + int(coll) + int(gath)
            + int(srtsc),
            "collective_bytes": int(coll),
            "gather_bytes": int(gath),
            "sort_scatter_bytes": int(srtsc)}


def artifact_cost(artifact):
    """Priced quantities of a built artifact — one drift-snapshot row,
    with the reference's keys: ``donated`` (the buffers the program
    declares it updates in place), and from the graph ``dot_flops``,
    ``gather_bytes``, ``sort_scatter_bytes``, ``collective_count``,
    ``collective_bytes`` and ``aliased`` (the inputs it writes in
    place); ``cache_bytes`` from the metadata.  Quantities of a missing
    graph are absent: the drift pass reports the asymmetry instead of
    guessing zero."""
    row = {"donated": int(artifact.donated_leaves or 0)}
    parsed = artifact.parsed()
    if parsed is not None:
        row["dot_flops"] = int(parsed["flops"])
        row["gather_bytes"] = int(parsed["gather"]["bytes"])
        row["sort_scatter_bytes"] = int(
            parsed["sort_scatter"]["total"]["bytes"])
        row["collective_count"] = int(parsed["collectives"]["total"]["count"])
        row["collective_bytes"] = int(parsed["collectives"]["total"]["bytes"])
        row["aliased"] = len(parsed["written_inputs"])
    if artifact.meta.get("cache_bytes") is not None:
        row["cache_bytes"] = int(artifact.meta["cache_bytes"])
    return row

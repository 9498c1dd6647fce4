"""Network visualization — the port of ``mxnet_tpu/visualization.py``
(reference: python/mxnet/visualization.py): the same summary text and
the same graphviz dot source for the same symbol."""
from __future__ import annotations

import json

from .base import MXNetError
from . import symbol as sym_mod

__all__ = ["print_summary", "plot_network"]


def _summary_rows(symbol, shape):
    """Collect one record per compute node: (label, out_shape, nparams, preds).

    Pure data gathering — rendering is a separate concern (`_render_table`).
    """
    shape_dict = {}
    if shape is not None:
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape)
        shape_dict.update(zip(symbol.list_arguments(), arg_shapes))
        shape_dict.update(zip(symbol.list_auxiliary_states(), aux_shapes))
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        shape_dict.update(zip(internals.list_outputs(), out_shapes))

    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    head_ids = {h[0] for h in conf["heads"]}
    rows = []
    for nid, node in enumerate(nodes):
        if node["op"] == "null":
            continue
        nparams = 0
        preds = []
        for src_id, *_ in node.get("inputs", []):
            src = nodes[src_id]
            if src["op"] != "null" or src_id in head_ids:
                preds.append(src["name"])
            elif not src.get("is_aux"):
                pshape = shape_dict.get(src["name"])
                if pshape and not src["name"].endswith(("data", "label")):
                    count = 1
                    for dim in pshape:
                        count *= dim
                    nparams += count
        out_shape = ""
        if shape is not None:
            out_shape = shape_dict.get(node["name"] + "_output", "")
        rows.append(("%s(%s)" % (node["name"], node["op"]),
                     out_shape, nparams, preds))
    return rows


def _render_table(rows, line_length, positions):
    """Format gathered records into the fixed-column summary table."""
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]
    widths = [positions[0]] + [b - a for a, b in zip(positions, positions[1:])]

    def fmt(cells):
        return "".join(str(c)[:w].ljust(w) for c, w in zip(cells, widths))

    lines = ["_" * line_length,
             fmt(["Layer (type)", "Output Shape", "Param #", "Previous Layer"]),
             "=" * line_length]
    for label, out_shape, nparams, preds in rows:
        lines.append(fmt([label, out_shape, nparams,
                          preds[0] if preds else ""]))
        lines.extend(fmt(["", "", "", p]) for p in preds[1:])
        lines.append("_" * line_length)
    total = sum(r[2] for r in rows)
    lines.append("Total params: %s" % total)
    lines.append("_" * line_length)
    return lines


def print_summary(symbol, shape=None, line_length=120, positions=(0.44, 0.64, 0.74, 1.0)):
    """Tabular per-layer summary with param counts.

    Capability parity with the reference's summary printer
    (python/mxnet/visualization.py:20) — same columns, separators, and
    total-params footer — built as gather-records-then-render rather than
    an incremental truncation printer.
    """
    if not isinstance(symbol, sym_mod.Symbol):
        raise TypeError("symbol must be Symbol")
    for line in _render_table(_summary_rows(symbol, shape),
                              line_length, list(positions)):
        print(line)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs={}, hide_weights=True):
    """Graphviz plot (reference: visualization.py:145); requires graphviz."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("plot_network requires graphviz (not installed in "
                         "this environment)")
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    dot = Digraph(name=title)
    hidden = set()
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null":
            if hide_weights and (name.endswith("weight") or name.endswith("bias")
                                 or name.endswith("gamma") or name.endswith("beta")
                                 or "moving" in name):
                hidden.add(i)
                continue
            dot.node(name=name, label=name, shape="oval")
        else:
            dot.node(name=name, label="%s\n%s" % (name, op), shape="box")
    for i, node in enumerate(nodes):
        if node["op"] == "null":
            continue
        for item in node["inputs"]:
            if item[0] in hidden:
                continue
            dot.edge(tail_name=nodes[item[0]]["name"], head_name=node["name"])
    return dot

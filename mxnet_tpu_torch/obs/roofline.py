"""Per-program roofline accounting — measured time vs static cost (the
port of ``mxnet_tpu/obs/roofline.py``).

The captured programs (``DecodePredictor``'s serving programs, the
compiled train / eval steps) report each dispatch into one
:class:`ProgramAccounting`, and each program registers a lazy
static-cost prober.  :meth:`ProgramAccounting.table` joins the two into
the per-program MFU / achieved-bytes/s table.

Time: ``wall_s`` is the host time spent inside the dispatch calls, as
in the reference.  A CUDA-graph replay does not block the host, so on
the card the dispatch is also bracketed by two CUDA events recorded on
the current stream around the replay (never inside a capture): their
elapsed time, summed as ``device_s``, is what the achieved rates and
the MFU divide by there.  The events are read lazily (finished pairs
when more than :data:`PENDING_CAP` wait, and every pair at table time).

Static cost: the reference prices a program by lowering it to
StableHLO.  The port has no such artifact yet; its probers count from
the program's argument shapes and the symbol's nodes
(:func:`graph_flops`): 2·M·K·N for each FullyConnected / FusedLNLinear,
4·rows·keys·hd·heads for each ``dot_product_attention``, and bytes as
the arguments and outputs read or written once.

The MFU denominator (:data:`PEAK_FLOPS`) holds NVIDIA's spec-sheet
figures for the H100 SXM (dense, no sparsity): 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s f32 on the CUDA cores.  They are spec figures,
not measurements.
"""
from __future__ import annotations

import threading
from collections import deque

import numpy as np

__all__ = ["ProgramAccounting", "PEAK_FLOPS", "PENDING_CAP",
           "peak_flops_for", "auto_peak", "render_mfu_table",
           "graph_flops", "tensor_bytes"]

# peak FLOP/s per card and compute dtype — NVIDIA H100 SXM5 spec sheet,
# dense; keyed by the start of torch.cuda.get_device_name()
PEAK_FLOPS = {
    "NVIDIA H100": {"bfloat16": 989e12, "float16": 989e12,
                    "float32": 67e12},
}

# CUDA-event pairs kept unread per program before the finished ones are
# folded into device_s
PENDING_CAP = 64


def peak_flops_for(device, dtype="bfloat16"):
    """``(peak_flops_or_None, device_name)`` for a torch device (or a
    CUDA device index); None for the CPU and for cards the table does
    not list."""
    import torch

    if isinstance(device, int):
        device = torch.device("cuda", device)
    device = torch.device(device)
    if device.type != "cuda":
        return None, device.type
    name = torch.cuda.get_device_name(device)
    for prefix, peaks in PEAK_FLOPS.items():
        if name.lower().startswith(prefix.lower()):
            return peaks.get(str(dtype)), name
    return None, name


def auto_peak(dtype="bfloat16"):
    """The MFU denominator: ``MXNET_PEAK_FLOPS`` when set, else the
    spec peak of card 0 for ``dtype``, else ``None`` (the CPU — the
    table still carries flops/bytes/wall, mfu reads null)."""
    from .. import config as _config

    override = float(_config.get("MXNET_PEAK_FLOPS"))
    if override > 0:
        return override
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        peak, _ = peak_flops_for(0, dtype)
        return peak
    except Exception:
        return None


def tensor_bytes(*trees):
    """Bytes of every tensor (or numpy array) in nested tuples / lists /
    dicts — an argument or output read or written once."""
    total = 0
    stack = list(trees)
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif hasattr(x, "element_size") and hasattr(x, "numel"):
            total += int(x.numel()) * int(x.element_size())
        elif hasattr(x, "nbytes") and hasattr(x, "dtype"):
            total += int(x.nbytes)
    return total


def _weight_shape(node, attrs, shapes):
    """(N, K) of a FullyConnected / FusedLNLinear node's weight."""
    names = node.op.list_arguments(attrs)
    src, idx = node.inputs[names.index("weight")]
    return shapes[(id(src), idx)]


def graph_flops(symbol, shapes):
    """FLOPs of one forward pass of ``symbol``: 2·M·K·N for each
    FullyConnected / FusedLNLinear node (M the rows its input holds),
    4·rows·keys·hd·heads for each ``dot_product_attention`` node, and
    for each ``MoEFFN`` node its router and the expert products of the
    path it takes (:func:`~mxnet_tpu_torch.ops.moe.moe_flops`).
    ``shapes`` maps every node's outputs ``(id(node), index)`` to its
    shape (see :func:`symbol_shapes`)."""
    flops = 0
    for node in symbol._topo():
        if node.is_variable:
            continue
        name = node.op.name
        attrs = node.parsed_attrs()
        if name in ("FullyConnected", "FusedLNLinear"):
            n, k = _weight_shape(node, attrs, shapes)[:2]
            src, idx = node.inputs[0]
            m = int(np.prod(shapes[(id(src), idx)])) // max(int(k), 1)
            flops += 2 * m * int(k) * int(n)
        elif name == "dot_product_attention":
            (qs, qi), (ks, ki) = node.inputs[0], node.inputs[1]
            q_shape = shapes[(id(qs), qi)]
            rows = int(np.prod(q_shape[:-1]))
            keys = int(shapes[(id(ks), ki)][-2])
            # q_shape[-1] is heads * hd
            flops += 4 * rows * keys * int(q_shape[-1])
        elif name == "MoEFFN":
            from ..ops.moe import moe_flops

            src, idx = node.inputs[0]
            x_shape = shapes[(id(src), idx)]
            flops += moe_flops(attrs, int(np.prod(x_shape[:-1])),
                               int(x_shape[-1]))
    return flops


def symbol_shapes(symbol, **input_shapes):
    """``(id(node), index) -> shape`` for every node output of
    ``symbol`` at the given argument shapes (one shape inference over
    the symbol's internals)."""
    internals = symbol.get_internals()
    _, out_shapes, _ = internals.infer_shape(**input_shapes)
    return {(id(node), idx): tuple(shape)
            for (node, idx), shape in zip(internals._outputs, out_shapes)}


class ProgramAccounting:
    """Measured time + lazy static costs, per program name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._timing = {}   # name -> [calls, wall_s, device_s]
        self._pending = {}  # name -> deque of (start, end) CUDA events
        self._spare = []    # event pairs read back, for reuse
        self._probers = {}  # name -> () -> {"flops", "bytes"} | None
        self._static = {}   # name -> resolved {"flops", "bytes"} | error row

    # ------------------------------------------------------------------
    def note(self, name, seconds, events=None):
        """One dispatch of ``name`` took ``seconds`` of host wall;
        ``events`` (a recorded (start, end) CUDA event pair) adds its
        device time once the end event has completed."""
        with self._lock:
            t = self._timing.get(name)
            if t is None:
                t = self._timing[name] = [0, 0.0, 0.0]
            t[0] += 1
            t[1] += seconds
            if events is None:
                return
            pend = self._pending.setdefault(name, deque())
            pend.append(events)
            if len(pend) > PENDING_CAP:
                self._fold(name, block=False)

    def _fold(self, name, block):
        """Add the device time of ``name``'s finished event pairs, oldest
        first up to the first unfinished one (all of them, waiting, when
        ``block``); the lock is held.  One stream runs a program's calls
        in order, so the walk stops early."""
        pend = self._pending.get(name)
        t = self._timing[name]
        while pend:
            start, end = pend[0]
            if block:
                end.synchronize()
            elif not end.query():
                break
            pend.popleft()
            t[2] += start.elapsed_time(end) * 1e-3
            self._spare.append((start, end))

    def event_pair(self):
        """A (start, end) pair of timing CUDA events for one dispatch:
        one read back before (``_fold``) is reused, creating and
        destroying none a call."""
        with self._lock:
            if self._spare:
                return self._spare.pop()
        import torch

        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def register_static(self, name, prober):
        """Attach a lazy static-cost prober (idempotent; the newest
        registration wins so a rebuilt program refreshes its cost).  A
        prober may return None (owner gone, or program not yet runnable)
        and the row then simply carries no static columns."""
        with self._lock:
            self._probers[name] = prober
            self._static.pop(name, None)

    def has_static(self, name):
        """Whether ``name`` has a prober or a resolved cost."""
        with self._lock:
            return name in self._probers or name in self._static

    def set_static(self, name, flops, bytes):
        """Directly record a program's static cost."""
        with self._lock:
            self._static[name] = {"flops": int(flops), "bytes": int(bytes)}
            self._probers.pop(name, None)

    def reset(self, clear_static=False):
        """Zero the timings (a measurement window starts here); static
        registrations survive unless ``clear_static``."""
        with self._lock:
            self._timing.clear()
            self._pending.clear()
            if clear_static:
                self._probers.clear()
                self._static.clear()

    # ------------------------------------------------------------------
    def _resolve_static(self, name):
        """Run (once) and cache ``name``'s prober.  A prober returning
        None is retried next time; a raising prober is cached as an
        error so a broken count cannot re-pay its cost on every
        table."""
        with self._lock:
            hit = self._static.get(name)
            prober = self._probers.get(name)
        if hit is not None:
            return hit
        if prober is None:
            return None
        try:
            cost = prober()
        except Exception as exc:  # surfaced in the row, not raised
            cost = {"flops": None, "bytes": None, "error": str(exc)[:200]}
        if cost is None:
            return None
        with self._lock:
            self._static[name] = cost
            # resolved: drop the prober so it cannot pin its program's
            # owner for the life of the process
            self._probers.pop(name, None)
        return cost

    def table(self, peak_flops=None):
        """The joined per-program rows, sorted by time (largest first):
        ``{"program", "calls", "wall_s", "device_s", "flops", "bytes",
        "achieved_tflops", "achieved_gbps", "mfu"}`` — flops/bytes are
        PER CALL; the rates divide by ``device_s`` where the card timed
        the calls, else by ``wall_s``; mfu is achieved FLOP/s over
        ``peak_flops`` (null without a peak)."""
        with self._lock:
            for name in list(self._pending):
                self._fold(name, block=True)
            names = set(self._timing) | set(self._probers) \
                | set(self._static)
            timing = {n: tuple(v) for n, v in self._timing.items()}
        rows = []
        for name in names:
            calls, wall, dev = timing.get(name, (0, 0.0, 0.0))
            cost = self._resolve_static(name) or {}
            flops = cost.get("flops")
            nbytes = cost.get("bytes")
            row = {"program": name, "calls": calls,
                   "wall_s": round(wall, 6),
                   "device_s": round(dev, 6) if dev else None,
                   "flops": flops, "bytes": nbytes,
                   "achieved_tflops": None, "achieved_gbps": None,
                   "mfu": None}
            if "error" in cost:
                row["error"] = cost["error"]
            secs = dev if dev > 0 else wall
            if secs > 0 and calls > 0:
                if flops:
                    rate = flops * calls / secs
                    row["achieved_tflops"] = round(rate / 1e12, 6)
                    if peak_flops:
                        row["mfu"] = round(rate / peak_flops, 6)
                if nbytes:
                    row["achieved_gbps"] = round(nbytes * calls / secs
                                                 / 1e9, 6)
            rows.append(row)
        rows.sort(key=lambda r: -(r["device_s"] or r["wall_s"]))
        return rows


def _fmt(v, unit=""):
    if v is None:
        return "-"
    if isinstance(v, float) and unit == "":
        return "%.4g" % v
    return "%s%s" % (v, unit)


def render_mfu_table(rows):
    """Fixed-width text rendering of :meth:`ProgramAccounting.table`
    rows."""
    cols = ("program", "calls", "wall_s", "device_s", "flops", "bytes",
            "achieved_tflops", "achieved_gbps", "mfu")
    table = [[str(c) for c in cols]]
    for r in rows:
        table.append([_fmt(r.get(c)) for c in cols])
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)

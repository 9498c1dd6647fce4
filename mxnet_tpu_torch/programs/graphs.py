"""Programs as captured CUDA graphs — the port's counterpart of
``jax.jit`` and of ``mxnet_tpu/programs/aot.py``'s ``AotDispatch``.

A :class:`GraphProgram` wraps one program body (a Python function over
tensors: one paged decode step, or one whole training step — forward,
autograd's backward, the optimizer update — whose body turns autograd
on itself).  Its first call at a new argument
signature runs the body eagerly on a side stream (which builds the
kernels and makes their one-time attribute calls), then captures the
body into a ``torch.cuda.CUDAGraph`` and counts one trace; every later
call at that signature copies its arguments into the graph's static
input buffers and replays it.  A capture plays the part of a trace, a
replay that of a dispatch of the compiled executable.

Arguments come in two kinds:

* **bound** (positions in ``bind``): buffers the caller owns and keeps,
  such as page pools, lengths and tables.  The graph reads and writes
  those very tensors, so their pointers are part of the signature: a
  call with another buffer captures again (and counts a trace), as a
  new argument signature retraces in JAX.  They are never copied.
* **copied** (every other tensor): the graph owns a static buffer for
  each, on the program's device, and a call copies its argument in
  (host tensors included: that is the program's host-to-device copy),
  skipping an argument that already is that buffer.

Other leaves (None, numbers, ``torch.Generator``) are part of the
signature as they are; a generator is registered with the graph, so
its draws advance on every replay.  Arguments may nest in tuples, lists
and named tuples (``QuantKV``).

A replay returns the graph's static outputs: they stay valid until the
next replay of any program sharing the graph's memory pool
(:class:`GraphPool`; a predictor's programs share one), so a caller
consumes or copies them first.  Kernel wrappers count their launches
in Python, which a replay does not run: each graph records the launch
counts its capture made and adds them on every replay, so
``LAUNCHES`` mean the same with and without graphs; likewise the path
markers (``FUSED_PATH``, ``PATH_TAKEN``, ``DECODE_PATH``,
``UPDATE_PATH`` and the kernels' ``LAST_VARIANT``) are set on every
replay to what the capture's run set them to.  The body's Python runs
twice at a new signature on the card (the warm-up, which is the call's
real work, and the capture, which runs nothing): host side effects
(update counts, schedules, metric hooks) belong outside it.

On a CPU device the same object keeps the same static buffers and the
same signatures and counts, and runs the body on the buffers without a
capture.  A capture that fails raises: a program never goes on eagerly
in its place.  :func:`eager` is the counterpart of
``jax.disable_jit()``: inside it every program runs its body directly
on the arguments given, with no buffers, no capture and no counting
(tests and ``chip_smoke.py`` use it to hold the graphs against the
eager path); host tensors still move to the program's device.
:data:`GRAPH_STATS` counts set-ups (``captures``; a capture on the card,
buffers on the CPU), calls served by them (``replays``) and the seconds
the set-ups took (``capture_s``).
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from ..base import MXNetError

__all__ = ["GraphProgram", "GraphPool", "GRAPH_STATS", "eager",
           "eager_active"]

GRAPH_STATS = {"captures": 0, "replays": 0, "capture_s": 0.0}
_EAGER = [0]


def eager_active():
    """Whether a :func:`eager` block is open."""
    return _EAGER[0] > 0


@contextlib.contextmanager
def eager():
    """Run every :class:`GraphProgram` called inside the block as its
    plain body (no static buffers, no capture, no counts)."""
    _EAGER[0] += 1
    try:
        yield
    finally:
        _EAGER[0] -= 1


def _flatten(x, leaves):
    """Append ``x``'s leaves; return its structure (hashable)."""
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


def _launch_counters():
    """Every kernel wrapper's launch counter."""
    from ..ops import decode_kernel, flash_kernel, fused_kernel, update_kernel

    return (fused_kernel.LAUNCHES, decode_kernel.LAUNCHES,
            flash_kernel.LAUNCHES, update_kernel.LAUNCHES)


def _path_markers():
    """Every path marker and last-variant record an op or a wrapper
    sets."""
    from ..ops import (attention, decode_kernel, flash_kernel, fused_kernel,
                       fused_lm, update_kernel)

    return (fused_lm.FUSED_PATH, attention.PATH_TAKEN,
            attention.DECODE_PATH, update_kernel.UPDATE_PATH,
            fused_kernel.LAST_VARIANT, flash_kernel.LAST_VARIANT,
            decode_kernel.LAST_VARIANT)


class GraphPool:
    """One CUDA-graph memory pool shared by several programs, made at the
    first capture."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class _Entry:
    """One signature's set-up: the leaves the body runs on (bound
    tensors, static copies, other leaves), the copies to refresh, and on
    the card the graph, its static outputs and its launch counts."""

    __slots__ = ("specs", "leaves", "copies", "graph", "outputs",
                 "launches", "paths")

    def __init__(self, specs, leaves, copies, graph=None, outputs=None,
                 launches=(), paths=()):
        self.specs = specs
        self.leaves = leaves
        self.copies = copies
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.paths = paths


class GraphProgram:
    """A program captured once per argument signature and replayed.

    Parameters
    ----------
    name : str
        The program's name (``paged_decode_step``, ...).
    body : callable
        The program: a function of the arguments, run under
        ``torch.no_grad()``; it returns tensors (nested), or None.
    bind : iterable of int
        Positions of the bound arguments (see the module docstring).
    pool : GraphPool, optional
        The memory pool to capture into (a new one by default).
    """

    def __init__(self, name, body, bind=(), pool=None):
        self.name = name
        self.body = body
        self.bind = frozenset(bind)
        self.pool = pool if pool is not None else GraphPool()
        self.traces = 0
        self._entries = {}

    def _run(self, specs, leaves):
        it = iter(leaves)
        args = [_unflatten(s, it) for s in specs]
        with torch.no_grad():
            return self.body(*args)

    def _key(self, args):
        leaves, specs, sig, bound = [], [], [], []
        for i, a in enumerate(args):
            n0 = len(leaves)
            specs.append(_flatten(a, leaves))
            is_bound = i in self.bind
            for x in leaves[n0:]:
                bound.append(is_bound)
                if isinstance(x, torch.Tensor):
                    sig.append((tuple(x.shape), x.dtype) + (
                        (x.device, x.data_ptr(), x.stride()) if is_bound
                        else ()))
                elif x is None or isinstance(x, (bool, int, float, str)):
                    sig.append(x)
                else:
                    sig.append(("id", id(x)))
        return (tuple(specs), tuple(sig)), leaves, bound

    def _device(self, leaves, bound):
        """The program's device: that of its first bound tensor (else of
        its first tensor)."""
        tensors = [x for x, b in zip(leaves, bound)
                   if b and isinstance(x, torch.Tensor)] or \
            [x for x in leaves if isinstance(x, torch.Tensor)]
        if not tensors:
            raise MXNetError("program %r: no tensor argument" % self.name)
        return tensors[0].device

    def __call__(self, *args):
        key, leaves, bound = self._key(args)
        if _EAGER[0]:
            dev = self._device(leaves, bound)
            return self._run(key[0], [
                x.to(dev) if isinstance(x, torch.Tensor) and x.device != dev
                else x for x in leaves])
        entry = self._entries.get(key)
        if entry is None:
            return self._setup(key, leaves, bound)
        for i, buf in entry.copies:
            if leaves[i] is not buf:
                buf.copy_(leaves[i])
        GRAPH_STATS["replays"] += 1
        if entry.graph is None:
            return self._run(entry.specs, entry.leaves)
        entry.graph.replay()
        for counter, name, n in entry.launches:
            counter[name] += n
        for marker, name, value in entry.paths:
            marker[name] = value
        return entry.outputs

    def _setup(self, key, leaves, bound):
        dev = self._device(leaves, bound)
        static, copies = list(leaves), []
        for i, (x, b) in enumerate(zip(leaves, bound)):
            if isinstance(x, torch.Tensor) and not b:
                static[i] = torch.empty(x.shape, dtype=x.dtype, device=dev)
                static[i].copy_(x)
                copies.append((i, static[i]))
        specs = key[0]
        t0 = time.perf_counter()
        if dev.type == "cuda":
            out, entry = self._capture(dev, specs, static, copies)
        else:
            out = self._run(specs, static)
            entry = _Entry(specs, static, copies)
        self._entries[key] = entry
        self.traces += 1
        GRAPH_STATS["captures"] += 1
        GRAPH_STATS["capture_s"] += time.perf_counter() - t0
        return out

    def _capture(self, dev, specs, leaves, copies):
        """Warm the body up on a side stream (the first call's result),
        then capture it; the capture runs nothing on the card."""
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._run(specs, leaves)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for x in leaves:
            if isinstance(x, torch.Generator):
                graph.register_generator_state(x)
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        # the markers the capture's run sets are the ones a replay sets
        markers = _path_markers()
        warm = [dict(m) for m in markers]
        for m in markers:
            m.update(dict.fromkeys(m))
        # no garbage collection while the stream captures: collecting a
        # dead program would destroy its graph, a CUDA call that
        # invalidates the capture (torch.cuda.graph no longer collects
        # before it begins)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(dev), \
                    torch.cuda.graph(graph, pool=self.pool.handle()):
                outputs = self._run(specs, leaves)
        except Exception as exc:
            raise MXNetError("program %r: CUDA graph capture failed: %s"
                             % (self.name, exc)) from exc
        finally:
            if collecting:
                gc.enable()
            launches = tuple((c, k, c[k] - b[k])
                             for c, b in zip(counters, before)
                             for k in c if c[k] != b[k])
            for c, b in zip(counters, before):
                c.update(b)
            paths = tuple((m, k, v) for m in markers for k, v in m.items()
                          if v is not None)
            for m, w in zip(markers, warm):
                m.update(w)
        return out, _Entry(specs, leaves, copies, graph, outputs, launches,
                           paths)

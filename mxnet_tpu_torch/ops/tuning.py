"""Kernel plan autotuner + persistent tuning cache — the port of
``mxnet_tpu/ops/tuning.py``.

The hand-written CUDA kernels choose their launch plans by rules fixed
by hand: kernel A / F's tile sides and dW split (``fused_kernel._plan``),
kernel B's split count (``decode_kernel._plan``), kernel B1's block
height (``update_kernel.BLOCK_ROWS``).  Each kernel module registers its
**tunable space** here (the parameters, the hand-fixed defaults, a
candidate enumerator and a probe runner), and the first armed process
sweeps the candidates on the card — the same probe per candidate, only
the plan changes, so the delta IS the plan — and persists the winner in
a content-addressed **tuning cache** in the program-cache directory
(:func:`mxnet_tpu_torch.programs.aot.cache_dir`).

Cache entries are small JSON records keyed by ``(card name, op,
shape class, dtype, space version)`` — ``tune_<sha256[:20]>.json`` — so a
cold process resolves every registered kernel's plan by reading files,
with ZERO probe executions (:data:`PROBE_COUNT` is the proof).  A
corrupt or stale entry warns visibly and reads as a miss; without
``MXNET_PALLAS_TUNE`` a miss resolves to the module's hand-fixed
defaults, and with an empty cache every plan is the one the rules give.

Shape classes bucket each dimension to its power-of-two ceiling
(:func:`shape_class_for`): a plan's winner depends on the operands'
magnitude, not on exact row counts, and the bucketing keeps one sweep's
winner live for every size in its octave.

The port's own choices, where the reference's differ:

* the device axis (:func:`device_generation`) is the CUDA card's name;
  a CPU (or any other) device runs the kernels' plain versions, so
  :func:`resolve` returns the defaults there and reads no file;
* there is no interpret mode: :func:`sweep_mode` arms only on a card,
  and its second value is always False;
* a probe is timed with CUDA events (one warm-up, then ``iters`` runs
  captured into one CUDA graph and replayed once, so the time is the
  card's and not the host's launches), and a runner may hand back a
  :class:`Probe` whose ``check`` holds the warm-up's outputs against the
  kernel's plain version: a candidate beyond the kernel's tolerance is
  recorded and never wins;
* the kernels' launch counters, last-variant records and path markers
  are restored after a sweep, so probes never show as launches of a
  main path;
* a sweep synchronizes, which would invalidate a CUDA graph capture: a
  miss while the current stream captures returns the defaults, unswept
  and not memoized, with a warning (a program's eager warm-up resolves
  and memoizes first, so its capture hits the memo);
* a space's version is the reference's int plus a digest of its
  kernel's CUDA sources (``sources``), so rewriting a kernel turns its
  old winners stale without a manual bump.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import time

import torch

log = logging.getLogger(__name__)

__all__ = ["register_space", "spaces", "resolve", "shape_class_for",
           "parse_shape_class", "sweep_mode", "cache_key", "put", "get",
           "reset_memo", "PROBE_COUNT", "SpaceError", "Probe",
           "device_generation", "error_share"]

# schema version of the cache entries themselves (bump to invalidate the
# whole cache format); per-space staleness rides the space's own version
_FORMAT = 1

# op -> _Space; populated by the kernel modules at import
_SPACES = {}

# (op, shape_class, dtype, device) -> params resolved this process
_MEMO = {}

# CUDA device index -> its normalized name (resolve runs before every
# launch)
_NAMES = {}

# timed candidate executions this process — the zero-probes-on-cache-hit
# proof counter.  A dict (not an int) so tests can reset in place.
PROBE_COUNT = {"n": 0}


class SpaceError(ValueError):
    """A runner rejecting a candidate it cannot execute (a plan the C
    entry does not take at this shape...).  Sweeps skip the candidate;
    every other exception propagates."""


class Probe:
    """What a runner may return instead of a bare callable: ``run()``
    launches the kernel once under the candidate's plan; ``check()``,
    called after the warm-up run, returns ``(max_abs_err, share)`` — the
    largest |kernel - plain| over the outputs, and the largest ratio of
    an output's error to its tolerance (beyond 1 the candidate is
    wrong)."""

    __slots__ = ("run", "check")

    def __init__(self, run, check=None):
        self.run = run
        self.check = check


def error_share(got, want, tol):
    """One output of a runner's check: ``(max |got - want|, that over tol
    x max(1, max |want|))``."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / (tol * max(1.0, float(want.float().abs().max())))


class _Space:
    __slots__ = ("op", "base_version", "defaults", "constants",
                 "candidates", "runner", "sources", "_version")

    def __init__(self, op, version, defaults, constants, candidates,
                 runner, sources):
        self.op = op
        self.base_version = int(version)
        self.defaults = dict(defaults)
        self.constants = tuple(constants)
        self.candidates = candidates
        self.runner = runner
        self.sources = tuple(sources)
        self._version = None

    @property
    def version(self):
        """The reference's int, with ``+<digest>`` of the kernel's CUDA
        sources when the space names any (read at first use, not at
        import)."""
        if self._version is None:
            if self.sources:
                from .. import cuda_build

                digest = hashlib.sha1()
                for name in self.sources:
                    digest.update(cuda_build.source_digest(name).encode())
                self._version = "%d+%s" % (self.base_version,
                                           digest.hexdigest()[:12])
            else:
                self._version = self.base_version
        return self._version


def register_space(op, version, defaults, constants, candidates, runner,
                   sources=()):
    """Register a kernel module's tunable space.

    ``op``          — the cache namespace (module name, e.g.
                      ``"fused_kernel"``);
    ``version``     — bump when the space's meaning changes (param
                      renames): older cache entries then read as stale;
    ``defaults``    — ``{param: value}``, the module's hand-fixed plan
                      (what every process without a cache entry runs);
    ``constants``   — the module-level constant NAMES the space governs;
    ``candidates``  — ``f(shape_class, interpret) -> [ {param: value},
                      ... ]`` partial overrides of ``defaults``;
    ``runner``      — ``f(params, shape_class, dtype, interpret) -> g``
                      where ``g`` (a callable or a :class:`Probe`)
                      executes ONE probe of the kernel under ``params``
                      (allocate outside ``g``); raise :class:`SpaceError`
                      for candidates the kernel cannot run;
    ``sources``     — the ``csrc`` kernel names (``cuda_build.SOURCES``)
                      whose digest joins the version.
    """
    _SPACES[op] = _Space(op, version, defaults, constants, candidates,
                         runner, sources)
    return _SPACES[op]


def spaces():
    """{op: space} of every registered tunable space (imports the
    kernel modules so their registrations ran)."""
    from . import (decode_kernel, flash_kernel, fused_kernel,  # noqa
                   update_kernel)

    return dict(_SPACES)


def reset_memo():
    """Forget in-process resolutions (tests and the smoke; cache files
    stay)."""
    _MEMO.clear()


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def _pow2_ceil(v):
    v = int(v)
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()


def shape_class_for(**dims):
    """Canonical shape-class string: each dim bucketed to its pow-2
    ceiling, sorted by name — ``shape_class_for(m=1000, k=64, n=256)``
    -> ``"k64,m1024,n256"``."""
    return ",".join("%s%d" % (k, _pow2_ceil(v))
                    for k, v in sorted(dims.items()))


def parse_shape_class(shape_class):
    """Back-parse a shape-class string into ``{dim: bucket}`` — sweep
    runners probe at the bucket sizes themselves (every shape in the
    octave shares the winner, so the ceiling is the representative)."""
    out = {}
    for part in shape_class.split(","):
        name = part.rstrip("0123456789")
        out[name] = int(part[len(name):])
    return out


def device_generation(device=None):
    """The cache's device axis: the CUDA card's name
    (``torch.cuda.get_device_name``), normalized as the reference
    normalizes ``device_kind``; None where no kernel runs (a CPU or any
    other non-CUDA device, or no card at all).  ``device``: the tensor
    device a plan is for (None: the current CUDA device)."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
        index = device.index
    elif not torch.cuda.is_available():
        return None
    else:
        index = None
    if index is None:
        index = torch.cuda.current_device()
    got = _NAMES.get(index)
    if got is None:
        got = _NAMES[index] = str(torch.cuda.get_device_name(
            index)).strip().replace(" ", "_")
    return got


def cache_key(op, shape_class, dtype, version, device=None):
    """Content address of one tuning decision."""
    ident = json.dumps({
        "format": _FORMAT,
        "device": device or device_generation() or "unknown",
        "op": op,
        "shape_class": shape_class,
        "dtype": str(dtype),
        "version": version,
    }, sort_keys=True)
    return "tune_" + hashlib.sha256(ident.encode()).hexdigest()[:20]


def _cache_path(key):
    from ..programs import aot

    return os.path.join(aot.cache_dir(), key + ".json")


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def put(op, shape_class, dtype, params, version=0, device=None,
        extra=None):
    """Persist one tuning decision (atomic tmp + ``os.replace``).
    Returns the cache key; failures warn and are swallowed — the cache
    is an accelerator, never a correctness dependency."""
    from ..programs import aot

    device = device or device_generation() or "unknown"
    key = cache_key(op, shape_class, dtype, version, device=device)
    entry = {"format": _FORMAT, "op": op, "shape_class": shape_class,
             "dtype": str(dtype), "version": version,
             "device": device, "params": dict(params)}
    if extra:
        entry.update(extra)
    try:
        d = aot.cache_dir(create=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tune_tmp_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(entry, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, os.path.join(d, key + ".json"))
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError as exc:
        log.warning("tuning cache save failed for %s/%s (%s); the "
                    "winner stays in-process only", op, shape_class, exc)
    return key


def get(op, shape_class, dtype, version=0, device=None):
    """The persisted params for one key, or None on miss.  Corrupt or
    stale entries (unreadable JSON, wrong op/version, params that are
    not a dict) warn VISIBLY and read as a miss."""
    key = cache_key(op, shape_class, dtype, version, device=device)
    path = _cache_path(key)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            entry = json.load(f)
        if not isinstance(entry, dict):
            raise ValueError("entry is not an object")
        if entry.get("op") != op or entry.get("version") != version \
                or entry.get("format") != _FORMAT:
            raise ValueError("key fields do not match (stale entry)")
        params = entry.get("params")
        if not isinstance(params, dict):
            raise ValueError("params missing")
        return params
    except (OSError, ValueError) as exc:
        log.warning("tuning cache entry %s for %s/%s is corrupt or stale "
                    "(%s); falling back to defaults", key, op,
                    shape_class, exc)
        return None


# ---------------------------------------------------------------------------
# sweep + resolve
# ---------------------------------------------------------------------------

def sweep_mode(device=None):
    """``(armed, interpret)``: sweeps run when ``MXNET_PALLAS_TUNE`` is
    set AND the plan is for a CUDA card (:func:`device_generation`).
    There is no interpret mode: the second value is always False."""
    from .. import config as _config

    if not _config.get("MXNET_PALLAS_TUNE"):
        return False, False
    return device_generation(device) is not None, False


def _capturing():
    """Whether the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _kernel_state():
    """Snapshots of every kernel module's launch counters, last-variant
    records and path markers (the dicts the graphs replay)."""
    from ..programs import graphs

    return [(d, dict(d)) for d in
            graphs._launch_counters() + graphs._path_markers()]


def _restore(state):
    for d, saved in state:
        d.clear()
        d.update(saved)


def _time(run, iters):
    """Seconds per run over ``iters`` runs; each execution bumps
    :data:`PROBE_COUNT`.  On a card the ``iters`` runs are captured into
    one CUDA graph (after a run on a side stream, as a capture wants) and
    one replay is timed with CUDA events, so the time is the card's, not
    the host's enqueue (a decode-sized kernel takes less than its
    launch); the host clock otherwise."""
    if not torch.cuda.is_available():
        tic = time.perf_counter()
        for _ in range(iters):
            run()
            PROBE_COUNT["n"] += 1
        return (time.perf_counter() - tic) / iters
    import gc

    from ..programs import graphs

    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        run()
    PROBE_COUNT["n"] += 1
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # no collection while the stream captures (it could free a graph, a
    # CUDA call the capture forbids); other threads' CUDA calls wait
    collecting = gc.isenabled()
    gc.disable()
    try:
        with graphs.CAPTURE_LOCK, torch.cuda.graph(graph):
            for _ in range(iters):
                run()
    finally:
        if collecting:
            gc.enable()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    PROBE_COUNT["n"] += iters
    return start.elapsed_time(end) / 1e3 / iters


def _sweep(space, shape_class, dtype, interpret=False, iters=3):
    """Time every candidate; return ``(winner_params, results)`` with one
    ``{"ms", "params"[, "max_abs_err", "tol_share"]}`` record a candidate
    the runner took.  Each timed execution bumps :data:`PROBE_COUNT`; a
    candidate whose ``tol_share`` exceeds 1 never wins.  The kernels'
    counters and markers read after the sweep as before it."""
    results = []
    state = _kernel_state()
    try:
        with torch.no_grad():
            for cand in space.candidates(shape_class, interpret):
                params = dict(space.defaults)
                params.update(cand)
                try:
                    probe = space.runner(params, shape_class, dtype,
                                         interpret)
                    run, check = (probe.run, probe.check) \
                        if isinstance(probe, Probe) else (probe, None)
                    run()                    # warm-up (and the check's run)
                    PROBE_COUNT["n"] += 1
                    rec = {"params": params}
                    if check is not None:
                        err, share = check()
                        rec["max_abs_err"] = float(err)
                        rec["tol_share"] = float(share)
                    rec["ms"] = _time(run, iters) * 1e3
                except SpaceError as exc:
                    log.info("tuning %s/%s: candidate %s unsupported (%s)",
                             space.op, shape_class, cand, exc)
                    continue
                if rec.get("tol_share", 0.0) > 1.0:
                    log.warning("tuning %s/%s: candidate %s disagrees with "
                                "the plain version (max |err| %.3g, %.3gx "
                                "its tolerance); it cannot win", space.op,
                                shape_class, cand, rec["max_abs_err"],
                                rec["tol_share"])
                results.append(rec)
    finally:
        _restore(state)
    good = [r for r in results if r.get("tol_share", 0.0) <= 1.0]
    if not good:
        return dict(space.defaults), results
    return dict(min(good, key=lambda r: r["ms"])["params"]), results


def resolve(op, shape_class, dtype, device=None):
    """The tuned parameters for ``(op, shape_class, dtype)`` on this
    card — the ONE lookup the kernel modules call before a launch.
    ``device``: the tensors' device (None: the current CUDA device).

    Resolution order: no card -> the defaults (no file read);
    in-process memo -> persisted cache entry -> sweep (when
    :func:`sweep_mode` arms and no graph is being captured, persisting
    the winner) -> the space's registered defaults.  Always returns a
    full params dict; unknown params in a cache entry are dropped so a
    tampered entry cannot inject keys the kernels never declared."""
    space = _SPACES.get(op)
    if space is None:
        raise KeyError("no tunable space registered for %r" % op)
    gen = device_generation(device)
    if gen is None:
        return dict(space.defaults)
    dtype = str(dtype)
    memo_key = (op, shape_class, dtype, gen)
    hit = _MEMO.get(memo_key)
    if hit is not None:
        return dict(hit)

    entry = get(op, shape_class, dtype, version=space.version, device=gen)
    if entry is not None:
        params = dict(space.defaults)
        params.update({k: v for k, v in entry.items()
                       if k in space.defaults})
        _MEMO[memo_key] = params
        return dict(params)

    armed, interpret = sweep_mode(device)
    if armed:
        if _capturing():
            log.warning("tuning %s/%s: cache miss while a CUDA graph is "
                        "being captured; the defaults run unswept (resolve "
                        "before the capture)", op, shape_class)
            return dict(space.defaults)
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.device(device):
                params, results = _sweep(space, shape_class, dtype,
                                         interpret)
        else:
            params, results = _sweep(space, shape_class, dtype, interpret)
        put(op, shape_class, dtype, params, version=space.version,
            device=gen, extra={"swept": results})
        _MEMO[memo_key] = params
        return dict(params)

    _MEMO[memo_key] = dict(space.defaults)
    return dict(space.defaults)

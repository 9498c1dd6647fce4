"""Async fenced checkpointing: snapshot on the card, write off the loop
(the counterpart of ``mxnet_tpu/elastic/checkpointer.py``).

Check-Freq's observation (Mohan et al., FAST '21): checkpoint stalls
vanish when the *snapshot* (cheap, must be consistent) is decoupled from
the *write* (slow, needs no loop participation).  Here the snapshot is a
``clone()`` of every tensor of the training store (parameters, aux
states, optimizer slots, the metric's device accumulators), enqueued on
the loop's stream right after the step's replay, followed by a CUDA
event: stream order makes the clones exactly "after step N", and the
loop thread never waits on the card.  The writer thread then works on a
side stream: it waits on that event, copies the clones into pinned host
buffers (``non_blocking``, ``record_stream`` on the clones so the
caching allocator does not hand their memory out early), waits for its
own stream only, and lands a committed step directory
(``checkpoint.save_state_tree`` + sidecar + ``commit_step``, in that
order, so a crash anywhere leaves the previous checkpoint as the resume
point).  A copy issued on the loop's own stream would queue behind the
next replays and stall them.  The writer's CUDA calls (the wait, the
copies, its stream's synchronize, the clones' release) run under
``programs.graphs.CAPTURE_LOCK``: a graph capture on the loop thread
forbids them from any thread.  The file itself is written from host
memory only.

At most one write is in flight: a fence arriving while the writer is
busy is *skipped* (``skipped_busy``), never queued.

A mesh module (one rank a process) writes its fence over the process
group (``checkpoint.save_state_tree`` with the module's
``checkpoint.Layout``): every rank writes its own blocks of one step
directory, and the first rank writes the sidecar and the commit marker
after every rank's payload is in.  DCP's planning and its commit are
collectives, and a collective must not run on a writer thread beside the
loop thread's gradient collectives on the same group, so under a group
the whole write runs on the loop thread at the fence (``async_write``
is not taken there).  ``async_write``
False (``MXNET_CKPT_ASYNC=0``) runs the same write inline on the loop
thread: the A/B baseline for ``checkpoint_stall_fraction``.  A write
that fails raises on the loop thread at the next fence (or at ``wait``).

The sidecar ``elastic.json`` carries the JAX package's keys (epoch,
nbatch_done, global_step, iterator, optimizer, metric_host,
metric_device) and the port's generator record under ``rng``: the
states of every generator of ``random``, torch's default CPU and CUDA
generators, and numpy's (the JAX package stores a jax key instead).
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time

import numpy as np
import torch

from .. import checkpoint as ckpt_mod
from ..base import MXNetError

__all__ = ["Checkpointer", "SIDECAR"]

SIDECAR = "elastic.json"

log = logging.getLogger(__name__)


def _metric_state(module):
    """The train step's metric accumulator tensors (per metric leaf:
    ``(sums, counts)``), or None."""
    step = getattr(module, "_train_step", None)
    acc = getattr(step, "_metric_acc", None) if step is not None else None
    if acc is None or acc.state is None:
        return None
    return acc.state


def _bytes(t):
    return t.tolist() if isinstance(t, torch.Tensor) else t


def _rng_record():
    """Every generator state the port draws from, as JSON-able lists."""
    from .. import random as _rnd

    st = _rnd._table()
    cuda = [g.get_state() for g in torch.cuda.default_generators] \
        if torch.cuda.is_initialized() else []
    kind, keys, pos, has_gauss, gauss = np.random.get_state()
    return {"seed": int(st.seed),
            "generators": {str(dev): _bytes(g.get_state())
                           for dev, g in st.gens.items()},
            "torch_cpu": _bytes(torch.get_rng_state()),
            "torch_cuda": [_bytes(s) for s in cuda],
            "numpy": [kind, keys.tolist(), int(pos), int(has_gauss),
                      float(gauss)]}


def _restore_rng(rec):
    from .. import random as _rnd

    def state(lst):
        return torch.tensor(lst, dtype=torch.uint8)

    st = _rnd._table()
    st.seed = int(rec["seed"])
    cuda_ok = torch.cuda.is_available()
    for dev, lst in rec["generators"].items():
        if torch.device(dev).type == "cuda" and not cuda_ok:
            continue
        _rnd.generator(dev).set_state(state(lst))
    torch.set_rng_state(state(rec["torch_cpu"]))
    if rec["torch_cuda"] and cuda_ok:
        for gen, lst in zip(torch.cuda.default_generators,
                            rec["torch_cuda"]):
            gen.set_state(state(lst))
    kind, keys, pos, has_gauss, gauss = rec["numpy"]
    np.random.set_state((kind, np.asarray(keys, dtype=np.uint32), pos,
                         has_gauss, gauss))


class Checkpointer:
    """Periodic fenced checkpoints of a training module into one
    directory of committed step directories (step = global step number),
    each with an ``elastic.json`` sidecar carrying the loop state for
    deterministic resume."""

    def __init__(self, directory, period=None, async_write=None, keep=None,
                 resume=None):
        from .. import config as _config

        self.directory = os.path.abspath(directory)
        self.period = int(_config.get("MXNET_CKPT_PERIOD")
                          if period is None else period)
        self.async_write = bool(_config.get("MXNET_CKPT_ASYNC")
                                if async_write is None else async_write)
        self.keep = int(_config.get("MXNET_CKPT_KEEP")
                        if keep is None else keep)
        self.resume = bool(_config.get("MXNET_CKPT_RESUME")
                           if resume is None else resume)
        os.makedirs(self.directory, exist_ok=True)
        self._thread = None
        self._error = None
        self._pinned = {}        # host buffers by key, reused across writes
        self._streams = {}       # the writer's side stream by device
        self.writes = 0          # committed checkpoints
        self.skipped_busy = 0    # fences skipped because a write was in flight
        self.steps_during_write = 0  # steps dispatched while a write ran
        self.snapshot_bytes = 0  # the last snapshot's clones
        self.last_write_ms = None

    # ------------------------------------------------------------------
    def writing(self):
        """Whether a background write is in flight."""
        return self._thread is not None and self._thread.is_alive()

    def note_step(self):
        """Once per training step (the controller): counts steps that
        overlapped an in-flight write."""
        if self.writing():
            self.steps_during_write += 1

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise MXNetError("elastic checkpoint write failed: %s" % (err,))

    # ------------------------------------------------------------------
    def snapshot(self, module, meta):
        """Take a fence checkpoint of ``module`` (loop thread).

        ``meta`` is the controller's sidecar dict (epoch, nbatch_done,
        global_step, iterator, optimizer counts, metric host sums).
        Returns True when a write was started (or, synchronous, done),
        False when skipped because one is in flight.  Asynchronous, only
        the clones, the event and the thread start run here."""
        from .. import obs as _obs
        from .. import profiler as _prof

        t0 = time.perf_counter()
        try:
            self._raise_pending()
            if self.writing():
                self.skipped_busy += 1
                return False
            job = self._device_snapshot(module)
            job["meta"] = dict(meta)
            job["rng"] = _rng_record()
            _obs.instant("ckpt_fence", cat="elastic",
                         args={"step": int(meta.get("global_step", -1))})
            job["layout"] = ckpt_mod.layout_of(module)
            if self.async_write and job["layout"] is None:
                self._thread = threading.Thread(
                    target=self._write_guarded, args=(job,), daemon=True,
                    name="mxtorch-ckpt-writer")
                self._thread.start()
            else:
                self._write(job)
            return True
        finally:
            _prof.record_ckpt_stall(time.perf_counter() - t0)

    def _device_snapshot(self, module):
        """Clones of the store (``checkpoint._state_of``) and of the metric
        accumulators, enqueued on the current stream, and the event that
        completes with them (None on the CPU)."""
        with torch.no_grad():
            state = ckpt_mod._map_state(lambda key, t: t.clone(),
                                        ckpt_mod._state_of(module))
            acc = _metric_state(module)
            metric = None if acc is None else {"metric": {
                str(i): [t.clone() for t in sums + counts]
                for i, (sums, counts) in enumerate(acc)}}
        self.snapshot_bytes = sum(
            t.numel() * t.element_size()
            for t in ckpt_mod._flatten(state).values())
        device = next(iter(ckpt_mod._flatten(state).values())).device
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        return {"state": state, "metric": metric, "event": event,
                "device": device,
                "metric_shape": None if acc is None else
                [len(sums) for sums, _ in acc]}

    # ------------------------------------------------------------------
    def _write_guarded(self, job):
        try:
            self._write(job)
        except Exception as exc:  # raised on the loop thread next fence
            log.warning("elastic checkpoint write failed: %s", exc)
            self._error = exc

    def _pinned_copy(self, key, t, stream):
        buf = self._pinned.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(t, non_blocking=True)
        t.record_stream(stream)
        return buf

    def _to_host(self, job):
        """The job's clones as host tensors, the clones and the event
        released.  On the card: after the snapshot's event, on the
        writer's side stream, into pinned buffers; this thread then waits
        for that stream alone.  A capture on the loop thread forbids these
        calls from any thread, so they run under the programs' capture
        lock (a capture waits for the copies; the file is written
        without it)."""
        from ..programs.graphs import CAPTURE_LOCK

        state, metric = job.pop("state"), job.pop("metric")
        device = job["device"]
        if device.type != "cuda":
            return state, metric
        with CAPTURE_LOCK, torch.cuda.device(device):
            stream = self._streams.get(device)
            if stream is None:
                stream = self._streams[device] = torch.cuda.Stream(
                    device=device)
            with torch.cuda.stream(stream):
                stream.wait_event(job.pop("event"))
                state = ckpt_mod._map_state(
                    lambda key, t: self._pinned_copy(key, t, stream), state)
                if metric is not None:
                    metric = ckpt_mod._map_state(
                        lambda key, t: self._pinned_copy(key, t, stream),
                        metric)
            stream.synchronize()
        return state, metric

    def _write(self, job):
        from .. import obs as _obs
        from .. import profiler as _prof

        t0 = time.perf_counter()
        step = int(job["meta"]["global_step"])
        state, metric = self._to_host(job)
        layout = job.get("layout")
        first = layout is None or ckpt_mod._first_rank()
        # 1. the payload lands under a temporary sibling, renamed to
        #    directory/<step> when complete (under a group, every rank's
        #    blocks into one directory)
        path = ckpt_mod.save_state_tree(self.directory, step, state) \
            if layout is None else ckpt_mod.save_state_tree(
                self.directory, step, state, layout=layout)
        # 2. the sidecar: loop state for deterministic resume
        sidecar = dict(job["meta"])
        sidecar["rng"] = job["rng"]
        if metric is not None:
            rows = []
            for i, n in enumerate(job["metric_shape"]):
                vals = [float(t) for t in metric["metric"][str(i)]]
                rows.append([vals[:n], vals[n:]])
            sidecar["metric_device"] = rows
        if first:
            tmp = os.path.join(path, SIDECAR + ".tmp")
            with open(tmp, "w") as f:
                json.dump(sidecar, f)
            os.replace(tmp, os.path.join(path, SIDECAR))
        # 3. the commit marker is the LAST write: latest_step resumes
        #    only from steps that got this far
        ckpt_mod.commit_step(path, layout)
        self.writes += 1
        ms = (time.perf_counter() - t0) * 1e3
        self.last_write_ms = ms
        _prof.record_ckpt_write(ms)
        # from the writer thread: the timeline shows the overlap
        _obs.instant("ckpt_commit", cat="elastic",
                     args={"step": step, "ms": round(ms, 3)})
        if first:
            self._prune()

    def _prune(self):
        entries = os.listdir(self.directory)
        committed = sorted(s for s in (int(d) for d in entries
                                       if d.isdigit())
                           if ckpt_mod.is_committed(self.directory, s))
        if not committed:
            return
        newest = committed[-1]
        if self.keep > 0:
            for s in committed[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(s)),
                              ignore_errors=True)
        # torn debris below the newest commit is dead (the one write in
        # flight is always the newest step): uncommitted step directories
        # and temporary siblings must not accumulate payloads
        for name in entries:
            if name.isdigit():
                s = int(name)
                dead = s < newest and not ckpt_mod.is_committed(
                    self.directory, s)
            else:
                head = name.split(".", 1)[0]
                dead = name.endswith(ckpt_mod.TMP_SUFFIX) and \
                    head.isdigit() and int(head) < newest
            if dead:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # ------------------------------------------------------------------
    def wait(self):
        """Join any in-flight write (epoch or fit end, before a
        restore); raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def latest(self):
        """Highest committed step that also carries the sidecar."""
        if not os.path.isdir(self.directory):
            return None
        steps = [int(d) for d in os.listdir(self.directory)
                 if d.isdigit() and ckpt_mod.is_committed(self.directory, d)
                 and os.path.exists(os.path.join(self.directory, d, SIDECAR))]
        return max(steps) if steps else None

    def peek(self):
        """The latest committed fence's sidecar without touching the
        module, or None."""
        self.wait()
        step = self.latest()
        if step is None:
            return None
        with open(os.path.join(self.directory, str(step), SIDECAR)) as f:
            return json.load(f)

    def restore(self, module, step=None):
        """Restore the latest committed fence (or fence ``step``) into
        ``module`` (the store in place, the generators, the optimizer's
        counts) and return the sidecar dict, or None when the directory
        holds none.  On a mesh a collective: every rank calls it."""
        self.wait()
        if step is None:
            step = self.latest()
        if step is None:
            return None
        ckpt_mod.load_sharded(self.directory, step, module)
        with open(os.path.join(self.directory, str(step), SIDECAR)) as f:
            meta = json.load(f)
        if meta.get("rng") is not None:
            _restore_rng(meta["rng"])
        self._restore_optimizer(module, meta)
        return meta

    @staticmethod
    def _restore_optimizer(module, meta):
        """Update counts back to the fence's: Adam's bias correction and
        lr schedules read them on the host, so replayed step t must
        really be step t (the slots rode the payload)."""
        opt = getattr(module, "_optimizer", None)
        rec = meta.get("optimizer")
        if opt is None or not rec:
            return
        opt.begin_num_update = int(rec["begin_num_update"])
        opt.num_update = int(rec["num_update"])
        opt._index_update_count = {
            int(k): int(v)
            for k, v in rec.get("index_update_count", {}).items()}

"""Runtime environment-variable configuration registry.

The port's copy of ``mxnet_tpu/config.py`` with the knobs the port
reads.  There is no kernel on/off knob: on the card the kernels always
run, on the CPU their plain versions do.  That holds for the train
step's multi-tensor optimizer update too: its slab plan is armed
wherever the optimizer and the masters allow it.  The training loop's
keys (``MXNET_FUSED_TRAIN_STEP``, ``MXNET_DEVICE_METRICS``,
``MXNET_METRIC_SYNC_PERIOD``, ``MXNET_MAX_STEPS_IN_FLIGHT``,
``MXNET_PREFETCH_DEPTH``, ``MXNET_DEVICE_PREFETCH``) are the JAX
package's, with its defaults.
"""
from __future__ import annotations

import contextlib
import os

__all__ = ["EnvVar", "register", "get", "describe", "refresh",
           "overrides"]

_REGISTRY = {}


def _parse_bool(s):
    return str(s).lower() in ("1", "true", "yes", "on")


class EnvVar:
    """One declared runtime flag."""

    __slots__ = ("name", "type", "default", "doc", "_value", "_loaded")

    def __init__(self, name, type, default, doc):
        self.name = name
        self.type = type
        self.default = default
        self.doc = doc
        self._value = None
        self._loaded = False

    def get(self):
        if not self._loaded:
            raw = os.environ.get(self.name)
            if raw is None:
                self._value = self.default
            elif self.type is bool:
                self._value = _parse_bool(raw)
            else:
                self._value = self.type(raw)
            self._loaded = True
        return self._value

    def reset(self):
        self._loaded = False


def register(name, type, default, doc):
    """Declare a runtime flag; returns the EnvVar."""
    var = EnvVar(name, type, default, doc)
    _REGISTRY[name] = var
    return var


def get(name):
    """Read a declared flag (cached after first read)."""
    return _REGISTRY[name].get()


def refresh(name=None):
    """Drop the cached value(s) so the next get() re-reads the
    environment."""
    if name is not None:
        _REGISTRY[name].reset()
    else:
        for var in _REGISTRY.values():
            var.reset()


@contextlib.contextmanager
def overrides(**values):
    """Set flags for the duration of a ``with`` block (tests), then
    restore what the environment says."""
    old = {}
    for name, value in values.items():
        var = _REGISTRY[name]
        old[name] = (var._value, var._loaded)
        var._value, var._loaded = value, True
    try:
        yield
    finally:
        for name, (value, loaded) in old.items():
            var = _REGISTRY[name]
            var._value, var._loaded = value, loaded


def describe():
    """Human-readable catalog of every declared flag."""
    lines = []
    for name in sorted(_REGISTRY):
        var = _REGISTRY[name]
        lines.append("%s (%s, default=%r)\n    %s"
                     % (name, var.type.__name__, var.default, var.doc))
    return "\n".join(lines)


register("MXNET_DECODE_SLOTS", int, 8,
         "Batch width of the continuous-batching serving loop "
         "(decode.DecodeServer): the decode step always runs this many "
         "sequence slots; free slots refill from the request queue after "
         "every step.")
register("MXNET_KV_DTYPE", str, "",
         "Storage dtype for the decode KV caches: 'int8', 'float8_e4m3fn' "
         "('f8e4m3') or 'float8_e5m2' ('f8e5m2') quantize K/V on append "
         "with per-(token, kv-head) fp32 scales; the paged decode kernel "
         "dequantizes them as it loads each page.  Empty (default) stores "
         "full-precision K/V.")
register("MXNET_KV_PAGED", bool, False,
         "Store decode KV caches as fixed-size pages in one shared pool "
         "per attention node, addressed through per-slot page tables "
         "(copy-on-write prefix sharing and chunked prefill ride on it).")
register("MXNET_KV_PAGE_TOKENS", int, 16,
         "Tokens per KV page in paged mode; cache_len must divide by it.")
register("MXNET_KV_POOL_PAGES", int, 0,
         "Total pages in the shared KV pool (page 0 is the scratch page). "
         "0 (default) sizes the pool to fit every slot at full capacity.")
register("MXNET_PREFILL_CHUNK", int, 0,
         "Chunk width for paged-mode prefill: prompts are admitted in "
         "chunks of this many tokens, interleaved with decode steps.  0 "
         "(default) prefills each prompt's tail in one chunk.")
register("MXNET_SPEC_K", int, 0,
         "Tokens drafted per speculative-decoding step (decode.DecodeServer "
         "/ DecodePredictor.generate_speculative): a proposer drafts k "
         "tokens, one verify pass through the target scores all k+1 "
         "positions and the acceptance-rejection rule keeps the output "
         "distribution the target's.  0 (default) disables speculation.")
register("MXNET_SPEC_NGRAM", int, 2,
         "Suffix length the n-gram proposer (decode.NGramProposer) matches "
         "against each sequence's own history.")
register("MXNET_DECODE_MAX_NEW", int, 256,
         "Default cap on generated tokens per request in the serving loop "
         "when the caller gives no explicit max_new_tokens.")
register("MXNET_FUSED_TRAIN_STEP", bool, True,
         "Run forward, backward and the optimizer update of Module's "
         "training step as one captured program (train_step."
         "CompiledTrainStep: a CUDA graph a bucket executor on the card) "
         "when the optimizer supports it.  0 = the eager forward / "
         "backward / update path.")
register("MXNET_DEVICE_METRICS", bool, True,
         "Fold the metric's (sum, count) accumulation into the compiled "
         "train step (and score()'s compiled eval step) as device scalars "
         "for metrics that implement the device protocol (metric.py "
         "device_batch); reading the metric is the only sync.  0 = the "
         "host-side metric.update path.")
register("MXNET_METRIC_SYNC_PERIOD", int, 0,
         "With device-side metric accumulation active, pull the metric "
         "accumulators to the host every N training steps.  0 (default) "
         "syncs only at natural boundaries (epoch end, or whenever a "
         "callback reads the metric).")
register("MXNET_MAX_STEPS_IN_FLIGHT", int, 2,
         "Upper bound on dispatched-but-unfinished training steps in "
         "fit(): the loop waits on the event of the step K behind, not on "
         "the newest.  1 = a synchronous loop.")
register("MXNET_PREFETCH_DEPTH", int, 2,
         "How many batches DevicePrefetchIter keeps in flight to the card "
         "ahead of the consumer.")
register("MXNET_DEVICE_PREFETCH", bool, True,
         "Let fit() wrap the training iterator in a DevicePrefetchIter "
         "when a compiled train step is active: batches are pinned and "
         "copied on a side stream the step's stream waits on.  0 = feed "
         "host batches directly.")

"""Runtime environment-variable configuration registry.

The port's copy of ``mxnet_tpu/config.py`` with the knobs the port
reads.  There is no kernel on/off knob: on the card the kernels always
run, on the CPU their plain versions do.  That holds for the train
step's multi-tensor optimizer update too: its slab plan is armed
wherever the optimizer and the masters allow it.  The training loop's
keys (``MXNET_FUSED_TRAIN_STEP``, ``MXNET_DEVICE_METRICS``,
``MXNET_METRIC_SYNC_PERIOD``, ``MXNET_MAX_STEPS_IN_FLIGHT``,
``MXNET_PREFETCH_DEPTH``, ``MXNET_DEVICE_PREFETCH``) are the JAX
package's, with its defaults, and so are the telemetry keys
(``MXNET_TELEMETRY`` ... ``MXNET_PEAK_FLOPS``, ``MXNET_PROFILER_AUTOSTART``),
the fleet's (``MXNET_FLEET_SWAP``, ``MXNET_FLEET_DECODE_BOUND``,
``MXNET_FLEET_PREFILL_THRESHOLD``) and the mixture-of-experts op's
(``MXNET_MOE_DISPATCH``, ``MXNET_MOE_TOPK``, ``MXNET_MOE_DROPLESS``,
``MXNET_MOE_CAPACITY``).
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
register("MXNET_PROFILER_AUTOSTART", bool, False,
         "Start the profiler at import time (reference env_var.md:71-79).")
register("MXNET_TELEMETRY", bool, True,
         "Arm the telemetry subsystem (mxnet_tpu_torch.obs): timed "
         "dispatch wrappers around the captured programs (the "
         "per-program MFU/roofline table), timeline spans and instant "
         "events (bounded ring buffer) and the static-cost probers.  "
         "Host-side only: the captured graphs replay the same kernels on "
         "or off.  The step_stats loop counters stay on regardless.")
register("MXNET_TRACE_BUFFER", int, 65536,
         "Capacity (events) of the trace-timeline ring buffer "
         "(mxnet_tpu_torch.obs.timeline).  Oldest events are evicted "
         "first, so an armed timeline costs bounded memory however long "
         "the process lives; profiler.dump_profile exports whatever is "
         "retained as Chrome-trace JSON.")
register("MXNET_METRICS_EXPORT", str, "",
         "Path for the metrics registry's JSON-lines snapshot exporter: "
         "with MXNET_METRICS_EXPORT_PERIOD > 0, a background thread "
         "appends one {ts, metrics} line per period.  Empty (default) = "
         "no file export; the registry is still readable in-process "
         "(obs.registry.snapshot) and over HTTP (MXNET_METRICS_PORT).")
register("MXNET_METRICS_EXPORT_PERIOD", float, 0.0,
         "Seconds between JSON-lines metric snapshots written to "
         "MXNET_METRICS_EXPORT (0 = off).")
register("MXNET_METRICS_PORT", int, 0,
         "Serve the metrics registry over HTTP from decode.DecodeServer "
         "(obs.MetricsServer, 127.0.0.1): /metrics is the Prometheus "
         "text format, /metrics.json the snapshot, /trace the current "
         "timeline as Chrome-trace JSON.  0 (default) = no server.")
register("MXNET_PEAK_FLOPS", float, 0.0,
         "Peak FLOP/s used as the MFU denominator in the per-program "
         "roofline table (obs.mfu_table).  0 (default) = look the card's "
         "name up in obs.roofline.PEAK_FLOPS (spec-sheet figures); "
         "unknown devices (the CPU) then report mfu=null while "
         "flops/bytes/wall stay populated.")
register("MXNET_FLEET_SWAP", bool, True,
         "Arm preemption/swap in the paged serving loop "
         "(decode.DecodeServer / serve.swap): when the page pool cannot "
         "admit the queue head for MXNET_FLEET_DECODE_BOUND consecutive "
         "decode iterations, the lowest-priority (then longest-running) "
         "slot's pages move to host RAM as a restorable record, the "
         "waiter admits on the freed pages, and the victim re-queues — "
         "readmitted later by restoring its pages bit-exactly at the "
         "same ring positions, so a long decode can no longer wedge "
         "admission.  0 = classic backpressure only (the queue waits "
         "for retirements).")
register("MXNET_FLEET_DECODE_BOUND", int, 8,
         "Fair-admission bound for the paged serving loop: consecutive "
         "pool-gate-blocked decode iterations tolerated before a "
         "preemption swap-out (MXNET_FLEET_SWAP) makes room for the "
         "queue head.  Bounds the admission-starvation tail a long "
         "wrapped decode can inflict (single host AND fleet p95 TTFT); "
         "equal-priority thrash is bounded to one swap per this many "
         "iterations — round-robin time slicing, every request still "
         "finishes.  0 disables the bound (swap never triggers on "
         "fairness grounds).")
register("MXNET_FLEET_PREFILL_THRESHOLD", float, 0.5,
         "Disaggregation routing threshold (serve.fleet.Router): a "
         "prompt whose best cache-aware chain match covers at least "
         "this fraction of its tokens admits DIRECTLY on the matching "
         "decode host (its chunked prefill computes only the tail); "
         "colder prompts go to a dedicated prefill worker, whose "
         "committed pages migrate to the least-loaded decode host "
         "(DistServe-style prefill/decode split).  Only consulted when "
         "the router has prefill workers.")
register("MXNET_MOE_DISPATCH", str, "sort",
         "Capacity-slot assignment algorithm for the sparse MoE "
         "dispatch (ops/moe.py): 'sort' (default) ranks the (token, "
         "rank-k choice) pairs by argsort over a composite "
         "(expert, priority) key and derives each choice's capacity "
         "position from its index within the sorted expert group "
         "(MegaBlocks-style sort/scatter dispatch — no (N*k, E) one-hot "
         "cumsum ever materializes); 'onehot' restores the one-hot "
         "cumsum pack for A/B comparison.  Both produce BIT-IDENTICAL "
         "slot assignments, outputs, grads and drop sets (tier-1 "
         "asserted); the dispatch intermediates they materialize "
         "differ, priced by analysis/cost.py sort/scatter accounting.")
register("MXNET_MOE_TOPK", int, 0,
         "Override the MoEFFN op's num_experts_per_tok attribute at trace "
         "time (top-k routing: each token is dispatched to its k highest-"
         "probability experts, gates renormalized over the chosen k when "
         "k > 1).  0 (default) keeps the per-op attribute; k = 1 is the "
         "classic switch (top-1) routing with the raw chosen probability "
         "as the gate.")
register("MXNET_MOE_DROPLESS", bool, False,
         "Force the sparse MoE dispatch's overflow policy to 'dropless': "
         "per-device capacity stretches to the worst case (every local "
         "choice fits, padding-masked slots carry the slack) so no token "
         "is ever dropped — at the cost of expert-FFN compute/memory that "
         "scales like the dense path's worst case.  0 (default) keeps the "
         "per-op 'overflow' attribute (Switch drop semantics unless the "
         "symbol says otherwise).")
register("MXNET_MOE_CAPACITY", float, 0.0,
         "Override the MoEFFN op's capacity_factor attribute at trace "
         "time: > 0 arms the sparse capacity-slot dispatch with per-"
         "(group, expert) capacity ceil(cf * k * group_tokens / E).  "
         "0 (default) keeps the per-op attribute.  Under an 'expert' mesh "
         "the sparse path is the explicit all-to-all shard_map program "
         "(docs/moe.md).")

"""The shipped analysis passes (ten with ``schedule.SchedulePass``) —
the port of ``mxnet_tpu/analysis/passes.py``, with the reference's names
and finding codes, over traced graphs (:mod:`.graph_parse`) in place of
HLO text:

* :class:`DonationPass` — every buffer the program declares it updates
  in place (``donated_leaves``: the step's store, the decode state) is
  written in place by the graph (a ``(a!)`` operator argument or an
  in-place ATen op, followed back to the input): a dropped donation is a
  step that allocates fresh buffers (and copies) every call.
* :class:`CollectiveBudgetPass` — collective nodes per program within
  the budget file's ceilings (zero on one card).
* :class:`RetracePass` — each program captured once per signature.
* :class:`HostSyncPass` — no host transfers in a program (``.item()``,
  copies to the CPU, data-dependent shapes), the ``host_sync_allow``
  sanction kept.
* :class:`FlopDtypePass` — FLOP coverage (dot-like nodes no formula
  models are errors), f32 matmuls inside bf16 programs, and the kernel
  promises: a program that promises kernel B (``decode_kernel``) or B1
  (``update_kernel``) must hold its operator (``paged_decode`` /
  ``multi_tensor_update``).
* :class:`CacheBytesPass` — KV-cache bytes within the ceiling, narrow
  data planes under a quantized ``kv_dtype``, pages under a paged
  config, grouped planes under a grouped config.
* :class:`TunerCoveragePass` — every kernel module's block / split
  constants governed by its tuning space (``ops/tuning.py``); a space
  with one candidate (kernels C-E's compiled tiles) shows as a visible
  ``single-candidate`` row.
* :class:`ShardingCoveragePass` — the partition records of a mesh rank's
  programs (a tensor-parallel Module's train step, a mesh predictor's
  serving programs); ``no-mesh`` on one card.
* :class:`DriftPass` — each program's priced quantities against a
  recorded, content-addressed snapshot.

:class:`~mxnet_tpu_torch.analysis.schedule.SchedulePass` lives in
:mod:`~mxnet_tpu_torch.analysis.schedule` with its parser.
"""
from __future__ import annotations

from .framework import Pass

__all__ = ["DonationPass", "CollectiveBudgetPass", "RetracePass",
           "HostSyncPass", "FlopDtypePass", "CacheBytesPass",
           "TunerCoveragePass", "ShardingCoveragePass", "DriftPass",
           "record_snapshot", "snapshot_hash"]


class DonationPass(Pass):
    """Buffers the program updates in place must be written in place.

    The train step updates its store (masters, gradients, slots, compute
    copies, aux states, metric accumulators) and the decode steps their
    caches, lengths and tokens in place; a write that turns into a
    fresh tensor (an out-of-place op where an in-place one was) leaves
    the buffer stale and the step allocating every call.  The artifact
    records how many buffers the program declares (``donated_leaves``);
    the graph says how many of its inputs it writes.
    """

    name = "donation"
    requires = ("graph",)

    def run(self, artifact, context):
        if not artifact.donated_leaves:
            return [self.finding(
                artifact, "info", "program donates nothing; pass skipped",
                code="no-donation")]
        written = artifact.parsed()["written_inputs"]
        n = len(written)
        if n >= artifact.donated_leaves:
            return [self.finding(
                artifact, "info",
                "%d/%d donated buffers aliased" % (n, artifact.donated_leaves),
                code="aliased", aliased=n,
                donated=artifact.donated_leaves)]
        return [self.finding(
            artifact, "error",
            "dropped donation: %d buffers donated but only %d written in "
            "place by the graph — the step allocates fresh buffers (and "
            "copies) every call" % (artifact.donated_leaves, n),
            code="dropped-donation", aliased=n,
            donated=artifact.donated_leaves, written=list(written))]


class CollectiveBudgetPass(Pass):
    """Collective counts/bytes vs the committed budget ceilings.

    Budget layout (``analysis/budgets.json``)::

        {"programs": {"<program>": {"collectives": {
            "total": {"count": N, "bytes": B},
            "all-gather": {"count": N, "bytes": B}, ...}}},
         "suppressions": ["pass[:program[:code]]", ...]}

    Every ceiling is inclusive (measured == budget passes).  Collective
    ops present in the program but absent from its budget are errors —
    a GSPMD regression typically shows up as a brand-new all-gather, not
    as growth of an existing entry.  Byte ceilings more than 2x the
    measurement emit an info row suggesting the budget be re-tightened
    (``tools/mxlint_torch.py --update-budgets``).  The collectives are
    the graph's ``_c10d_functional`` / ``c10d`` nodes: zero on one card.
    """

    name = "collective-budget"
    requires = ("graph",)

    def run(self, artifact, context):
        budget = context.budget_for(artifact.name) or {}
        ceilings = budget.get("collectives")
        stats = artifact.parsed()["collectives"]
        if ceilings is None:
            sev = "info" if stats["total"]["count"] == 0 else "warning"
            return [self.finding(
                artifact, sev,
                "no committed collective budget for this program "
                "(measured: %d collectives, %d bytes) — run "
                "tools/mxlint_torch.py --update-budgets" %
                (stats["total"]["count"], stats["total"]["bytes"]),
                code="no-budget", measured=stats)]
        findings = []
        for op, measured in stats.items():
            if op == "overlappable":
                continue
            ceiling = ceilings.get(op)
            if ceiling is None:
                if op != "total" and measured["count"] > 0:
                    findings.append(self.finding(
                        artifact, "error",
                        "unbudgeted collective %r: %d op(s), %d bytes — a "
                        "sharding-spec regression inserted a collective "
                        "this program never had" %
                        (op, measured["count"], measured["bytes"]),
                        code="unbudgeted-op", op=op, measured=measured))
                continue
            for key in ("count", "bytes"):
                if key in ceiling and measured[key] > ceiling[key]:
                    findings.append(self.finding(
                        artifact, "error",
                        "collective %s %s over budget: %d > %d" %
                        (op, key, measured[key], ceiling[key]),
                        code="over-budget", op=op, kind=key,
                        measured=measured[key], budget=ceiling[key]))
            if "bytes" in ceiling and ceiling["bytes"] > 0 and \
                    ceiling["bytes"] > 2 * max(measured["bytes"], 1):
                findings.append(self.finding(
                    artifact, "info",
                    "collective %s byte budget %d is >2x the measured %d; "
                    "consider --update-budgets" %
                    (op, ceiling["bytes"], measured["bytes"]),
                    code="slack-budget", op=op))
        # ops budgeted but absent from the program: the ceiling is stale
        # headroom a future regression could silently refill — surface it
        for op, ceiling in ceilings.items():
            if op in stats or ceiling.get("count", 0) == 0:
                continue
            findings.append(self.finding(
                artifact, "info",
                "budgeted collective %r no longer appears in the program "
                "(%d op(s) / %d bytes of stale headroom); tighten with "
                "--update-budgets" %
                (op, ceiling.get("count", 0), ceiling.get("bytes", 0)),
                code="stale-budget", op=op, budget=ceiling))
        if not findings:
            findings.append(self.finding(
                artifact, "info",
                "within budget: %d collectives, %d bytes" %
                (stats["total"]["count"], stats["total"]["bytes"]),
                code="within-budget", measured=stats["total"]))
        return findings


class RetracePass(Pass):
    """Each canonical program traces exactly once per distinct shape.

    The artifact's ``trace_count`` comes from the programs' capture
    counters (``CompiledTrainStep.trace_count``,
    ``DecodePredictor.trace_counts``: a ``GraphProgram`` capture is the
    counterpart of a trace) or a
    :class:`~mxnet_tpu_torch.analysis.retrace.RetraceAuditor`; the
    canonical drive runs every program at least twice at identical shapes
    before snapshotting, so a count above ``expected_traces`` is a new
    capture at "the same" signature — a dtype or buffer drift.  The
    auditor's recorded signature diffs (``meta['retrace']``) say which
    leaf moved.
    """

    name = "retrace"
    requires = ()

    def run(self, artifact, context):
        if artifact.trace_count is None:
            return [self.finding(
                artifact, "info", "no retrace instrumentation on this "
                "artifact", code="no-instrumentation")]
        record = artifact.meta.get("retrace") or {}
        if artifact.meta.get("aot") and artifact.trace_count == 0:
            # AOT-prepared programs dispatch a deserialized (or
            # probe-compiled) executable: zero python-level traces is
            # the DESIGNED state, not missing instrumentation — surface
            # the provenance so "every host runs the canonical program,
            # not a local retrace" reads straight off the lint
            return [self.finding(
                artifact, "info",
                "0 traces: program dispatches an AOT %s executable"
                % artifact.meta["aot"],
                code="aot-loaded", source=artifact.meta["aot"])]
        if artifact.trace_count <= artifact.expected_traces:
            return [self.finding(
                artifact, "info",
                "traced %d time(s), %d expected" %
                (artifact.trace_count, artifact.expected_traces),
                code="no-retrace")]
        diffs = record.get("diffs") or []
        diff_text = "; ".join("|".join(d) for d in diffs if d) \
            or "no signature diff recorded"
        return [self.finding(
            artifact, "error",
            "retraced: %d traces for %d expected shape variant(s) — the "
            "program's signature drifted (%s)" %
            (artifact.trace_count, artifact.expected_traces, diff_text),
            code="retrace", traces=artifact.trace_count,
            expected=artifact.expected_traces, record=record)]


class HostSyncPass(Pass):
    """No host round-trips inside device programs.

    Static scan of the graph: ``.item()`` (``_local_scalar_dense``),
    copies from the card to the CPU, and ops whose output shape depends
    on the data (``nonzero``, ``masked_select``, ``unique``), each of
    which synchronizes the host with the card every call (and cannot be
    captured in a CUDA graph).

    Sanctioned transfers: an artifact may carry
    ``meta['host_sync_allow']`` — a list of finding codes its owner
    declares intentional.  A matching finding is downgraded to an
    *info* row with a ``sanctioned:`` code prefix, so the waiver stays
    visible in reports instead of silently vanishing.
    """

    name = "host-sync"
    requires = ("graph",)

    def run(self, artifact, context):
        findings = []
        sanctioned = set(artifact.meta.get("host_sync_allow") or ())

        def emit(code, message, **detail):
            if code in sanctioned:
                findings.append(self.finding(
                    artifact, "info",
                    "sanctioned host transfer (%s): %s" % (code, message),
                    code="sanctioned:" + code, **detail))
            else:
                findings.append(self.finding(artifact, "error", message,
                                             code=code, **detail))

        for rec in artifact.parsed()["host_transfers"]:
            emit(rec["op"], "%d %s node(s) in the graph: the program "
                 "round-trips through the host every step"
                 % (rec["count"], rec["op"]), count=rec["count"])
        if not findings:
            findings.append(self.finding(
                artifact, "info", "no host callbacks or host transfers",
                code="clean"))
        return findings


class FlopDtypePass(Pass):
    """FLOP-counter coverage + f32 matmuls in bf16 programs + the
    kernel promises.

    Coverage: a dot-like node no formula models (``uncounted_ops``)
    makes every FLOP total a silent undercount — an error.  Element
    types missing from the width table are a warning.

    Dtype: in a program whose compute dtype is bfloat16/float16, every
    dot whose result is f32 is flagged (warning).

    Kernel promises: an artifact whose ``meta['decode_kernel']`` (a
    paged decode / verify step with the kernels on) or
    ``meta['update_kernel']`` (a train step under the slab plan) is set
    promises kernel B or B1; its graph must hold the operator
    (``paged_decode`` / ``multi_tensor_update``), else the program fell
    back to a plain path — an error.
    """

    name = "flop-dtype"
    requires = ("graph",)

    _KERNEL_PROMISES = (
        ("decode_kernel", "paged_decode", "kernel-decode",
         "kernel B present (mxnet_tpu_torch::paged_decode)",
         "the program promises kernel B (paged flash decoding) but its "
         "graph holds no paged_decode operator — decode attention fell "
         "back to the plain path"),
        ("update_kernel", "multi_tensor_update", "kernel-update",
         "kernel B1 present (mxnet_tpu_torch::multi_tensor_update)",
         "the program promises kernel B1 (the multi-tensor update) but "
         "its graph holds no multi_tensor_update operator — the update "
         "fell back to the plain or per-parameter path"),
    )

    def run(self, artifact, context):
        from .artifact import kernel_ops

        findings = []
        ops = kernel_ops(artifact)
        for key, op, ok_code, ok_msg, fail_msg in self._KERNEL_PROMISES:
            if not artifact.meta.get(key):
                continue
            if ops.get(op):
                findings.append(self.finding(
                    artifact, "info", ok_msg, code=ok_code, count=ops[op]))
            else:
                findings.append(self.finding(
                    artifact, "error", fail_msg, code="kernel-fallback",
                    op=op))
        report = artifact.parsed()
        for rec in report["uncounted_ops"]:
            findings.append(self.finding(
                artifact, "error",
                "%d %r op(s) not modeled by the FLOP counter: FLOP totals "
                "for this program are undercounts" % (rec["count"],
                                                      rec["op"]),
                code="uncounted:" + rec["op"], **rec))
        unknown = report["unknown_dtypes"]
        if unknown:
            findings.append(self.finding(
                artifact, "warning",
                "element types %s missing from the width table: byte "
                "accounting skips them" % (unknown,),
                code="unknown-dtype", dtypes=unknown))
        cd = (artifact.compute_dtype or "").lower().replace("torch.", "")
        if cd in ("bfloat16", "bf16", "float16", "f16"):
            low = {"bfloat16": "bf16", "bf16": "bf16",
                   "float16": "f16", "f16": "f16"}[cd]
            bad = [d for d in report["dots"] if d["dtype"] == "float32"]
            if bad:
                findings.append(self.finding(
                    artifact, "warning",
                    "%d of %d dots compute in f32 inside a %s program — "
                    "an upcast re-promoted the matmul path (first: %s)" %
                    (len(bad), len(report["dots"]), low,
                     bad[0]["line"][:160]),
                    code="f32-dot", count=len(bad),
                    total_dots=len(report["dots"]),
                    lines=[d["line"][:160] for d in bad[:8]]))
        if not findings:
            findings.append(self.finding(
                artifact, "info",
                "%d dot(s), %d FLOPs, full coverage" %
                (len(report["dots"]), report["flops"]),
                code="covered", flops=report["flops"]))
        return findings


# dtypes a cache DATA plane may use under a quantized MXNET_KV_DTYPE; the
# fp32 scale plane rides separately and is counted in cache_bytes
_NARROW_CACHE_DTYPES = ("int8", "float8_e4m3fn", "float8_e5m2",
                        "float8_e4m3fnuz", "float8_e5m2fnuz", "int4")


def _dtype_name(d):
    """``"torch.int8"`` -> ``"int8"`` (the port's metadata records torch
    dtype names)."""
    return str(d).replace("torch.", "")


class CacheBytesPass(Pass):
    """Decode KV-cache bytes vs the committed ceiling; quantized configs
    must store narrow data; paged configs must store pages.

    Decode is bandwidth-bound on the cache: every step streams the whole
    (B, C, E) K/V per layer, so cache bytes ARE the serving-cost
    denominator.  The decode artifacts record ``meta['cache_bytes']`` —
    data plus per-(token, head) scale planes, counted from the tensors
    (``DecodePredictor.cache_bytes``) — plus
    ``meta['kv_dtype']``/``meta['cache_data_dtypes']`` and
    ``meta['cache_layout']`` ('dense' ring buffers per slot, or 'paged':
    shared page pools whose recorded bytes are the POOL total — the
    serving HBM bill a page-table regression would silently re-inflate).
    Budget layout::

        {"programs": {"<program>": {"cache_bytes": N}}}

    Findings: bytes over the ceiling = error (a dtype regression silently
    doubling the cache); a quantized ``kv_dtype`` whose data planes are
    full-precision = error (the quantize plumbing got dropped — the
    config promises narrow reads it no longer performs); a dense-ring
    allocation under a paged config (``meta['kv_paged']``) = error (the
    page-pool plumbing got dropped — HBM scales with slots x max-context
    again); no committed ceiling = warning nudging ``--update-budgets``
    hygiene.  Programs without cache metadata (training steps) skip with
    an info row.
    """

    name = "cache-bytes"
    requires = ()

    def run(self, artifact, context):
        cache_bytes = artifact.meta.get("cache_bytes")
        if cache_bytes is None:
            return [self.finding(
                artifact, "info", "no KV-cache metadata; pass skipped",
                code="no-cache")]
        findings = []
        kv_dtype = artifact.meta.get("kv_dtype")
        data_dtypes = artifact.meta.get("cache_data_dtypes") or []
        layout = artifact.meta.get("cache_layout")
        if artifact.meta.get("kv_paged") and layout == "dense":
            findings.append(self.finding(
                artifact, "error",
                "MXNET_KV_PAGED promises paged KV caches but this program "
                "allocates dense ring buffers — the page-pool plumbing "
                "was dropped and serving HBM scales with "
                "slots x max-context again",
                code="dense-under-paged", layout=layout))
        if kv_dtype:
            wide = [d for d in data_dtypes
                    if _dtype_name(d) not in _NARROW_CACHE_DTYPES]
            if wide:
                findings.append(self.finding(
                    artifact, "error",
                    "kv_dtype=%s promises quantized caches but data "
                    "planes store %s — the quantize path was dropped and "
                    "every decode step streams full-precision bytes"
                    % (kv_dtype, wide),
                    code="f32-cache", kv_dtype=kv_dtype, wide=wide))
        # grouped-K/V promise (meta['num_kv_heads'] from a GQA config):
        # every cache/pool plane must be H_kv head slices wide — an H_q-
        # wide allocation means the num_kv_heads plumbing was dropped and
        # the G× pool shrink silently forfeited
        if artifact.meta.get("num_kv_heads"):
            widths = artifact.meta.get("cache_kv_dims") or []
            for dims in artifact.meta.get("attn_dims") or []:
                q_dim = dims.get("q_dim")
                kv_dim = dims.get("kv_dim")
                if dims.get("num_kv_heads") == dims.get("num_heads") \
                        or q_dim == kv_dim or kv_dim is None:
                    continue
                if q_dim in widths:
                    findings.append(self.finding(
                        artifact, "error",
                        "config promises grouped K/V (num_kv_heads=%s < "
                        "num_heads=%s) but a cache/pool plane allocates "
                        "the full q width %d (expected %d) — the grouped "
                        "layout was dropped and the pool is G× too large"
                        % (dims.get("num_kv_heads"),
                           dims.get("num_heads"), q_dim, kv_dim),
                        code="mha-under-gqa", q_dim=q_dim, kv_dim=kv_dim))
        budget = context.budget_for(artifact.name) or {}
        ceiling = budget.get("cache_bytes")
        if ceiling is None:
            findings.append(self.finding(
                artifact, "warning",
                "no committed cache-byte budget for this program "
                "(measured: %d bytes) — run tools/mxlint_torch.py "
                "--update-budgets" % cache_bytes,
                code="no-budget", measured=cache_bytes))
        elif cache_bytes > ceiling:
            findings.append(self.finding(
                artifact, "error",
                "cache bytes over budget: %d > %d — the per-token "
                "bandwidth bill grew (dtype or shape regression in the "
                "ring buffers)" % (cache_bytes, ceiling),
                code="over-budget", measured=cache_bytes, budget=ceiling))
        if not findings:
            findings.append(self.finding(
                artifact, "info",
                "cache within budget: %d <= %d bytes (kv_dtype=%s, %s)"
                % (cache_bytes, ceiling, kv_dtype or "full-precision",
                   layout or "dense"),
                code="within-budget", measured=cache_bytes,
                budget=ceiling, kv_dtype=kv_dtype, layout=layout))
        return findings


# the tunable-constant surface the tuner-coverage audit matches: block
# shapes (BLOCK*) and split counts (*SPLIT/SPLITS).  MIN_* floors are
# support gates, and a space's own candidate list (*_CANDIDATES) is the
# space, not a constant it governs.
_TUNABLE_CONST_RE = r"^(BLOCK[A-Z_0-9]*|[A-Z_0-9]*SPLITS?)$"
# the kernel modules (ops/<name>.py), each registering the tuning space
# of its name
_KERNEL_MODULES = ("fused_kernel", "decode_kernel", "flash_kernel",
                   "update_kernel")


class TunerCoveragePass(Pass):
    """Every kernel module's block/split constants registered with the
    autotuner.

    Static source audit, not an artifact property: each kernel module
    (``ops/fused_kernel.py``, ``decode_kernel.py``, ``flash_kernel.py``,
    ``update_kernel.py``) is AST-scanned for module-level ALL_CAPS
    ``BLOCK*``/``*SPLITS`` assignments, and each found name must appear
    in that module's registered tuning space
    (``tuning.spaces()[module].constants``).  A constant outside the
    space is a plan ``MXNET_PALLAS_TUNE`` can never sweep — an error.
    A space with a single candidate (kernels C-E's tiles are compiled
    in) is a visible ``single-candidate`` info row: a sweep records it,
    it cannot choose.  The scan is repo-global, so it runs ONCE per
    drive (findings land on the first artifact; later artifacts skip
    with an info row).
    """

    name = "tuner-coverage"
    requires = ()

    def __init__(self):
        self._ran = False

    def _scan(self):
        import ast
        import os
        import re

        ops_dir = os.path.join(os.path.dirname(__file__), "..", "ops")
        pat = re.compile(_TUNABLE_CONST_RE)
        found = {}
        for mod in _KERNEL_MODULES:
            path = os.path.join(ops_dir, mod + ".py")
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
            names = []
            for node in tree.body:
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Name) and pat.match(tgt.id) \
                            and not tgt.id.startswith("MIN_") \
                            and not tgt.id.endswith("_CANDIDATES"):
                        names.append(tgt.id)
            found[mod] = names
        return found

    def run(self, artifact, context):
        if self._ran:
            return [self.finding(
                artifact, "info", "tuner coverage audited once per drive",
                code="already-ran")]
        self._ran = True
        from ..ops import tuning

        spaces = tuning.spaces()
        findings = []
        total = 0
        scanned = self._scan()
        for mod, names in scanned.items():
            space = spaces.get(mod)
            registered = set(space.constants) if space is not None else set()
            missing = [n for n in names if n not in registered]
            total += len(names)
            if space is None:
                if names:
                    findings.append(self.finding(
                        artifact, "error",
                        "ops/%s.py hardcodes block constants %s but "
                        "registers no tuning space at all — "
                        "MXNET_PALLAS_TUNE cannot sweep this kernel "
                        "(ops/tuning.register_space)" % (mod, names),
                        code="no-space", module=mod, constants=names))
                continue
            if missing:
                findings.append(self.finding(
                    artifact, "error",
                    "ops/%s.py block constants %s are not governed by the "
                    "module's registered tuning space (constants=%s) — "
                    "the autotuner can never improve them"
                    % (mod, missing, sorted(registered)),
                    code="unregistered-constant", module=mod,
                    missing=missing, registered=sorted(registered)))
            try:
                cands = space.candidates(None, False)
            except Exception:   # a space whose candidates need a class
                cands = None
            if cands is not None and len(cands) == 1:
                findings.append(self.finding(
                    artifact, "info",
                    "ops/%s.py's tuning space has one candidate (%s): a "
                    "sweep times and records it but cannot choose"
                    % (mod, sorted(space.constants)),
                    code="single-candidate", module=mod,
                    constants=sorted(space.constants)))
        if not [f for f in findings if f.severity != "info"]:
            findings.append(self.finding(
                artifact, "info",
                "%d block/split constants across %d kernel modules all "
                "registered with the autotuner"
                % (total, len([1 for n in scanned.values() if n])),
                code="covered", constants=total))
        return findings


class ShardingCoveragePass(Pass):
    """Partition-rule coverage over the bound param tree, as the
    reference has it.  A Module with a model axis above 1 stamps
    ``meta['sharding_coverage']`` on its ``train_step`` artifact
    (``Module.program_artifacts``: the records of
    ``parallel.tp_exec.TensorParallel``), and so does a mesh
    ``DecodePredictor`` on its decode, verify and prefill artifacts (the
    same records); programs without a mesh report ``no-mesh``.

    Mesh-bound programs stamp ``meta['sharding_coverage']`` — per-leaf
    records written at placement time by ``programs/partition.
    build_shardings`` and ``parallel/tp_exec.TensorParallel`` (train)::

        {"mesh": {"data": 2, "model": 2},
         "leaves": {"<param>": {"shape": [...],
                                "source": "rule|plan|mesh_axes|naive|"
                                          "default|scalar",
                                "spec": [...],        # when sharded
                                "degrade": "rank-mismatch|indivisible"}}}

    Findings:

    * a leaf a rule/plan MATCHED but the divisibility guard silently
      replicated (``degrade``) is an **error naming the param** — the
      intended placement was lost, every shard now holds the whole
      tensor (the 4x-HBM surprise this pass exists to catch);
    * the grouped-K/V cache degrade (``meta['replicated_degrades']``
      from ``tp_rules._kv_head_axis`` — ``H_kv % model != 0``) is a
      visible *info* row: legitimate, but never silent;
    * an UNMATCHED >=2-D leaf replicating by default is an **error**
      when the program's budget opts into strict coverage
      (``{"sharding": {"strict": true}}``) and a visible *info*
      otherwise — scalars and 1-D per-feature vectors always count as
      intentional replicates.

    Programs without a mesh (or predating the stamping) skip with an
    info row.
    """

    name = "sharding-coverage"
    requires = ()

    def run(self, artifact, context):
        findings = []
        for rec in artifact.meta.get("replicated_degrades") or []:
            findings.append(self.finding(
                artifact, "info",
                "%s degraded to replicated K/V sharding: %s — each "
                "model shard holds the full grouped K/V (visible "
                "degrade, see parallel/tp_rules._kv_head_axis)"
                % (rec.get("site", "kv sharding"),
                   rec.get("reason", "?")),
                code="kv-replicated-degrade", **rec))
        cov = artifact.meta.get("sharding_coverage")
        if cov is None:
            if not findings:
                return [self.finding(
                    artifact, "info",
                    "no sharding-coverage metadata (unmeshed program); "
                    "pass skipped", code="no-mesh")]
            return findings
        mesh = cov.get("mesh") or {}
        leaves = cov.get("leaves") or {}
        strict = bool(((context.budget_for(artifact.name) or {})
                       .get("sharding") or {}).get("strict"))
        meshed = any(int(v) > 1 for v in mesh.values())
        matched = unmatched_big = intentional = 0
        for name in sorted(leaves):
            rec = leaves[name]
            shape = rec.get("shape") or []
            degrade = rec.get("degrade")
            source = rec.get("source")
            if degrade:
                findings.append(self.finding(
                    artifact, "error",
                    "param %r matched a partition rule but DEGRADED to "
                    "full replication (%s, shape %s on mesh %s) — every "
                    "shard holds the whole tensor; fix the rule or the "
                    "shape, or waive it explicitly in the budget file"
                    % (name, degrade, shape, mesh),
                    code="replicated-degrade", param=name,
                    degrade=degrade, shape=shape))
            elif source in ("rule", "plan", "mesh_axes", "naive") \
                    and rec.get("spec"):
                matched += 1
            elif source == "default" and meshed \
                    and sum(1 for d in shape if int(d) > 1) >= 2:
                # effective rank counts dims > 1: a [1, 1, 16] LN gain
                # is a per-feature vector (always an intentional
                # replicate), a [1, 16, 16] embedding table is not
                unmatched_big += 1
                findings.append(self.finding(
                    artifact, "error" if strict else "info",
                    "param %r (shape %s) matched NO partition rule and "
                    "fully replicates on mesh %s — declare a rule or an "
                    "intentional replicate%s"
                    % (name, shape, mesh,
                       "" if strict else " (info: budget has no "
                       "{'sharding': {'strict': true}})"),
                    code="unmatched-param", param=name, shape=shape))
            else:
                intentional += 1
        if not findings:
            findings.append(self.finding(
                artifact, "info",
                "%d leaves covered: %d sharded by rule, %d intentional "
                "replicates, 0 degrades on mesh %s"
                % (len(leaves), matched, intentional, mesh),
                code="covered", leaves=len(leaves), sharded=matched,
                replicated=intentional))
        return findings


# ---------------------------------------------------------------------------
# drift snapshots (mxlint --record / --check)
# ---------------------------------------------------------------------------

# quantities compared EXACTLY (structural integers: a donation map or a
# collective count has no tolerance band)
_DRIFT_EXACT = ("donated", "aliased", "collective_count")
# quantities compared within the snapshot's relative tolerance
_DRIFT_PRICED = ("dot_flops", "collective_bytes", "gather_bytes",
                 "sort_scatter_bytes", "cache_bytes")
_SNAPSHOT_VERSION = 1


def snapshot_hash(snapshot):
    """Content address of a drift snapshot: a digest over its canonical
    JSON minus the hash field itself.  ``load_snapshot`` refuses a file
    whose recorded hash no longer matches — hand-edited baselines must
    go through ``mxlint --record``, not a text editor."""
    import hashlib
    import json

    body = {k: v for k, v in snapshot.items() if k != "content_hash"}
    blob = json.dumps(body, sort_keys=True, default=str)
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


def record_snapshot(artifacts, report=None, tolerance=0.02):
    """Build a drift snapshot dict over built artifacts.

    Per program: the priced quantities
    (:func:`~mxnet_tpu_torch.analysis.cost.artifact_cost`), the program
    fingerprint when known, and the pass-finding severity counts from
    ``report`` (so a baseline records what lint state it was taken in).
    ``tolerance`` is the relative band the check applies to priced
    quantities; structural integers compare exactly."""
    from .cost import artifact_cost

    per_prog = {}
    if report is not None:
        for f in report.findings:
            row = per_prog.setdefault(f.program,
                                      {"errors": 0, "warnings": 0})
            if f.severity != "info" and not f.suppressed:
                row[f.severity + "s"] += 1
    programs = {}
    for art in artifacts:
        row = artifact_cost(art)
        row["fingerprint"] = art.fingerprint
        if art.name in per_prog:
            row["findings"] = per_prog[art.name]
        programs[art.name] = row
    snap = {"version": _SNAPSHOT_VERSION, "tolerance": tolerance,
            "programs": programs}
    snap["content_hash"] = snapshot_hash(snap)
    return snap


class DriftPass(Pass):
    """The differential gate: priced quantities vs a recorded snapshot.

    ``mxlint --record <snapshot.json>`` writes the content-addressed
    baseline; ``mxlint --check <snapshot.json>`` loads it into the
    context and this pass compares each program's measured
    :func:`~mxnet_tpu_torch.analysis.cost.artifact_cost` row against it:

    * a priced quantity (dot FLOPs, collective/gather/sort-scatter
      bytes, cache bytes) GROWN beyond the snapshot's relative
      tolerance is an **error naming the program and the quantity** —
      the regression gate the bench trajectory never had;
    * a structural integer (donated, aliased, collective count) compares
      exactly;
    * a quantity that SHRANK beyond tolerance is an *info* row (an
      improvement to bank: re-record so the gate tightens);
    * a program missing from the snapshot (or a snapshot program that
      was not built) is a **warning** — the baseline is stale and must
      be re-recorded;
    * a changed fingerprint alone is an *info* row (fingerprints move
      with any intentional retrace; the priced quantities decide).

    No snapshot loaded -> one info row per program.
    """

    name = "drift"
    requires = ()

    def run(self, artifact, context):
        from .cost import artifact_cost

        snap = context.snapshot
        if not snap:
            return [self.finding(
                artifact, "info",
                "no drift snapshot loaded; record one with "
                "tools/mxlint_torch.py --record <snapshot.json>",
                code="no-snapshot")]
        findings = []
        recorded = snap.get("programs", {})
        row = recorded.get(artifact.name)
        if row is None:
            findings.append(self.finding(
                artifact, "warning",
                "program absent from the drift snapshot — re-record "
                "the baseline (tools/mxlint_torch.py --record)",
                code="new-program"))
            return findings
        measured = artifact_cost(artifact)
        tol = float(snap.get("tolerance", 0.02))
        drifted = []
        for key in _DRIFT_EXACT + _DRIFT_PRICED:
            was, now = row.get(key), measured.get(key)
            if was is None and now is None:
                continue
            if was is None or now is None:
                findings.append(self.finding(
                    artifact, "warning",
                    "quantity %r %s the snapshot but %s this run — "
                    "surfaces changed; re-record the baseline"
                    % (key, "missing from" if was is None else "in",
                       "measured" if was is None else "unmeasured"),
                    code="asymmetric-quantity", quantity=key,
                    recorded=was, measured=now))
                continue
            if key in _DRIFT_EXACT:
                if now != was:
                    drifted.append((key, was, now, "error"))
                continue
            band = tol * max(abs(was), 1)
            if now > was + band:
                drifted.append((key, was, now, "error"))
            elif now < was - band:
                drifted.append((key, was, now, "info"))
        for key, was, now, sev in drifted:
            pct = 100.0 * (now - was) / max(abs(was), 1)
            if sev == "error":
                findings.append(self.finding(
                    artifact, "error",
                    "%s drifted %+.1f%% (%d -> %d) beyond the %.0f%% "
                    "tolerance without a re-recorded baseline — an "
                    "intentional change ships with tools/mxlint_torch.py "
                    "--record, a regression gets fixed"
                    % (key, pct, was, now, 100 * tol),
                    code="drift:" + key, quantity=key, recorded=was,
                    measured=now, tolerance=tol))
            else:
                findings.append(self.finding(
                    artifact, "info",
                    "%s improved %+.1f%% (%d -> %d); re-record so the "
                    "gate banks the win" % (key, pct, was, now),
                    code="improved:" + key, quantity=key, recorded=was,
                    measured=now))
        if row.get("fingerprint") and artifact.fingerprint \
                and row["fingerprint"] != artifact.fingerprint:
            findings.append(self.finding(
                artifact, "info",
                "program fingerprint changed (%s -> %s); priced "
                "quantities decide whether it matters"
                % (row["fingerprint"][:12], artifact.fingerprint[:12]),
                code="fingerprint-changed"))
        if not findings:
            findings.append(self.finding(
                artifact, "info",
                "all priced quantities within %.0f%% of the snapshot"
                % (100 * tol), code="within-tolerance"))
        return findings

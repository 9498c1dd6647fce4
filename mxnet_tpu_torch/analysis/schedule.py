"""Schedule model of compiled HLO: async pairs and their compute shadows
(the port of ``mxnet_tpu/analysis/schedule.py``, as the reference has
it).

A port artifact has no compiled text: ``compiled_text`` is always None
(a CUDA graph has no schedule text), so :class:`SchedulePass`, which
requires it, reports every port program as a visible info row with code
``missing-surface`` (the framework's skip) — never a silent pass.
:func:`parse_schedule` still models compiled XLA HLO as the reference's
does (the canned TPU corpus under ``tests/data/hlo/``).

The double-buffered ring, the async fenced checkpoint and every
other latency-hiding claim this repo ships reduce to ONE property of the
*scheduled* instruction stream: each communication op is split into a
``-start``/``-done`` pair and real compute sits between them.  The
collective pass counts those bytes but is blind to WHERE they sit; this
module parses the entry computation's instruction order into a
:class:`ScheduleModel` so the placement itself becomes lintable:

* every async pair (``collective-permute-start/done``,
  ``all-reduce-start/done``, ``all-gather-start/done``,
  ``copy-start/done``, ...) is matched by the start instruction's name
  appearing in the done's operands;
* a start whose done never arrives (or vice versa) is broken scheduling
  and surfaces as an *unpaired* record;
* the instructions between each start and its done are the pair's
  **shadow** — the dot FLOPs and result bytes of compute the scheduler
  actually hid behind the wire.  A start directly followed by its done
  (``shadow_ops == 0``) is a *serialized* pair: the async split bought
  nothing.

:class:`SchedulePass` checks the model against per-program ``overlap``
floors in the budget file, so "2*(n-1) overlapped
collective-permutes per ring step" is a committed contract, not a claim.
XLA:CPU legalizes collectives synchronously, so the canonical CPU-mesh
programs report an empty model (an info row); the contract is proven on
the canned real-TPU HLO corpus under ``tests/data/hlo/`` (provenance in
its README), the same canned-snippet pattern ``test_hlo_stats.py`` uses.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from .framework import Pass
from .hlo_text import _scan_shape, dot_flops_report, shape_bytes

__all__ = ["AsyncPair", "ScheduleModel", "SchedulePass", "parse_schedule"]

# op families whose -start/-done splits the schedule model pairs up.
# 'copy' covers cross-memory-space prefetch (copy-start/copy-done);
# 'send'/'recv' are omitted on purpose — their channel semantics pair
# across modules, not within one entry computation.
ASYNC_OPS = ("collective-permute", "all-reduce", "all-gather",
             "reduce-scatter", "all-to-all", "collective-broadcast",
             "copy")

# '%name = shape op(...)' — the lhs instruction name (ROOT-prefixed on
# the root), then the shape (balanced scan — tuples nest), then the op
_LHS_RE = re.compile(r"^\s*(?:ROOT\s+)?(%?[\w.\-]+)\s*=\s*")
_OP_NAME_RE = re.compile(r"\s*([a-z][a-z0-9\-]*)\(")
_OPERAND_RE = re.compile(r"%[\w.\-]+")
# structural ops that are free at runtime: their result bytes are not
# compute the scheduler hid behind a wire
_STRUCTURAL_OPS = ("parameter", "constant", "tuple", "get-tuple-element",
                   "bitcast", "after-all", "iota")


@dataclass
class AsyncPair:
    """One matched ``-start``/``-done`` pair in entry-computation order."""

    op: str                 # family, e.g. "collective-permute"
    start_name: str         # lhs name of the -start instruction
    start_index: int        # position in the entry instruction stream
    done_index: int
    bytes: int              # wire payload (the -start's result tuple)
    shadow_flops: int = 0   # dot/conv FLOPs between start and done
    shadow_bytes: int = 0   # result bytes of compute between the pair
    shadow_ops: int = 0     # compute instructions between the pair

    @property
    def serialized(self):
        """True when the start retired immediately: no compute between
        the pair, so the async split hid nothing."""
        return self.shadow_ops == 0

    def to_dict(self):
        return {"op": self.op, "start": self.start_name,
                "window": [self.start_index, self.done_index],
                "bytes": self.bytes, "shadow_flops": self.shadow_flops,
                "shadow_bytes": self.shadow_bytes,
                "shadow_ops": self.shadow_ops,
                "serialized": self.serialized}


@dataclass
class ScheduleModel:
    """The entry computation's async structure, in instruction order."""

    instructions: int = 0
    pairs: list = field(default_factory=list)
    unpaired_starts: list = field(default_factory=list)
    unpaired_dones: list = field(default_factory=list)

    def by_op(self):
        out = {}
        for p in self.pairs:
            out.setdefault(p.op, []).append(p)
        return out

    def serialized_pairs(self):
        return [p for p in self.pairs if p.serialized]

    def summary(self):
        return {"instructions": self.instructions,
                "pairs": len(self.pairs),
                "unpaired": len(self.unpaired_starts)
                + len(self.unpaired_dones),
                "serialized": len(self.serialized_pairs()),
                "shadow_flops": sum(p.shadow_flops for p in self.pairs),
                "shadow_bytes": sum(p.shadow_bytes for p in self.pairs)}


def _entry_lines(compiled_text):
    """The instruction lines of the ENTRY computation, in order.  Fusion
    and while-body computations are separate blocks in the module text;
    only the entry's stream IS the top-level schedule."""
    lines = []
    in_entry = False
    for line in compiled_text.splitlines():
        if not in_entry:
            if line.lstrip().startswith("ENTRY ") and line.rstrip(). \
                    endswith("{"):
                in_entry = True
            continue
        if line.strip() == "}":
            break
        if "=" in line:
            lines.append(line)
    return lines


def _async_split(op_name):
    """('collective-permute', '-start') for async spellings, else
    (op_name, None)."""
    for suffix in ("-start", "-done"):
        if op_name.endswith(suffix):
            base = op_name[:-len(suffix)]
            if base in ASYNC_OPS:
                return base, suffix
    return op_name, None


def parse_schedule(compiled_text):
    """Parse compiled HLO text into a :class:`ScheduleModel`.

    One pass over the entry computation's instruction stream: starts are
    recorded by lhs name; a same-family done whose operands reference a
    pending start closes the pair; everything else is compute whose dot
    FLOPs and result bytes accrue to the shadow of every open pair."""
    model = ScheduleModel()
    open_pairs = {}     # start lhs name -> AsyncPair
    for index, line in enumerate(_entry_lines(compiled_text)):
        lm = _LHS_RE.match(line)
        if lm is None:
            continue
        model.instructions += 1
        lhs = lm.group(1).lstrip("%")
        shape_s, end = _scan_shape(line, lm.end())
        om = _OP_NAME_RE.match(line, end)
        op_name = om.group(1) if om is not None else ""
        base, suffix = _async_split(op_name)
        if suffix == "-start":
            open_pairs[lhs] = AsyncPair(
                op=base, start_name=lhs, start_index=index,
                done_index=-1, bytes=_pair_bytes(base, shape_s))
            continue
        if suffix == "-done":
            operands = [t.lstrip("%")
                        for t in _OPERAND_RE.findall(line[end:])]
            hit = next((n for n in operands
                        if n in open_pairs and open_pairs[n].op == base),
                       None)
            if hit is None:
                model.unpaired_dones.append(
                    {"op": base, "name": lhs, "index": index})
                continue
            pair = open_pairs.pop(hit)
            pair.done_index = index
            model.pairs.append(pair)
            continue
        if op_name in _STRUCTURAL_OPS or not op_name:
            continue
        # plain compute: it shadows every currently-open pair
        if open_pairs:
            flops = dot_flops_report(line)["flops"]
            nbytes = shape_bytes(shape_s)
            for pair in open_pairs.values():
                pair.shadow_flops += flops
                pair.shadow_bytes += nbytes
                pair.shadow_ops += 1
    for pair in open_pairs.values():
        model.unpaired_starts.append(
            {"op": pair.op, "name": pair.start_name,
             "index": pair.start_index})
    model.pairs.sort(key=lambda p: p.start_index)
    return model


def _pair_bytes(op, shape_s):
    """Wire payload of a '-start' result tuple — the same op-specific
    layout rules :func:`~mxnet_tpu.analysis.hlo_parse.collective_stats` (the reference)
    prices (copy-start carries (dest, src, ctx): count the dest)."""
    from .hlo_text import _start_bytes

    if op == "copy":
        from .hlo_text import _split_top_level

        parts = _split_top_level(shape_s)
        return shape_bytes(parts[0]) if parts else 0
    return _start_bytes(op, shape_s)


class SchedulePass(Pass):
    """Async-overlap contract: pairs matched, shadows above the floors.

    Findings:

    * an unpaired ``-start``/``-done`` is always an **error** — the
      schedule references an async op whose other half never ran;
    * a serialized pair (start directly followed by its done) is an
      **error** when the program has an ``overlap`` budget (the budget
      says this program PAYS for latency hiding) and a visible *info*
      row otherwise;
    * ``overlap`` floors per op family::

          {"programs": {"<program>": {"overlap": {
              "collective-permute": {"min_pairs": 6,
                                     "min_shadow_flops": 1,
                                     "max_serialized": 0}}}}}

      fewer matched pairs than ``min_pairs``, any pair whose shadow
      FLOPs sit under ``min_shadow_flops``, or more serialized pairs
      than ``max_serialized`` (default 0 once an overlap budget exists)
      are **errors** naming the op family and the measured values.

    Overlap budgets describe TPU-compiled artifacts; XLA:CPU keeps sync
    collectives, so the canonical CPU-mesh programs carry no ``overlap``
    entries and report an info row (``sync-backend``) — the contract is
    exercised against the canned corpus under ``tests/data/hlo/``.
    """

    name = "schedule"
    requires = ("compiled",)

    def run(self, artifact, context):
        model = parse_schedule(artifact.compiled_text)
        budget = (context.budget_for(artifact.name) or {}).get("overlap")
        findings = []
        for rec in model.unpaired_starts:
            findings.append(self.finding(
                artifact, "error",
                "%s-start %r (entry index %d) has no matching -done in "
                "the entry computation — broken async schedule"
                % (rec["op"], rec["name"], rec["index"]),
                code="unpaired-start", **rec))
        for rec in model.unpaired_dones:
            findings.append(self.finding(
                artifact, "error",
                "%s-done %r (entry index %d) references no open -start "
                "in the entry computation" %
                (rec["op"], rec["name"], rec["index"]),
                code="unpaired-done", **rec))
        serialized = model.serialized_pairs()
        if serialized and budget is None:
            findings.append(self.finding(
                artifact, "info",
                "%d of %d async pair(s) retire immediately (start "
                "directly followed by done — zero overlap window): %s"
                % (len(serialized), len(model.pairs),
                   [p.start_name for p in serialized[:8]]),
                code="serialized-pair",
                pairs=[p.to_dict() for p in serialized[:8]]))
        for op, ceiling in sorted((budget or {}).items()):
            pairs = model.by_op().get(op, [])
            ser = [p for p in pairs if p.serialized]
            min_pairs = ceiling.get("min_pairs", 0)
            if len(pairs) < min_pairs:
                findings.append(self.finding(
                    artifact, "error",
                    "overlap budget promises >= %d async %s pair(s) but "
                    "the schedule carries %d — the latency-hiding "
                    "structure was lost (sync legalization or a "
                    "scheduling regression)" % (min_pairs, op, len(pairs)),
                    code="missing-pairs", op=op, measured=len(pairs),
                    budget=min_pairs))
            if len(ser) > ceiling.get("max_serialized", 0):
                findings.append(self.finding(
                    artifact, "error",
                    "%d async %s pair(s) retire immediately (max %d "
                    "allowed): the -start/-done split hides nothing for "
                    "%s" % (len(ser), op,
                            ceiling.get("max_serialized", 0),
                            [p.start_name for p in ser[:8]]),
                    code="serialized-pair", op=op, measured=len(ser),
                    budget=ceiling.get("max_serialized", 0)))
            floor = ceiling.get("min_shadow_flops", 0)
            thin = [p for p in pairs
                    if not p.serialized and p.shadow_flops < floor]
            if floor and thin:
                findings.append(self.finding(
                    artifact, "error",
                    "%d async %s pair(s) shadow fewer than %d FLOPs of "
                    "compute (min shadow %d) — the wire is no longer "
                    "hidden behind the chunk matmul" %
                    (len(thin), op, floor,
                     min(p.shadow_flops for p in thin)),
                    code="thin-shadow", op=op, floor=floor,
                    pairs=[p.to_dict() for p in thin[:8]]))
        if not findings:
            if not model.pairs:
                findings.append(self.finding(
                    artifact, "info",
                    "no async collective pairs in the entry computation "
                    "(sync backend or collective-free program)",
                    code="sync-backend", **model.summary()))
            else:
                findings.append(self.finding(
                    artifact, "info",
                    "%d async pair(s) all matched, min shadow %d FLOPs "
                    "/ %d bytes" %
                    (len(model.pairs),
                     min(p.shadow_flops for p in model.pairs),
                     min(p.shadow_bytes for p in model.pairs)),
                    code="overlapped", **model.summary()))
        return findings

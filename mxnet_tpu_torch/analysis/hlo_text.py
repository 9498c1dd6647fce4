"""Compiled-HLO text helpers the schedule model reads — the HLO half of
``mxnet_tpu/analysis/hlo_parse.py``, kept as the reference has it.

A port artifact has no compiled text (a CUDA graph has none); these
parse compiled XLA HLO, the text :func:`~.schedule.parse_schedule` models
(the canned TPU corpus the reference pins its async-overlap contract
on): shape bytes, tuple splitting, async ``-start`` payloads and the dot
/ convolution FLOPs of an instruction line.
"""
from __future__ import annotations

import re

__all__ = ["dot_flops_report", "shape_bytes", "shape_bytes_report"]

# Bit widths per HLO element type.
_DTYPE_BITS = {
    "f64": 64, "f32": 32, "f16": 16, "bf16": 16,
    "f8e4m3": 8, "f8e4m3fn": 8, "f8e4m3fnuz": 8, "f8e4m3b11fnuz": 8,
    "f8e5m2": 8, "f8e5m2fnuz": 8, "f8e3m4": 8, "f8e8m0fnu": 8,
    "f4e2m1fn": 4,
    "s64": 64, "u64": 64, "s32": 32, "u32": 32, "s16": 16, "u16": 16,
    "s8": 8, "u8": 8, "s4": 4, "u4": 4, "s2": 2, "u2": 2,
    "pred": 8, "c64": 64, "c128": 128,
    # StableHLO spells integers signless (i8, not s8) and bools i1 —
    # the lowered-dialect byte accounting (collective payloads, gather
    # intermediates) reads these; compiled HLO never produces them.
    # i1 is stored one byte per element, like pred.
    "i64": 64, "i32": 32, "i16": 16, "i8": 8, "i4": 4, "i2": 2, "i1": 8,
    "ui64": 64, "ui32": 32, "ui16": 16, "ui8": 8, "ui4": 4, "ui2": 2,
}

# dtype-shaped names only — 'pred', 'bf16', or letter-digit-led tokens
# like f32/s4/u8/c64/f8e4m3fn — so identifier[index] strings in HLO
# metadata (op_name="params[0]", arg names) never read as shapes
_SHAPE_RE = re.compile(r"\b(pred|bf16|[fsuc][0-9][0-9a-z]*)\[([0-9,]*)\]")

# dtype-shaped names only — 'pred', 'bf16', or letter-digit-led tokens
# like f32/s4/u8/c64/f8e4m3fn — so identifier[index] strings in HLO
# metadata never read as shapes
_SHAPE_RE = re.compile(r"\b(pred|bf16|[fsuc][0-9][0-9a-z]*)\[([0-9,]*)\]")


def _scan_shape(line, start):
    """Return (shape_str, end_index) for the shape beginning at `start` —
    either a balanced parenthesized tuple or a single whitespace-free
    token."""
    if start < len(line) and line[start] == "(":
        depth = 0
        for i in range(start, len(line)):
            if line[i] == "(":
                depth += 1
            elif line[i] == ")":
                depth -= 1
                if depth == 0:
                    return line[start:i + 1], i + 1
        return line[start:], len(line)
    m = re.match(r"\S+", line[start:])
    if m is None:
        return "", start
    return m.group(0), start + m.end()


def shape_bytes_report(shape_str):
    """(total_bytes, unknown_dtypes) over every 'dtype[dims]' shape in the
    string (tuples ok).  Element types missing from the width table land in
    ``unknown_dtypes`` (sorted, deduped) instead of silently contributing
    zero — the analysis FLOP/byte passes turn a non-empty list into a
    recorded finding."""
    total = 0
    unknown = set()
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        bits = _DTYPE_BITS.get(dtype)
        if bits is None:
            unknown.add(dtype)
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += (n * bits + 7) // 8
    return total, sorted(unknown)


def shape_bytes(shape_str):
    """Total bytes of every 'dtype[dims]' shape in the string (tuples ok).
    Unknown dtypes contribute zero here — use :func:`shape_bytes_report`
    when the caller needs them surfaced."""
    return shape_bytes_report(shape_str)[0]


def _split_top_level(tuple_str):
    """Split '(a, (b, c), d)' into top-level elements ['a', '(b, c)', 'd']."""
    s = tuple_str.strip()
    if not (s.startswith("(") and s.endswith(")")):
        return [s]
    s = s[1:-1]
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch in "({[":
            depth += 1
        elif ch in ")}]":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(s[start:i])
            start = i + 1
    parts.append(s[start:])
    return [p.strip() for p in parts if p.strip()]


def _start_bytes(op, shape_s):
    """Result payload of an async '-start' tuple shape.

    The tuple layout is op-specific (verified against compiled HLO):
    ``all-reduce-start`` has the SAME shape as the sync op — a flat tuple
    of results when XLA combined several all-reduces — so every buffer
    counts.  ``all-gather-start`` / ``reduce-scatter-start`` /
    ``collective-permute-start`` carry
    ``(operand(s), result(s), [u32 context scalars...])`` — count only
    the result element (itself possibly a tuple for grouped ops).
    Summing naively would double those (reduce-scatter-start used to fall
    into the generic fallback and did exactly that, inflating absolute
    KiB/step); taking the single largest buffer (the old rule)
    undercounts any grouped form.
    """
    parts = _split_top_level(shape_s)
    parts = [p for p in parts
             if not re.fullmatch(r"[su]32\[\]\S*", p)]  # context scalars
    if not parts:
        return 0
    if op == "all-reduce":
        return sum(shape_bytes(p) for p in parts)
    if op in ("all-gather", "reduce-scatter", "collective-permute") \
            and len(parts) >= 2:
        return shape_bytes(parts[1])
    # generic async wrapper: ((operands...), results, ctx) — a leading
    # tuple element marks the operand pack; otherwise flat results
    if len(parts) >= 2 and parts[0].startswith("("):
        return shape_bytes(parts[1])
    return sum(shape_bytes(p) for p in parts)


# HLO: '%dot.3 = f32[8,512]{1,0} dot(f32[8,128]{1,0} %a, ...),
#   lhs_contracting_dims={1}, rhs_contracting_dims={0}'
_HLO_DOT_RE = re.compile(
    r"=\s*([a-z][a-z0-9]+\[[0-9,]*\])\S*\s+dot\(\s*([a-z][a-z0-9]+\[[0-9,]*\])"
    r".*?lhs_contracting_dims=\{([0-9,]*)\}")
# HLO convolution: '%conv = f32[1,16,6,6]{...} convolution(
#   f32[1,3,8,8]{...} %x, f32[16,3,3,3]{...} %w), window={size=3x3},
#   dim_labels=bf01_oi01->bf01' — kernel dim roles from the middle
# dim_labels group (chars: o, i, spatial digits).
_HLO_CONV_RE = re.compile(
    r"=\s*([a-z][a-z0-9]+\[[0-9,]*\])\S*\s+convolution\("
    r"[^(]*?,\s*([a-z][a-z0-9]+\[[0-9,]*\])"
    r".*?dim_labels=[a-z0-9]+_([a-z0-9]+)->")
# label-less convolution fallbacks: the shapes alone, for lines whose
# dim_labels/dim_numbers metadata was stripped (debug dumps, minimized
# repros).  dim-role parsing stays the PREFERRED path — these only match
# after it fails, and the contraction is inferred from the conventional
# kernel layout (HLO 'oi01': output features FIRST; StableHLO
# '[0, 1, i, o]': output features LAST), cross-checked against the
# result shape before counting.
_HLO_CONV_NOLABEL_RE = re.compile(
    r"=\s*([a-z][a-z0-9]+\[[0-9,]*\])\S*\s+convolution\("
    r"[^(]*?,\s*([a-z][a-z0-9]+\[[0-9,]*\])")
_UNCOUNTED_RE = re.compile(r"((?<![-\w])convolution\(|(?<![-\w.])dot\()")
_UNCOUNTED_NAMES = {"convolution(": "convolution", "dot(": "dot"}


def _bracket_dims(spec):
    """'f32[8,128]' -> [8, 128]."""
    inner = spec[spec.index("[") + 1:spec.index("]")]
    return [int(d) for d in inner.split(",") if d]


def _bracket_dtype(spec):
    """'f32[8,128]' -> 'f32'."""
    return spec[:spec.index("[")]


def _prod(dims):
    n = 1
    for d in dims:
        n *= d
    return n


def _conv_contraction(rhs_dims, rhs_spec):
    """Per-output-element multiply count of a convolution: the kernel's
    ``i`` dim (already C_in / feature_group_count in both dialects) times
    its spatial dims.  ``rhs_spec`` is the kernel dim-role string — a
    stablehlo ``dim_numbers`` group like ``'0, 1, i, o'`` or an HLO
    ``dim_labels`` group like ``'oi01'``.  Returns None (-> uncounted)
    when the roles don't line up with the shape."""
    roles = [t for t in re.split(r"[,\s]+", rhs_spec.strip()) if t] \
        if "," in rhs_spec or " " in rhs_spec else list(rhs_spec.strip())
    if len(roles) != len(rhs_dims) or "i" not in roles:
        return None
    contraction = 1
    for role, dim in zip(roles, rhs_dims):
        if role != "o":
            contraction *= dim
    return contraction


def _conv_contraction_from_shapes(rhs_dims, out_dims, o_first):
    """Per-output-element multiply count of a LABEL-LESS convolution,
    inferred from the kernel and result shapes alone: contraction =
    prod(kernel dims) / output-feature dim.  The output-feature dim is
    taken from the conventional kernel layout of the dialect
    (``o_first`` True for HLO's ``oi01``, False for StableHLO's
    ``[0, 1, i, o]``), cross-checked against the result shape — a
    candidate ``o`` absent from the result dims falls back to the other
    end, and None (-> uncounted) when neither lines up.  Exact when the
    layout convention holds; a floor (never an overcount of the honest
    per-element work) otherwise, since every kernel element multiplies
    at most once per output element."""
    if not rhs_dims or not out_dims:
        return None
    ends = (0, -1) if o_first else (-1, 0)
    for end in ends:
        o = rhs_dims[end]
        if o in out_dims:
            return _prod(rhs_dims) // o
    return None


def dot_flops_report(program_text):
    """Matmul-FLOP accounting of compiled HLO text: ``{"flops", "dots",
    "uncounted_ops"}``, each ``dot(`` line 2 * result elements *
    contraction, each convolution its kernel's contraction (dim labels
    first, the label-less shape fallback after) — the reference's HLO
    rules."""
    total = 0
    dots = []
    uncounted = {}
    for line in program_text.splitlines():
        m = _HLO_DOT_RE.search(line)
        if m is not None:
            out = _bracket_dims(m.group(1))
            lhs = _bracket_dims(m.group(2))
            cdims = [int(d) for d in m.group(3).split(",") if d]
            flops = 2 * _prod(out) * _prod(lhs[d] for d in cdims)
            total += flops
            dots.append({"op": "dot", "dtype": _bracket_dtype(m.group(1)),
                         "flops": flops, "line": line.strip()})
            continue
        m = _HLO_CONV_RE.search(line)
        if m is not None:
            contraction = _conv_contraction(_bracket_dims(m.group(2)),
                                            m.group(3))
            if contraction is not None:
                out = _bracket_dims(m.group(1))
                flops = 2 * _prod(out) * contraction
                total += flops
                dots.append({"op": "convolution",
                             "dtype": _bracket_dtype(m.group(1)),
                             "flops": flops, "line": line.strip()})
                continue
        m = _HLO_CONV_NOLABEL_RE.search(line)
        if m is not None:
            contraction = _conv_contraction_from_shapes(
                _bracket_dims(m.group(2)), _bracket_dims(m.group(1)),
                o_first=True)
            if contraction is not None:
                out = _bracket_dims(m.group(1))
                flops = 2 * _prod(out) * contraction
                total += flops
                dots.append({"op": "convolution",
                             "dtype": _bracket_dtype(m.group(1)),
                             "flops": flops, "inferred": True,
                             "line": line.strip()})
                continue
        m = _UNCOUNTED_RE.search(line)
        if m is not None:
            name = _UNCOUNTED_NAMES[m.group(1)]
            uncounted[name] = uncounted.get(name, 0) + 1
    return {"flops": total, "dots": dots,
            "uncounted_ops": [{"op": k, "count": v}
                              for k, v in sorted(uncounted.items())]}

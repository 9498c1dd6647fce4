#!/usr/bin/env python
"""mxstat_torch — render and sanity-check the port's telemetry surfaces
(the counterpart of ``tools/mxstat_torch.py`` for ``mxnet_tpu_torch``).

The CLI half of ``mxnet_tpu_torch.obs``: the per-program MFU/roofline
table the captured programs accumulate (``obs.mfu_table()``, a
``mfu_table`` field in any JSON line), the metrics-registry exporters
(JSON-lines snapshot, Prometheus text) and the Chrome-trace timeline
export.  It imports neither jax nor the JAX package.

Usage:

* ``tools/mxstat_torch.py FILE.json`` — render the ``mfu_table`` found
  in a JSON object (``{"mfu_table": mt.obs.mfu_table()}`` dumped by a
  run, or a contract line carrying one) as a text table; a file of JSON
  lines works too (the last line with an ``mfu_table`` wins).
* ``tools/mxstat_torch.py --snapshot`` — print the current
  process-wide registry snapshot.
* ``tools/mxstat_torch.py --diff A.json B.json`` — headline / MFU /
  bytes deltas between two contract lines: the headline value, the
  byte-ish and rate extras, and a per-program join of the two
  ``mfu_table``s (bytes, flops, wall_s, mfu) with absolute and percent
  deltas.
* ``tools/mxstat_torch.py --smoke``   — tier-1 mode
  (``tests/test_torch_analysis.py`` runs it): drive the port's registry
  / timeline / roofline machinery end to end — concurrent
  counter increments, a histogram cross-checked against numpy, a
  ring-bounded timeline exported and re-parsed as Chrome-trace JSON, a
  JSON-lines registry round-trip, a Prometheus-text render, and an MFU
  table built from synthetic timings + static costs — then emit ONE
  contract JSON line on stdout (nonzero exit on any check failure).

Exit status: nonzero when a smoke check fails or no table is found.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def contract_line(metric, value, unit, vs_baseline, **extra):
    """The one-line stdout JSON contract: ``{"metric", "value", "unit",
    "vs_baseline", ...extras}``."""
    row = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": vs_baseline}
    row.update(extra)
    return json.dumps(row)


def _load_rows(path):
    """The last ``mfu_table`` found in a JSON file or JSON-lines file."""
    rows = None
    with open(path) as f:
        text = f.read()
    try:
        payloads = [json.loads(text)]
    except ValueError:
        payloads = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                payloads.append(json.loads(line))
            except ValueError:
                continue
    for obj in payloads:
        if isinstance(obj, dict):
            if isinstance(obj.get("mfu_table"), list):
                rows = obj["mfu_table"]
            elif obj.get("metric") and isinstance(obj.get("value"), list):
                rows = obj["value"]
    return rows


def _load_contract(path):
    """The last bench-contract object (has "metric" and "value") in a
    JSON or JSON-lines file; None when the file carries none."""
    with open(path) as f:
        text = f.read()
    try:
        payloads = [json.loads(text)]
    except ValueError:
        payloads = []
        for line in text.splitlines():
            line = line.strip()
            if line:
                try:
                    payloads.append(json.loads(line))
                except ValueError:
                    continue
    found = None
    for obj in payloads:
        if isinstance(obj, dict) and obj.get("metric") is not None \
                and "value" in obj:
            found = obj
    return found


def _delta_row(label, a, b):
    """One diff line: label, a, b, absolute delta, percent delta."""
    if not (isinstance(a, (int, float)) and isinstance(b, (int, float))):
        return [label, str(a), str(b), "-", "-"]
    d = b - a
    pct = ("%+.2f%%" % (100.0 * d / a)) if a else "-"
    fmt = "%+d" if isinstance(a, int) and isinstance(b, int) else "%+.4g"
    return [label, "%.6g" % a, "%.6g" % b, fmt % d, pct]


def _render_diff_table(rows):
    table = [["field", "a", "b", "delta", "pct"]] + rows
    widths = [max(len(r[i]) for r in table) for i in range(5)]
    lines = []
    for i, r in enumerate(table):
        lines.append("  ".join(c.rjust(w) if j else c.ljust(w)
                               for j, (c, w) in enumerate(zip(r, widths))))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


_EXTRA_SUFFIXES = (".ratio", ".count", "_ms", "_rate", "_pages",
                   "_outs", "_prefills", "_tokens_per_sec",
                   "vs_round_robin",
                   # capacity headlines and the GQA contract
                   # (bench_decode.py): tokens/s/GB and the grouped-KV
                   # ratios; the gqa_*bytes* fields match the byte rule
                   "_per_gb", "_vs_mha", "gqa_group",
                   # the bench_fleet.py --cold-start contract: per-host
                   # program readiness, warm AOT cache vs trace+compile
                   "cold_start_s", "cold_start_jit_s", "cold_start_vs_jit",
                   "aot_hits", "aot_misses", "aot_fallbacks",
                   "programs_loaded",
                   # the mxlint schedule/drift aggregates: async overlap
                   # structure and the differential gate's verdict ride
                   # the same trend lines as the byte ceilings
                   "_pairs", "_unpaired", "_serialized", "_shadow_flops",
                   "drift_checked", "drifted")


def _flatten_bytes_extras(obj, prefix=""):
    """The byte-ish / fleet-headline scalar extras of a contract line,
    flattened: opt_update_bytes.fused_bytes, dispatch_bytes.sort.bytes,
    p95_ttft_ms, router_cache_hit_rate, migrated_pages, ..."""
    out = {}
    for key, val in sorted((obj or {}).items()):
        if key in ("mfu_table",) or key.startswith("_"):
            continue
        name = prefix + key
        if isinstance(val, dict):
            out.update(_flatten_bytes_extras(val, name + "."))
        elif isinstance(val, (int, float)) and not isinstance(val, bool) \
                and ("bytes" in name
                     or name.endswith(_EXTRA_SUFFIXES)):
            out[name] = val
    return out


def diff(a_path, b_path, out=None):
    """Print headline/MFU/bytes deltas between two bench contracts.
    Returns 0, or 1 when either file carries no contract line."""
    out = out if out is not None else sys.stdout
    a = _load_contract(a_path)
    b = _load_contract(b_path)
    if a is None or b is None:
        print("no bench contract line found in %s"
              % (a_path if a is None else b_path), file=sys.stderr)
        return 1
    rows = []
    label = a["metric"] if a["metric"] == b["metric"] else \
        "%s -> %s" % (a["metric"], b["metric"])
    rows.append(_delta_row("headline: %s [%s]" % (label,
                                                  a.get("unit", "?")),
                           a.get("value"), b.get("value")))
    if a.get("vs_baseline") is not None \
            and b.get("vs_baseline") is not None:
        rows.append(_delta_row("vs_baseline", a["vs_baseline"],
                               b["vs_baseline"]))
    fa, fb = _flatten_bytes_extras(a), _flatten_bytes_extras(b)
    keys = sorted(set(fa) | set(fb))
    for k in keys:
        rows.append(_delta_row(k, fa.get(k, "-"), fb.get(k, "-")))
    # per-program mfu_table join
    ta = {r.get("program"): r for r in a.get("mfu_table") or []}
    tb = {r.get("program"): r for r in b.get("mfu_table") or []}
    for prog in sorted(set(ta) | set(tb)):
        ra, rb = ta.get(prog, {}), tb.get(prog, {})
        for col in ("bytes", "flops", "wall_s", "mfu",
                    "collective_bytes", "gather_bytes",
                    "sort_scatter_bytes"):
            va, vb = ra.get(col), rb.get(col)
            if va is None and vb is None:
                continue
            rows.append(_delta_row("%s.%s" % (prog, col),
                                   va if va is not None else "-",
                                   vb if vb is not None else "-"))
    print(_render_diff_table(rows), file=out)
    return 0


def smoke():
    """Synthetic end-to-end drive of the port's obs machinery."""
    import tempfile
    import threading

    import numpy as np

    from mxnet_tpu_torch.obs.metrics import MetricsRegistry
    from mxnet_tpu_torch.obs.roofline import (PEAK_FLOPS, ProgramAccounting,
                                              render_mfu_table)
    from mxnet_tpu_torch.obs.trace import TraceTimeline

    checks = {}

    # 1. concurrent counter increments sum exactly
    reg = MetricsRegistry()
    c = reg.counter("mx_smoke_ops", "smoke increments", labels=("who",))
    nthreads, per = 8, 5000

    def worker(i):
        child = c.labels(who="t%d" % (i % 2))
        for _ in range(per):
            child.inc()

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = sum(row["value"]
                for row in reg.snapshot()["mx_smoke_ops"]["series"])
    checks["counter_sum"] = total == nthreads * per

    # 2. histogram percentiles match numpy on random data
    h = reg.histogram("mx_smoke_latency", "smoke latencies")
    rng = np.random.RandomState(0)
    vals = rng.exponential(0.05, 1000)
    for v in vals:
        h.observe(v)
    checks["histogram_numpy"] = all(
        abs(h.percentile(q) - float(np.percentile(vals, q * 100))) < 1e-12
        for q in (0.5, 0.9, 0.95, 0.99))

    # 3. exporter round-trips + prometheus text renders the same values
    with tempfile.TemporaryDirectory(prefix="mxstat_smoke_") as tmp:
        path = os.path.join(tmp, "metrics.jsonl")
        reg.export_jsonl(path)
        with open(path) as f:
            back = json.loads(f.readlines()[-1])
        checks["jsonl_roundtrip"] = (
            back["metrics"]["mx_smoke_latency"]["series"][0]["value"]
            ["count"] == len(vals) and back["metrics"] == reg.snapshot())
        prom = reg.prometheus_text()
        checks["prometheus_text"] = (
            "mx_smoke_latency_count 1000" in prom
            and "# TYPE mx_smoke_ops counter" in prom)

        # 4. ring-bounded timeline -> valid chrome-trace JSON
        tl = TraceTimeline(capacity=256)
        for i in range(1000):
            with tl.span("step", cat="loop", args={"i": i}):
                tl.instant("tick", args={"i": i})
        checks["ring_bound"] = len(tl) == 256 and tl.dropped == 2000 - 256
        trace_path = os.path.join(tmp, "trace.json")
        tl.export(trace_path)
        with open(trace_path) as f:
            payload = json.load(f)
        evs = payload.get("traceEvents", [])
        checks["chrome_schema"] = bool(evs) and all(
            isinstance(e["name"], str) and e["ph"] in ("X", "i")
            and isinstance(e["ts"], int) and "pid" in e and "tid" in e
            and (e["ph"] != "X" or e["dur"] >= 0)
            and (e["ph"] != "i" or e.get("s") in ("t", "p", "g"))
            for e in evs)

    # 5. --diff round-trip: two synthetic bench contracts through the
    # real loader + table (jax-free), checking the joined deltas land
    import io

    with tempfile.TemporaryDirectory(prefix="mxstat_diff_") as tmp:
        a_line = {"metric": "resnet50_train_imgs_per_sec_bs256",
                  "value": 2442.6, "unit": "img/s", "vs_baseline": 13.45,
                  "opt_update_bytes": {"per_param_bytes": 1200,
                                       "fused_bytes": 1200,
                                       "ratio": 1.0},
                  "schedule_pairs": 6, "schedule_serialized": 0,
                  "drift_checked": 13, "drifted": 0,
                  "mfu_table": [{"program": "train_step", "calls": 10,
                                 "wall_s": 1.0, "flops": 100,
                                 "bytes": 1000, "mfu": 0.15}]}
        b_line = {"metric": "resnet50_train_imgs_per_sec_bs256",
                  "value": 2520.9, "unit": "img/s", "vs_baseline": 13.89,
                  "opt_update_bytes": {"per_param_bytes": 1200,
                                       "fused_bytes": 540,
                                       "ratio": 0.45},
                  "schedule_pairs": 4, "schedule_serialized": 2,
                  "drift_checked": 13, "drifted": 1,
                  "mfu_table": [{"program": "train_step", "calls": 10,
                                 "wall_s": 0.9, "flops": 100,
                                 "bytes": 800, "mfu": 0.17}]}
        pa = os.path.join(tmp, "a.json")
        pb = os.path.join(tmp, "b.json")
        with open(pa, "w") as f:
            f.write("not json\n" + json.dumps(a_line) + "\n")
        with open(pb, "w") as f:
            f.write(json.dumps(b_line))
        buf = io.StringIO()
        rc = diff(pa, pb, out=buf)
        text = buf.getvalue()
        checks["diff_exit"] = rc == 0
        checks["diff_headline"] = "+78.3" in text and "+3.21%" in text
        checks["diff_bytes"] = "opt_update_bytes.fused_bytes" in text \
            and "-660" in text and "-55.00%" in text
        checks["diff_programs"] = "train_step.bytes" in text \
            and "-200" in text
        # the mxlint schedule/drift aggregates flatten like byte fields
        checks["diff_schedule"] = "schedule_pairs" in text \
            and "schedule_serialized" in text and "+2" in text
        checks["diff_drift"] = "drifted" in text and "drift_checked" in text
        checks["diff_missing"] = diff(pa, os.devnull,
                                      out=io.StringIO()) == 1

    # 6. the MFU table joins timings with static costs
    acc = ProgramAccounting()
    for _ in range(10):
        acc.note("train_step", 0.01)
    acc.note("decode_step", 0.002)
    acc.set_static("train_step", flops=2.5e9, bytes=1.2e8)
    acc.set_static("decode_step", flops=1e7, bytes=4e6)
    rows = acc.table(peak_flops=PEAK_FLOPS["NVIDIA H100"]["bfloat16"])
    by_name = {r["program"]: r for r in rows}
    checks["mfu_rows"] = all(
        r["flops"] > 0 and r["bytes"] > 0 and r["wall_s"] > 0
        and r["mfu"] is not None and 0 <= r["mfu"] <= 1
        for r in rows) and set(by_name) == {"train_step", "decode_step"}
    print(render_mfu_table(rows), file=sys.stderr)

    failed = sorted(k for k, ok in checks.items() if not ok)
    print(contract_line(
        "mxstat_smoke_checks", len(checks), "checks",
        1.0 if not failed else 0.0, failed=failed,
        programs=len(rows)))
    return 1 if failed else 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mxstat_torch", description="render the port's per-program "
        "MFU/roofline table and telemetry exports")
    ap.add_argument("file", nargs="?", default=None,
                    help="JSON (or JSON-lines) file carrying an mfu_table "
                    "field")
    ap.add_argument("--smoke", action="store_true",
                    help="drive the registry/timeline/roofline machinery "
                    "synthetically and self-check")
    ap.add_argument("--snapshot", action="store_true",
                    help="print the process-wide metrics snapshot as JSON")
    ap.add_argument("--diff", nargs=2, metavar=("A.json", "B.json"),
                    default=None,
                    help="print headline/MFU/bytes deltas between two "
                    "bench JSON contracts")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    if args.smoke:
        return smoke()
    if args.diff:
        return diff(args.diff[0], args.diff[1])
    if args.snapshot:
        from mxnet_tpu_torch import obs

        print(json.dumps(obs.registry.snapshot(), indent=2))
        return 0
    if args.file is None:
        ap.print_help(sys.stderr)
        return 2
    rows = _load_rows(args.file)
    if not rows:
        print("no mfu_table found in %s" % args.file, file=sys.stderr)
        return 1
    from mxnet_tpu_torch.obs.roofline import render_mfu_table

    print(render_mfu_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""mxlint_torch — static program analysis over the port's canonical
programs (the counterpart of ``tools/mxlint.py`` for
``mxnet_tpu_torch``).

Builds the canonical programs on ``--device`` (default: the card;
``--smoke`` builds them on the CPU) — each driven as the reference's
canonical drive runs it, at the reference's small dims: the MLP's train and
eval steps, the dense LM's prefill and decode step, a mixed-length
speculative serve's int8 decode / draft / verify steps, a shared-prefix
paged serve's decode and verify steps, a grouped paged decode step and
the step of a ``fit`` under async checkpointing — traces each into a
:class:`~mxnet_tpu_torch.analysis.ProgramArtifact` (on fake tensors:
nothing runs) and runs the passes against the port's budget file
(``mxnet_tpu_torch/analysis/budgets.json``):

==================  =====================================================
pass                invariant it pins
==================  =====================================================
donation            buffers the program updates in place are written in
                    place by its graph
collective-budget   collective nodes <= the budget file (zero on one card)
retrace             one capture per program signature
host-sync           no ``.item()``, copies to the CPU or data-dependent
                    shapes in a program
flop-dtype          FLOP coverage; no f32 matmuls in bf16 programs; a
                    program that promises kernel B / B1 holds its
                    operator
cache-bytes         KV-cache bytes <= ceiling; narrow / paged / grouped
                    promises kept
tuner-coverage      kernel-module block / split constants governed by
                    their tuning space
schedule            compiled-HLO async pairs (a port program has no
                    compiled text: ``missing-surface``)
sharding-coverage   ``no-mesh`` on one card
drift               priced quantities vs a recorded snapshot (``--check``)
==================  =====================================================

``ring_tp_step`` and ``moe_train_step`` are mesh programs: the port's
mesh runs one eager rank a process and traces no single graph, so they
are reported as skipped programs with the reason (their multi-rank
artifacts are ROADMAP item 7 step 8).

Output: ONE json line on stdout — ``{"metric":
"mxlint_unsuppressed_findings", "value", "unit", "vs_baseline", ...}`` —
with the findings on stderr in the ``--format`` of choice (default
``jsonl``).  Exit codes: **0** clean or info-only findings; **1** at
least one unsuppressed error; **2** a usage or input error (an unknown
flag, an unreadable or hand-edited ``--check`` snapshot).

Workflow:

* ``python tools/mxlint_torch.py --smoke`` — every program on the CPU;
* ``python tools/mxlint_torch.py`` — the same on the card;
* ``--update-budgets`` — rewrite the budget file's per-program
  ceilings from this run (its suppressions are kept);
* ``--record PATH`` / ``--check PATH`` — write a content-addressed
  drift snapshot / hold this run against one;
* ``--programs decode_step --format text`` — a subset, readable.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def contract_line(metric, value, unit, vs_baseline, **extra):
    """The one-line stdout JSON contract: ``{"metric", "value", "unit",
    "vs_baseline", ...extras}``."""
    row = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": vs_baseline}
    row.update(extra)
    return json.dumps(row)


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="mxlint_torch", description="static analysis over the "
        "port's canonical programs")
    ap.add_argument("--smoke", action="store_true",
                    help="build every canonical program on the CPU")
    ap.add_argument("--device", default="",
                    help="device the programs are built on (default: "
                    "the card; --smoke: cpu)")
    ap.add_argument("--programs", default="",
                    help="comma-filter of canonical programs (default all)")
    ap.add_argument("--budgets", default="",
                    help="budget file path (default: MXNET_ANALYSIS_BUDGETS "
                    "or mxnet_tpu_torch/analysis/budgets.json)")
    ap.add_argument("--suppress", default="",
                    help="extra suppression patterns, comma-separated")
    ap.add_argument("--update-budgets", action="store_true",
                    help="rewrite the budget file's per-program ceilings "
                    "from this run's measurements and exit")
    ap.add_argument("--record", default="", metavar="PATH",
                    help="write a content-addressed drift snapshot of this "
                    "run's priced quantities to PATH")
    ap.add_argument("--check", default="", metavar="PATH",
                    help="load a drift snapshot and arm the drift pass")
    ap.add_argument("--format", default="jsonl", dest="fmt",
                    choices=("jsonl", "json", "github", "text"),
                    help="stderr finding format")
    ap.add_argument("--list", action="store_true", dest="list_only",
                    help="list canonical programs and passes, then exit")
    return ap.parse_args(argv)


def format_github(report, file="mxnet_tpu_torch/analysis/budgets.json"):
    """GitHub workflow-command annotations for every unsuppressed error
    or warning (info rows stay off)."""
    lines = []
    for f in report.unsuppressed:
        title = "%s(%s)%s" % (f.pass_name, f.program,
                              ":" + f.code if f.code else "")
        msg = (f.message.replace("%", "%25").replace("\r", "%0D")
               .replace("\n", "%0A"))
        lines.append("::%s file=%s,line=1,title=%s::%s"
                     % (f.severity, file, title, msg))
    return lines


def main(argv=None):
    try:
        args = _parse_args(argv if argv is not None else sys.argv[1:])
    except SystemExit as exc:
        return 2 if exc.code else 0

    from mxnet_tpu_torch import analysis
    from mxnet_tpu_torch.analysis import programs as canon

    if args.list_only:
        for name in canon.CANONICAL_PROGRAMS:
            print("program:", name)
        for p in analysis.default_passes():
            print("pass:", p.name)
        return 0

    snapshot = None
    if args.check:
        try:
            snapshot = analysis.load_snapshot(args.check)
        except (OSError, ValueError) as e:
            print("mxlint_torch: --check: %s" % e, file=sys.stderr)
            return 2

    device = args.device or ("cpu" if args.smoke else None)
    names = [n for n in args.programs.split(",") if n] or None
    unknown = [n for n in names or () if n not in canon.CANONICAL_PROGRAMS]
    if unknown:
        print("mxlint_torch: unknown program(s) %s; known: %s"
              % (unknown, list(canon.CANONICAL_PROGRAMS)), file=sys.stderr)
        return 2
    from mxnet_tpu_torch.programs import registry as progreg

    artifacts, notes, build_s = [], {}, {}
    for group in progreg.canonical_groups(names):
        t0 = time.perf_counter()
        arts, skipped = canon.build_canonical_artifacts(group,
                                                        device=device)
        build_s["+".join(group)] = round(time.perf_counter() - t0, 3)
        artifacts += arts
        notes.update(skipped)
    for prog, reason in notes.items():
        print(json.dumps({"skipped_program": prog, "reason": reason}),
              file=sys.stderr)

    budgets_path = args.budgets or None
    budgets = analysis.load_budgets(budgets_path)

    if args.update_budgets:
        path = analysis.resolve_budgets_path(budgets_path)
        programs = budgets.setdefault("programs", {})
        for art in artifacts:
            row = programs.setdefault(art.name, {})
            if art.meta.get("cache_bytes") is not None:
                row["cache_bytes"] = art.meta["cache_bytes"]
            row["collectives"] = {
                op: dict(v) for op, v in
                art.parsed()["collectives"].items()}
        with open(path, "w") as f:
            json.dump(budgets, f, indent=2, sort_keys=True)
            f.write("\n")
        print(json.dumps({"updated": os.path.relpath(path),
                          "programs": sorted(programs)}), file=sys.stderr)
        return 0

    report = analysis.run_passes(artifacts, budgets=budgets,
                                 suppressions=args.suppress,
                                 snapshot=snapshot)

    if args.record:
        snap = analysis.record_snapshot(artifacts, report)
        with open(args.record, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        print(json.dumps({"recorded": args.record,
                          "programs": sorted(snap["programs"]),
                          "content_hash": snap["content_hash"]}),
              file=sys.stderr)

    if args.fmt == "text":
        print(report.format_text(), file=sys.stderr)
    elif args.fmt == "json":
        print(report.to_json(), file=sys.stderr)
    elif args.fmt == "github":
        for line in format_github(report):
            print(line, file=sys.stderr)
    else:
        for f in report.findings:
            print(json.dumps(f.to_dict()), file=sys.stderr)

    drifted = sum(1 for f in report.findings
                  if f.pass_name == "drift"
                  and f.code.startswith("drift:") and not f.suppressed)
    s = report.summary()
    unsup = len(report.unsuppressed)
    print(contract_line(
        "mxlint_unsuppressed_findings", unsup, "findings",
        1.0 if unsup == 0 else 0.0,
        errors=s["errors"], warnings=s["warnings"],
        suppressed=s["suppressed"], programs=s["programs"],
        passes=s["passes"], skipped_programs=sorted(notes),
        device=str(device or "cuda:0"),
        kernel_ops={a.name: analysis.kernel_ops(a) for a in artifacts},
        costs={a.name: analysis.artifact_cost(a) for a in artifacts},
        build_s=build_s,
        drift_checked=len(artifacts) if snapshot is not None else 0,
        drifted=drifted))
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())

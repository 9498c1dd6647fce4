"""The pass framework: findings, suppressions, and run_passes (the port
of ``mxnet_tpu/analysis/framework.py``, as the reference has it).

A :class:`Pass` inspects a
:class:`~mxnet_tpu_torch.analysis.artifact.ProgramArtifact` (the traced
graph, its text, and metadata) and emits structured :class:`Finding`\\ s;
:func:`run_passes` drives every pass over every artifact and folds the
results into a :class:`Report` with severity ordering and suppression
support.  A report's JSON and text are the reference's for the same
findings.

Suppression syntax (budget file ``suppressions`` list, the
``MXNET_ANALYSIS_SUPPRESS`` env var, or the ``suppressions=`` argument):
``pass-name``, ``pass-name:program``, or ``pass-name:program:code`` —
``*`` wildcards any segment.  Suppressed findings stay in the report
(marked ``suppressed``) so an audit can see what was waived.
"""
from __future__ import annotations

import fnmatch
import json
from dataclasses import dataclass, field

__all__ = ["Finding", "Pass", "Report", "run_passes", "SEVERITIES"]

# severity order: index = badness.  "info" never fails a run.
SEVERITIES = ("info", "warning", "error")


@dataclass
class Finding:
    """One structured result of a pass over a program."""

    pass_name: str
    program: str
    severity: str           # "error" | "warning" | "info"
    message: str
    code: str = ""          # stable machine key for suppressions
    detail: dict = field(default_factory=dict)
    suppressed: bool = False

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError("severity %r not in %s"
                             % (self.severity, SEVERITIES))

    def to_dict(self):
        return {"pass": self.pass_name, "program": self.program,
                "severity": self.severity, "code": self.code,
                "message": self.message, "suppressed": self.suppressed,
                "detail": self.detail}

    def __str__(self):
        tag = " [suppressed]" if self.suppressed else ""
        code = ":" + self.code if self.code else ""
        return "%s%s %s(%s)%s: %s" % (self.severity.upper(), tag,
                                      self.pass_name, self.program, code,
                                      self.message)


class Pass:
    """Base class for analysis passes.

    Subclasses set ``name`` and implement :meth:`run`, returning a list of
    findings for one artifact.  ``requires`` names the artifact text
    surfaces the pass reads (``"graph"``, ``"exported"``, ``"compiled"``;
    a port artifact has no compiled text);
    run_passes emits an *info* finding instead of calling :meth:`run` when
    a required surface is missing, so a partially-built artifact degrades
    visibly rather than silently passing.
    """

    name = "pass"
    requires = ()

    def run(self, artifact, context):
        raise NotImplementedError

    def finding(self, artifact, severity, message, code="", **detail):
        return Finding(pass_name=self.name, program=artifact.name,
                       severity=severity, message=message, code=code,
                       detail=detail)


@dataclass
class AnalysisContext:
    """Shared state run_passes hands every pass."""

    budgets: dict = field(default_factory=dict)
    # parsed drift snapshot (``mxlint --check``); None = drift pass
    # reports "no snapshot loaded" info rows instead of comparing
    snapshot: dict = None

    def budget_for(self, program):
        return self.budgets.get("programs", {}).get(program)


class Report:
    """All findings of one :func:`run_passes` drive."""

    def __init__(self, findings, programs=(), passes=()):
        self.findings = list(findings)
        self.programs = list(programs)
        self.passes = list(passes)

    def _active(self):
        return [f for f in self.findings if not f.suppressed]

    @property
    def errors(self):
        return [f for f in self._active() if f.severity == "error"]

    @property
    def warnings(self):
        return [f for f in self._active() if f.severity == "warning"]

    @property
    def unsuppressed(self):
        """Actionable findings: unsuppressed errors + warnings (info rows
        are advisory and never fail a run)."""
        return [f for f in self._active() if f.severity != "info"]

    @property
    def suppressed(self):
        return [f for f in self.findings if f.suppressed]

    def ok(self):
        return not self.errors

    def summary(self):
        return {
            "programs": len(self.programs),
            "passes": len(self.passes),
            "findings": len(self.findings),
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "suppressed": len(self.suppressed),
            "unsuppressed": len(self.unsuppressed),
        }

    def to_json(self):
        return json.dumps({"summary": self.summary(),
                           "findings": [f.to_dict() for f in self.findings]})

    def format_text(self, include_info=True):
        lines = []
        order = {s: -i for i, s in enumerate(SEVERITIES)}
        for f in sorted(self.findings,
                        key=lambda f: (f.suppressed, order[f.severity],
                                       f.pass_name, f.program)):
            if not include_info and f.severity == "info":
                continue
            lines.append(str(f))
        s = self.summary()
        lines.append("%(errors)d error(s), %(warnings)d warning(s), "
                     "%(suppressed)d suppressed over %(programs)d "
                     "program(s) x %(passes)d pass(es)" % s)
        return "\n".join(lines)


def _parse_suppressions(spec):
    """Normalize a suppression spec (iterable or comma string) into
    (pass, program, code) glob triples."""
    if spec is None:
        return []
    if isinstance(spec, str):
        spec = [t for t in spec.split(",") if t.strip()]
    triples = []
    for token in spec:
        parts = [p.strip() or "*" for p in str(token).split(":")]
        while len(parts) < 3:
            parts.append("*")
        triples.append(tuple(parts[:3]))
    return triples


def _is_suppressed(finding, triples):
    for pat_pass, pat_prog, pat_code in triples:
        if fnmatch.fnmatchcase(finding.pass_name, pat_pass) \
                and fnmatch.fnmatchcase(finding.program, pat_prog) \
                and fnmatch.fnmatchcase(finding.code or "*", pat_code):
            return True
    return False


def default_passes():
    """Fresh instances of the ten shipped passes, in run order."""
    from .passes import (CacheBytesPass, CollectiveBudgetPass, DonationPass,
                         DriftPass, FlopDtypePass, HostSyncPass,
                         RetracePass, ShardingCoveragePass,
                         TunerCoveragePass)
    from .schedule import SchedulePass

    return [DonationPass(), CollectiveBudgetPass(), RetracePass(),
            HostSyncPass(), FlopDtypePass(), CacheBytesPass(),
            TunerCoveragePass(), SchedulePass(), ShardingCoveragePass(),
            DriftPass()]


_SURFACE_ATTR = {"graph": "graph_text", "exported": "exported_text",
                 "compiled": "compiled_text"}


def run_passes(artifacts, passes=None, budgets=None, suppressions=None,
               snapshot=None):
    """Drive ``passes`` (default: all shipped passes) over
    ``artifacts`` and return a :class:`Report`.

    ``budgets`` is the parsed budget file (``analysis/budgets.json``
    layout); its ``suppressions`` list, the ``MXNET_ANALYSIS_SUPPRESS``
    env var, and the ``suppressions`` argument all apply.  ``snapshot``
    is a parsed drift snapshot (``mxlint --check``) handed to the drift
    pass through the context.

    A budget-file suppression that matches NO finding of the run emits
    a ``stale-suppression`` info row (pass name ``suppressions``): the
    waived finding stopped firing, so the waiver is dead weight that
    would silently swallow the next regression of the same shape.
    Env/argument suppressions are local to the run and exempt.
    """
    from .. import config as _config

    if passes is None:
        passes = default_passes()
    budgets = budgets or {}
    budget_triples = _parse_suppressions(budgets.get("suppressions"))
    triples = list(budget_triples)
    triples += _parse_suppressions(_config.get("MXNET_ANALYSIS_SUPPRESS"))
    triples += _parse_suppressions(suppressions)

    context = AnalysisContext(budgets=budgets, snapshot=snapshot)
    findings = []
    for artifact in artifacts:
        for p in passes:
            missing = [s for s in p.requires
                       if getattr(artifact, _SURFACE_ATTR[s], None) is None]
            if missing:
                findings.append(p.finding(
                    artifact, "info",
                    "skipped: artifact lacks %s text" % "/".join(missing),
                    code="missing-surface", missing=missing))
                continue
            findings.extend(p.run(artifact, context))
    for f in findings:
        f.suppressed = _is_suppressed(f, triples)
    for triple in budget_triples:
        if any(_is_suppressed(f, [triple]) for f in findings):
            continue
        stale = Finding(
            pass_name="suppressions", program="*", severity="info",
            message="budget-file suppression %r matched no finding this "
            "run — the waived issue stopped firing; remove it from the "
            "budget file's suppressions list" % ":".join(triple),
            code="stale-suppression", detail={"pattern": list(triple)})
        stale.suppressed = _is_suppressed(stale, triples)
        findings.append(stale)
    return Report(findings, programs=[a.name for a in artifacts],
                  passes=[p.name for p in passes])

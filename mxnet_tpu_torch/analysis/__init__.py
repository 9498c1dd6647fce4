"""Static program analysis over traced graphs (the counterpart of
``mxnet_tpu/analysis``).

The framework's performance invariants — buffers updated in place, one
capture per program signature, no host syncs in a step, FLOP coverage
and no f32 matmuls in bf16 programs, KV-cache bytes, tuner coverage,
sharding coverage, drift against a snapshot — become static audits of
the programs' traced graphs, run on any device (the trace is on fake
tensors: nothing computes):

* :mod:`~mxnet_tpu_torch.analysis.graph_parse` — the parsing layer over
  FX graphs (the counterpart of ``hlo_parse.py``);
* :mod:`~mxnet_tpu_torch.analysis.artifact` — :class:`ProgramArtifact`,
  one program's traced graph + metadata, and
  :func:`artifact_from_export`, the one tracing function (``torch.export``, or
  ``make_fx`` for a body that calls autograd);
* :mod:`~mxnet_tpu_torch.analysis.framework` — :class:`Pass`,
  :class:`Finding`, suppression matching and :func:`run_passes`;
* :mod:`~mxnet_tpu_torch.analysis.passes` — the shipped passes and the
  drift-snapshot record / hash helpers;
* :mod:`~mxnet_tpu_torch.analysis.schedule` — the compiled-HLO schedule
  model and its pass (a port artifact has no compiled text: the pass
  reports ``missing-surface``);
* :mod:`~mxnet_tpu_torch.analysis.retrace` — :class:`RetraceAuditor`;
* :mod:`~mxnet_tpu_torch.analysis.programs` — the canonical programs'
  build functions, registered with ``programs.registry``.

Entry point: ``tools/mxlint_torch.py``; library use::

    from mxnet_tpu_torch import analysis
    report = analysis.run_passes(
        [module.program_artifacts()["train_step"]],
        budgets=analysis.load_budgets())
    assert report.ok(), report.format_text()
"""
from __future__ import annotations

import json
import os

from .artifact import ProgramArtifact, artifact_from_export, kernel_ops
from .cost import artifact_cost, aval_bytes, program_cost
from .framework import (Finding, Pass, Report, SEVERITIES, default_passes,
                        run_passes)
from .passes import (CacheBytesPass, CollectiveBudgetPass, DonationPass,
                     DriftPass, FlopDtypePass, HostSyncPass, RetracePass,
                     ShardingCoveragePass, TunerCoveragePass,
                     record_snapshot, snapshot_hash)
from .retrace import RetraceAuditor, arg_signature, signature_diff
from .schedule import ScheduleModel, SchedulePass, parse_schedule

__all__ = [
    "CacheBytesPass", "CollectiveBudgetPass", "DonationPass", "DriftPass",
    "Finding", "FlopDtypePass", "HostSyncPass", "Pass", "ProgramArtifact",
    "Report", "RetraceAuditor", "RetracePass", "SEVERITIES",
    "ScheduleModel", "SchedulePass", "ShardingCoveragePass",
    "TunerCoveragePass", "arg_signature", "artifact_cost",
    "artifact_from_export", "aval_bytes", "default_passes", "kernel_ops",
    "load_budgets", "load_snapshot", "parse_schedule", "program_cost",
    "record_snapshot", "resolve_budgets_path", "run_passes",
    "signature_diff", "snapshot_hash",
]

# the port's own budget file (never the JAX package's)
DEFAULT_BUDGETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "budgets.json")


def resolve_budgets_path(path=None):
    """The budget file location: explicit ``path`` argument, the
    ``MXNET_ANALYSIS_BUDGETS`` knob, the port's default
    (``mxnet_tpu_torch/analysis/budgets.json``) — the one resolution
    rule, shared by :func:`load_budgets` and ``tools/mxlint_torch.py
    --update-budgets`` so reads and writes cannot diverge."""
    from .. import config as _config

    return path or _config.get("MXNET_ANALYSIS_BUDGETS") or DEFAULT_BUDGETS


def load_budgets(path=None):
    """Parse the budget file (resolved by :func:`resolve_budgets_path`).
    A missing file returns ``{}``: the budget passes then report
    per-program "no committed budget" findings rather than crashing."""
    path = resolve_budgets_path(path)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_snapshot(path):
    """Parse a drift snapshot (``mxlint_torch --record`` output) and
    verify its content hash.

    A mismatch raises ``ValueError``: the baseline was hand-edited, and
    a gate whose baseline can be quietly nudged is no gate — intentional
    changes re-record through the tool.
    """
    with open(path) as f:
        snap = json.load(f)
    want = snap.get("content_hash")
    have = snapshot_hash(snap)
    if want != have:
        raise ValueError(
            "drift snapshot %s content hash mismatch (recorded %s, "
            "computed %s) — the file was edited by hand; re-record it "
            "with tools/mxlint_torch.py --record" % (path, want, have))
    return snap

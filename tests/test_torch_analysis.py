"""Static program analysis through the port (``mxnet_tpu_torch.analysis``)
held against the JAX package's (``mxnet_tpu.analysis``):

* the framework: the same findings give the same report JSON and text,
  suppressions (argument, env, budget file) and stale suppressions
  behave alike;
* each pass's error scenario on torch programs traced by the port's one
  tracing function (``artifact_from_export``): a dropped donation (and a donation
  through a detached alias, kernel B1's operator), a ``.item()`` and a
  copy to the CPU with the ``host_sync_allow`` sanction, an uncounted
  op, an f32 matmul in a bf16 program, a broken kernel promise, cache
  bytes over budget / an f32 cache under a quantized config / MHA under
  GQA, a collective outside its budget, a retrace with its signature
  diff, drift record / check / regression and a hand-edited snapshot
  refused, a missing surface;
* the canonical programs: ``prefill``, ``decode_step`` and
  ``ckpt_train_step`` priced exactly as the reference prices them and
  with the reference's finding codes, except the differences stated in
  :data:`PRICED_EXCEPTIONS` / :data:`CODE_EXCEPTIONS`; the kernel-armed
  programs (``train_step`` / ``eval_step``, the paged pair,
  ``gqa_decode_step``) against reference artifacts built with the
  Pallas knobs off, on the quantities no kernel changes;
* the new operators (kernels F, D, E and B1): their CPU implementations
  equal the plain versions, and ``torch.library.opcheck`` passes;
* ``tools/mxlint_torch.py`` and ``tools/mxstat_torch.py``: their smoke
  runs and exit-code contracts, in subprocesses.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu import analysis as janalysis
from mxnet_tpu import config as jconfig

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.analysis import passes as tpasses
from mxnet_tpu_torch.analysis.artifact import artifact_from_export
from mxnet_tpu_torch.ops import flash_kernel as fl
from mxnet_tpu_torch.ops import fused_kernel as fk
from mxnet_tpu_torch.ops import update_kernel as uk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HLO_DIR = os.path.join(ROOT, "tests", "data", "hlo")


# ---------------------------------------------------------------------------
# the framework: findings, reports, suppressions
# ---------------------------------------------------------------------------

FINDINGS = [
    ("donation", "prog", "error", "dropped", "dropped-donation", {"n": 1}),
    ("retrace", "prog", "info", "traced once", "no-retrace", {}),
    ("host-sync", "other", "warning", "a warning", "w-code", {"x": [1]}),
    ("cache-bytes", "other", "error", "over budget", "over-budget", {}),
    ("drift", "prog", "info", "no snapshot", "", {}),
]


def _pass_class(pkg):
    class Replay(pkg.Pass):
        """Emits the fixed findings of the artifact's program."""

        name = "replay"

        def run(self, artifact, context):
            out = []
            for pname, prog, sev, msg, code, detail in FINDINGS:
                if prog == artifact.name:
                    f = self.finding(artifact, sev, msg, code=code,
                                     **detail)
                    f.pass_name = pname
                    out.append(f)
            return out
    return Replay


def _report(pkg, budgets=None, suppressions=None):
    arts = [pkg.ProgramArtifact(name="prog"),
            pkg.ProgramArtifact(name="other")]
    return pkg.run_passes(arts, passes=[_pass_class(pkg)()],
                          budgets=budgets, suppressions=suppressions)


@pytest.mark.parametrize("budgets,suppressions", [
    (None, None),
    (None, "donation"),
    (None, "*:other"),
    (None, "cache-bytes:other:over-budget,host-sync:*:w-*"),
    ({"suppressions": ["donation:prog"]}, None),
    ({"suppressions": ["donation:nowhere", "retrace"]}, "cache-bytes"),
])
def test_report_json_and_text_match_reference(budgets, suppressions):
    """The same findings (through a pass that replays them) give the same
    report: JSON, text, summary, suppression marks, stale-suppression
    rows."""
    jrep = _report(janalysis, budgets, suppressions)
    trep = _report(tanalysis, budgets, suppressions)
    assert trep.to_json() == jrep.to_json()
    assert trep.format_text() == jrep.format_text()
    assert trep.format_text(include_info=False) == \
        jrep.format_text(include_info=False)
    assert trep.summary() == jrep.summary()
    assert trep.ok() == jrep.ok()


def test_env_suppression_matches_reference():
    with jconfig.overrides(MXNET_ANALYSIS_SUPPRESS="donation,host-sync"), \
            tconfig.overrides(MXNET_ANALYSIS_SUPPRESS="donation,host-sync"):
        jrep, trep = _report(janalysis), _report(tanalysis)
    assert trep.to_json() == jrep.to_json()
    assert len(trep.suppressed) == 2 and not any(
        f.code == "stale-suppression" for f in trep.findings)


def test_finding_severity_validated():
    with pytest.raises(ValueError):
        tanalysis.Finding(pass_name="p", program="x", severity="fatal",
                          message="m")


def test_missing_surface_is_shown():
    """An artifact without a graph: every pass that reads one reports a
    ``missing-surface`` info row instead of passing silently."""
    art = tanalysis.ProgramArtifact(name="partial")
    rep = tanalysis.run_passes(
        [art], passes=[tpasses.DonationPass(), tpasses.HostSyncPass(),
                       tpasses.FlopDtypePass(),
                       tpasses.CollectiveBudgetPass(),
                       tanalysis.SchedulePass()])
    assert {f.code for f in rep.findings} == {"missing-surface"}
    assert all(f.severity == "info" for f in rep.findings)
    assert len(rep.findings) == 5


# ---------------------------------------------------------------------------
# the passes' error scenarios on torch programs
# ---------------------------------------------------------------------------

def _art(fn, args, name="prog", autograd=False, **kw):
    return artifact_from_export(fn, args, name, autograd=autograd, **kw)


def _codes(rep):
    return {(f.severity, f.code) for f in rep.findings if not f.suppressed}


@pytest.mark.parametrize("autograd", [False, True])
def test_donation_dropped_and_kept(autograd):
    """A step that declares its buffer updated in place but returns a
    fresh tensor drops the donation; an in-place write keeps it."""
    def dropped(x, g):
        return x - 0.1 * g

    def kept(x, g):
        x.sub_(0.1 * g)
        return x

    args = (torch.randn(8), torch.randn(8))
    p = [tpasses.DonationPass()]
    rep = tanalysis.run_passes([_art(dropped, args, autograd=autograd,
                                     donated_leaves=1)], passes=p)
    assert _codes(rep) == {("error", "dropped-donation")}
    assert rep.errors[0].detail["aliased"] == 0
    rep = tanalysis.run_passes([_art(kept, args, autograd=autograd,
                                     donated_leaves=1)], passes=p)
    assert _codes(rep) == {("info", "aliased")}
    rep = tanalysis.run_passes([_art(kept, args, autograd=autograd)],
                               passes=p)
    assert _codes(rep) == {("info", "no-donation")}


@pytest.mark.parametrize("autograd", [False, True])
def test_donation_through_a_detached_alias(autograd):
    """Kernel B1's operator writes w, the slot and wc through a
    ``.detach()`` alias of the inputs (as a step under ``no_grad`` does):
    the writes are read from the operator's schema and followed back to
    the inputs; the gradient and the lr / wd blocks are not written."""
    def step(w, g, m, wc, lrb, wdb):
        with torch.no_grad():
            uk.multi_tensor_update("sgd", 1, w.detach(), g, (m.detach(),),
                                   wc.view(16, 128).detach(), lrb, wdb,
                                   (1.0, -1.0, 0.9))
        return w

    args = (torch.randn(16, 128), torch.randn(16, 128),
            torch.zeros(16, 128), torch.zeros(16 * 128,
                                              dtype=torch.bfloat16),
            torch.full((1,), 0.1), torch.zeros(1))
    art = _art(step, args, autograd=autograd, donated_leaves=3)
    parsed = art.parsed()
    assert [parsed["inputs"].index(n) for n in parsed["written_inputs"]] \
        == [0, 2, 3]
    assert tanalysis.kernel_ops(art) == {"multi_tensor_update": 1}
    rep = tanalysis.run_passes([art], passes=[tpasses.DonationPass()])
    assert _codes(rep) == {("info", "aliased")}


def test_host_sync_item_copy_and_sanction():
    """``.item()`` and a copy from the card to the CPU are host transfers
    (errors); a program's ``host_sync_allow`` downgrades them to visible
    ``sanctioned:`` info rows."""
    def item(x):
        return x * x.sum().item()

    def to_host(x):
        return x.cpu() + 1

    p = [tpasses.HostSyncPass()]
    rep = tanalysis.run_passes([_art(item, (torch.randn(4),))], passes=p)
    assert _codes(rep) == {("error", "item")}
    # meta tensors stand for the card's (the trace computes nothing)
    art = _art(to_host, (torch.randn(4, device="meta"),))
    rep = tanalysis.run_passes([art], passes=p)
    assert _codes(rep) == {("error", "d2h-copy")}
    art = _art(item, (torch.randn(4),), host_sync_allow=["item"])
    rep = tanalysis.run_passes([art], passes=p)
    assert _codes(rep) == {("info", "sanctioned:item")}
    rep = tanalysis.run_passes([_art(lambda x: x * 2, (torch.randn(4),))],
                               passes=p)
    assert _codes(rep) == {("info", "clean")}


def test_flop_pass_uncounted_op():
    def chain(a, b, c):
        return torch.einsum("ij,jk,kl->il", a, b, c)

    art = _art(chain, (torch.randn(2, 3), torch.randn(3, 4),
                       torch.randn(4, 5)))
    rep = tanalysis.run_passes([art], passes=[tpasses.FlopDtypePass()])
    assert _codes(rep) == {("error", "uncounted:aten.einsum")}


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, {("warning", "f32-dot")}),
    (torch.bfloat16, {("info", "covered")})])
def test_flop_pass_f32_matmul_in_bf16_program(dtype, want):
    def mm(x, w):
        return x @ w

    art = _art(mm, (torch.randn(4, 8, dtype=dtype),
                    torch.randn(8, 16, dtype=dtype)),
               compute_dtype="bfloat16")
    rep = tanalysis.run_passes([art], passes=[tpasses.FlopDtypePass()])
    assert _codes(rep) == want
    assert art.parsed()["flops"] == 2 * 4 * 8 * 16


def test_flop_pass_kernel_promises():
    """A program that promises kernel B or B1 must hold its operator."""
    p = [tpasses.FlopDtypePass()]
    plain = _art(lambda x: x * 2, (torch.randn(4),), decode_kernel=True)
    rep = tanalysis.run_passes([plain], passes=p)
    assert _codes(rep) == {("error", "kernel-fallback")}
    assert rep.errors[0].detail["op"] == "paged_decode"

    def step(w, g, lrb, wdb):
        uk.multi_tensor_update("sgd", 0, w, g, (), None, lrb, wdb,
                               (1.0, -1.0))
        return w

    args = (torch.randn(16, 128), torch.randn(16, 128),
            torch.full((1,), 0.1), torch.zeros(1))
    rep = tanalysis.run_passes([_art(step, args, update_kernel=True)],
                               passes=p)
    assert _codes(rep) == {("info", "kernel-update")}
    rep = tanalysis.run_passes(
        [_art(lambda w, g, lrb, wdb: w - g, args, update_kernel=True)],
        passes=p)
    assert _codes(rep) == {("error", "kernel-fallback")}


# cache-bytes scenarios: (meta, budgets) -> the same codes as the
# reference's pass on the same metadata
CACHE_CASES = {
    "no-cache": ({}, {}),
    "over-budget": ({"cache_bytes": 4096, "cache_data_dtypes": ["float32"]},
                    {"programs": {"prog": {"cache_bytes": 1024}}}),
    "within": ({"cache_bytes": 1024, "kv_dtype": "int8",
                "cache_data_dtypes": ["int8"], "cache_layout": "paged",
                "kv_paged": True},
               {"programs": {"prog": {"cache_bytes": 4096}}}),
    "f32-cache": ({"cache_bytes": 1024, "kv_dtype": "int8",
                   "cache_data_dtypes": ["float32"]},
                  {"programs": {"prog": {"cache_bytes": 4096}}}),
    "dense-under-paged": ({"cache_bytes": 64, "kv_paged": True,
                           "cache_layout": "dense"},
                          {"programs": {"prog": {"cache_bytes": 64}}}),
    "mha-under-gqa": ({"cache_bytes": 64, "num_kv_heads": 1,
                       "cache_kv_dims": [16],
                       "attn_dims": [{"num_heads": 4, "num_kv_heads": 1,
                                      "q_dim": 16, "kv_dim": 4}]},
                      {"programs": {"prog": {"cache_bytes": 64}}}),
    "no-budget": ({"cache_bytes": 64}, {}),
}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_bytes_pass_matches_reference(case):
    meta, budgets = CACHE_CASES[case]
    tart = _art(lambda x: x + 1, (torch.randn(4),), **meta)
    jart = janalysis.ProgramArtifact(name="prog", meta=dict(meta))
    trep = tanalysis.run_passes([tart], passes=[tpasses.CacheBytesPass()],
                                budgets=budgets)
    jrep = janalysis.run_passes([jart],
                                passes=[janalysis.CacheBytesPass()],
                                budgets=budgets)
    assert _codes(trep) == _codes(jrep)
    assert [f.detail for f in trep.findings] == \
        [f.detail for f in jrep.findings]


def test_cache_bytes_reads_torch_dtype_names():
    """The port's predictors record ``torch.int8``: a narrow plane."""
    art = _art(lambda x: x + 1, (torch.randn(4),), cache_bytes=8,
               kv_dtype="int8", cache_data_dtypes=["torch.int8"])
    rep = tanalysis.run_passes(
        [art], passes=[tpasses.CacheBytesPass()],
        budgets={"programs": {"prog": {"cache_bytes": 8}}})
    assert _codes(rep) == {("info", "within-budget")}


def _all_reduce(x):
    y = torch.ops._c10d_functional.all_reduce(x, "sum", "0")
    return torch.ops._c10d_functional.wait_tensor(y)


@pytest.mark.parametrize("budget,want", [
    (None, {("warning", "no-budget")}),
    ({"total": {"count": 1, "bytes": 100}},
     {("error", "unbudgeted-op"), ("info", "slack-budget")}),
    ({"total": {"count": 0, "bytes": 0},
      "all-reduce": {"count": 0, "bytes": 0}},
     {("error", "over-budget")}),
    ({"total": {"count": 1, "bytes": 32},
      "all-reduce": {"count": 1, "bytes": 32}},
     {("info", "within-budget")}),
    ({"total": {"count": 2, "bytes": 32},
      "all-reduce": {"count": 1, "bytes": 32},
      "all-gather": {"count": 1, "bytes": 32}},
     {("info", "stale-budget")}),
])
def test_collective_budget_pass(budget, want):
    """A functional all-reduce in a traced program, against its budget."""
    art = _art(_all_reduce, (torch.randn(8),), autograd=True)
    assert art.parsed()["collectives"]["all-reduce"] == {"count": 1,
                                                         "bytes": 32}
    budgets = {} if budget is None else \
        {"programs": {"prog": {"collectives": budget}}}
    rep = tanalysis.run_passes([art],
                               passes=[tpasses.CollectiveBudgetPass()],
                               budgets=budgets)
    assert _codes(rep) == want


def test_retrace_pass_catches_dtype_drift():
    """A GraphProgram driven at f32 twice, then at f64: two captures for
    one expected signature, the diff naming the leaf and the dtypes."""
    from mxnet_tpu_torch.programs import GraphProgram

    prog = GraphProgram("drifty", lambda x: x * 2)
    auditor = tanalysis.RetraceAuditor(prog)
    x32 = torch.arange(8, dtype=torch.float32)
    auditor.wrapped(x32)
    auditor.wrapped(x32)
    assert auditor.traces == 1
    auditor.wrapped(x32.double())
    assert auditor.traces == 2
    rec = auditor.record(expected_traces=1)
    assert rec["unique_signatures"] == 2 and rec["calls"] == 3
    assert any("float32 -> float64" in d for diff in rec["diffs"]
               for d in diff)
    art = tanalysis.ProgramArtifact(name="drifty", trace_count=2,
                                    expected_traces=1,
                                    meta={"retrace": rec})
    rep = tanalysis.run_passes([art], passes=[tpasses.RetracePass()])
    assert len(rep.errors) == 1
    assert "float32 -> float64" in rep.errors[0].message
    # a plain callable counts a trace at each new signature
    plain = tanalysis.RetraceAuditor(lambda x: x + 1)
    for x in (x32, x32, x32[:4]):
        plain.wrapped(x)
    assert plain.traces == 2
    ok = tanalysis.ProgramArtifact(name="ok", trace_count=1)
    rep = tanalysis.run_passes([ok, tanalysis.ProgramArtifact(name="b")],
                               passes=[tpasses.RetracePass()])
    assert [f.code for f in rep.findings] == ["no-retrace",
                                              "no-instrumentation"]


def test_signatures_match_reference_shape_and_dtype_fields():
    a = tanalysis.arg_signature((torch.zeros(2, 3), 5))
    b = tanalysis.arg_signature((torch.zeros(2, 4, dtype=torch.float64), 5))
    assert tanalysis.signature_diff(a, b) == [
        "leaf 0: shape (2, 3) -> (2, 4); dtype float32 -> float64"]
    assert tanalysis.signature_diff(a, a[:1]) == ["leaf count 2 != 1"]


def _drift_arts():
    def mm(x, w):
        return x @ w

    return [_art(mm, (torch.randn(4, 8), torch.randn(8, 16)), name="a"),
            _art(mm, (torch.randn(4, 8), torch.randn(8, 32)), name="b",
                 cache_bytes=100)]


def test_drift_record_check_and_regression(tmp_path):
    arts = _drift_arts()
    snap = tanalysis.record_snapshot(arts, tanalysis.run_passes(arts))
    assert snap["programs"]["a"]["dot_flops"] == 2 * 4 * 8 * 16
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(snap))
    loaded = tanalysis.load_snapshot(str(path))
    rep = tanalysis.run_passes(arts, passes=[tpasses.DriftPass()],
                               snapshot=loaded)
    assert _codes(rep) == {("info", "within-tolerance")}
    # a recorded baseline below this run's FLOPs (re-hashed): the run
    # regressed against it
    low = json.loads(json.dumps(snap))
    low["programs"]["b"]["dot_flops"] = int(
        low["programs"]["b"]["dot_flops"] / 1.1)
    low["programs"]["a"]["donated"] = 1
    low["programs"]["b"]["cache_bytes"] = 200
    low["content_hash"] = tanalysis.snapshot_hash(low)
    rep = tanalysis.run_passes(arts, passes=[tpasses.DriftPass()],
                               snapshot=low)
    errs = {(f.program, f.code) for f in rep.errors}
    assert errs == {("b", "drift:dot_flops"), ("a", "drift:donated")}
    assert any(f.code == "improved:cache_bytes" for f in rep.findings)
    # a program the snapshot lacks, and no snapshot at all
    rep = tanalysis.run_passes(
        arts + [_art(lambda x: x, (torch.randn(2),), name="c")],
        passes=[tpasses.DriftPass()], snapshot=loaded)
    assert ("warning", "new-program") in _codes(rep)
    rep = tanalysis.run_passes(arts, passes=[tpasses.DriftPass()])
    assert _codes(rep) == {("info", "no-snapshot")}
    # a hand edit without re-hashing is refused
    path.write_text(json.dumps(low).replace('"tolerance": 0.02',
                                            '"tolerance": 0.5'))
    with pytest.raises(ValueError, match="content hash mismatch"):
        tanalysis.load_snapshot(str(path))


def test_snapshot_hash_matches_reference():
    snap = {"version": 1, "tolerance": 0.02,
            "programs": {"p": {"dot_flops": 12, "donated": 2}}}
    assert tanalysis.snapshot_hash(snap) == janalysis.snapshot_hash(snap)


def test_suppression_by_env_and_budget_file_and_stale():
    art = _art(lambda x, g: x - g, (torch.randn(4), torch.randn(4)),
               donated_leaves=1)
    p = [tpasses.DonationPass()]
    with tconfig.overrides(MXNET_ANALYSIS_SUPPRESS="donation:prog"):
        rep = tanalysis.run_passes([art], passes=p)
    assert rep.errors == [] and len(rep.suppressed) == 1
    rep = tanalysis.run_passes(
        [art], passes=p, budgets={"suppressions": ["donation:*:dropped-*"]})
    assert rep.errors == [] and len(rep.suppressed) == 1
    rep = tanalysis.run_passes(
        [art], passes=p, budgets={"suppressions": ["donation:other"]})
    stale = [f for f in rep.findings if f.code == "stale-suppression"]
    assert len(stale) == 1 and stale[0].severity == "info"
    assert rep.errors[0].code == "dropped-donation"


def test_load_budgets_default_and_missing(tmp_path):
    budgets = tanalysis.load_budgets()
    assert tanalysis.resolve_budgets_path() == tanalysis.DEFAULT_BUDGETS
    assert os.path.dirname(tanalysis.DEFAULT_BUDGETS).endswith(
        os.path.join("mxnet_tpu_torch", "analysis"))
    # every budget-file suppression states its reason
    assert set(budgets["suppressions"]) == set(budgets["suppression_reasons"])
    assert tanalysis.load_budgets(str(tmp_path / "none.json")) == {}
    with tconfig.overrides(MXNET_ANALYSIS_BUDGETS=str(tmp_path / "x.json")):
        assert tanalysis.resolve_budgets_path() == str(tmp_path / "x.json")


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(HLO_DIR) if n.endswith(".hlo")))
def test_parse_schedule_matches_reference(name):
    from mxnet_tpu.analysis.schedule import parse_schedule as jparse

    with open(os.path.join(HLO_DIR, name)) as f:
        text = f.read()
    jm, tm = jparse(text), tanalysis.parse_schedule(text)
    assert tm.summary() == jm.summary()
    assert [p.to_dict() for p in tm.pairs] == [p.to_dict() for p in jm.pairs]
    art = tanalysis.ProgramArtifact(name="hlo", compiled_text=text)
    jart = janalysis.ProgramArtifact(name="hlo", compiled_text=text)
    trep = tanalysis.run_passes([art], passes=[tanalysis.SchedulePass()])
    jrep = janalysis.run_passes([jart], passes=[janalysis.SchedulePass()])
    assert trep.to_json() == jrep.to_json()


def test_tuner_coverage_and_sharding_on_the_kernel_modules():
    """The kernel modules' constants against their spaces: decode's
    MAX_SPLITS (the reference's split rule, kept for parity; the budget
    file waives it with its reason) and kernels C-E's single candidate
    show; the second artifact skips; no mesh anywhere."""
    arts = [_art(lambda x: x, (torch.randn(2),), name=n) for n in "ab"]
    rep = tanalysis.run_passes(
        arts, passes=[tpasses.TunerCoveragePass(),
                      tpasses.ShardingCoveragePass()],
        budgets=tanalysis.load_budgets())
    got = {(f.program, f.code, f.suppressed) for f in rep.findings}
    assert got == {("a", "unregistered-constant", True),
                   ("a", "single-candidate", False),
                   ("b", "already-ran", False),
                   ("a", "no-mesh", False), ("b", "no-mesh", False)}
    single = next(f for f in rep.findings if f.code == "single-candidate")
    assert single.detail["module"] == "flash_kernel"
    unreg = next(f for f in rep.findings
                 if f.code == "unregistered-constant")
    assert unreg.detail["missing"] == ["MAX_SPLITS"]
    assert rep.errors == []


# ---------------------------------------------------------------------------
# the canonical programs against the reference's
# ---------------------------------------------------------------------------

# priced quantities of the port's canonical programs that differ from the
# reference's, each with its reason
PRICED_EXCEPTIONS = {
    ("prefill", "gather_bytes"):
        "the port's graph holds 4 gathers, the reference's StableHLO 3: "
        "both walks gather the final LayerNorm's gamma and beta along "
        "their length-1 position axis (the positional-broadcast rule of "
        "decode.py); the reference's lowered program carries one of the "
        "two (1, 16, 16) f32 gathers, so the port prices 2048 bytes more",
    ("decode_step", "donated"):
        "the dense decode step writes its K/V rings in place and returns "
        "new lengths and tokens (the dense predictor runs eagerly, "
        "ROADMAP queue A item 3); the reference donates all four",
    ("decode_step", "aliased"): "as decode_step's donated",
    ("decode_step", "sort_scatter_bytes"):
        "the reference appends to its rings with a functional scatter "
        "whose result XLA aliases to the donated cache (priced 2x its "
        "bytes); the port writes the ring in place (no intermediate)",
    ("ckpt_train_step", "donated"):
        "the port's store is the slab plan's: one master, one gradient, "
        "one slot and one bf16 compute slab (4) plus the metric's two "
        "accumulators; the reference donates 4 parameters, 4 slots and "
        "the 2 accumulators",
    ("ckpt_train_step", "aliased"): "as ckpt_train_step's donated",
}

# finding codes (pass -> (reference's, the port's)) that differ, and why
CODE_EXCEPTIONS = {
    ("*", "schedule"): (
        {"sync-backend"}, {"missing-surface"},
        "a port artifact has no compiled text: the schedule pass shows "
        "the missing surface"),
    ("decode_step", "flop-dtype"): (
        {"covered"}, {"kernel-decode"},
        "the port's dense decode step attends through kernel B's "
        "operator and promises it; the reference's runs the einsum path "
        "(no promise)"),
    ("ckpt_train_step", "flop-dtype"): (
        {"covered"}, {"kernel-update"},
        "the port arms the slab plan wherever plan_for accepts the "
        "optimizer, so the step promises kernel B1; the reference's "
        "needs MXNET_PALLAS_UPDATE, off in its fit"),
}


@pytest.fixture(scope="module")
def canonical():
    """The three programs without a kernel promise in the reference,
    built by both packages' canonical drives (the port's on the CPU),
    with each package's default budgets."""
    from mxnet_tpu.analysis import programs as jprograms
    from mxnet_tpu_torch.analysis import programs as tprograms

    names = ["prefill", "decode_step", "ckpt_train_step"]
    jarts, _ = jprograms.build_canonical_artifacts(names)
    tarts, _ = tprograms.build_canonical_artifacts(names, device="cpu")
    jrep = janalysis.run_passes(jarts, budgets=janalysis.load_budgets())
    trep = tanalysis.run_passes(tarts, budgets=tanalysis.load_budgets())
    return ({a.name: a for a in jarts}, {a.name: a for a in tarts},
            jrep, trep)


@pytest.mark.parametrize("name", ["prefill", "decode_step",
                                  "ckpt_train_step"])
def test_canonical_priced_quantities_match_reference(canonical, name):
    jarts, tarts, _, _ = canonical
    want = janalysis.artifact_cost(jarts[name])
    got = tanalysis.artifact_cost(tarts[name])
    assert set(got) == set(want)
    differ = {k for k in want if got[k] != want[k]}
    assert differ == {k for (p, k) in PRICED_EXCEPTIONS if p == name}, \
        (got, want)


@pytest.mark.parametrize("name", ["prefill", "decode_step",
                                  "ckpt_train_step"])
def test_canonical_finding_codes_match_reference(canonical, name):
    _, _, jrep, trep = canonical

    def codes(rep):
        out = {}
        for f in rep.findings:
            if f.program == name:
                out.setdefault(f.pass_name, set()).add(f.code)
        return out

    jc, tc = codes(jrep), codes(trep)
    # tuner coverage is a repo-global scan landing on the first program
    for c in (jc, tc):
        c.pop("tuner-coverage", None)
    assert set(jc) == set(tc)
    for pass_name in jc:
        exc = CODE_EXCEPTIONS.get((name, pass_name)) \
            or CODE_EXCEPTIONS.get(("*", pass_name))
        if exc is not None:
            assert (jc[pass_name], tc[pass_name]) == exc[:2]
        else:
            assert tc[pass_name] == jc[pass_name], pass_name
    assert [f for f in trep.errors + trep.warnings if f.program == name] \
        == []


def test_kernel_programs_match_reference_kernel_free_quantities():
    """The kernel-armed programs against reference artifacts built with
    the Pallas knobs off, through the reference's public surfaces (a
    ``fit`` then ``Module.program_artifacts``; a paged and a grouped
    decode predictor's artifacts): FLOPs and cache bytes, which no
    kernel changes; the port's graphs hold the kernels' operators."""
    import mxnet_tpu as mx
    from mxnet_tpu.analysis import programs as jp
    from mxnet_tpu.decode import DecodePredictor as JPred
    from mxnet_tpu.decode import DecodeServer as JServer
    from mxnet_tpu_torch.analysis import programs as tp

    d = jp._MLP
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (d["batch"] * 2, d["features"])) \
        .astype(np.float32)
    y = rng.randint(0, d["classes"], (d["batch"] * 2,)).astype(np.float32)
    jmod = mx.mod.Module(jp._mlp_module()[0].symbol, context=mx.cpu(),
                         compute_dtype="bfloat16")
    with jconfig.overrides(MXNET_PALLAS_UPDATE="0"):
        jmod.fit(mx.io.NDArrayIter(x, y, batch_size=d["batch"]),
                 num_epoch=1, optimizer="sgd",
                 optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                 initializer=mx.initializer.Xavier())
        jmod.score(mx.io.NDArrayIter(x, y, batch_size=d["batch"]), "acc")
        jarts = jmod.program_artifacts()
    tarts, _ = tp.build_canonical_artifacts(
        ["train_step", "eval_step", "paged_decode_step",
         "paged_verify_step", "gqa_decode_step"], device="cpu")
    tarts = {a.name: a for a in tarts}
    for name in ("train_step", "eval_step"):
        assert tanalysis.artifact_cost(tarts[name])["dot_flops"] == \
            janalysis.artifact_cost(jarts[name])["dot_flops"]
    assert tanalysis.kernel_ops(tarts["train_step"]) == \
        {"multi_tensor_update": 1}

    lm = jp._LM
    for kv_heads, names in ((0, ("paged_decode_step", "paged_verify_step")),
                            (1, ("gqa_decode_step",))):
        kw = {"num_kv_heads": kv_heads} if kv_heads else {}
        sym = jp._lm_symbol(**kw)
        pred = JPred(sym, jp._lm_params(sym, lm["batch"], lm["seq_len"]),
                     cache_len=lm["seq_len"], temperature=0.0, kv_dtype="",
                     paged=True, page_tokens=4, prefill_chunk=4)
        srv = JServer(pred, max_prefill=12, slots=lm["batch"],
                      max_new_tokens=3)
        srv.submit(np.arange(7) % lm["vocab"])
        srv.run()
        state = pred.paged_batch_state(lm["batch"])
        for name in names:
            jart = pred.verify_artifact(state, jp._SPEC_K) \
                if "verify" in name else pred.decode_artifact(state)
            want = janalysis.artifact_cost(jart)
            got = tanalysis.artifact_cost(tarts[name])
            assert got["dot_flops"] == want["dot_flops"], name
            assert got["cache_bytes"] == want["cache_bytes"], name
            assert tanalysis.kernel_ops(tarts[name]).get("paged_decode") \
                == lm["layers"]


# ---------------------------------------------------------------------------
# the new operators
# ---------------------------------------------------------------------------

def _fused_case(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(24, 16, generator=g).to(dtype)
    w = (torch.randn(12, 16, generator=g) / 4).to(dtype)
    scale = 1 + 0.1 * torch.randn(16, generator=g)
    shift = 0.1 * torch.randn(16, generator=g)
    dy = torch.randn(24, 12, generator=g).to(dtype)
    return x, dy, scale, shift, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
def test_fused_bwd_operator_equals_plain(dtype, relu):
    x, dy, scale, shift, w = _fused_case(dtype)
    got = fk.fused_bwd_op(x, dy, scale, shift, w, relu)
    want = fk.fused_bwd_plain(x, dy, scale, shift, w, relu)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    torch.library.opcheck(fk.fused_bwd_op, (x, dy, scale, shift, w, relu))


@pytest.mark.parametrize("groups", [1, 2])
def test_flash_bwd_operators_equal_plain(groups):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(4, 24, 64, generator=g)
    k, v = (torch.randn(4 // groups, 24, 64, generator=g) for _ in "kv")
    do = torch.randn(4, 24, 64, generator=g)
    o, lse = fl.flash_fwd(q, k, v, 0.125, True, groups)
    delta = fl.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, 0.125, True, groups)
    dq = fl.flash_bwd_dq_op(*args)
    dk, dv = fl.flash_bwd_dkv_op(*args)
    want = fl.flash_plain_bwd(q, k, v, o, lse, do, 0.125, True, groups)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    torch.library.opcheck(fl.flash_bwd_dq_op, args)
    torch.library.opcheck(fl.flash_bwd_dkv_op, args)


@pytest.mark.parametrize("kind,nslots", [("sgd", 0), ("sgd", 1),
                                         ("adam", 2)])
@pytest.mark.parametrize("wc", [None, torch.bfloat16])
def test_multi_tensor_update_operator_equals_plain(kind, nslots, wc):
    g = torch.Generator().manual_seed(2)
    shape = (32, 128)
    w = torch.randn(shape, generator=g)
    grad = torch.randn(shape, generator=g)
    slots = [torch.rand(shape, generator=g) for _ in range(nslots)]
    wcs = None if wc is None else torch.empty(shape, dtype=wc)
    lrb, wdb = torch.tensor([0.1, 0.05]), torch.tensor([1e-4, 0.0])
    hyp = [0.5, -1.0, 0.9] if kind == "sgd" else [0.5, 0.3, 0.9, 0.999,
                                                   1e-8]
    ref = [w.clone()] + [s.clone() for s in slots] + \
        ([torch.empty(shape, dtype=wc)] if wc is not None else [])
    uk.multi_tensor_update_op(kind, nslots, w, grad, slots, wcs, lrb, wdb,
                              hyp, 16)
    uk.update_plain(kind, nslots, ref[0], grad, tuple(ref[1:1 + nslots]),
                    ref[-1] if wc is not None else None, lrb, wdb, hyp)
    got = [w] + slots + ([wcs] if wc is not None else [])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    torch.library.opcheck(uk.multi_tensor_update_op,
                          (kind, nslots, w, grad, slots, wcs, lrb, wdb,
                           hyp, 16))


def test_registered_gradients_go_through_the_operators():
    """A's gradient is F's operator and C's is D's and E's, on the CPU
    through their plain implementations: a traced backward holds them."""
    x, _, scale, shift, w = _fused_case()

    def step(x, scale, shift, w, q, k, v):
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, scale, shift, w, q, k, v)]
        with torch.enable_grad():
            y, s1, _ = fk.FusedLNLinearFn.apply(*leaves[:4], None, None,
                                                True, False)
            o = fl.FlashAttentionFn.apply(*leaves[4:], 0.125, True, 1,
                                          False)
            loss = y.sum() + s1.sum() + o.sum()
            return torch.autograd.grad(loss, leaves)

    q = torch.randn(2, 16, 64)
    art = _art(step, (x, scale, shift, w, q, q.clone(), q.clone()),
               autograd=True)
    assert tanalysis.kernel_ops(art) == {
        "fused_fwd": 1, "fused_bwd": 1, "flash_fwd": 1, "flash_bwd_dq": 1,
        "flash_bwd_dkv": 1}
    # the statistics' cotangent folds in: ysum's gradient reaches x
    p = art.parsed()
    assert p["flops"] == 2 * 24 * 16 * 12 * 3 + 4 * 2 * 16 * 16 * 64 * 3


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

def _tool(name, *args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, os.path.join(ROOT, "tools", name)]
                          + list(args), capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=timeout)


def _module(name):
    """A tool's module, loaded in this process (its ``main(argv)``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_%s_under_test" % name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mxlint_torch_smoke_and_exit_codes(tmp_path, capsys):
    """``--smoke`` (a subprocess) builds every canonical program on the
    CPU: exit 0, one contract line, the mesh programs skipped with their
    reason.  In process: a record / check round trip; 1 on an
    unsuppressed error (with its github annotation); 2 on a hand-edited
    snapshot and on an unknown flag."""
    out = _tool("mxlint_torch.py", "--smoke")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "mxlint_unsuppressed_findings"
    assert line["value"] == 0 and line["errors"] == 0
    assert line["programs"] == 11 and line["passes"] == 10
    assert line["skipped_programs"] == ["moe_train_step", "ring_tp_step"]
    assert line["kernel_ops"]["paged_decode_step"]["paged_decode"] == 1
    assert line["kernel_ops"]["train_step"] == {"multi_tensor_update": 1}
    assert "ROADMAP.md queue A item 7" in out.stderr

    main = _module("mxlint_torch").main
    snap = str(tmp_path / "snap.json")
    sub = ["--smoke", "--programs", "decode_step"]
    assert main(sub + ["--record", snap]) == 0
    capsys.readouterr()
    assert main(sub + ["--check", snap]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(got)["drift_checked"] == 1
    budgets = tmp_path / "budgets.json"
    budgets.write_text(json.dumps(
        {"programs": {"decode_step": {"cache_bytes": 1}}}))
    assert main(sub + ["--budgets", str(budgets), "--format",
                       "github"]) == 1
    assert "::error file=mxnet_tpu_torch/analysis/budgets.json" in \
        capsys.readouterr().err
    edited = json.load(open(snap))
    edited["tolerance"] = 0.9
    with open(snap, "w") as f:
        json.dump(edited, f)
    assert main(sub + ["--check", snap]) == 2
    assert main(["--no-such-flag"]) == 2


def test_mxstat_torch_smoke_and_render(tmp_path, capsys):
    out = _tool("mxstat_torch.py", "--smoke")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "mxstat_smoke_checks" and line["failed"] == []
    main = _module("mxstat_torch").main
    rows = [{"program": "train_step", "calls": 3, "wall_s": 0.6,
             "device_s": 0.59, "flops": 1e12, "bytes": 1e9, "mfu": 0.4}]
    path = tmp_path / "t.json"
    path.write_text("junk\n" + json.dumps({"mfu_table": rows}) + "\n")
    assert main([str(path)]) == 0
    assert "train_step" in capsys.readouterr().out
    empty = tmp_path / "e.json"
    empty.write_text("{}")
    assert main([str(empty)]) == 1
    with pytest.raises(SystemExit) as exc:
        main([str(path), "--no-such"])
    assert exc.value.code == 2


def test_program_cost_and_spec_probes_leave_counters_alone():
    """``ProgramSpec.cost`` / ``artifact`` and ``donated_leaves`` probe
    under ``probing``: no capture, no launch, no marker moves."""
    from mxnet_tpu_torch.programs import (GRAPH_STATS, GraphProgram,
                                          ProgramSpec)

    def body(x, acc):
        acc.add_(x.sum())
        return x @ x.t()

    prog = GraphProgram("probe", body)
    spec = ProgramSpec("probe", prog, abstract_args=(
        torch.randn(4, 8), torch.zeros(())), donate_argnums=(1,))
    before = dict(GRAPH_STATS), dict(fk.LAUNCHES), dict(uk.UPDATE_PATH)
    cost = spec.cost()
    art = spec.artifact()
    assert (dict(GRAPH_STATS), dict(fk.LAUNCHES), dict(uk.UPDATE_PATH)) \
        == before
    assert cost["flops"] == 2 * 4 * 8 * 4
    assert cost["bytes"] == (4 * 8 + 1 + 4 * 4) * 4
    assert spec.donated_leaves(spec.avals()) == 1
    assert art.donated_leaves == 1
    assert tanalysis.artifact_cost(art)["aliased"] == 1
    assert prog.traces == 0

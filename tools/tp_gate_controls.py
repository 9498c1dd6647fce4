"""Planted-fault controls for ``chip_smoke.py`` phase 21 (a)'s gate.

Phase 21 (a) trains the LM over a model axis of two ranks sharing one
CUDA card and holds every step's gathered parameters against
single-process runs, within ``CAPTURE_SPREAD`` times the widest of three
single-process spreads (``chip_smoke._tp_spread_bound``).  This script
shows what that gate catches: it runs the phase on the tree as it is,
then on copies of the tree with one fault planted in the
tensor-parallel walk (``mxnet_tpu_torch/parallel/tp_exec.py``), and
prints, for each run, every step's reading and bound in both tiers and
the gate's verdict.

The faults:

* ``gamma_beta_not_summed``: a column-parallel FusedLNLinear takes its
  LN gamma and beta without *f*, so F's partial sums over the local
  columns are never all-reduced;
* ``row_bias_every_rank``: the row-parallel FusedLNLinear (ffn2) adds
  its bias inside the kernel's epilogue on every rank, before *g*;
* ``row_partials_bf16``: the row-parallel segments' partial sums are
  rounded to bf16 before *g* (a precision slip of about 2^-9).

Each copy is made in a temporary directory outside the checkout and is
removed afterwards.  Run from the root of a checkout, on a machine with
a CUDA card::

    python3 tools/tp_gate_controls.py [--only NAME ...] [--out FILE]

It prints one ``tp control`` JSON line a run and exits 0 when the
unmodified tree passes the gate and every planted fault fails it.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join("mxnet_tpu_torch", "parallel", "tp_exec.py")

FAULTS = {
    "gamma_beta_not_summed": [(
        '''                if arg in ("data", "gamma", "beta"):
                    inputs.append(self.copy(k))''',
        '''                if arg == "data":
                    inputs.append(self.copy(k))
                elif arg in ("gamma", "beta"):
                    inputs.append(self.rep(k))''')],
    "row_bias_every_rank": [
        ('''                                [x, w, zero], [])''',
         '''                                [x, w, self.rep(self.key(
                                    entry["bias"]))], [])'''),
        ('''        out = self._bias_after(out, entry["bias"], out.dim() - 1)
''', '')],
    "row_partials_bf16": [(
        '''        out = C.reduce_from(part[0], self.tp.group)''',
        '''        out = C.reduce_from(part[0].bfloat16().float(),
                            self.tp.group)''')],
}

# run inside a tree: phase 21 (a)'s runs and gate, one JSON line out
_RUN = r'''
import json, torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_build()
reading, ranks = c._tp_measure(torch, torch.device("cuda", 0))
failed = c._tp_gate(reading, ranks)
steps = [{"step": st["step"], "tiers": {
    tier: {"reading": st["vs_single"][tier]["max"],
           "tensor": st["vs_single"][tier]["tensor"],
           "bound": c._tp_spread_bound(st, tier)}
    for tier in ("before_relu", "behind_relu")}}
    for st in reading["by_step"]]
print("TP_CONTROL_RESULT " + json.dumps({
    "card": reading["card"], "steps": steps, "failed": failed,
    "ranks": [{k: r[k] for k in ("rank", "losses", "step_s", "peak_bytes",
                                 "launches_per_step",
                                 "collectives_per_step")}
              for r in reading["ranks"]]}), flush=True)
'''


def plant(tree, edits):
    """Apply ``edits`` ((old, new) pairs, every occurrence) to the walk
    in ``tree``; each old text must be there."""
    path = os.path.join(tree, TARGET)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise SystemExit("fault text not found in %s:\n%s" % (TARGET,
                                                                 old))
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def run(tree, timeout):
    proc = subprocess.run([sys.executable, "-c", _RUN], cwd=tree,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        if line.startswith("TP_CONTROL_RESULT "):
            return json.loads(line[len("TP_CONTROL_RESULT "):])
    return {"error": "exit %d" % proc.returncode,
            "tail": proc.stdout[-3000:]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(FAULTS),
                    help="the faults to plant (default: all)")
    ap.add_argument("--out", help="also write the results to this file")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for each run")
    args = ap.parse_args(argv)
    names = args.only or list(FAULTS)
    results = []
    base = run(ROOT, args.timeout)
    base["control"] = "none"
    results.append(base)
    print("tp control: " + json.dumps(base), flush=True)
    for name in names:
        tmp = tempfile.mkdtemp(prefix="tp_control_")
        tree = os.path.join(tmp, "tree")
        try:
            shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(
                ".git", "__pycache__"))
            plant(tree, FAULTS[name])
            res = run(tree, args.timeout)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        res["control"] = name
        results.append(res)
        print("tp control: " + json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = "error" not in base and not base["failed"] and all(
        "error" not in r and r["failed"] for r in results[1:])
    print("tp controls: baseline %s, faults caught %s" % (
        "passed" if "error" not in base and not base["failed"]
        else "FAILED", {r["control"]: bool(r.get("failed"))
                        for r in results[1:]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

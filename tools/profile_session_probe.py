#!/usr/bin/env python3
"""Probe what torch.profiler records of the paged decode steps late in a
long run on the card.

Runs ``chip_smoke.py``'s phases up to the fleet (phase 14) and, in place
of phase 14 (d)'s kernel gate, opens ``--sessions`` profiling sessions of
their own, telemetry on and off in turns.  Each session prefills phase
5's first four prompts, takes one decode step, spins the card (a marker),
takes three decode steps and spins again; it prints the session's device
record: activities in all, marker spins, activities before the first
spin and between the two, and the first activity's start relative to the
first recorded spin (microseconds).  Then it exits.  Run from the
repository root on a machine with one CUDA card::

    python3 tools/profile_session_probe.py --sessions 40
"""
import argparse
import json
import os
import sys

import numpy as np


def _session(torch, c, pred, prompts):
    from torch.profiler import ProfilerActivity, profile

    batch = np.zeros((c.SLOTS, max(c.PROMPT_LENS[:c.SLOTS])), np.float32)
    for i in range(c.SLOTS):
        batch[i, :c.PROMPT_LENS[i]] = prompts[i]
    state, _ = pred.prefill(batch, np.asarray(c.PROMPT_LENS[:c.SLOTS]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = pred.step(state)
        torch.cuda.synchronize()
        c._guard(torch)
        for _ in range(3):
            state, _ = pred.step(state)
        torch.cuda.synchronize()
        c._guard(torch)
    device = sorted((e for e in prof.events()
                     if "CUDA" in str(getattr(e, "device_type", ""))),
                    key=lambda e: e.time_range.start)
    spins = [e.time_range for e in device if "spin_kernel" in e.name]
    out = {"device": len(device), "spins": len(spins)}
    if spins and device:
        out["first_start_us"] = device[0].time_range.start - spins[0].start
    if len(spins) == 2:
        out["before_first_spin"] = sum(
            1 for e in device if e.time_range.end <= spins[0].start)
        out["between"] = sum(
            1 for e in device if spins[0].end <= e.time_range.start
            and e.time_range.end <= spins[1].start)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sessions", type=int, default=40)
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    import chip_smoke as c

    def probe(torch_, pred, prompts, *_, **__):
        rows = []
        for i in range(args.sessions):
            c._telemetry(i % 2 == 0)
            rows.append(dict(_session(torch_, c, pred, prompts), session=i))
            print("session " + json.dumps(rows[-1]), flush=True)
        c._telemetry(True)
        complete = [r for r in rows if r["spins"] == 2]
        print("sessions: " + json.dumps({
            "sessions": len(rows), "with_both_spins": len(complete),
            "between": sorted({r["between"] for r in complete}),
            "before_first_spin": sorted({r["before_first_spin"]
                                         for r in complete})}), flush=True)
        raise SystemExit(0)

    c._step_kernel_reads = probe
    return c.main()


if __name__ == "__main__":
    sys.exit(main())

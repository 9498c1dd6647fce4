"""The port's tuning cache (``mxnet_tpu_torch.ops.tuning``) and the four
kernel spaces, on the CPU.

* The reference's ``tests/test_tuning.py`` cases on toy spaces whose
  runners are CPU functions: the card check is monkeypatched
  (``tuning.device_generation`` names a card), because on a CPU device
  ``resolve`` returns the defaults and reads no file.  Unarmed resolve,
  the sweep round trip, ``SpaceError`` skips, corrupt / stale / tampered
  entries, a cold subprocess at zero probes.
* The port's own rules: a candidate that disagrees with the plain
  version never wins; a miss during a (monkeypatched) graph capture
  returns the defaults unswept and unmemoized; a sweep leaves the
  kernels' launch counters and markers as it found them.
* ``shape_class_for`` / ``parse_shape_class`` against the JAX package's.
* With an empty cache every plan is the one the hand-fixed rules gave
  before the spaces existed: ``FUSED_PLANS`` and ``DECODE_PLANS`` below
  were printed from ``fused_kernel._plan`` / ``decode_kernel._plan``
  before they took the space's params; ``update_kernel.plan_for`` lays
  the slabs out as the JAX package does at ``BLOCK_ROWS`` 16, and at a
  tuned 32 as the JAX package does at 32.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_update as pu
from mxnet_tpu.ops import tuning as jtuning

from mxnet_tpu_torch import config
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import decode_kernel as dk
from mxnet_tpu_torch.ops import flash_kernel as fl
from mxnet_tpu_torch.ops import fused_kernel as fk
from mxnet_tpu_torch.ops import tuning
from mxnet_tpu_torch.ops import update_kernel as uk

CARD = "Toy_Card"


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A fresh cache directory, a clean memo and a card name for every
    test (the CPU resolves to the defaults without one)."""
    cache = str(tmp_path / "programs")
    monkeypatch.setattr(tuning, "device_generation",
                        lambda device=None: CARD)
    with config.overrides(MXNET_PROGRAM_CACHE=cache):
        tuning.reset_memo()
        yield cache
    tuning.reset_memo()


def _toy_space(calls, op="toy_kernel", wrong=()):
    """A 2-candidate toy space whose probes count invocations; the
    block=16 candidate's probe is measurably slower, so a sweep picks
    block=8.  Candidates in ``wrong`` fail their check."""
    def runner(params, shape_class, dtype, interpret):
        calls.append(dict(params))
        delay = 0.0 if params["block"] == 8 else 0.003

        def run():
            if delay:
                time.sleep(delay)

        share = 2.0 if params["block"] in wrong else 0.5
        return tuning.Probe(run, lambda: (share * 1e-5, share))

    tuning.register_space(
        op, version=1, defaults={"block": 8}, constants=("TOY_BLOCK",),
        candidates=lambda shape_class, interpret: [{"block": 8},
                                                   {"block": 16}],
        runner=runner)
    return calls


def _files(cache):
    return sorted(f for f in os.listdir(cache) if f.startswith("tune_"))


def test_unarmed_resolve_returns_defaults_without_probing(tune_cache):
    _toy_space([])
    before = tuning.PROBE_COUNT["n"]
    assert tuning.resolve("toy_kernel", "n64", "float32") == {"block": 8}
    assert tuning.PROBE_COUNT["n"] == before
    assert not os.path.exists(tune_cache)


def test_sweep_roundtrip_persists_and_reloads(tune_cache):
    calls = _toy_space([])
    with config.overrides(MXNET_PALLAS_TUNE=True):
        before = tuning.PROBE_COUNT["n"]
        params = tuning.resolve("toy_kernel", "n64", "float32")
        probes = tuning.PROBE_COUNT["n"] - before
    assert params == {"block": 8}          # the faster candidate won
    assert probes == 2 * (1 + 3)           # a warm-up and 3 timed runs each
    assert {c["block"] for c in calls} == {8, 16}

    # the decision persisted: a memo-less re-resolve (armed or not) is a
    # disk hit with ZERO probes
    tuning.reset_memo()
    before = tuning.PROBE_COUNT["n"]
    assert tuning.resolve("toy_kernel", "n64", "float32") == params
    assert tuning.PROBE_COUNT["n"] == before

    # and the record is honest about what it swept
    (name,) = _files(tune_cache)
    entry = json.load(open(os.path.join(tune_cache, name)))
    assert entry["op"] == "toy_kernel" and entry["device"] == CARD
    assert entry["params"] == {"block": 8}
    assert [r["params"] for r in entry["swept"]] == [{"block": 8},
                                                     {"block": 16}]
    assert all(r["ms"] > 0 and r["tol_share"] == 0.5
               for r in entry["swept"])
    assert name == tuning.cache_key("toy_kernel", "n64", "float32", 1,
                                    device=CARD) + ".json"


def test_sweep_skips_space_error_candidates(tune_cache):
    def runner(params, shape_class, dtype, interpret):
        if params["block"] == 8:
            raise tuning.SpaceError("block does not tile")
        return lambda: None

    tuning.register_space(
        "toy_gated", version=1, defaults={"block": 8}, constants=(),
        candidates=lambda shape_class, interpret: [{"block": 8},
                                                   {"block": 16}],
        runner=runner)
    with config.overrides(MXNET_PALLAS_TUNE=True):
        assert tuning.resolve("toy_gated", "n64", "float32") == \
            {"block": 16}
    entry = json.load(open(os.path.join(tune_cache,
                                        _files(tune_cache)[0])))
    assert [r["params"] for r in entry["swept"]] == [{"block": 16}]


def test_wrong_candidate_never_wins(tune_cache, caplog):
    """The faster candidate fails its check against the plain version:
    it is recorded, warned about, and the slower one wins."""
    _toy_space([], wrong=(8,))
    with config.overrides(MXNET_PALLAS_TUNE=True):
        assert tuning.resolve("toy_kernel", "n64", "float32") == \
            {"block": 16}
    assert "disagrees with the plain version" in caplog.text
    entry = json.load(open(os.path.join(tune_cache,
                                        _files(tune_cache)[0])))
    assert [r["tol_share"] for r in entry["swept"]] == [2.0, 0.5]


@pytest.mark.parametrize("damage", ["corrupt", "stale", "tampered"])
def test_bad_entry_reads_as_defaults(tune_cache, damage, caplog):
    """A corrupt or stale record reads as a miss with a visible warning;
    a tampered one keeps its known keys and drops the rest."""
    _toy_space([])
    if damage == "tampered":
        tuning.put("toy_kernel", "n64", "float32",
                   {"block": 16, "evil_extra": 1}, version=1)
        assert tuning.resolve("toy_kernel", "n64", "float32") == \
            {"block": 16}
        return
    with config.overrides(MXNET_PALLAS_TUNE=True):
        tuning.resolve("toy_kernel", "n64", "float32")
    path = os.path.join(tune_cache, _files(tune_cache)[0])
    if damage == "corrupt":
        with open(path, "w") as f:
            f.write("{not json")
    else:
        entry = json.load(open(path))
        entry["version"] = 99   # a rewritten kernel's space
        entry["params"] = {"block": 16}
        with open(path, "w") as f:
            json.dump(entry, f)
    tuning.reset_memo()
    before = tuning.PROBE_COUNT["n"]
    assert tuning.resolve("toy_kernel", "n64", "float32") == {"block": 8}
    assert tuning.PROBE_COUNT["n"] == before
    assert "corrupt or stale" in caplog.text


def test_cpu_device_resolves_defaults_and_reads_no_file(tmp_path,
                                                         monkeypatch):
    """No kernel runs on the CPU: a winner on disk for a card is not
    read for a CPU tensor, and nothing sweeps there."""
    _toy_space([])
    with config.overrides(MXNET_PROGRAM_CACHE=str(tmp_path),
                          MXNET_PALLAS_TUNE=True):
        tuning.reset_memo()
        assert tuning.device_generation(torch.device("cpu")) is None
        assert tuning.sweep_mode(torch.device("cpu")) == (False, False)
        gen = "cpu_has_no_card"
        tuning.put("toy_kernel", "n64", "float32", {"block": 16},
                   version=1, device=gen)
        monkeypatch.setattr(tuning, "get", lambda *a, **k: pytest.fail(
            "resolve read the cache for a CPU device"))
        before = tuning.PROBE_COUNT["n"]
        assert tuning.resolve("toy_kernel", "n64", "float32",
                              device=torch.device("cpu")) == {"block": 8}
        assert tuning.PROBE_COUNT["n"] == before


def test_miss_under_capture_returns_defaults_unswept(tune_cache,
                                                     monkeypatch, caplog):
    """A sweep would synchronize inside a CUDA graph capture: the miss
    returns the defaults without probing and without memoizing them, so
    the next resolve outside the capture sweeps."""
    calls = _toy_space([])
    monkeypatch.setattr(tuning, "_capturing", lambda: True)
    with config.overrides(MXNET_PALLAS_TUNE=True):
        before = tuning.PROBE_COUNT["n"]
        assert tuning.resolve("toy_kernel", "n64", "float32") == \
            {"block": 8}
        assert tuning.PROBE_COUNT["n"] == before and calls == []
        assert "being captured" in caplog.text
        assert not os.path.exists(tune_cache)
        monkeypatch.setattr(tuning, "_capturing", lambda: False)
        tuning.resolve("toy_kernel", "n64", "float32")
        assert tuning.PROBE_COUNT["n"] > before and len(calls) == 2


def test_sweep_restores_kernel_counters_and_markers(tune_cache):
    """Probes launch kernels; the main path's counts must not see them."""
    def runner(params, shape_class, dtype, interpret):
        def run():
            fk.LAUNCHES["fused_fwd"] += 1
            fk.LAST_VARIANT["fused_fwd"] = "probe"
            dk.LAUNCHES["paged_decode"] += 1
            uk.UPDATE_PATH["last"] = "probe"
        return run

    tuning.register_space(
        "toy_launcher", version=1, defaults={"block": 8}, constants=(),
        candidates=lambda shape_class, interpret: [{"block": 8}],
        runner=runner)
    before = (dict(fk.LAUNCHES), dict(fk.LAST_VARIANT), dict(dk.LAUNCHES),
              dict(uk.UPDATE_PATH))
    with config.overrides(MXNET_PALLAS_TUNE=True):
        tuning.resolve("toy_launcher", "n64", "float32")
    assert (dict(fk.LAUNCHES), dict(fk.LAST_VARIANT), dict(dk.LAUNCHES),
            dict(uk.UPDATE_PATH)) == before


@pytest.mark.parametrize("dims", [
    {"m": 1000, "k": 64, "n": 256}, {"m": 1, "k": 0, "n": 3},
    {"n": 25557032}, {"m": 128, "tq": 9, "g": 4}, {"t": 2048, "d": 128}])
def test_shape_class_matches_jax(dims):
    sc = tuning.shape_class_for(**dims)
    assert sc == jtuning.shape_class_for(**dims)
    assert tuning.parse_shape_class(sc) == jtuning.parse_shape_class(sc)


def test_cache_key_matches_jax_format():
    """The same key derivation as the JAX package's (the port's entries
    live in a directory of their own, so the two never meet)."""
    args = ("op", "m256", "float32", 3)
    assert tuning.cache_key(*args, device="X") == \
        jtuning.cache_key(*args, device="X")


_CHILD = textwrap.dedent("""
    import json, sys, time
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.ops import tuning

    tuning.device_generation = lambda device=None: "Toy_Card"
    tuning.register_space(
        "toy_kernel", version=1, defaults={"block": 8}, constants=(),
        candidates=lambda sc, interpret: [{"block": 8}, {"block": 16}],
        runner=lambda params, sc, dtype, interpret: (lambda: None))
    cache, payload = sys.argv[1], json.loads(sys.argv[2])
    spaces = tuning.spaces()
    with config.overrides(MXNET_PROGRAM_CACHE=cache):
        before = tuning.PROBE_COUNT["n"]
        out = [tuning.resolve(op, sc, dt) for op, sc, dt in payload]
        print(json.dumps({"probes": tuning.PROBE_COUNT["n"] - before,
                          "params": out}))
""")


def test_cold_process_zero_probe_cache_hit(tune_cache):
    """Sweep a toy space here, put a winner for each real space, then a
    cold subprocess sharing only the cache directory resolves all of
    them with PROBE_COUNT == 0 and the same params."""
    _toy_space([], wrong=(8,))
    with config.overrides(MXNET_PALLAS_TUNE=True):
        warm = [tuning.resolve("toy_kernel", "n64", "float32")]
    assert warm == [{"block": 16}]
    cases = [("toy_kernel", "n64", "float32")]
    winners = {"fused_kernel": {"fwd_side": 64, "dx_side": 32,
                                "dw_side": 128, "dw_splits": 2},
               "decode_kernel": {"blocks_per_sm": 8, "min_split_tokens": 16,
                                 "max_splits": 4},
               "flash_kernel": dict(fl.TUNE_DEFAULTS),
               "update_kernel": {"block_rows": 32}}
    for op, sc, dt in (("fused_kernel", "k1024,m16384,n4096", "float32"),
                       ("decode_kernel", "m128,tq1", "any"),
                       ("flash_kernel", "d128,g1,t2048", "float32"),
                       ("update_kernel", "n33554432", "any")):
        tuning.put(op, sc, dt, winners[op],
                   version=tuning.spaces()[op].version)
        cases.append((op, sc, dt))
        warm.append(winners[op])
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, tune_cache, json.dumps(cases)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"probes": 0, "params": warm}


def test_spaces_hold_the_four_port_spaces():
    spaces = tuning.spaces()
    for op, sources in (("fused_kernel", ("fused_fwd", "fused_bwd")),
                        ("decode_kernel", ("paged_decode",)),
                        ("flash_kernel", ("flash_attention",)),
                        ("update_kernel", ("multi_tensor_update",))):
        sp = spaces[op]
        assert sp.defaults and sp.constants and sp.sources == sources
        # the version carries the kernel sources' digest
        base, digest = sp.version.split("+")
        assert base == "1" and len(digest) == 12
        # every candidate names only the space's params, the defaults
        # first
        cands = sp.candidates("k1024,m16384,n4096,t2048,d128,g1,tq1,n1",
                              False)
        assert cands[0] == sp.defaults
        assert all(set(c) <= set(sp.defaults) for c in cands)
    assert spaces["update_kernel"].defaults == {"block_rows": 16}
    assert spaces["flash_kernel"].candidates("d128,g1,t2048", False) == \
        [fl.TUNE_DEFAULTS]


# today's plans, printed from _plan before it took the space's params:
# (m, k, n, dtype, product, aligned, variant, splits) and
# ((b, tq, heads, kv_heads, hd_k, hd_v, m, pt, sms, aligned), Plan)
FUSED_PLANS = [
    (4, 1024, 1024, 'float32', 'fwd', True, 'decode', 1),
    (4, 1024, 4096, 'float32', 'fwd', True, 'decode', 1),
    (4, 4096, 1024, 'float32', 'fwd', True, 'decode', 1),
    (36, 1024, 1024, 'float32', 'fwd', True, 'simt32', 1),
    (36, 1024, 4096, 'float32', 'fwd', True, 'simt32', 1),
    (36, 4096, 1024, 'float32', 'fwd', True, 'simt32', 1),
    (256, 1024, 1024, 'float32', 'fwd', True, 'simt32', 1),
    (256, 1024, 4096, 'float32', 'fwd', True, 'simt64', 1),
    (256, 4096, 1024, 'float32', 'fwd', True, 'simt32', 1),
    (256, 1024, 4096, 'bfloat16', 'fwd', True, 'mma64', 1),
    (16384, 1024, 1024, 'float32', 'fwd', True, 'simt128', 1),
    (16384, 1024, 1024, 'float32', 'dx', True, 'simt128', 1),
    (16384, 1024, 1024, 'float32', 'dw', True, 'simt128', 4),
    (16384, 1024, 4096, 'float32', 'fwd', True, 'simt128', 1),
    (16384, 1024, 4096, 'float32', 'dx', True, 'simt128', 1),
    (16384, 1024, 4096, 'float32', 'dw', True, 'simt128', 1),
    (16384, 4096, 1024, 'float32', 'fwd', True, 'simt128', 1),
    (16384, 4096, 1024, 'float32', 'dx', True, 'simt128', 1),
    (16384, 4096, 1024, 'float32', 'dw', True, 'simt128', 1),
    (16384, 1024, 1024, 'bfloat16', 'fwd', True, 'wgmma128', 1),
    (16384, 1024, 1024, 'bfloat16', 'dx', True, 'mma128', 1),
    (16384, 1024, 1024, 'bfloat16', 'dw', True, 'mma128', 4),
    (16384, 1024, 4096, 'bfloat16', 'fwd', True, 'wgmma128', 1),
    (16384, 1024, 4096, 'bfloat16', 'dx', True, 'mma128', 1),
    (16384, 1024, 4096, 'bfloat16', 'dw', True, 'mma128', 1),
    (16384, 4096, 1024, 'bfloat16', 'fwd', True, 'wgmma128', 1),
    (16384, 4096, 1024, 'bfloat16', 'dx', True, 'mma128', 1),
    (16384, 4096, 1024, 'bfloat16', 'dw', True, 'mma128', 1),
    (16384, 2048, 512, 'bfloat16', 'fwd', True, 'wgmma128', 1),
    (16384, 2048, 512, 'bfloat16', 'dw', True, 'mma128', 4),
    (2048, 64, 256, 'float32', 'dw', True, 'simt128', 2),
    (256, 1024, 4096, 'float32', 'fwd', False, 'simt64_scalar', 1),
    (36, 30, 50, 'bfloat16', 'fwd', True, 'simt32_scalar', 1),
    (4, 30, 50, 'float32', 'fwd', True, 'decode_scalar', 1),
    (16384, 30, 50, 'float32', 'dw', True, 'simt128_scalar', 16),
]
DECODE_PLANS = [
    ((4, 1, 4, 4, 256, 256, 128, 16, 132, True), ('decode', 0, 32, 4, 1, 1, 8, 512)),
    ((4, 1, 4, 1, 256, 256, 128, 16, 132, True), ('decode', 0, 64, 2, 4, 1, 8, 256)),
    ((4, 1, 4, 2, 256, 256, 128, 16, 132, True), ('decode', 0, 64, 2, 4, 1, 8, 512)),
    ((4, 1, 8, 8, 128, 128, 128, 16, 132, True), ('decode', 0, 16, 8, 1, 1, 4, 512)),
    ((4, 1, 8, 2, 128, 128, 128, 16, 132, True), ('decode', 0, 64, 2, 4, 1, 4, 512)),
    ((4, 9, 4, 4, 256, 256, 128, 16, 132, True), ('decode', 0, 11, 12, 4, 3, 8, 528)),
    ((4, 9, 4, 1, 256, 256, 128, 16, 132, True), ('decode', 0, 15, 9, 4, 9, 8, 540)),
    ((4, 9, 4, 2, 256, 256, 128, 16, 132, True), ('decode', 0, 13, 10, 4, 5, 8, 520)),
    ((4, 9, 8, 8, 128, 128, 128, 16, 132, True), ('decode', 0, 6, 22, 4, 3, 4, 576)),
    ((4, 9, 8, 2, 128, 128, 128, 16, 132, True), ('decode', 0, 8, 16, 4, 9, 4, 576)),
    ((4, 256, 4, 4, 256, 256, 128, 16, 132, True), ('chunk', 1, 9, 15, 64, 4, 8, 576)),
    ((4, 256, 4, 4, 256, 256, 128, 16, 132, False), ('decode', 0, 1, 128, 4, 64, 8, 1024)),
    ((4, 256, 4, 1, 256, 256, 128, 16, 132, True), ('chunk', 1, 9, 15, 64, 16, 8, 576)),
    ((4, 256, 4, 2, 256, 256, 128, 16, 132, True), ('chunk', 1, 9, 15, 64, 8, 8, 576)),
    ((4, 256, 8, 8, 128, 128, 128, 16, 132, True), ('chunk', 1, 5, 26, 64, 4, 4, 640)),
    ((4, 256, 8, 2, 128, 128, 128, 16, 132, True), ('chunk', 1, 5, 26, 64, 16, 4, 640)),
    ((1, 1, 4, 4, 256, 256, 8, 16, 132, True), ('decode', 0, 4, 2, 1, 1, 8, 16)),
    ((8, 1, 16, 16, 64, 64, 2048, 1, 132, True), ('decode', 0, 5, 410, 1, 1, 2, 640)),
]


@pytest.mark.parametrize("kernel", ["fused", "decode"])
def test_empty_cache_plans_are_todays(tmp_path, monkeypatch, kernel):
    """An empty cache on a card resolves every plan to the hand-fixed
    rule's, at the smoke's shapes."""
    monkeypatch.setattr(tuning, "device_generation",
                        lambda device=None: CARD)
    with config.overrides(MXNET_PROGRAM_CACHE=str(tmp_path)):
        tuning.reset_memo()
        if kernel == "fused":
            for m, k, n, dt, prod, al, variant, splits in FUSED_PLANS:
                params = fk._tuned(m, k, n, getattr(torch, dt), "cuda")
                assert params == fk.TUNE_DEFAULTS
                got = fk._plan(m, k, n, getattr(torch, dt), prod, al,
                               params, 132)
                assert (got.variant, got.splits) == (variant, splits), \
                    (m, k, n, dt, prod, al)
        else:
            for args, plan in DECODE_PLANS:
                b, tq, heads, kvh = args[:4]
                params = dk._tuned(args[6], tq, heads // kvh, "cuda")
                assert params == dk.TUNE_DEFAULTS
                got = dk._plan(*args, params["blocks_per_sm"],
                               params["min_split_tokens"],
                               params["max_splits"])
                assert tuple(got) == plan, args
        tuning.reset_memo()


def test_tuned_records_reach_the_plans(tune_cache):
    """A winner on disk changes the plan the launch computes."""
    sc = tuning.shape_class_for(m=256, k=1024, n=4096)
    tuning.put("fused_kernel", sc, "float32",
               {"fwd_side": 128, "dx_side": 0, "dw_side": 0,
                "dw_splits": 0},
               version=tuning.spaces()["fused_kernel"].version)
    params = fk._tuned(256, 1024, 4096, torch.float32, "cuda")
    assert fk._plan(256, 1024, 4096, torch.float32, "fwd", True, params,
                    132).variant == "simt128"   # the rule gives simt64
    tuning.put("decode_kernel", "m128,tq1", "any",
               {"blocks_per_sm": 4, "min_split_tokens": 0, "max_splits": 8},
               version=tuning.spaces()["decode_kernel"].version)
    params = dk._tuned(128, 1, 1, "cuda")
    assert dk._plan(4, 1, 4, 4, 256, 256, 128, 16, 132, True,
                    *(params[k] for k in ("blocks_per_sm",
                                          "min_split_tokens",
                                          "max_splits"))).splits == 8


def test_grouped_shape_warns_on_an_mha_record(tune_cache):
    """The reference's warned miss: a grouped shape finding only an
    MHA-keyed record does not take its winner."""
    version = tuning.spaces()["decode_kernel"].version
    tuning.put("decode_kernel", tuning.shape_class_for(m=64, tq=1), "any",
               {"blocks_per_sm": 1, "min_split_tokens": 0, "max_splits": 0},
               version=version)
    with pytest.warns(UserWarning, match="MHA-keyed"):
        params = dk._tuned(64, 1, 4, "cuda")
    assert params == dk.TUNE_DEFAULTS
    assert dk._tuned(64, 1, 1, "cuda")["blocks_per_sm"] == 1


def _trainables():
    return {"a_weight": torch.zeros(3, 700), "a_bias": torch.zeros(7),
            "b_weight": torch.zeros(64, 3, 3, 3, dtype=torch.bfloat16),
            "b_gamma": torch.zeros(2049), "d_weight": torch.zeros(4096)}


def _jax_layout(params, block_rows):
    import jax

    sds = {n: jax.ShapeDtypeStruct(tuple(v.shape),
                                   str(v.dtype).replace("torch.", ""))
           for n, v in params.items()}
    segs = pu._segments_for(sds, block_rows=block_rows)
    return {bk: [(s.name, s.row0, s.nblocks) for s in v]
            for bk, v in segs.items()}


@pytest.mark.parametrize("block_rows", [16, 32])
def test_update_plan_layout_follows_block_rows(tmp_path, monkeypatch,
                                               block_rows):
    """With the default block height the slab layout is today's (the JAX
    package's at 16); a tuned 32 lays the slabs, the per-block lr / wd
    and the plain update out as the JAX package does at 32."""
    params = _trainables()
    monkeypatch.setattr(tuning, "device_generation",
                        lambda device=None: CARD)
    with config.overrides(MXNET_PROGRAM_CACHE=str(tmp_path)):
        tuning.reset_memo()
        if block_rows != uk.BLOCK_ROWS:
            total = sum(v.numel() for v in params.values())
            tuning.put("update_kernel", tuning.shape_class_for(n=total),
                       "any", {"block_rows": block_rows},
                       version=tuning.spaces()["update_kernel"].version)
        opt = topt.SGD(learning_rate=0.1, momentum=0.9)
        plan = uk.plan_for(opt, params, list(params), None)
        tuning.reset_memo()
    assert plan.block_rows == block_rows
    got = {bk: [(s.name, s.row0, s.nblocks) for s in v]
           for bk, v in plan.buckets.items()}
    assert got == _jax_layout(params, block_rows)
    lrb, _ = plan.lr_wd_blocks({n: float(i + 1) for i, n in
                                enumerate(params)}, {n: 0.0 for n in params})
    for bk in plan.buckets:
        assert plan.rows(bk) % block_rows == 0
        assert lrb[bk].shape == (plan.rows(bk) // block_rows,)
    # the plain update reads a block's lr over block_rows x 128 elements
    w = torch.zeros(plan.rows("float32"), uk.LANES)
    g = torch.ones_like(w)
    uk.multi_tensor_update("sgd", 0, w, g, (), None,
                           torch.from_numpy(lrb["float32"]),
                           torch.zeros(len(lrb["float32"])), (1.0, -1.0),
                           block_rows=block_rows)
    want = -np.repeat(lrb["float32"], block_rows * uk.LANES)
    np.testing.assert_array_equal(w.reshape(-1).numpy(), want)


def test_plan_for_on_the_cpu_keeps_the_default_height(tmp_path):
    """The CPU reads no record: the plan is today's."""
    with config.overrides(MXNET_PROGRAM_CACHE=str(tmp_path)):
        plan = uk.plan_for(topt.SGD(learning_rate=0.1), _trainables(),
                           list(_trainables()), None)
    assert plan.block_rows == uk.BLOCK_ROWS == 16
    assert not os.listdir(tmp_path)

"""Serving over a mesh through the port: ``DecodePredictor(mesh=)`` over
gloo ranks on the CPU, against the JAX package's ``DecodePredictor(mesh=)``
on its 8-virtual-device harness, with the same numpy weights and tokens.

This file is its own worker: ``python tests/test_torch_serve_mesh.py
<rank> <world> <host:port> <outdir>`` runs one rank (it imports only
PyTorch and the port) and writes what it computed to
``<outdir>/r<rank>.pkl``.  Two spawns serve every case, started
together: 2 ranks (``MeshConfig(data=1, model=2)``) and 4 ranks
(``MeshConfig(data=2, model=2)``, then ``MeshConfig(data=1, model=4)``).
What is held, probabilities at the reference's rtol 1e-4 / atol 1e-5
and tokens exactly:

* a dense prefill and 4 steps at model=2 and at data=2 x model=2
  (``tests/test_decode.py``'s sharded-cache case): the rings hold the
  rank's rows and kv-heads;
* a paged prefill and a step at both meshes (``tests/test_paged_serve.py``
  's pool case): the pools hold the rank's kv-heads and every page;
* an int8 cache at model=4 over 2 heads (``tests/test_decode.py``'s
  degrade case): the attention runs on gathered q / k / v, the cache is
  replicated and ``_replicated_degrades`` says so (the reference splits
  that cache finer than a head instead);
* a grouped-query LM (4 heads over 2 kv-heads) at model=2;
* ``DecodeServer`` sessions over a paged int8 mesh predictor (shared
  prefixes: forks; chunked prefill; and one with speculation) whose
  greedy tokens equal the single-rank server's and the JAX server's on
  every rank; a sampled serve draws the same tokens on every rank;
* the programs run eagerly (``trace_counts`` 0, ``prepare_programs``
  reports "eager"), their artifacts carry ``mesh_shape`` and
  ``sharding_coverage``, ``serving_avals`` are at the local widths;
* a ``DeviceMesh`` from ``parallel.build_mesh`` serves as its config
  does; a mesh that does not cover the group raises, and one with an
  ``expert`` axis binds.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
PROC_TIMEOUT = 240
VOCAB, T, B = 32, 16, 2
LMS = {"lm": dict(embed=16, heads=4), "gqa": dict(embed=16, heads=4,
                                                   num_kv_heads=2),
       "heads2": dict(embed=16, heads=2)}
TOL = dict(rtol=1e-4, atol=1e-5)
PROMPTS = [(9, 0), (7, 1), (10, 2), (8, 3)]   # (length, seed)
SHARED = 6          # a prefix that ends inside a page: forks
SERVE = dict(paged=True, kv_dtype="int8", page_tokens=4, prefill_chunk=4)
MAX_NEW = 5


def _lm(sym_mod, name):
    kw = dict(LMS[name])
    return sym_mod.get_symbol(VOCAB, T, num_layers=2, ffn_hidden=16, **kw)


def _params(sym):
    """Weights N(0, 0.5); LN gammas 1 + N(0, 0.1), betas and biases
    N(0, 0.05): the greedy tokens then vary (with the final LN's beta and
    the head's bias at N(0, 0.5) one token wins every step)."""
    rng = np.random.RandomState(0)
    shapes, _, _ = sym.infer_shape(data=(B, T), softmax_label=(B, T))
    out = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        v = rng.normal(0, 0.5, s)
        if n.endswith("gamma"):
            v = 1 + 0.2 * v
        elif n.endswith(("beta", "bias")):
            v = 0.1 * v
        out[n] = v.astype(np.float32)
    return out


def _tokens():
    return np.random.RandomState(6).randint(0, VOCAB, (B, T)).astype(
        np.float32)


def _prompts():
    shared = np.random.RandomState(9).randint(0, VOCAB, SHARED)
    return [np.concatenate([shared, np.random.RandomState(s).randint(
        0, VOCAB, n - SHARED)]) for n, s in PROMPTS]


def _steps(pred, x, steps):
    """Prefill x[:, :8] and ``steps`` decode steps: the probabilities
    and tokens of each call, as numpy."""
    state, probs = pred.prefill(x[:, :8], 8)
    out = {"probs": [np.asarray(probs)], "tok": [np.asarray(state.tok)]}
    for _ in range(steps):
        state, probs = pred.step(state)
        out["probs"].append(np.asarray(probs))
        out["tok"].append(np.asarray(state.tok))
    return out, state


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _serve(mt, pred, spec_k=0, seed=0):
    srv = mt.decode.DecodeServer(pred, max_prefill=T, slots=2,
                                 max_new_tokens=MAX_NEW, spec_k=spec_k)
    ids = [srv.submit(p) for p in _prompts()]
    res = srv.run()
    return [np.asarray(res[i]).tolist() for i in ids], srv.stats()


def _cases(mt, mc, world, res):
    from mxnet_tpu_torch.models import attention_lm

    x = _tokens()

    def pred(name, mesh=mc, **kw):
        sym = _lm(attention_lm, name)
        return mt.decode.DecodePredictor(sym, _params(sym), cache_len=T,
                                         device="cpu", mesh=mesh, **kw)

    tag = "d%dm%d" % (mc.data, mc.model)
    if mc.model == 4:
        p = pred("heads2", kv_dtype="int8")
        out, state = _steps(p, x, 3)
        kc = state.caches[0][0]
        res[tag + "_int8"] = dict(
            out, data_shape=list(kc.data.shape),
            scale_shape=list(kc.scale.shape),
            degrades=list(p._replicated_degrades))
        return
    p = pred("lm")
    out, state = _steps(p, x, 4)
    res[tag + "_dense"] = dict(out, cache_shape=list(state.caches[0][0].shape))
    p = pred("lm", paged=True, page_tokens=4)
    state, probs = p.prefill(x[:, :8], 8)
    state, probs2 = p.step(state)
    res[tag + "_paged"] = {"probs": [np.asarray(probs), np.asarray(probs2)],
                           "pool_shape": list(state.caches[0][0].shape)}
    if mc.data > 1:
        return
    p = pred("gqa")
    out, state = _steps(p, x, 4)
    res[tag + "_gqa"] = dict(out, cache_shape=list(state.caches[0][0].shape))
    # the server: greedy, greedy with speculation, sampled
    p = pred("lm", **SERVE)
    toks, stats = _serve(mt, p)
    res["serve"] = {"tokens": toks, "forks": stats.get("cow_forks"),
                    "trace_counts": dict(p.trace_counts)}
    toks, _ = _serve(mt, p, spec_k=2)
    res["serve_spec"] = {"tokens": toks}
    hot = pred("lm", temperature=1.0, top_k=4, **SERVE)
    res["sampled"] = hot.generate(x[:, :6], 6, max_new_tokens=6,
                                  seed=3).tolist()
    # programs and artifacts
    report = p.prepare_programs(2, 4, spec_k=2)
    state = p.paged_batch_state(2)
    art = p.decode_artifact(state)
    ver = p.verify_artifact(state, 2)
    pre = p.prefill_artifact(1, 4)
    avals = p.serving_avals(2, 4)
    spec_art = p._program_specs["decode"].artifact()
    res["programs"] = {
        "sources": {k: v["source"] for k, v in report["programs"].items()},
        "trace_counts": dict(p.trace_counts),
        "mesh_shape": [a.mesh_shape for a in (art, ver, pre, spec_art)],
        "coverage": [a.meta.get("sharding_coverage")
                     for a in (art, ver, pre, spec_art)],
        "pool_aval": list(avals["decode"][1][0][0].data.shape),
        "fingerprints": sorted(p.program_fingerprints(2, 4)),
        "sharded": dict(p._tp.sharded)}
    dense = pred("lm")
    res["dense_prefill_art"] = dense.prefill_artifact(B, 8).mesh_shape
    # a DeviceMesh from parallel.build_mesh serves as the config does
    from mxnet_tpu_torch.parallel import build_mesh

    out, _ = _steps(pred("lm", mesh=build_mesh(mc)), x, 2)
    res["device_mesh"] = out
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import MeshConfig

    for what, cfg in (("cover", MeshConfig(data=1, model=2 * world)),
                      ("expert", MeshConfig(data=1, model=1,
                                            expert=world))):
        try:
            res["bound_" + what] = pred("lm", mesh=cfg).mesh_shape
            res["raise_" + what] = None
        except MXNetError as exc:
            res["raise_" + what] = str(exc)


def _worker_main(argv):
    rank, world, address, outdir = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import MeshConfig, launch

    launch.init(address, world, rank, backend="gloo", timeout=120)
    res = {}
    meshes = [MeshConfig(data=1, model=2)] if world == 2 else \
        [MeshConfig(data=2, model=2), MeshConfig(data=1, model=4)]
    for mc in meshes:
        _cases(mt, mc, world, res)
    with open(os.path.join(outdir, "r%d.pkl" % rank), "wb") as f:
        pickle.dump(res, f)
    launch.shutdown()
    print("SERVE_MESH_RANK_%d_OK" % rank, flush=True)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start(outdir, world):
    address = "127.0.0.1:%d" % _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, HERE, str(r), str(world), address, outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True, cwd=ROOT) for r in range(world)]


def _finish(procs, outdir):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "SERVE_MESH_RANK_%d_OK" % r in out, \
            "rank %d:\n%s" % (r, out[-6000:])
    ranks = []
    for r in range(len(procs)):
        with open(os.path.join(outdir, "r%d.pkl" % r), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both spawns' ranks, started together: ``{world: [rank results]}``."""
    started = {}
    for world in (2, 4):
        outdir = str(tmp_path_factory.mktemp("serve_mesh%d" % world))
        started[world] = (outdir, _start(outdir, world))
    return {w: _finish(procs, o) for w, (o, procs) in started.items()}


def _jax(name, mesh_sizes=None, **kw):
    """The JAX package's predictor of LM ``name`` over a mesh of
    ``mesh_sizes`` (data, model) on the first devices of the harness."""
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.decode import DecodePredictor
    from mxnet_tpu.models import attention_lm
    from mxnet_tpu.parallel import MeshConfig, build_mesh

    with mx.base.NameManager():
        sym = _lm(attention_lm, name)
    mesh = None
    if mesh_sizes is not None:
        d, m = mesh_sizes
        if len(jax.devices()) < d * m:
            pytest.skip("needs the 8-virtual-device harness")
        mesh = build_mesh(MeshConfig(data=d, model=m),
                          devices=jax.devices()[:d * m])
    return DecodePredictor(sym, _params(sym), cache_len=T, mesh=mesh, **kw)


def _torch_single(name, **kw):
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.models import attention_lm

    with mt.NameManager():
        sym = _lm(attention_lm, name)
    return mt.decode.DecodePredictor(sym, _params(sym), cache_len=T,
                                     device="cpu", **kw)


def _hold_steps(got, want):
    for i, (gp, wp) in enumerate(zip(got["probs"], want["probs"])):
        np.testing.assert_allclose(gp, wp, err_msg="call %d" % i, **TOL)
    for i, (gt, wt) in enumerate(zip(got["tok"], want["tok"])):
        np.testing.assert_array_equal(gt, wt, err_msg="call %d" % i)


@pytest.mark.parametrize("world,tag,sizes", [(2, "d1m2", (1, 2)),
                                             (4, "d2m2", (2, 2))])
def test_dense_prefill_and_steps_match_jax_mesh(ranks, world, tag, sizes):
    want, _ = _steps(_jax("lm", sizes), _tokens(), 4)
    for rk in ranks[world]:
        _hold_steps(rk[tag + "_dense"], want)
        # the ring holds the rank's rows and kv-heads: (B / data, C,
        # E / model)
        assert rk[tag + "_dense"]["cache_shape"] == \
            [B // sizes[0], T, 16 // sizes[1]]


@pytest.mark.parametrize("world,tag,sizes", [(2, "d1m2", (1, 2)),
                                             (4, "d2m2", (2, 2))])
def test_paged_prefill_and_step_match_jax_mesh(ranks, world, tag, sizes):
    jp = _jax("lm", sizes, paged=True, page_tokens=4)
    x = _tokens()
    state, probs = jp.prefill(x[:, :8], 8)
    state, probs2 = jp.step(state)
    for rk in ranks[world]:
        got = rk[tag + "_paged"]
        np.testing.assert_allclose(got["probs"][0], np.asarray(probs), **TOL)
        np.testing.assert_allclose(got["probs"][1], np.asarray(probs2),
                                   **TOL)
        # kv-heads split, every page on every rank
        assert got["pool_shape"][2] == 16 // sizes[1]


def test_int8_heads_indivisible_degrades_and_matches(ranks):
    want, _ = _steps(_jax("heads2", (1, 4), kv_dtype="int8"), _tokens(), 3)
    for rk in ranks[4]:
        got = rk["d1m4_int8"]
        _hold_steps(got, want)
        # replicated: the whole E and both heads' scales on every rank
        assert got["data_shape"] == [B, T, 16]
        assert got["scale_shape"] == [B, T, 2]
        assert got["degrades"] and all(
            d["site"] == "kv_cache" and "model=4" in d["reason"]
            for d in got["degrades"])


def test_gqa_lm_matches_jax_mesh(ranks):
    want, _ = _steps(_jax("gqa", (1, 2)), _tokens(), 4)
    for rk in ranks[2]:
        _hold_steps(rk["d1m2_gqa"], want)
        # 2 kv-heads of 4 over model=2: one kv-head (width 4) a rank
        assert rk["d1m2_gqa"]["cache_shape"] == [B, T, 4]


def test_server_tokens_equal_single_rank_and_jax(ranks):
    import mxnet_tpu_torch as mt
    from mxnet_tpu.decode import DecodeServer as JaxServer

    single, _ = _serve(mt, _torch_single("lm", **SERVE))
    spec, _ = _serve(mt, _torch_single("lm", **SERVE), spec_k=2)
    jsrv = JaxServer(_jax("lm", **SERVE), max_prefill=T, slots=2,
                     max_new_tokens=MAX_NEW)
    ids = [jsrv.submit(p) for p in _prompts()]
    jres = jsrv.run()
    assert single == [np.asarray(jres[i]).tolist() for i in ids]
    assert spec == single
    for rk in ranks[2]:
        assert rk["serve"]["tokens"] == single
        assert rk["serve_spec"]["tokens"] == single
        assert rk["serve"]["forks"] >= 1
        assert set(rk["serve"]["trace_counts"].values()) == {0}
    assert ranks[2][0]["sampled"] == ranks[2][1]["sampled"]


def test_mesh_programs_and_artifacts(ranks):
    for r, rk in enumerate(ranks[2]):
        got = rk["programs"]
        assert set(got["sources"].values()) == {"eager"}
        assert set(got["trace_counts"].values()) == {0}
        sizes = {"data": 1, "model": 2, "pipe": 1, "seq": 1, "expert": 1}
        assert got["mesh_shape"] == [sizes] * 4
        for cov in got["coverage"]:
            assert cov["mesh"] == sizes
            leaves = cov["leaves"]
            assert leaves["layer0_q_weight"]["spec"] == ["model", None]
            assert leaves["layer0_ffn2_weight"]["spec"] == [None, "model"]
            assert leaves["embed_weight"]["spec"] == ["model", None]
        # the decode program's pool at the local kv width
        assert got["pool_aval"][2] == 8
        assert got["fingerprints"] == ["chunk", "commit", "decode",
                                       "extract", "fork", "install"]
        assert got["sharded"]["layer0_q_weight"] == 0
        assert rk["dense_prefill_art"] == sizes
        for a, b in zip(rk["device_mesh"]["probs"], rk["d1m2_dense"]["probs"]):
            np.testing.assert_array_equal(a, b)
        assert "does not cover" in rk["raise_cover"]
        # an expert axis binds (this LM has no MoE: every rank the same)
        assert rk["raise_expert"] is None
        assert rk["bound_expert"] == dict(sizes, model=1, expert=2)


if __name__ == "__main__":
    _worker_main(sys.argv[1:])

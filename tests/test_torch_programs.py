"""The port's compiled serving programs (``mxnet_tpu_torch.programs``)
against the JAX package's (``mxnet_tpu.programs``) on the CPU.

On the CPU a :class:`GraphProgram` keeps its static buffers, signatures
and counts and runs its body on the buffers without a capture, so these
tests hold the buffer plumbing, the trace counters, the specs and the
registry; ``tests/test_torch_cuda.py`` holds the captured graphs on the
card.  Sizes are small (vocab 17, embed 8-16, 2 heads, 1-2 layers,
4-token pages).  Probabilities are compared at rtol 1e-5 / atol 1e-6
against the JAX package (the two sum the same f32 products in other
orders) and exactly between a program and its eager body (the same ops
on the same inputs).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.decode import DecodePredictor as JaxPredictor
from mxnet_tpu.decode import DecodeServer as JaxServer
from mxnet_tpu.models import attention_lm as jax_lm
from mxnet_tpu.programs.registry import ProgramRegistry as JaxRegistry
from mxnet_tpu.programs.spec import ProgramSpec as JaxSpec

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import programs
from mxnet_tpu_torch.decode import DecodePredictor, DecodeServer
from mxnet_tpu_torch.models import attention_lm
from mxnet_tpu_torch.programs import GRAPH_STATS, GraphProgram
from mxnet_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

VOCAB, T, HEADS = 17, 16, 2
TOL = dict(rtol=1e-5, atol=1e-6)
KINDS = ("decode", "chunk", "commit", "fork")


def _lm(embed=16, layers=2, ffn=16, burn=False):
    """The JAX symbol, the port's symbol and numpy params; ``burn``
    builds another symbol first, so the port's op names differ."""
    with mx.base.NameManager():
        sym = jax_lm.get_symbol(VOCAB, T, num_layers=layers, embed=embed,
                                heads=HEADS, ffn_hidden=ffn)
    rng = np.random.RandomState(0)
    shapes, _, _ = sym.infer_shape(data=(1, T), softmax_label=(1, T))
    params = {n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    with mt.NameManager():
        if burn:
            attention_lm.get_symbol(VOCAB, T, num_layers=1, embed=8,
                                    heads=HEADS, ffn_hidden=8)
        tsym = attention_lm.get_symbol(VOCAB, T, num_layers=layers,
                                       embed=embed, heads=HEADS,
                                       ffn_hidden=ffn)
    return sym, tsym, params


def _preds(pkg, sym, tsym, params, **kw):
    kw = dict(dict(paged=True, page_tokens=4, prefill_chunk=4,
                   kv_dtype="int8"), **kw)
    if pkg == "jax":
        return JaxPredictor(sym, params, cache_len=T, **kw)
    return DecodePredictor(tsym, params_from_jax(params, device="cpu"),
                           cache_len=T, device="cpu", **kw)


def _prompts(seed=3):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, VOCAB, 7)
    return [np.concatenate([prefix, rng.randint(0, VOCAB, n)])
            for n in (2, 5, 3)] + [rng.randint(0, VOCAB, 6)]


def _serve(pred, server_cls, prompts):
    srv = server_cls(pred, 12, slots=2, max_new_tokens=6)
    for p in prompts:
        srv.submit(p)
    return srv.run(), srv


# ---------------------------------------------------------------------------
# the registry and the fingerprints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_registry_holds_specs_weakly(pkg):
    class Owner:
        _probing = False

    owner = Owner()
    if pkg == "jax":
        reg, fn = JaxRegistry(), jax.jit(lambda x: x + 1)
        spec = reg.register(JaxSpec(
            "t_unit", fn, owner=owner,
            abstract_args=lambda: (jax.ShapeDtypeStruct((2,), jnp.float32),),
            trace_count=lambda: 0))
    else:
        reg = programs.ProgramRegistry()
        fn = GraphProgram("t_unit", lambda x: x + 1)
        spec = reg.register(programs.ProgramSpec(
            "t_unit", fn, owner=owner,
            abstract_args=lambda: (torch.empty(2, device="meta"),),
            trace_count=lambda: 0))
    assert reg.get("t_unit") is spec
    assert reg.trace_report()["t_unit"] == {"trace_count": 0,
                                            "expected_traces": 1}
    del spec
    # the registry never pins a program (and through it a model)
    assert reg.get("t_unit") is None
    assert reg.names() == []


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fingerprints_stable_and_sensitive(pkg):
    """Equal keys for equal predictors (also when the symbol's generated
    op names differ); page size, batch width, kv dtype and the symbol
    each move them — in both packages."""
    sym, tsym, params = _lm(embed=8, layers=1)
    kw = dict(kv_dtype="")
    a = _preds(pkg, sym, tsym, params, **kw)
    fa = a.program_fingerprints(2, chunk_w=4)
    assert fa == _preds(pkg, sym, tsym, params, **kw).program_fingerprints(
        2, chunk_w=4)
    assert set(KINDS) <= set(fa) and len(set(fa.values())) == len(fa)
    assert a.program_fingerprints(3, chunk_w=4)["decode"] != fa["decode"]
    for extra in (dict(page_tokens=8), dict(kv_dtype="int8")):
        other = _preds(pkg, sym, tsym, params, **dict(kw, **extra))
        assert other.program_fingerprints(2, chunk_w=4)["decode"] \
            != fa["decode"]
    sym2, tsym2, params2 = _lm(embed=8, layers=1, ffn=24)
    e = _preds(pkg, sym2, tsym2, params2, **kw)
    assert e.program_fingerprints(2, chunk_w=4)["commit"] != fa["commit"]
    if pkg == "torch":
        _, tsym3, _ = _lm(embed=8, layers=1, burn=True)
        assert tsym3.tojson() != tsym.tojson()
        renamed = _preds(pkg, sym, tsym3, params, **kw)
        assert renamed.program_fingerprints(2, chunk_w=4) == fa
        assert set(programs.spec.kernel_digest()) <= set("0123456789abcdef")


# ---------------------------------------------------------------------------
# the serving programs against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prepare", [False, True])
def test_paged_server_programs_match_jax(prepare):
    """A shared-prefix paged serve (chunks, prefix hits, copy-on-write
    forks, commits, slot refills) through the programs: the JAX
    package's greedy tokens and trace counts; a second run() on the
    same predictor captures nothing new; the eager bodies give the same
    tokens.  With ``prepare``, every program is captured ahead of the
    first request and the serve adds no trace."""
    sym, tsym, params = _lm()
    prompts = _prompts()
    jpred = _preds("jax", sym, tsym, params)
    tpred = _preds("torch", sym, tsym, params)
    if prepare:
        rep = tpred.prepare_programs(2, chunk_w=4)
        assert set(rep["programs"]) == set(KINDS) and rep["wall_s"] > 0
        keys = tpred.program_fingerprints(2, chunk_w=4)
        for kind, row in rep["programs"].items():
            assert row["source"] == "capture" and row["seconds"] > 0
            assert row["key"] == keys[kind]
        assert tpred.prepare_programs(2, chunk_w=4) is rep
        assert tpred.trace_counts == dict(
            dict.fromkeys(tpred.trace_counts, 0), **dict.fromkeys(KINDS, 1))
        assert set(programs.registry.trace_report()) >= {
            "paged_decode_step", "prefill_chunk", "slot_commit", "page_fork"}
    want, _ = _serve(jpred, JaxServer, prompts)
    got, srv = _serve(tpred, DecodeServer, prompts)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert srv.stats()["cow_forks"] > 0 and srv.chunks > 0
    jtc, ttc = jpred.trace_counts, tpred.trace_counts
    if prepare:
        assert all(ttc[k] == 1 for k in KINDS), ttc
    else:
        assert {k: ttc[k] for k in KINDS} == {k: jtc[k] for k in KINDS}
    assert ttc["prefill"] == ttc["verify"] == 0
    # a second run on the same predictor: no new capture, same tokens
    captures = GRAPH_STATS["captures"]
    replays = GRAPH_STATS["replays"]
    again, srv2 = _serve(tpred, DecodeServer, prompts)
    assert GRAPH_STATS["captures"] == captures
    assert GRAPH_STATS["replays"] - replays >= srv2.steps + srv2.chunks
    assert tpred.trace_counts == ttc
    # the eager bodies: the same tokens, nothing counted
    with programs.eager():
        eager, _ = _serve(tpred, DecodeServer, prompts)
    assert GRAPH_STATS["captures"] == captures
    for rid in want:
        np.testing.assert_array_equal(again[rid], want[rid])
        np.testing.assert_array_equal(eager[rid], want[rid])


def test_paged_step_program_matches_eager_and_jax():
    """Prefill, then teacher-forced paged steps (a token fed in from
    outside the batch's buffers) with one row inactive at the third:
    the program's probabilities equal the eager body's exactly and the
    JAX package's within tolerance; lengths and tokens follow the
    activity mask; the tables are shipped only when the manager changed
    them."""
    sym, tsym, params = _lm(embed=8, layers=1)
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, (2, 9)).astype(np.float32)
    lens = np.array([5, 9], np.int32)
    jp = _preds("jax", sym, tsym, params)
    tp, ep = _preds("torch", sym, tsym, params), \
        _preds("torch", sym, tsym, params)
    js, jprobs = jp.prefill(x, lens)
    ts, tprobs = tp.prefill(x, lens)
    with programs.eager():
        es, eprobs = ep.prefill(x, lens)
    assert torch.equal(tprobs, eprobs)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **TOL)
    lens_h = lens.astype(np.int64)
    for i in range(5):
        forced = rng.randint(0, VOCAB, (2, 1)).astype(np.int32)
        act = np.array([1, 0 if i == 2 else 1], np.int32)
        js = js._replace(tok=js.tok * 0 + forced)
        js, jprobs = jp.paged_step(js, lens_h, active=act)
        ships = tp._table_ships
        ts, tprobs = tp.paged_step(ts._replace(tok=torch.from_numpy(forced)),
                                   lens_h, active=act)
        tprobs = tprobs.clone()
        assert tp._table_ships - ships <= 1
        with programs.eager():
            es, eprobs = ep.paged_step(
                es._replace(tok=torch.from_numpy(forced)), lens_h,
                active=act)
        assert torch.equal(tprobs, eprobs), "step %d" % i
        assert torch.equal(ts.tok, es.tok) and torch.equal(ts.lens, es.lens)
        np.testing.assert_array_equal(ts.tok.numpy(), np.asarray(js.tok))
        np.testing.assert_array_equal(ts.lens.numpy(), np.asarray(js.lens))
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                                   err_msg="step %d" % i, **TOL)
        lens_h = lens_h + act
    # a step that allocates no page ships no table
    mgr = tp._manager
    version, ships = mgr.version, tp._table_ships
    tp.paged_step(ts, lens_h, active=np.zeros(2, np.int32))
    assert mgr.version == version and tp._table_ships == ships
    assert tp.trace_counts["decode"] == 1 and tp.trace_counts["chunk"] == 1


# ---------------------------------------------------------------------------
# GraphProgram's buffer plumbing
# ---------------------------------------------------------------------------
def test_graph_program_buffers_and_signatures():
    """Copied arguments land in the program's static buffers (host
    tensors included), skipped when the argument is that buffer; a bound
    argument is used in place and a new one is a new signature; a
    non-tensor leaf is part of the signature; eager() runs the body on
    the arguments and counts nothing."""
    seen = []

    def body(state, x, scale):
        seen.append(x)
        state.add_(x * scale)
        return state.sum()

    prog = GraphProgram("t_plumbing", body, bind=(0,))
    s1 = torch.zeros(3)
    out = prog(s1, torch.ones(3), 2.0)
    assert float(out) == 6.0 and prog.traces == 1
    static = seen[-1]
    prog(s1, torch.full((3,), 3.0), 2.0)       # copied into the buffer
    assert seen[-1] is static and float(s1[0]) == 8.0
    prog(s1, static, 2.0)                      # already the buffer
    assert seen[-1] is static and prog.traces == 1
    prog(s1, torch.ones(3), 1.0)               # another scale
    assert prog.traces == 2
    s2 = torch.zeros(3)
    prog(s2, torch.ones(3), 2.0)               # another bound buffer
    assert prog.traces == 3 and float(s2[0]) == 2.0
    with programs.eager():
        x = torch.ones(3)
        prog(s2, x, 2.0)
        assert seen[-1] is x and prog.traces == 3
    assert float(s2[0]) == 4.0

"""Speculative decoding in the port (``mxnet_tpu_torch``) against the JAX
package on the CPU: the acceptance rule, the n-gram and draft
proposers, ``generate_speculative``, the paged verify program and the
speculative ``DecodeServer``.

The same numpy inputs go to both packages.  The two draw other random
numbers from the same seed, so sampled paths are held to their
distribution (Monte Carlo, atol 0.035 as the JAX package's own test)
and to repeatability, and the cross-package checks are greedy: tokens,
counts, and the servers' step and acceptance counters must be equal.
Probabilities are compared at rtol 1e-5 / atol 1e-6 (the same f32
products summed in other orders), ``residual_probs`` at 1e-6, and a
program against its eager body bit for bit.  Sizes are small (vocab 17,
T 16, embed 8-16, 2 heads, 1-2 layers, 4-token pages).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.decode import DecodePredictor as JaxPredictor
from mxnet_tpu.decode import DecodeServer as JaxServer
from mxnet_tpu.decode import NGramProposer as JaxNGram
from mxnet_tpu.models import attention_lm as jax_lm
from mxnet_tpu.ops import sample as jax_sample
from mxnet_tpu.serve.manager import PagedKVManager as JaxManager

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import decode, programs
from mxnet_tpu_torch.decode import (DecodePredictor, DecodeServer,
                                    DraftProposer, NGramProposer)
from mxnet_tpu_torch.models import attention_lm
from mxnet_tpu_torch.ops.sample import residual_probs, speculative_accept
from mxnet_tpu_torch.serve import PagedKVManager
from mxnet_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

VOCAB, T, HEADS = 17, 16, 2
TOL = dict(rtol=1e-5, atol=1e-6)


def _lm(embed=16, layers=2, ffn=32, seed=6, scale=0.2):
    """The JAX symbol, the port's symbol and numpy params.  The default
    weights give greedy continuations with 3 distinct tokens in 14, so
    drafts are both accepted and rejected."""
    with mx.base.NameManager():
        sym = jax_lm.get_symbol(VOCAB, T, num_layers=layers, embed=embed,
                                heads=HEADS, ffn_hidden=ffn)
    rng = np.random.RandomState(seed)
    shapes, _, _ = sym.infer_shape(data=(1, T), softmax_label=(1, T))
    params = {n: rng.normal(0, scale, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes)
              if n not in ("data", "softmax_label")}
    with mt.NameManager():
        tsym = attention_lm.get_symbol(VOCAB, T, num_layers=layers,
                                       embed=embed, heads=HEADS,
                                       ffn_hidden=ffn)
    return sym, tsym, params


def _pair(model, cache_len, paged=False, **kw):
    """A JAX predictor and the port's over the same weights."""
    sym, tsym, params = model
    if paged:
        kw = dict(dict(paged=True, page_tokens=4, prefill_chunk=4), **kw)
    return (JaxPredictor(sym, params, cache_len=cache_len, **kw),
            DecodePredictor(tsym, params_from_jax(params, device="cpu"),
                            cache_len=cache_len, device="cpu", **kw))


def _batch(seed, b=2, p=8):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, p)).astype(
        np.float32)


def _shared_prefix_prompts(seed=3):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, VOCAB, 7)
    return [np.concatenate([prefix, rng.randint(0, VOCAB, n)])
            for n in (2, 5, 3)] + [rng.randint(0, VOCAB, 6)]


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------
def test_residual_probs_matches_jax_and_identity():
    """norm(max(p - q, 0)) against the JAX function on Dirichlet rows
    (also a row with p <= q everywhere, which falls back to p), and the
    identity q min(1, p/q) + P(reject) res = p."""
    rng = np.random.RandomState(3)
    p = rng.dirichlet(np.ones(7), size=16).astype(np.float32)
    q = rng.dirichlet(np.ones(7), size=16).astype(np.float32)
    q[0] = p[0]
    got = residual_probs(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    want = np.asarray(jax_sample.residual_probs(jnp.asarray(p),
                                                jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], p[0])
    accept = q * np.minimum(1.0, p / q)
    marginal = accept + (1.0 - accept.sum(-1, keepdims=True)) * got
    np.testing.assert_allclose(marginal, p, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("b,k,v,seed", [(3, 1, 5, 0), (4, 3, 7, 1),
                                        (5, 8, 17, 2)])
def test_speculative_accept_greedy_matches_jax(b, k, v, seed):
    """Greedy acceptance on the same (B, k+1, V) probabilities: counts
    and emitted tokens equal the JAX function's exactly; drafts copy the
    argmax up to a random point, so every count from 1 to k+1 can
    occur."""
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.ones(v), size=(b, k + 1)).astype(np.float32)
    drafts = p[:, :k].argmax(-1).astype(np.int32)
    for r in range(b):
        cut = rng.randint(0, k + 1)
        if cut < k:
            drafts[r, cut] = (drafts[r, cut] + 1 + rng.randint(v - 1)) % v
    counts, out = speculative_accept(torch.from_numpy(p),
                                     torch.from_numpy(drafts), greedy=True)
    jc, jo = jax_sample.speculative_accept(
        jax.random.PRNGKey(0), jnp.asarray(p), jnp.asarray(drafts),
        greedy=True)
    assert counts.dtype == out.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))


@pytest.mark.parametrize("proposal", ["q-drawn", "delta"])
def test_speculative_accept_preserves_target_distribution(proposal):
    """Monte Carlo over 4000 rows: the first emitted token's empirical
    distribution equals the target's row-0 distribution, for drafts
    drawn from q and for a fixed (delta) proposal; two runs from one
    generator seed are bit-identical."""
    rng = np.random.RandomState(4)
    v, k, n = 5, 2, 4000
    p = torch.from_numpy(rng.dirichlet(np.ones(v), size=k + 1).astype(
        np.float32)).expand(n, k + 1, v)
    q = torch.from_numpy(rng.dirichlet(np.ones(v), size=k).astype(
        np.float32)).expand(n, k, v)
    fixed = torch.from_numpy(rng.randint(0, v, (1, k)).astype(np.int32))

    def first_tokens(seed):
        g = torch.Generator().manual_seed(seed)
        if proposal == "q-drawn":
            drafts = torch.multinomial(q.reshape(-1, v), 1, generator=g)
            return speculative_accept(p, drafts.reshape(n, k).int(), q,
                                      generator=g)
        return speculative_accept(p, fixed.expand(n, k), None, generator=g)

    counts, out = first_tokens(0)
    emp = np.bincount(out[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(emp, p[0, 0].numpy(), atol=0.035)
    assert int(counts.min()) >= 1 and int(counts.max()) <= k + 1
    again = first_tokens(0)
    assert torch.equal(again[0], counts) and torch.equal(again[1], out)


@pytest.mark.parametrize("k,ngram", [(1, 1), (4, 2), (3, 3)])
def test_ngram_proposer_matches_jax(k, ngram):
    """Proposals equal the JAX class's on random histories: an empty
    one, a single token, no-match suffixes and repeats; exactly k each,
    and no probabilities."""
    rng = np.random.RandomState(k * 10 + ngram)
    hists = [[], [5], list(range(9)), [1, 2, 3, 1, 2], [7] * 6]
    hists += [list(rng.randint(0, 4, rng.randint(2, 20)))
              for _ in range(20)]
    got, probs = NGramProposer(k, ngram).propose(hists)
    want, _ = JaxNGram(k, ngram).propose(hists)
    assert probs is None and got.shape == (len(hists), k)
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# generate_speculative
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("proposer", ["ngram", "draft"])
@pytest.mark.parametrize("padded", [False, True])
def test_generate_speculative_greedy_matches_jax_and_generate(proposer,
                                                              padded):
    """Greedy speculation (k = 3) over a batch (a padded one with row
    lengths [5, 8]) emits the JAX package's tokens and the port's own
    greedy generate's; the draft is a smaller model over the same
    vocabulary."""
    model = _lm()
    jp, tp = _pair(model, 2 * T)
    x = _batch(20)
    lens = 8
    if padded:
        lens = np.array([5, 8], np.int32)
        x[0, 5:] = 0.0
    kw = dict(max_new_tokens=10, seed=3, k=3)
    if proposer == "draft":
        jd, td = _pair(_lm(embed=8, layers=1, ffn=16, seed=9), 2 * T)
        kw_j, kw_t = dict(kw, draft=jd), dict(kw, draft=td)
    else:
        kw_j = kw_t = kw
    want = jp.generate_speculative(x, lens, **kw_j)
    got = tp.generate_speculative(x, lens, **kw_t)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tp.generate(x, lens, max_new_tokens=10, seed=3))


@pytest.mark.parametrize("paged", [False, True])
def test_ring_wrap_falls_back_to_plain_steps(paged):
    """A 12-token cache (prompt 6, 10 new tokens): near the ring's end
    speculation gives way to plain steps; tokens equal the JAX
    package's and plain greedy generation's.  A paged predictor
    captures its verify and decode programs once each, as the JAX
    package traces them."""
    model = _lm()
    jp, tp = _pair(model, 12, paged=paged)
    x = _batch(21, p=6)
    want = jp.generate_speculative(x, 6, max_new_tokens=10, seed=1, k=3)
    got = tp.generate_speculative(x, 6, max_new_tokens=10, seed=1, k=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tp.generate(x, 6, max_new_tokens=10, seed=1))
    assert tp.trace_counts["verify"] <= 1
    if paged:
        assert tp.trace_counts["verify"] == jp.trace_counts["verify"] == 1
        assert tp.trace_counts["decode"] == jp.trace_counts["decode"] == 1


def test_generate_speculative_eos_discards_window_tail():
    """A row whose EOS comes inside a window stops there: tokens equal
    plain greedy generation through the EOS, and the row pads with the
    EOS after it — as in the JAX package."""
    model = _lm()
    jp, tp = _pair(model, 4 * T)
    x = _batch(32, p=6)
    ref = tp.generate(x, 6, max_new_tokens=10, seed=2)
    eos = next(int(ref[0][i]) for i in range(1, 10)
               if ref[0][i] != ref[0][0])
    got = tp.generate_speculative(x, 6, max_new_tokens=10, seed=2, k=3,
                                  eos_id=eos)
    e0 = int(np.flatnonzero(ref[0] == eos)[0])
    np.testing.assert_array_equal(got[0, :e0 + 1], ref[0, :e0 + 1])
    assert (got[0, e0:] == eos).all()
    np.testing.assert_array_equal(
        got, jp.generate_speculative(x, 6, max_new_tokens=10, seed=2, k=3,
                                     eos_id=eos))


def test_sampled_generate_speculative_repeats_per_seed():
    """Temperature 1, top-k 5: the same seed draws the same tokens, and
    the draws move with the seed."""
    _, tp = _pair(_lm(), 2 * T, temperature=1.0, top_k=5)
    x = _batch(22)
    a = tp.generate_speculative(x, 8, max_new_tokens=8, seed=11, k=3)
    np.testing.assert_array_equal(
        a, tp.generate_speculative(x, 8, max_new_tokens=8, seed=11, k=3))
    draws = {tuple(tp.generate_speculative(x, 8, max_new_tokens=8, seed=s,
                                           k=3)[0]) for s in range(5)}
    assert len(draws) > 1


# ---------------------------------------------------------------------------
# the paged verify program
# ---------------------------------------------------------------------------
def test_paged_verify_program_matches_eager_and_jax():
    """Prefill, then verify steps with drafts partly right and partly
    not, one row inactive at the second: the program's emitted tokens,
    counts, probabilities, lengths and token equal the eager body's bit
    for bit; tokens and counts equal the JAX package's paged_verify; each
    row i of the window's probabilities equals the JAX package's at that
    position (a prefill of the committed sequence plus the window's
    first i drafts)."""
    model = _lm(embed=8, layers=1, ffn=16)
    kw = dict(paged=True, kv_dtype="int8")
    jp, tp = _pair(model, T, **kw)
    jq, ep = _pair(model, T, **kw)
    k = 3
    x = _batch(1, p=9)
    lens = np.array([5, 9], np.int32)
    js, _ = jp.prefill(x, lens)
    ts, _ = tp.prefill(x, lens)
    with programs.eager():
        es, _ = ep.prefill(x, lens)
    seqs = [list(x[r, :lens[r]].astype(np.int64)) for r in range(2)]
    pend = [int(t) for t in ts.tok[:, 0]]
    lens_h = lens.astype(np.int64)
    rng = np.random.RandomState(5)
    for step in range(3):
        act = np.array([1, 0 if step == 1 else 1], np.int32)
        drafts = rng.randint(0, VOCAB, (2, k)).astype(np.int32)
        js, jout, jcounts = jp.paged_verify(js, lens_h, drafts, active=act)
        ts, out, counts = tp.paged_verify(ts, lens_h, drafts, active=act)
        probs = tp.verify_probs.clone()
        out, counts = out.clone(), counts.clone()
        with programs.eager():
            es, eout, ecounts = ep.paged_verify(es, lens_h, drafts,
                                                active=act)
        assert torch.equal(out, eout) and torch.equal(counts, ecounts)
        assert torch.equal(probs, ep.verify_probs)
        assert torch.equal(ts.tok, es.tok) and torch.equal(ts.lens, es.lens)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(ts.tok.numpy(), np.asarray(js.tok))
        np.testing.assert_array_equal(ts.lens.numpy(), np.asarray(js.lens))
        for r in range(2):
            if not act[r]:
                assert int(counts[r]) == 0
                continue
            window = [pend[r]] + list(drafts[r])
            for i in range(k + 1):
                full = np.asarray(seqs[r] + window[:i + 1], np.float32)
                _, jprobs = jq.prefill(full[None], full.size)
                np.testing.assert_allclose(
                    probs[r, i].numpy(), np.asarray(jprobs)[0],
                    err_msg="step %d row %d position %d" % (step, r, i),
                    **TOL)
            c = int(counts[r])
            seqs[r] += window[:c]
            pend[r] = int(out[r, c - 1])
        lens_h = lens_h + counts.numpy()
    assert tp.trace_counts["verify"] == 1 and ep.trace_counts["verify"] == 0


@pytest.mark.parametrize("prepare", [False, True])
def test_paged_spec_server_matches_jax(prepare):
    """A shared-prefix paged int8 serve with spec_k 3 (chunks, prefix
    hits, forks, slot refills, plain steps while an admission is
    mid-prefill): the JAX server's tokens, steps, spec_steps, proposed
    and accepted; the verify program captured once; with ``prepare``
    every program, verify included, is captured ahead of the first
    request and the serve adds no capture.  The fingerprints name
    verify only when spec_k is set."""
    model = _lm()
    jp, tp = _pair(model, T, paged=True, kv_dtype="int8")
    prompts = _shared_prefix_prompts()
    if prepare:
        rep = tp.prepare_programs(2, chunk_w=4, spec_k=3)
        assert rep["signature"] == (2, 4, 3)
        assert set(rep["programs"]) == {"decode", "chunk", "commit",
                                        "fork", "verify"}
        keys = tp.program_fingerprints(2, chunk_w=4, spec_k=3)
        assert rep["programs"]["verify"]["key"] == keys["verify"]
        assert rep["programs"]["verify"]["source"] == "capture"
        assert "verify" not in tp.program_fingerprints(2, chunk_w=4)
        assert tp.trace_counts["verify"] == 1
        assert "paged_verify_step" in programs.registry.trace_report()
    out = []
    for pred, cls in ((jp, JaxServer), (tp, DecodeServer)):
        srv = cls(pred, 12, slots=2, max_new_tokens=6, spec_k=3)
        for p in prompts:
            srv.submit(p)
        out.append((srv.run(), srv))
    (want, jsrv), (got, srv) = out
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert srv.spec_steps > 0 and srv.steps > srv.spec_steps
    assert (srv.steps, srv.spec_steps, srv.proposed, srv.accepted) == \
        (jsrv.steps, jsrv.spec_steps, jsrv.proposed, jsrv.accepted)
    assert 0 < srv.accepted < srv.proposed
    stats = srv.stats()
    assert stats["spec_steps"] == srv.spec_steps
    assert stats["accept_rate"] == srv.accept_rate
    ttc = tp.trace_counts
    assert ttc["verify"] == jp.trace_counts["verify"] == 1
    assert ttc["decode"] == ttc["chunk"] == ttc["commit"] == 1
    # again, and under programs.eager(): the same tokens, no capture
    captures = programs.GRAPH_STATS["captures"]
    srv2 = DecodeServer(tp, 12, slots=2, max_new_tokens=6, spec_k=3)
    with programs.eager():
        for p in prompts:
            srv2.submit(p)
        again = srv2.run()
    for rid in want:
        np.testing.assert_array_equal(again[rid], want[rid])
    assert programs.GRAPH_STATS["captures"] == captures
    assert tp.trace_counts == ttc


@pytest.mark.parametrize("paged", [False, True])
def test_self_draft_accepts_every_draft(paged):
    """Draft == target weights (a second, dense predictor): every window
    is accepted whole (accept rate exactly 1), which holds only if the
    draft's teacher-forced catch-up keeps its cache complete; tokens
    equal per-prompt greedy generation and the JAX server's."""
    model = _lm()
    kw = dict(paged=True, kv_dtype="int8") if paged else {}
    jp, tp = _pair(model, 4 * T, **kw)
    jd, td = _pair(model, 4 * T)
    rng = np.random.RandomState(30)
    prompts = [rng.randint(0, VOCAB, (n,)) for n in (5, 7, 6, 4)]
    refs = [tp.generate(p[None].astype(np.float32), p.size,
                        max_new_tokens=20)[0] for p in prompts]
    out = []
    for pred, draft, cls in ((jp, jd, JaxServer), (tp, td, DecodeServer)):
        srv = cls(pred, T, slots=2, max_new_tokens=20, spec_k=3,
                  draft=draft)
        ids = [srv.submit(p) for p in prompts]
        out.append((srv.run(), srv, ids))
    (want, jsrv, _), (got, srv, ids) = out
    for rid, ref in zip(ids, refs):
        np.testing.assert_array_equal(got[rid], ref)
        np.testing.assert_array_equal(got[rid], want[rid])
    assert srv.spec_steps > 0
    assert srv.accept_rate == jsrv.accept_rate == 1.0, srv.accept_rate
    assert isinstance(srv._proposer, DraftProposer)


def test_server_eos_retirement_mid_window():
    """An EOS inside a k = 4 window: each of three requests retires at
    it with the window's later tokens dropped, the freed slot serves the
    next request, and tokens_out counts only delivered tokens — as in
    the JAX server."""
    model = _lm()
    jp, tp = _pair(model, T)
    prompt = np.random.RandomState(27).randint(0, VOCAB, (6,))
    ref = tp.generate(prompt[None].astype(np.float32), 6,
                      max_new_tokens=8)[0]
    eos = next(int(ref[i]) for i in range(1, len(ref)) if ref[i] != ref[0])
    n = int(np.flatnonzero(ref == eos)[0]) + 1
    out = []
    for pred, cls in ((jp, JaxServer), (tp, DecodeServer)):
        srv = cls(pred, T, slots=1, eos_id=eos, max_new_tokens=64,
                  spec_k=4)
        ids = [srv.submit(prompt) for _ in range(3)]
        out.append((srv.run(), srv, ids))
    (want, jsrv, _), (got, srv, ids) = out
    for rid in ids:
        np.testing.assert_array_equal(got[rid], ref[:n])
        np.testing.assert_array_equal(got[rid], want[rid])
    assert srv.tokens_out == jsrv.tokens_out == 3 * n
    assert srv.spec_steps == jsrv.spec_steps > 0


# ---------------------------------------------------------------------------
# the gate, the arguments, the exports
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prompt_len,max_new,spec_k,pool_pages", [
    (5, 6, 0, 0), (5, 6, 3, 0), (9, 2, 8, 0), (14, 30, 4, 0), (3, 8, 8, 9),
    (12, 1, 2, 12)])
def test_gate_reserves_the_speculation_window(prompt_len, max_new, spec_k,
                                              pool_pages):
    """PagedKVManager.gate(spec_k=...) reserves the JAX manager's page
    count (and matches the same prefix) for the same inputs: a second
    request sharing the first's prompt, both budgets."""
    rng = np.random.RandomState(prompt_len + spec_k)
    first = rng.randint(0, VOCAB, prompt_len)
    second = np.concatenate([first[:prompt_len - 1], [VOCAB - 1]])
    got = []
    for cls in (JaxManager, PagedKVManager):
        mgr = cls(2, T, 4, pool_pages=pool_pages)
        rows = []
        for slot, prompt in enumerate((first, second)):
            for wrap in (True, False):
                g = mgr.gate(prompt, prompt.size, max_new, spec_k=spec_k,
                             budget_wrap_forks=wrap)
                rows.append(None if g is None else (g[0], g[2]))
                if g is not None and wrap:
                    mgr.allocator.unreserve(g[2])
                    for page in g[1]:
                        mgr.allocator.decref(page)
            g = mgr.gate(prompt, prompt.size, max_new, spec_k)
            if g is not None:
                mgr.map_slot(slot, g[1], g[2])
                mgr.ensure(slot, 0, prompt.size)
                mgr.publish(slot, prompt, prompt.size)
        got.append(rows)
    assert got[0] == got[1]
    assert any(r is not None for r in got[1])


def test_server_arguments_pick_the_proposer():
    """The JAX package's precedence: an explicit proposer (its k wins),
    then a draft (k = spec_k or 4), then MXNET_SPEC_K / spec_k with the
    n-gram proposer; a paged draft and a prompt window past the draft's
    ring are refused; the classes are exported."""
    _, tp = _pair(_lm(embed=8, layers=1, ffn=16), T)
    _, td = _pair(_lm(embed=8, layers=1, ffn=16), 2 * T)
    assert DecodeServer(tp, 8)._proposer is None
    srv = DecodeServer(tp, 8, spec_k=2, proposer=NGramProposer(5))
    assert srv._spec_k == 5
    srv = DecodeServer(tp, 8, draft=td)
    assert srv._spec_k == 4 and isinstance(srv._proposer, DraftProposer)
    srv = DecodeServer(tp, 8, spec_k=3)
    assert isinstance(srv._proposer, NGramProposer)
    assert srv._proposer.ngram == 2 and srv._proposer.k == 3
    _, tpaged = _pair(_lm(embed=8, layers=1, ffn=16), T, paged=True)
    with pytest.raises(mt.MXNetError, match="dense-cache"):
        DraftProposer(tpaged, 3)
    _, small = _pair(_lm(embed=8, layers=1, ffn=16), 8)
    with pytest.raises(mt.MXNetError, match="draft's cache_len"):
        DecodeServer(tp, 12, draft=small)
    assert {"NGramProposer", "DraftProposer"} <= set(decode.__all__)

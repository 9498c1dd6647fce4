"""The port's serving fleet (``mxnet_tpu_torch.serve.fleet`` /
``serve.swap`` and ``DecodeServer``'s session, priorities and
preemption) against the JAX package, drive for drive: the eight cases
of ``tests/test_fleet.py``, each run through both packages on the same
numpy weights and prompts (``weights.params_from_jax``).

Sizes are ``test_fleet.py``'s (vocab 17, T 32, embed 8, 2 heads, 2
layers, pages and chunks of 4).  Tokens are compared exactly (greedy);
the extracted page payloads with ``TOL`` on f32 planes (the serve
tests' rtol 1e-5 / atol 1e-6: the two packages sum the same f32
products in other orders), and int8 planes exactly, or one quantization
step apart at no more than ``INT8_FLIPS`` entries (a value that rounds
at the half step may land either way under another summation order).
"""
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config as jcfg
from mxnet_tpu.decode import DecodePredictor as JaxPredictor
from mxnet_tpu.decode import DecodeServer as JaxServer
from mxnet_tpu.models import attention_lm as jax_lm
from mxnet_tpu.serve import PageAllocator as JaxAllocator
from mxnet_tpu.serve import PrefixCache as JaxPrefixCache
from mxnet_tpu.serve import chain_hash as jax_chain_hash
from mxnet_tpu.serve import fleet as jax_fleet

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import config as tcfg
from mxnet_tpu_torch.decode import DecodePredictor, DecodeServer
from mxnet_tpu_torch.models import attention_lm
from mxnet_tpu_torch.serve import PageAllocator, PrefixCache, chain_hash
from mxnet_tpu_torch.serve import fleet as torch_fleet
from mxnet_tpu_torch.serve.swap import _leaves
from mxnet_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

VOCAB, T, EMBED, HEADS = 17, 32, 8, 2
TOL = dict(rtol=1e-5, atol=1e-6)
INT8_FLIPS = 4

JAX = dict(pred=JaxPredictor, server=JaxServer, fleet=jax_fleet,
           alloc=JaxAllocator, cache=JaxPrefixCache, hash=jax_chain_hash)
TORCH = dict(pred=DecodePredictor, server=DecodeServer, fleet=torch_fleet,
             alloc=PageAllocator, cache=PrefixCache, hash=chain_hash)


def _lm(seed=0):
    with mx.base.NameManager():
        sym = jax_lm.get_symbol(VOCAB, T, num_layers=2, embed=EMBED,
                                heads=HEADS, ffn_hidden=16)
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(data=(2, T), softmax_label=(2, T))
    params = {n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    with mt.NameManager():
        tsym = attention_lm.get_symbol(VOCAB, T, num_layers=2, embed=EMBED,
                                       heads=HEADS, ffn_hidden=16)
    return {"jax": (sym, params),
            "torch": (tsym, params_from_jax(params, device="cpu"))}


def _pred(pkg, model, cache_len=T, paged=True, **kw):
    if paged:
        kw.update(paged=True, page_tokens=4, prefill_chunk=4)
    if pkg is TORCH:
        kw["device"] = "cpu"
        sym, params = model["torch"]
    else:
        sym, params = model["jax"]
    return pkg["pred"](sym, params, cache_len=cache_len, **kw)


def _overrides(pkg, swap, bound=4):
    if pkg is TORCH:
        return tcfg.overrides(MXNET_FLEET_DECODE_BOUND=bound,
                              MXNET_FLEET_SWAP=bool(swap))
    return jcfg.overrides(MXNET_FLEET_DECODE_BOUND=str(bound),
                          MXNET_FLEET_SWAP="1" if swap else "0")


# ---------------------------------------------------------------------------
# radix matching and the chain summary
# ---------------------------------------------------------------------------
def _radix_drive(pkg):
    alloc = pkg["alloc"](32)
    cache = pkg["cache"](4, alloc)
    h = pkg["hash"]
    pages = [alloc.alloc() for _ in range(3)]
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]     # 2 full pages + [9, 10]
    cache.insert(prompt, 10, pages)
    out = {"matches": [cache.match(p) for p in (
        [1, 2, 3, 4, 5, 6, 99, 98, 97], [1, 2, 3, 4, 5, 6, 7, 8, 9, 77, 66],
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [1, 2, 3, 4])],
        "radix_hits": cache.radix_hits}
    summ = cache.summary()
    out["summary"] = json.dumps(summ)
    out["summary_cached"] = cache.summary() is summ
    out["hashes"] = [h([1, 2, 3, 4]), h(np.arange(40) % VOCAB), h([])]
    probes = ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [1, 2, 3, 4, 5, 6, 99],
              [1, 2, 3, 4], [7, 7, 7], [1, 2, 3, 4, 5, 6, 7, 8, 42])
    out["estimates"] = [pkg["fleet"].match_chains(p, summ) for p in probes]
    out["real"] = [cache.match(p)[0] for p in probes]
    cache.clear()
    for p in pages:
        alloc.decref(p)
    out["used_after"] = alloc.used_pages
    return out


def test_radix_matching_and_chain_summary_match_jax():
    """Token-level matches inside partial pages, the chain summary
    (byte-identical JSON: a router scores hosts by these hashes), the
    router's estimates (a lower bound of the real match) and the
    release to zero, the same in both packages."""
    got, want = _radix_drive(TORCH), _radix_drive(JAX)
    assert got == want
    assert got["matches"][0] == (6, [1, 2]) and got["radix_hits"] == 2
    summ = json.loads(got["summary"])
    assert chain_hash([1, 2, 3, 4]) in summ["full"]
    assert {"prefix": chain_hash([1, 2, 3, 4, 5, 6, 7, 8]), "len": 2,
            "hash": chain_hash([9, 10])} in summ["partial"]
    assert got["summary_cached"] is True
    assert all(e <= r for e, r in zip(got["estimates"], got["real"]))
    assert got["estimates"][0] == 10 and got["estimates"][-1] == 8
    assert got["used_after"] == 0


# ---------------------------------------------------------------------------
# router units on stub hosts (no model)
# ---------------------------------------------------------------------------
class _StubServer:
    def __init__(self):
        self.submitted = []
        self._max_new = 8
        self._preempt_cb = None
        self._req = {}
        self._pred = type("P", (), {"_page_tokens": 4})()
        self.swap_outs = 0

    def submit(self, prompt, cap, priority=0):
        rid = len(self.submitted)
        self.submitted.append(np.asarray(prompt))
        self._req[rid] = {"submit": 0.0}
        return rid

    def _bind_host_metrics(self, name):
        pass


class _TickStubServer(_StubServer):
    """A host whose tick finishes one queued request with the prompt's
    length as its tokens."""

    def __init__(self):
        super().__init__()
        self._pending = []
        self._done = {}
        self.completed = 0

    def submit(self, prompt, cap, priority=0):
        hrid = super().submit(prompt, cap, priority)
        self._pending.append((hrid, np.asarray(prompt)))
        return hrid

    @property
    def has_work(self):
        return bool(self._pending)

    def serve_tick(self):
        if self._pending:
            hrid, prompt = self._pending.pop(0)
            self._done[hrid] = np.full((2,), prompt.size, np.int32)
            self.completed += 1

    def serve_results(self, clear=True):
        out = dict(self._done)
        if clear:
            self._done.clear()
        return out


def _stub_host(pkg, name, chains, load):
    class Host(pkg["fleet"].FleetHost):
        def summary(self):
            return {"host": self.name, "slots": 4, "active": self._load,
                    "queue_depth": 0, "free_pages": 64, "swap_outs": 0,
                    "chains": self._chains}

    host = Host(name, _StubServer())
    host._chains, host._load = chains, load
    return host


def _affinity_drive(pkg):
    h = pkg["hash"]

    def chains(tokens):
        toks = np.asarray(tokens, np.int64)
        return {"page_tokens": 4, "partial": [],
                "full": [h(toks[:(i + 1) * 4]) for i in range(toks.size // 4)]}

    Router = pkg["fleet"].Router
    tenant = np.arange(12) % VOCAB
    prompt = np.concatenate([tenant, [7, 7]])

    def route(router, rid, p):
        return router.route({"rid": rid, "prompt": p, "cap": 4, "prio": 0,
                             "submit": 0.0}).name

    out = [route(Router([_stub_host(pkg, "short", chains(tenant[:4]), 0),
                         _stub_host(pkg, "long", chains(tenant), 3)]),
                 0, prompt)]
    ha = _stub_host(pkg, "a", chains(tenant), 5)
    hb = _stub_host(pkg, "b", chains(tenant), 1)
    r2 = Router([ha, hb])
    out.append(route(r2, 0, prompt))
    hb.alive = False
    out.append(route(r2, 1, prompt))
    empty = {"page_tokens": 4, "full": [], "partial": []}
    hd = _stub_host(pkg, "d", empty, 0)
    r3 = Router([_stub_host(pkg, "c", empty, 2), hd])
    cold = np.asarray([9, 8, 7, 6, 5])
    out.append(route(r3, 0, cold))
    hd._load = 9
    out.append(route(r3, 1, cold))
    r4 = Router([_stub_host(pkg, "x", chains(tenant), 0),
                 _stub_host(pkg, "y", chains(tenant), 0)],
                policy="round_robin")
    out.append([route(r4, i, prompt) for i in range(4)])
    out.append([d[1:] for d in r2.decisions + r3.decisions])
    return out


def _health_drive(pkg):
    fl = pkg["fleet"]
    health = {"a": True, "b": True}
    sa, sb = _TickStubServer(), _TickStubServer()
    ha = fl.FleetHost("a", sa, health=lambda: health["a"])
    hb = fl.FleetHost("b", sb, health=lambda: health["b"])
    router = fl.Router([ha, hb], policy="round_robin")
    prompts = [np.arange(n) % VOCAB for n in (3, 4, 5, 6)]
    rids = [router.submit(p, 2) for p in prompts]
    while router._queue:
        router.route(router._queue.popleft())
    log = [(len(sa.submitted), len(sb.submitted))]
    health["a"] = False
    router.tick()
    log.append((ha.alive, list(router.host_flips)))
    res = router.drain()
    log.append(({r: res[r].tolist() for r in rids}, sa.completed,
                sb.completed))
    health["a"] = True
    log.append(router.poll_health())
    r2 = router.submit(np.arange(4), 2)
    router.drain()
    log.append((r2 in router.results, len(router.results)))
    r3 = router.submit(np.arange(5), 2)
    while router._queue:
        router.route(router._queue.popleft())
    owner_name = next(k[0] for k, v in router._map.items() if v == r3)
    owner = sa if owner_name == "a" else sb
    n_before = len(router.results)
    health[owner_name] = False
    router.tick()
    owner.serve_tick()
    res = router.drain()
    log.append((res[r3].tolist(), len(router.results) - n_before))
    health[owner_name] = True
    router.poll_health()
    health["a"] = health["b"] = False
    r4 = router.submit(np.arange(3), 2)
    router.poll_health()
    with pytest.raises(Exception, match="no live decode hosts"):
        router.tick()
    log.append(len(router._queue))
    health["a"] = health["b"] = True
    log.append(router.drain()[r4].tolist())
    # health grace: N failures tolerated beyond the first
    up = {"ok": False}
    host = fl.FleetHost("g", _TickStubServer(), health=lambda: up["ok"],
                        health_grace=1)
    rg = fl.Router([host], policy="round_robin")
    grace = [rg.poll_health(), host.alive]
    up["ok"] = True
    rg.poll_health()
    up["ok"] = False
    grace += [rg.poll_health(), host.alive, rg.poll_health(), host.alive]
    return log, grace


def test_router_affinity_units_match_jax():
    """Longest chain wins over load; equal chains go to the lighter
    host; dead hosts are skipped; cold prompts bind to the least-loaded
    host and stay bound; round-robin ignores chains — the same hosts
    and decisions in both packages."""
    got = _affinity_drive(TORCH)
    assert got == _affinity_drive(JAX)
    assert got[:5] == ["long", "b", "a", "d", "d"]
    assert got[5] == ["x", "y", "x", "y"]


@pytest.mark.parametrize("case", ["requeue", "grace"])
def test_router_health_matches_jax(case):
    """A host whose probe goes dark flips dead, its in-flight requests
    requeue and finish on the survivor exactly once, a recovering probe
    brings it back, an all-dark fleet fails loudly with the queue held;
    ``health_grace`` tolerates one failure beyond the first.  The same
    log in both packages."""
    got, want = _health_drive(TORCH), _health_drive(JAX)
    if case == "requeue":
        assert got[0] == want[0]
        log = got[0]
        assert log[1] == (False, [("a", False)])
        assert log[2][1:] == (0, 4)
        assert log[3] == [("a", True, 0)]
        assert log[4] == (True, 5)
        assert log[5] == ([5, 5], 1)
        assert log[6] == 1 and log[7] == [3, 3]
    else:
        assert got[1] == want[1] == [[], True, [], True,
                                     [("g", False, 0)], False]


# ---------------------------------------------------------------------------
# swap-out / readmit (one host)
# ---------------------------------------------------------------------------
def _swap_drive(pkg, model, kv_dtype, swap, cap=24):
    rng = np.random.RandomState(3)
    long_p = rng.randint(0, VOCAB, (6,))
    short_p = rng.randint(0, VOCAB, (5,))
    with _overrides(pkg, swap):
        pred = _pred(pkg, model, cache_len=16, pool_pages=6,
                     prefix_cache=False, kv_dtype=kv_dtype)
        srv = pkg["server"](pred, max_prefill=8, slots=2,
                            max_new_tokens=cap)
        srv._verify_restore = True
        records = []
        swap_out = srv._swap_out

        def spy(ps, slot):
            records.append(swap_out(ps, slot))
            return records[-1]

        srv._swap_out = spy
        name = next(iter(pred._env))
        before = np.array(pred._env[name], copy=True)
        r1 = srv.submit(long_p, cap, priority=-1)
        r2 = srv.submit(short_p, 4, priority=1)
        res = srv.run()
    after = np.asarray(pred._env[name])
    return dict(tokens=(res[r1], res[r2]), srv=srv, pred=pred,
                records=records, params_kept=np.array_equal(before, after),
                prompts=(long_p, short_p))


def _assert_payload_close(got, want, row_valid):
    """Two packages' page payloads of the same state: f32 planes within
    TOL, int8 planes equal or one step apart at <= INT8_FLIPS
    entries."""
    gl = _leaves(got)
    wl = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = np.asarray(g)[row_valid], np.asarray(w)[row_valid]
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and int((diff > 0).sum()) <= INT8_FLIPS
        else:
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_swap_out_readmit_matches_jax(kv_dtype):
    """A tight pool plus the fair-admission bound preempts the
    low-priority long decode; readmission restores its pages byte for
    byte (``_verify_restore``).  Tokens equal the JAX server's and a
    never-preempted run's (the same server with swap off: backpressure);
    swap_outs == swap_ins >= 1; extract and install are captured once
    each; the parameters are untouched; the pool drains; and the
    swapped record's pages match the JAX package's record of the same
    state."""
    model = _lm(seed=3)
    got = _swap_drive(TORCH, model, kv_dtype, swap=True)
    want = _swap_drive(JAX, model, kv_dtype, swap=True)
    never = _swap_drive(TORCH, model, kv_dtype, swap=False)
    srv, pred = got["srv"], got["pred"]
    assert never["srv"].swap_outs == 0
    for toks, ref, unswapped in zip(got["tokens"], want["tokens"],
                                    never["tokens"]):
        np.testing.assert_array_equal(toks, ref)
        np.testing.assert_array_equal(toks, unswapped)
    assert srv.swap_outs >= 1 and srv.swap_ins == srv.swap_outs
    assert srv.swap_outs == want["srv"].swap_outs
    assert got["params_kept"]
    tc = pred.trace_counts
    assert tc["extract"] == 1 and tc["install"] == 1, tc
    assert tc["chunk"] == 1 and tc["decode"] == 1 and tc["commit"] == 1
    assert pred._manager.allocator.used_pages == 0
    stats = srv.stats()
    assert stats["swap_outs"] == stats["swap_ins"] == srv.swap_outs
    # the first swapped record: the same request, lengths and pages
    g, w = got["records"][0], want["records"][0]
    assert (g.lens, g.tok, g.delivered, g.history) == \
        (w.lens, w.tok, w.delivered, w.history)
    np.testing.assert_array_equal(g.row_valid, w.row_valid)
    assert g.nbytes() == w.nbytes() > 0
    _assert_payload_close(g.data, w.data, g.row_valid)


def test_swap_disabled_keeps_backpressure():
    """MXNET_FLEET_SWAP=0: the waiter queues until retirements free
    pages — no preemption, the JAX server's tokens."""
    model = _lm(seed=3)
    got = _swap_drive(TORCH, model, "", swap=False, cap=12)
    want = _swap_drive(JAX, model, "", swap=False, cap=12)
    assert got["srv"].swap_outs == 0 and not got["records"]
    for a, b in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(a, b)
    assert got["pred"].trace_counts["extract"] == 0


# ---------------------------------------------------------------------------
# the fleet: token identity across migration, affinity, refcounts
# ---------------------------------------------------------------------------
def _fleet_drive(pkg, model):
    rng = np.random.RandomState(11)
    fl = pkg["fleet"]
    hosts = [fl.FleetHost("fh%d" % i, pkg["server"](
        _pred(pkg, model), max_prefill=T, slots=2, max_new_tokens=6))
        for i in range(2)]
    worker = fl.PrefillWorker(_pred(pkg, model), "fw0")
    router = fl.Router(hosts, [worker], policy="cache_aware")
    prefixes = [rng.randint(0, VOCAB, (12,)) for _ in range(2)]
    prompts, rids, tenants = [], [], []
    for wave in range(2):
        for tnt in range(2):
            for _ in range(2):
                p = np.concatenate([prefixes[tnt],
                                    rng.randint(0, VOCAB, (3,))])
                prompts.append(p)
                rids.append(router.submit(p, 6))
                tenants.append(tnt)
        for _ in range(8):
            router.tick()
    res = router.drain()
    return dict(res=res, rids=rids, prompts=prompts, tenants=tenants,
                router=router, hosts=hosts, worker=worker)


def test_fleet_token_identity_and_refcount_drain():
    """Two hosts and a prefill worker on a two-tenant shared-prefix
    trace: every result equals the JAX fleet's and a one-host
    ``generate``; the routing decisions are the JAX router's; pages
    migrate; each tenant stays on one host; no program is captured
    twice on any predictor; every pool drains once the prefix caches
    let go."""
    model = _lm(seed=0)
    got, want = _fleet_drive(TORCH, model), _fleet_drive(JAX, model)
    ref = _pred(TORCH, model)
    for rid, p in zip(got["rids"], got["prompts"]):
        np.testing.assert_array_equal(got["res"][rid], want["res"][rid])
        np.testing.assert_array_equal(got["res"][rid], ref.generate(
            p[None].astype(np.float32), p.size, max_new_tokens=6)[0])
    router = got["router"]
    assert router.decisions == want["router"].decisions
    stats = router.stats()
    assert stats["worker_prefills"] >= 1
    assert sum(stats["migrated_pages_by_host"].values()) >= 1
    assert stats["migrated_pages_by_host"] == \
        want["router"].stats()["migrated_pages_by_host"]
    assert stats["router_cache_hit_rate"] > 0
    assert "ttft_p50_s" in stats and "ttft_p95_s" in stats
    by_tenant = {}
    for (rid, host, matched, path), tnt in zip(router.decisions,
                                               got["tenants"]):
        by_tenant.setdefault(tnt, set()).add(host)
    assert all(len(hs) == 1 for hs in by_tenant.values()), by_tenant
    preds = [h.server._pred for h in got["hosts"]] + [got["worker"]._pred]
    for pred in preds:
        tc = pred.trace_counts
        assert all(tc[k] <= 1 for k in ("chunk", "decode", "fork", "commit",
                                        "extract", "install")), tc
    assert got["worker"]._pred.trace_counts["extract"] == 1
    for pred in preds:
        mgr = pred._manager
        if mgr.prefix_cache is not None:
            mgr.prefix_cache.clear()
        assert mgr.allocator.used_pages == 0, mgr.stats()


# ---------------------------------------------------------------------------
# /metrics.json
# ---------------------------------------------------------------------------
def test_metrics_json_serves_chain_summary():
    """The exporter's /metrics.json carries ``mx_serve_summary`` (the
    chain digest and load signals a remote router polls), the JAX
    server's for the same serve, beside the registry families."""
    model = _lm(seed=0)
    prompt = np.random.RandomState(5).randint(0, VOCAB, (9,))
    summaries = []
    for pkg in (TORCH, JAX):
        srv = pkg["server"](_pred(pkg, model), max_prefill=T, slots=2,
                            max_new_tokens=4)
        srv.submit(prompt)
        srv.run()
        summaries.append(srv.serve_summary())
    tsum, jsum = summaries
    assert json.dumps(tsum["chains"]) == json.dumps(jsum["chains"])
    assert {k: v for k, v in tsum.items() if k != "chains"} == \
        {k: v for k, v in jsum.items() if k != "chains"}
    ms = mt.obs.MetricsServer(port=0).start()
    try:
        ms.add_json("mx_serve_summary", lambda: tsum)
        payload = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/metrics.json" % ms.port).read())
        summ = payload["mx_serve_summary"]
        assert summ["host"] == "local" and summ["queue_depth"] == 0
        assert summ["free_pages"] > 0
        assert summ["chains"]["page_tokens"] == 4
        est = torch_fleet.match_chains(np.concatenate([prompt, [1, 2]]),
                                       summ["chains"])
        assert est >= (prompt.size // 4) * 4
        assert "mx_fleet_free_pages" in payload
        assert "mx_serve_steps" in payload
    finally:
        ms.stop()

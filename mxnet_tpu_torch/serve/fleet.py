"""Disaggregated serving fleet — cache-aware routing, prefill/decode
split, and preemption-aware readmission over N per-host ``DecodeServer``s
(the port of ``mxnet_tpu/serve/fleet.py``).

A front-end :class:`Router` mediates N hosts, three policies deep:

* **Cache-aware routing.**  Every host exposes a routing view
  (``DecodeServer.serve_summary`` — served remotely inside
  ``/metrics.json``, read directly in-process): free-page and
  queue-depth load signals plus the prefix-cache **chain summary**
  (content-free token-chain hashes,
  :meth:`~mxnet_tpu_torch.serve.prefix_cache.PrefixCache.summary`).  The
  router replays the same hashes over an incoming prompt
  (:func:`match_chains`) and routes to the host with the LONGEST cached
  chain, tie-broken by load — shared-prefix traffic lands where its
  pages already live and prefills only the tail.  ``round_robin`` is
  the baseline policy.
* **Prefill/decode disaggregation** (DistServe; Zhong et al., OSDI
  2024).  Prompts too cold to ride a cache match (below
  ``MXNET_FLEET_PREFILL_THRESHOLD``) go to a dedicated
  :class:`PrefillWorker`, which runs the SAME chunked-prefill program
  into its own pool and ships the committed pages — quantized data +
  per-(token, head) scales + chain keys — as a
  :class:`~mxnet_tpu_torch.serve.swap.SwappedRequest` record.  The
  target decode host admits it through the normal
  :meth:`~mxnet_tpu_torch.serve.manager.PagedKVManager.gate_pages`
  reservation gate and installs the pages with one captured scatter
  (page ids are data — no new capture on either end), then publishes
  the chain keys so later prompts match the migrated prefix.
* **Preemption/swap.**  When a host's pool wedges
  (``MXNET_FLEET_SWAP`` + ``MXNET_FLEET_DECODE_BOUND``), the victim's
  record lands back at the router (``_preempt_cb``) and readmits on the
  least-loaded ALIVE host — swap and migration are one mechanism, so a
  fleet drains around a wedged pool instead of stalling admission
  fleet-wide.

Dead hosts (``FleetHost.alive = False`` — set by an operator or a
failed health poll) are skipped by routing and ticking.  Everything
here is host-side numpy + the serve/swap records; device work happens
inside the per-host serving loops (on one card, every host and worker
is a predictor of its own).
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

from ..base import MXNetError
from .. import obs as _obs
from .prefix_cache import chain_hash
from .swap import SwapStore

__all__ = ["FleetHost", "PrefillWorker", "Router", "http_health",
           "match_chains"]


def http_health(url, timeout=1.0):
    """Poll a remote host's ``/healthz`` endpoint (the
    ``obs.MetricsServer`` liveness probe); False on any error or
    non-200 — a dark host and a dead host read the same to the router."""
    import urllib.request

    if not url.rstrip("/").endswith("/healthz"):
        url = url.rstrip("/") + "/healthz"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status == 200
    except Exception:
        return False


def match_chains(prompt, chains):
    """Estimated cached-chain coverage of ``prompt`` on a host, from its
    content-free chain summary (:meth:`PrefixCache.summary`): walk full
    pages by prefix hash, then the longest exactly-matching partial
    entry.  Page-granular plus exact partials — the host's token-level
    radix matching can only do better, so the estimate is a safe lower
    bound.  Capped at ``len(prompt) - 1`` like the cache itself."""
    toks = np.asarray(prompt, np.int64).reshape(-1)
    if not chains or toks.size == 0:
        return 0
    pt = int(chains["page_tokens"])
    cap = toks.size - 1
    full = set(chains.get("full") or ())
    n = 0
    while (n + 1) * pt <= toks.size \
            and chain_hash(toks[:(n + 1) * pt]) in full:
        n += 1
    matched = n * pt
    rest = toks[matched:]
    ph = chain_hash(toks[:matched])
    best = 0
    for part in chains.get("partial") or ():
        ln = int(part["len"])
        if part["prefix"] == ph and best < ln <= rest.size \
                and chain_hash(rest[:ln]) == part["hash"]:
            best = ln
    return min(matched + best, cap)


class FleetHost:
    """One decode host: a named paged :class:`~mxnet_tpu_torch.decode.
    DecodeServer` plus liveness.  ``summary()`` is the router's poll —
    in-process it reads the server directly; a remote router reads the
    identical payload from the host's ``/metrics.json``
    (``mx_serve_summary``)."""

    def __init__(self, name, server, health=None, health_grace=0):
        self.name = str(name)
        self.server = server
        self.alive = True
        # liveness probe: a callable returning bool, or a base URL whose
        # /healthz the router polls (http_health).  None = no probe —
        # this host's `alive` only flips by operator hand, the pre-HA
        # behavior.  health_grace = consecutive failed polls tolerated
        # BEYOND the first before flipping dark (0 = flip immediately;
        # production URL probes should set >= 1 so one timed-out scrape
        # of a loaded-but-healthy host doesn't requeue its whole batch)
        self.health = health
        self.health_grace = int(health_grace)
        self._health_fails = 0
        server._bind_host_metrics(self.name)

    def healthz(self):
        """One health poll: True/False from the probe, None when this
        host has no probe configured."""
        h = self.health
        if h is None:
            return None
        if callable(h):
            try:
                return bool(h())
            except Exception:
                return False
        return http_health(h)

    def summary(self):
        return self.server.serve_summary()

    def load(self, summary=None):
        """Queued + in-flight requests — the routing tie-breaker."""
        s = summary or self.summary()
        return int(s["active"]) + int(s["queue_depth"])


class PrefillWorker:
    """A dedicated prefill host (DistServe's prefill instance): runs
    chunked prefill into its OWN page pool and emits the committed
    prompt state as a migratable record.  The worker keeps a prefix
    cache too, so a shared-prefix burst that routes cold pays the
    prefix once per WORKER, not once per request."""

    def __init__(self, predictor, name="prefill0"):
        if not getattr(predictor, "_paged", False):
            raise MXNetError("PrefillWorker needs a paged DecodePredictor")
        self._pred = predictor
        self.name = str(name)
        self._state = None
        self.prefills = 0

    def reset(self):
        """Fresh pool + prefix cache (compiled programs survive)."""
        self._state = None

    def prefill(self, prompt, cap, priority=0, submit_ts=None,
                generator=None):
        """Run one prompt's chunked prefill; returns the ``migrate``
        record (pages + scales + chain keys + first token) ready for
        :meth:`DecodeServer.inject` on any decode host.  ``generator``
        draws the first token under a sampling policy (the worker
        predictor's own by default)."""
        from .swap import SwappedRequest

        pred = self._pred
        if self._state is None:
            self._state = pred.paged_batch_state(1)
        mgr = pred._manager
        prompt = np.asarray(prompt).reshape(-1).astype(np.int64)
        gate = mgr.gate(prompt, prompt.size, 0, budget_wrap_forks=False)
        if gate is None and mgr.prefix_cache is not None:
            mgr.prefix_cache.evict(mgr.pool_pages)
            gate = mgr.gate(prompt, prompt.size, 0,
                            budget_wrap_forks=False)
        if gate is None:
            raise MXNetError(
                "prefill worker pool (%d pages) cannot hold a %d-token "
                "prompt — raise its pool_pages" % (mgr.pool_pages,
                                                   prompt.size))
        matched, pages, reserve_n = gate
        mgr.map_slot(0, pages, reserve_n)
        if generator is None:
            generator = pred._sampling_generator()
        _, tok, _ = pred._chunked_fill(self._state.caches, 0, prompt,
                                       matched, generator)
        # the chunk's token is valid until the next program call
        first = int(tok[0, 0])
        mgr.publish(0, prompt, prompt.size)
        row = mgr.tables[0].copy()
        data = pred.extract_pages(self._state.caches, row)
        record = SwappedRequest(
            prompt, [first], list(prompt) + [first], cap, priority,
            lens=prompt.size, tok=first, row_valid=row != 0, data=data,
            kind="migrate", publish=True, submit_ts=submit_ts,
            first_ts=time.time(), kv_heads=pred._grouped_kv_heads)
        mgr.free_slot(0)
        self.prefills += 1
        return record


class Router:
    """Front-end over N :class:`FleetHost`\\ s (+ optional
    :class:`PrefillWorker`\\ s).

    ``submit`` queues; ``tick`` routes pending requests and advances
    every live host by one serving iteration; ``drain`` loops to
    completion and returns ``{router_rid: np.int32 tokens}``.  Policies:
    ``cache_aware`` (longest chain match, load tie-break, dead-host
    skip; disaggregates cold prompts through the prefill workers) and
    ``round_robin`` (the monolithic baseline — next live host, no
    disaggregation).  Preempted records re-enter here and readmit on
    the least-loaded live host (restore is host-agnostic — pages are
    raw pool bytes).
    """

    def __init__(self, hosts, prefill_workers=(), policy="cache_aware",
                 threshold=None, health_interval=None):
        from .. import config as _config

        if policy not in ("cache_aware", "round_robin"):
            raise MXNetError("unknown routing policy %r" % (policy,))
        self.hosts = list(hosts)
        if not self.hosts:
            raise MXNetError("Router needs at least one host")
        # tick-time health polling cadence (seconds): in-process callable
        # probes are free and poll every tick; URL probes block up to
        # their HTTP timeout, so a fleet with any URL-probed host rate-
        # limits to once a second by default — a dark host must not
        # throttle every surviving host's serving ticks behind a
        # connect timeout
        if health_interval is None:
            health_interval = 1.0 if any(
                isinstance(h.health, str) for h in self.hosts) else 0.0
        self._health_interval = float(health_interval)
        self._last_health = 0.0
        self.workers = list(prefill_workers)
        self.policy = policy
        self._threshold = float(
            _config.get("MXNET_FLEET_PREFILL_THRESHOLD")
            if threshold is None else threshold)
        self._queue = deque()       # unrouted submissions
        self._restores = deque()    # preempted records awaiting rehoming
        self.swap_store = SwapStore()   # host-RAM bill of parked records
        self._next_rid = 0
        self._rr = 0                # round-robin cursor
        self._wrr = 0               # worker cursor
        self._affinity = {}         # first-page chain hash -> host name
        self._map = {}              # (host_name, host_rid) -> router rid
        self._inflight = {}         # (host_name, host_rid) -> submission
        # entry, kept until completion so a host that goes dark can have
        # its in-flight requests requeued (at-least-once semantics)
        self.results = {}
        self.decisions = []         # (rid, host, matched_est, path)
        self.host_flips = []        # (host, alive) health-driven flips
        self._m_flips = _obs.registry.counter(
            "mx_fleet_host_flips", "health-driven alive flips",
            labels=("host", "to"))
        self._m_routed = _obs.registry.counter(
            "mx_fleet_routed", "requests routed to a decode host",
            labels=("host",))
        self._m_matched = _obs.registry.counter(
            "mx_fleet_router_matched_tokens",
            "prompt tokens the routing-time chain match covered")
        self._m_lookup = _obs.registry.counter(
            "mx_fleet_router_lookup_tokens",
            "prompt tokens scored by the router")
        self._base_matched = self._m_matched.get()
        self._base_lookup = self._m_lookup.get()
        for host in self.hosts:
            host.server._preempt_cb = \
                lambda record, h=host: self._on_preempt(h, record)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, priority=0):
        """Queue a prompt with the fleet; returns the router-level rid."""
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append({"rid": rid,
                            "prompt": np.asarray(prompt).reshape(-1),
                            "cap": max_new_tokens, "prio": int(priority),
                            "submit": time.time()})
        return rid

    def _alive(self):
        hosts = [h for h in self.hosts if h.alive]
        if not hosts:
            raise MXNetError("no live decode hosts")
        return hosts

    def _on_preempt(self, host, record):
        self.swap_store.put(record, key=(host.name, record.rid))
        self._restores.append((host.name, record))

    # ------------------------------------------------------------------
    def _score(self, prompt, summaries):
        """(host, summary, matched-token estimate) per live host."""
        out = []
        for host, s in summaries:
            out.append((host, s, match_chains(prompt, s["chains"])))
        return out

    def route(self, entry):
        """Route ONE submission: pick the host (and the prefill path)
        under the active policy and dispatch it.  Returns the chosen
        :class:`FleetHost`."""
        alive = self._alive()
        prompt = entry["prompt"]
        if self.policy == "round_robin":
            host = alive[self._rr % len(alive)]
            self._rr += 1
            matched, path = 0, "direct"
        else:
            summaries = [(h, h.summary()) for h in alive]
            scored = self._score(prompt, summaries)
            best = max(s[2] for s in scored)
            self._m_lookup.inc(max(prompt.size - 1, 0))
            self._m_matched.inc(best)
            matched = best
            if best > 0:
                # longest chain wins; load breaks ties
                host = max(scored,
                           key=lambda s: (s[2], -s[0].load(s[1])))[0]
            else:
                # nothing cached anywhere yet: STICKY affinity by the
                # prompt's first-page chain hash — the first sighting of
                # a chain binds it to the least-loaded live host, and
                # every later cold request of the same chain follows, so
                # a cold burst of one tenant co-locates (its second
                # request finds the first one's pages) while distinct
                # tenants spread by load instead of hash luck
                pt = int(getattr(alive[0].server._pred, "_page_tokens",
                                 0) or 16)
                head = chain_hash(np.asarray(prompt, np.int64)[:pt])
                bound = self._affinity.get(head)
                host = next((h for h in alive if h.name == bound), None)
                if host is None:
                    host = min(scored,
                               key=lambda s: s[0].load(s[1]))[0]
                    self._affinity[head] = host.name
            path = "prefill_worker" if self.workers \
                and best < self._threshold * prompt.size else "direct"
        if path == "prefill_worker":
            worker = self.workers[self._wrr % len(self.workers)]
            self._wrr += 1
            record = worker.prefill(prompt, entry["cap"]
                                    if entry["cap"] is not None
                                    else host.server._max_new,
                                    priority=entry["prio"],
                                    submit_ts=entry["submit"])
            hrid = host.server.inject(record)
        else:
            hrid = host.server.submit(prompt, entry["cap"],
                                      priority=entry["prio"])
            host.server._req[hrid]["submit"] = entry["submit"]
        self._map[(host.name, hrid)] = entry["rid"]
        self._inflight[(host.name, hrid)] = entry
        self._m_routed.labels(host=host.name).inc()
        self.decisions.append((entry["rid"], host.name, int(matched),
                               path))
        _obs.instant("route", cat="fleet",
                     args={"rid": entry["rid"], "host": host.name,
                           "matched": int(matched), "path": path})
        return host

    # ------------------------------------------------------------------
    # health-driven HA: /healthz polling flips `alive` and requeues a
    # dark host's in-flight requests on the survivors
    # ------------------------------------------------------------------
    def poll_health(self):
        """Poll every host that has a health probe and flip ``alive``
        accordingly.  A host going DARK has its in-flight requests
        (queued-on-host and mid-decode alike) requeued at the router —
        they re-route to live hosts and restart from the prompt
        (at-least-once: generated-so-far tokens on the dark host are
        lost, tokens are only ever delivered once because the dead
        host's result mapping is dropped).  A host whose probe recovers
        flips back alive and rejoins routing.  Returns the
        ``[(host, alive, requeued)]`` flips this poll made."""
        flips = []
        for host in self.hosts:
            ok = host.healthz()
            if ok is None:
                continue
            if ok:
                host._health_fails = 0
            else:
                host._health_fails += 1
            if host.alive and not ok \
                    and host._health_fails > host.health_grace:
                host.alive = False
                n = self._requeue_host(host.name)
                flips.append((host.name, False, n))
                self.host_flips.append((host.name, False))
                self._m_flips.labels(host=host.name, to="down").inc()
                _obs.instant("host_down", cat="fleet",
                             args={"host": host.name, "requeued": n})
            elif not host.alive and ok:
                host.alive = True
                flips.append((host.name, True, 0))
                self.host_flips.append((host.name, True))
                self._m_flips.labels(host=host.name, to="up").inc()
                _obs.instant("host_up", cat="fleet",
                             args={"host": host.name})
        return flips

    def _requeue_host(self, name):
        """Requeue every in-flight request of a dark host (original
        submission entries, original submit timestamps — TTFT stays
        honest) and drop its result mappings plus any cold-affinity
        bindings, so chains rebind to a live host."""
        n = 0
        requeued = set()
        for key in [k for k in self._map if k[0] == name]:
            self._map.pop(key)
            entry = self._inflight.pop(key, None)
            if entry is not None:
                self._queue.append(entry)
                requeued.add(key[1])
                n += 1
        # a record the dark host preempted but that has not rehomed yet
        # would otherwise be injected as an ORPHAN (its mapping is gone,
        # its results unconsumable) while the requeued original also
        # runs — consume the restore copy and its swap-store bill here
        if requeued:
            kept = deque()
            while self._restores:
                src, record = self._restores.popleft()
                if src == name and record.rid in requeued:
                    self.swap_store.pop((src, record.rid))
                    continue
                kept.append((src, record))
            self._restores = kept
        for head in [h for h, bound in self._affinity.items()
                     if bound == name]:
            del self._affinity[head]
        return n

    # ------------------------------------------------------------------
    def tick(self):
        """One fleet iteration: poll health (flipping ``alive`` and
        requeuing a dark host's work; URL-probed fleets rate-limit the
        poll — see ``health_interval``), route every pending submission
        and preempted record, then advance each live host by one
        serving iteration and collect finished results."""
        now = time.time()
        if now - self._last_health >= self._health_interval:
            self._last_health = now
            self.poll_health()
        if (self._queue or self._restores) \
                and not any(h.alive for h in self.hosts):
            # fail loudly BEFORE popping anything: the queued entries
            # and preempted records stay held, so a caller that catches
            # this can wait for a health recovery and resume with
            # nothing lost (previously the popped entry was dropped)
            raise MXNetError("no live decode hosts")
        while self._queue:
            self.route(self._queue.popleft())
        while self._restores:
            src_name, record = self._restores.popleft()
            # readmit on the least-loaded live host — no prefill, no
            # cache match needed: pages restore as raw pool bytes
            host = min(self._alive(), key=lambda h: h.load())
            rr = self._map.pop((src_name, record.rid), None)
            entry = self._inflight.pop((src_name, record.rid), None)
            self.swap_store.pop((src_name, record.rid))
            hrid = host.server.inject(record)
            if rr is not None:
                self._map[(host.name, hrid)] = rr
            if entry is not None:
                self._inflight[(host.name, hrid)] = entry
            _obs.instant("rehome", cat="fleet",
                         args={"from": src_name, "host": host.name,
                               "pages": record.n_pages})
        for host in self.hosts:
            if host.alive and host.server.has_work:
                host.server.serve_tick()
                done = host.server.serve_results(clear=True)
                for hrid, toks in done.items():
                    rr = self._map.pop((host.name, hrid), None)
                    self._inflight.pop((host.name, hrid), None)
                    if rr is not None:
                        self.results[rr] = toks

    @property
    def has_work(self):
        return bool(self._queue or self._restores
                    or any(h.alive and h.server.has_work
                           for h in self.hosts))

    def drain(self):
        """Tick until the fleet is idle; returns (and keeps) the
        accumulated ``{router_rid: tokens}``."""
        while self.has_work:
            self.tick()
        return self.results

    def reset(self):
        """Cold-start every host session and worker pool (fresh pools,
        managers, prefix caches; compiled programs survive) and clear
        the router's routing log — the reset between two timed drains
        (one policy against another)."""
        for host in self.hosts:
            host.server.serve_reset()
            host.server._queue.clear()
        for worker in self.workers:
            worker.reset()
        self._queue.clear()
        self._restores.clear()
        self._map.clear()
        self._inflight.clear()
        self._affinity.clear()
        self.results = {}
        self.decisions = []
        self.host_flips = []
        self._base_matched = self._m_matched.get()
        self._base_lookup = self._m_lookup.get()
        # cold-start THIS router's TTFT samples too, or stats() after a
        # timed drain would blend in warmup-compile outliers
        fam = _obs.registry.get("mx_fleet_ttft")
        if fam is not None:
            for host in self.hosts:
                fam.reset_series(host.name)

    # ------------------------------------------------------------------
    def stats(self):
        """Fleet snapshot derived from the mx_fleet_* registry families
        (no parallel bookkeeping): per-host routed counts, migrated /
        swapped pages, aggregate TTFT percentiles over this router's
        hosts, and the routing-time cache-hit estimate."""
        reg = _obs.registry
        names = {h.name for h in self.hosts}

        def per_host(metric):
            fam = reg.get(metric)
            out = {}
            if fam is None:
                return out
            for values, s in fam.series():
                labels = dict(zip(fam.label_names, values))
                if labels.get("host") in names:
                    out[labels["host"]] = s.value
            return out

        ttft = []
        fam = reg.get("mx_fleet_ttft")
        if fam is not None:
            for values, s in fam.series():
                labels = dict(zip(fam.label_names, values))
                if labels.get("host") in names:
                    ttft.extend(s.samples)
        ttft.sort()
        lookup = self._m_lookup.get() - self._base_lookup
        matched = self._m_matched.get() - self._base_matched
        out = {
            "policy": self.policy,
            "hosts": sorted(names),
            "alive_hosts": sorted(h.name for h in self.hosts if h.alive),
            "host_flips": list(self.host_flips),
            "routed_by_host": per_host("mx_fleet_routed"),
            "migrated_pages_by_host": per_host("mx_fleet_migrated_pages"),
            "swapped_pages_by_host": per_host("mx_fleet_swapped_pages"),
            "swap_outs": sum(h.server.swap_outs for h in self.hosts),
            "swap_ins": sum(h.server.swap_ins for h in self.hosts),
            "worker_prefills": sum(w.prefills for w in self.workers),
            "router_cache_hit_rate": matched / max(lookup, 1),
            "requests_completed": len(self.results),
        }
        if ttft:
            out["ttft_p50_s"] = float(np.percentile(ttft, 50))
            out["ttft_p95_s"] = float(np.percentile(ttft, 95))
        return out

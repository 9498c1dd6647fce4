"""KV-cached autoregressive decoding and continuous-batching serving —
the port of ``mxnet_tpu/decode.py``.

:class:`DecodePredictor` runs an ``attention_lm``-style symbol in two
modes over one graph walk (:meth:`DecodePredictor._run`):

* **prefill** — a full causal forward over the prompt that captures every
  ``dot_product_attention`` node's K/V into a ring-buffer cache (dense
  mode), or chunked prefill through the page pools (paged mode);
* **decode step** — one token per call: append its K/V, attend the query
  against the cache with a length mask, sample the next token.

Every ``FusedLNLinear`` node runs kernel A and every cached attention
runs kernel B on the card (their plain PyTorch versions on the CPU, or
everywhere under ``plain=True`` — the reference the kernels are held
to).  Caches are updated IN PLACE: a state passed to :meth:`step` is
consumed, like the donated state of the JAX package.

**Paged mode** (``paged=True`` / ``MXNET_KV_PAGED``) keeps K/V in fixed
pages of one shared pool per attention node, addressed through per-slot
page tables owned by :class:`~mxnet_tpu_torch.serve.PagedKVManager`
(refcounted allocator, copy-on-write prefix cache).  Prompts prefill in
``MXNET_PREFILL_CHUNK``-wide chunks.

:class:`DecodeServer` is the serving loop: ``slots`` sequences decode as
one fixed-width batch; finished ones retire and free slots refill from
the queue.  The paged loop interleaves one prefill chunk of the admitting
request with each decode step.

PyTorch runs eagerly, so the JAX package's jit / donation / AOT
machinery and its trace counters have no counterpart here.  Speculative
decoding, the mesh plan, the fleet layer, swap/preemption, metrics and
roofline hooks are not ported yet.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from . import config as _config
from .base import MXNetError
from .context import resolve_device
from .ops import attention as _attn
from .ops.sample import is_greedy_policy, sample_tokens
from .registry import OpContext
from .serve import PagedKVManager
from .weights import to_tensors

__all__ = ["DecodePredictor", "DecodeServer", "DecodeState"]

# MXNET_KV_DTYPE spellings -> storage dtypes
_KV_DTYPES = {
    "int8": torch.int8, "s8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn, "f8e4m3": torch.float8_e4m3fn,
    "f8e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2, "f8e5m2": torch.float8_e5m2,
}

# broadcast ops through which a (1, S, E) position table may meet the
# (B, t, E) activation stream; the decode walk gathers the table rows for
# the CURRENT positions before applying the op
_POSITION_BROADCAST_OPS = {
    "broadcast_add", "broadcast_plus", "broadcast_sub", "broadcast_minus",
    "broadcast_mul",
}


def _pad_window(tokens, width):
    """``tokens`` left-aligned in a zero-padded (1, width) float32
    window (admission padding and prefill-chunk windows)."""
    toks = np.asarray(tokens).reshape(-1)
    out = np.zeros((1, int(width)), np.float32)
    out[0, :toks.size] = toks
    return out


def _cache_leaves(caches):
    """Every tensor of a caches tuple, in order (QuantKV planes
    included)."""
    out = []
    for pair in caches:
        for c in pair:
            out.extend([c.data, c.scale] if isinstance(c, _attn.QuantKV)
                       else [c])
    return out


class DecodeState(NamedTuple):
    """The per-step serving state."""

    caches: tuple   # ((k, v), ...) per attention node: tensors or QuantKV
    lens: object    # (B,) int32 — tokens appended to each cache so far
    tok: object     # (B, 1) int32 — last sampled token, not yet appended


class DecodePredictor:
    """Incremental-decode executor for an attention LM.

    Parameters
    ----------
    symbol : Symbol or str
        The network, or its JSON text, or a ``*-symbol.json`` path.
    params : dict
        Parameters as tensors or numpy arrays (``arg:``/``aux:`` prefixes
        optional) — e.g. :func:`~mxnet_tpu_torch.weights.params_from_jax`.
    cache_len : int
        KV capacity C per sequence; generation past C wraps (the cache
        keeps the latest C tokens).
    device : Context, torch.device or str, optional
        Where the model runs.  Default: the card (raises without one);
        ``"cpu"`` runs the kernels' plain versions on the host.
    temperature, top_k
        Sampling policy (0 = greedy).
    kv_dtype : str, optional
        'int8', 'float8_e4m3fn' or 'float8_e5m2' quantized K/V; ``None``
        reads ``MXNET_KV_DTYPE``; '' keeps full precision.
    paged : bool, optional
        Paged KV pools (``None`` reads ``MXNET_KV_PAGED``).
    page_tokens, pool_pages, prefill_chunk : int, optional
        Paged-mode sizes (defaults from ``MXNET_KV_PAGE_TOKENS`` /
        ``MXNET_KV_POOL_PAGES`` / ``MXNET_PREFILL_CHUNK``).
    prefix_cache : bool
        Copy-on-write prefix sharing in paged mode.
    plain : bool
        Run every kernel's plain PyTorch version instead of the kernel,
        whatever the device — the reference run kernels are held to.
    """

    def __init__(self, symbol, params, cache_len, device=None,
                 temperature=0.0, top_k=0, data_name="data", kv_dtype=None,
                 paged=None, page_tokens=None, pool_pages=None,
                 prefill_chunk=None, prefix_cache=True, plain=False):
        from . import symbol as sym_mod

        if isinstance(symbol, str):
            symbol = sym_mod.load_json(symbol) \
                if symbol.lstrip().startswith("{") else sym_mod.load(symbol)
        self._symbol = symbol
        self._device = resolve_device(device)
        self._cache_len = int(cache_len)
        if self._cache_len <= 0:
            raise MXNetError("cache_len must be positive")
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._data_name = data_name
        self._plain = bool(plain)

        if kv_dtype is None:
            kv_dtype = _config.get("MXNET_KV_DTYPE")
        kv_dtype = (kv_dtype or "").strip().lower()
        if kv_dtype and kv_dtype not in _KV_DTYPES:
            raise MXNetError("unsupported MXNET_KV_DTYPE %r (supported: %s)"
                             % (kv_dtype, sorted(_KV_DTYPES)))
        self._kv_dtype = _KV_DTYPES[kv_dtype] if kv_dtype else None

        if paged is None:
            paged = _config.get("MXNET_KV_PAGED")
        self._paged = bool(paged)
        self._prefix_cache_on = bool(prefix_cache)
        self._page_tokens = int(page_tokens) if page_tokens \
            else int(_config.get("MXNET_KV_PAGE_TOKENS"))
        self._pool_pages = int(pool_pages) if pool_pages \
            else int(_config.get("MXNET_KV_POOL_PAGES"))
        self._prefill_chunk = int(prefill_chunk) if prefill_chunk \
            else int(_config.get("MXNET_PREFILL_CHUNK"))
        if self._paged:
            if self._page_tokens <= 0:
                raise MXNetError("page_tokens must be positive")
            if self._cache_len % self._page_tokens:
                raise MXNetError(
                    "cache_len %d is not a multiple of page_tokens %d — "
                    "paged capacity must tile into whole pages"
                    % (self._cache_len, self._page_tokens))

        self._env = to_tensors(params, self._device)
        free = [n for n in symbol.list_arguments() if n not in self._env]
        if data_name not in free:
            raise MXNetError("%r is not a free input of the symbol (free "
                             "inputs: %s)" % (data_name, free))
        if not any(not n.is_variable and n.op.name == "dot_product_attention"
                   for n in symbol._topo()):
            raise MXNetError("symbol has no dot_product_attention node; "
                             "nothing to cache")
        self._manager = None          # serve.PagedKVManager, per batch
        self._pools_template = None   # per-node cache shapes (probed)
        self._paged_lens = None       # host lens for standalone use
        self._tables_dev = None       # (manager, version, device tables)

    @property
    def cache_len(self):
        return self._cache_len

    @property
    def device(self):
        return self._device

    @property
    def _greedy(self):
        return is_greedy_policy(self._temperature, self._top_k)

    # ------------------------------------------------------------------
    # the shared graph walk
    # ------------------------------------------------------------------
    def _run(self, tokens, caches, pos0, tables=None, active=None,
             valid=None, env=None, plain=None):
        """Execute the symbol on (B, t) tokens; returns ``(probs (B, t,
        V), caches)``.

        ``caches is None`` = prefill: full causal attention, fresh ring
        buffers built from each attention node's K/V.  Otherwise K/V
        append at ``pos0`` (per sequence) and the queries attend the
        cache with a length mask; with ``tables`` the caches are page
        pools (``active``/``valid`` redirect non-writes to the scratch
        page)."""
        env = self._env if env is None else env
        plain = self._plain if plain is None else plain
        b, t = tokens.shape[0], tokens.shape[1]
        dev = tokens.device
        octx = OpContext(plain=plain)
        new_caches = []
        ci = 0
        values = {}
        for node in self._symbol._topo():
            if node.is_variable:
                if node.name == self._data_name:
                    val = tokens
                elif node.name in env:
                    val = env[node.name]
                else:
                    # unfed free input (loss labels): zeros, forward-unused
                    val = torch.zeros((b, t), dtype=torch.float32,
                                      device=dev)
                values[(id(node), 0)] = val
                continue
            attrs = node.parsed_attrs()
            n_args = node.op.n_inputs(attrs)
            ins = [values[(id(s), i)] for s, i in node.inputs[:n_args]]
            aux_ins = [values[(id(s), i)] for s, i in node.inputs[n_args:]]
            if node.op.name == "dot_product_attention":
                q, k, v = ins
                heads = attrs.get("num_heads", 1)
                # grouped-query attention: K/V (and so the caches) are
                # kv_heads wide
                kv_heads = attrs.get("num_kv_heads", 0) or heads
                scale = attrs.get("scale", 0.0) or None
                if caches is None:
                    outs = [_attn.sdpa(q, k, v, num_heads=heads,
                                       causal=attrs.get("causal", False),
                                       scale=scale, num_kv_heads=kv_heads)]
                    new_caches.append((self._fill_cache(k, kv_heads),
                                       self._fill_cache(v, kv_heads)))
                else:
                    kc, vc = caches[ci]
                    pos = torch.as_tensor(pos0, dtype=torch.int32,
                                          device=dev).reshape(-1)
                    if tables is not None:
                        _attn.paged_append(kc, tables, k, pos,
                                           num_heads=kv_heads,
                                           active=active, valid=valid)
                        _attn.paged_append(vc, tables, v, pos,
                                           num_heads=kv_heads,
                                           active=active, valid=valid)
                        outs = [_attn.paged_attend(
                            q, kc, vc, tables, pos + t, num_heads=heads,
                            scale=scale, num_kv_heads=kv_heads,
                            plain=plain)]
                    else:
                        _attn.cache_append(kc, k, pos, num_heads=kv_heads)
                        _attn.cache_append(vc, v, pos, num_heads=kv_heads)
                        outs = [_attn.cache_attend(
                            q, kc, vc, pos + t, num_heads=heads,
                            scale=scale, num_kv_heads=kv_heads,
                            plain=plain)]
                    new_caches.append((kc, vc))
                ci += 1
            else:
                if node.op.name in _POSITION_BROADCAST_OPS \
                        and len(ins) == 2 \
                        and ins[0].dim() == 3 and ins[1].dim() == 3 \
                        and ins[0].shape[1] != ins[1].shape[1] \
                        and t in (ins[0].shape[1], ins[1].shape[1]):
                    # learned positional table vs the (B, t, E) stream:
                    # gather the rows for the CURRENT positions
                    big_i = 0 if ins[0].shape[1] != t else 1
                    big = ins[big_i]
                    if big.shape[0] != 1:
                        raise MXNetError(
                            "decode: node %r mixes time-lengths %s without "
                            "a broadcastable (1, S, E) side"
                            % (node.name, (tuple(ins[0].shape),
                                           tuple(ins[1].shape))))
                    idx = (torch.as_tensor(pos0, dtype=torch.int64,
                                           device=dev).reshape(-1, 1)
                           + torch.arange(t, device=dev)[None, :])
                    idx = torch.clamp(idx, 0, big.shape[1] - 1)
                    ins = list(ins)
                    ins[big_i] = big[0][idx]
                outs, _ = node.op.fcompute(attrs, ins, aux_ins, octx)
            for i, o in enumerate(outs):
                values[(id(node), i)] = o
        head_node, head_idx = self._symbol._outputs[0]
        out = values[(id(head_node), head_idx)]
        if out.dim() == 2 and out.shape[0] == b * t:
            out = out.reshape(b, t, -1)
        elif out.dim() != 3:
            raise MXNetError("decode: head output shape %s is not (B*t, V) "
                             "or (B, t, V)" % (tuple(out.shape),))
        return out, tuple(new_caches)

    def _fill_cache(self, x, num_heads=1):
        """(B, t, E) prefill K/V -> a (B, C, E) ring buffer holding the t
        tokens in slots [0, t) (quantized per (token, head) under a
        ``kv_dtype``)."""
        b, t, e = x.shape
        buf = torch.zeros((b, self._cache_len, e), dtype=x.dtype,
                          device=x.device)
        buf[:, :t] = x
        if self._kv_dtype is not None:
            return _attn.quantize_kv(buf, self._kv_dtype, num_heads)
        return buf

    def _sample(self, probs, generator=None):
        if self._greedy:
            return torch.argmax(probs, dim=-1).to(torch.int32)[:, None]
        logits = torch.log(probs.float() + 1e-30)
        return sample_tokens(logits, self._temperature, self._top_k,
                             generator)[:, None]

    # ------------------------------------------------------------------
    # paged mode
    # ------------------------------------------------------------------
    def _probe_cache_shapes(self):
        """Per-attention-node cache shapes and dtypes from a prefill of
        one token on meta tensors (no memory, no kernel)."""
        env = {n: torch.empty(v.shape, dtype=v.dtype, device="meta")
               for n, v in self._env.items()}
        toks = torch.empty((1, 1), dtype=torch.float32, device="meta")
        return self._run(toks, None, 0, env=env, plain=True)[1]

    def paged_batch_state(self, slots):
        """Fresh paged serving state over ``slots`` slots: a new
        :class:`~mxnet_tpu_torch.serve.PagedKVManager` and zeroed
        pools."""
        self._manager = PagedKVManager(
            slots, self._cache_len, self._page_tokens,
            pool_pages=self._pool_pages,
            prefix_cache=self._prefix_cache_on)
        self._tables_dev = None
        if self._pools_template is None:
            self._pools_template = self._probe_cache_shapes()
        pp = self._manager.pool_pages
        pt = self._page_tokens

        def pool_of(like):
            return torch.zeros((pp, pt, like.shape[2]), dtype=like.dtype,
                               device=self._device)

        pools = []
        for pair in self._pools_template:
            pools.append(tuple(
                _attn.QuantKV(pool_of(c.data), pool_of(c.scale))
                if isinstance(c, _attn.QuantKV) else pool_of(c)
                for c in pair))
        self._paged_lens = np.zeros(slots, np.int64)
        return DecodeState(
            tuple(pools),
            torch.zeros((slots,), dtype=torch.int32, device=self._device),
            torch.zeros((slots, 1), dtype=torch.int32, device=self._device))

    def _run_forks(self, caches, copies):
        """Execute manager-planned (src, dst) copy-on-write page copies
        in every pool before the append that needs them."""
        for src, dst in copies:
            for pool in _cache_leaves(caches):
                _attn.paged_copy(pool, src, dst)

    def _device_tables(self):
        """The manager's page tables on the device, re-shipped only after
        the manager changed them."""
        mgr = self._manager
        cached = self._tables_dev
        if cached is None or cached[0] is not mgr \
                or cached[1] != mgr.version:
            self._tables_dev = (mgr, mgr.version, torch.as_tensor(
                mgr.tables, device=self._device))
        return self._tables_dev[2]

    def paged_prepare(self, state, lens_h, width, active=None):
        """Make positions [lens, lens + width) of every active row
        writable (allocate / copy-on-write fork through the manager) and
        return ``(tables, active)`` on the device."""
        mgr = self._manager
        act = np.ones(mgr.slots, np.int32) if active is None \
            else np.asarray(active).astype(np.int32).reshape(-1)
        for s in range(mgr.slots):
            if act[s]:
                copies = mgr.ensure(s, int(lens_h[s]),
                                    int(lens_h[s]) + int(width))
                if copies:
                    self._run_forks(state.caches, copies)
        return self._device_tables(), torch.as_tensor(act,
                                                      device=self._device)

    def paged_step(self, state, lens_h, generator=None, active=None):
        """One paged decode step over the batch; rows with ``active`` 0
        keep their length and token.  The caller owns the host length
        vector ``lens_h`` and advances it by the activity."""
        tables, act = self.paged_prepare(state, lens_h, 1, active)
        probs3, caches = self._run(state.tok, state.caches, state.lens,
                                   tables=tables, active=act)
        probs = probs3[:, 0]
        tok = self._sample(probs, generator)
        tok = torch.where(act.bool()[:, None], tok, state.tok)
        lens = state.lens + act.to(torch.int32)
        return DecodeState(caches, lens, tok), probs

    def _chunk(self, caches, slot, toks, pos0, width, generator=None):
        """One fixed-width prefill chunk for one slot: append the
        chunk's K/V at [pos0, pos0 + len(toks)) of the slot's pages (pad
        positions are never written), attend causally against everything
        cached, sample at the last real position.  Returns ``(caches,
        probs (1, V), tok (1, 1))``."""
        n = int(np.asarray(toks).size)
        dev = self._device
        probs3, caches = self._run(
            torch.as_tensor(_pad_window(toks, width), device=dev), caches,
            torch.tensor([pos0], dtype=torch.int32, device=dev),
            tables=torch.as_tensor(self._manager.tables[slot:slot + 1],
                                   device=dev),
            active=torch.ones((1,), dtype=torch.int32, device=dev),
            valid=torch.tensor([n], dtype=torch.int32, device=dev))
        probs = probs3[:, min(max(n - 1, 0), width - 1)]
        return caches, probs, self._sample(probs, generator)

    def _chunked_fill(self, caches, slot, prompt, start, generator=None):
        """Prefill [start, len(prompt)) of one slot's prompt in
        fixed-width chunks; returns (caches, first token, its probs)."""
        mgr = self._manager
        total = int(prompt.size)
        w = int(self._prefill_chunk or (total - int(start)))
        w = max(1, min(w, self._cache_len))
        pos = int(start)
        tok = probs = None
        while pos < total:
            n = min(w, total - pos)
            copies = mgr.ensure(slot, pos, pos + n)
            if copies:
                self._run_forks(caches, copies)
            caches, probs, tok = self._chunk(caches, slot,
                                             prompt[pos:pos + n], pos, w,
                                             generator)
            pos += n
        return caches, tok, probs

    def _paged_prefill(self, tokens, prompt_len=None, generator=None):
        """Chunked prefill of a (B, P) batch over fresh page tables, one
        slot per row, prefix cache consulted per row."""
        tokens = np.asarray(tokens)
        b, p = tokens.shape
        if p > self._cache_len:
            raise MXNetError("prompt width %d exceeds cache_len %d"
                             % (p, self._cache_len))
        if prompt_len is None:
            prompt_len = p
        lens_h = np.broadcast_to(
            np.asarray(prompt_len, np.int64).reshape(-1), (b,)).copy()
        state = self.paged_batch_state(b)
        mgr = self._manager
        caches = state.caches
        toks_out, probs_out = [], []
        for row in range(b):
            prompt = tokens[row, :int(lens_h[row])].astype(np.int64)
            gate = mgr.gate(prompt, prompt.size, self._cache_len,
                            budget_wrap_forks=False)
            if gate is None:
                raise MXNetError(
                    "KV page pool cannot admit a %d-token prompt — raise "
                    "MXNET_KV_POOL_PAGES (pool: %d pages)"
                    % (prompt.size, mgr.pool_pages))
            matched, pages, reserve_n = gate
            mgr.map_slot(row, pages, reserve_n)
            caches, tok, probs = self._chunked_fill(caches, row, prompt,
                                                    matched, generator)
            mgr.publish(row, prompt, prompt.size)
            toks_out.append(tok)
            probs_out.append(probs)
        self._paged_lens = lens_h
        return (DecodeState(caches, torch.as_tensor(lens_h, dtype=torch.int32,
                                                    device=self._device),
                            torch.cat(toks_out, dim=0)),
                torch.cat(probs_out, dim=0))

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def _place_tokens(self, tokens):
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self._device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(tokens, np.float32),
                               device=self._device)

    def prefill(self, tokens, prompt_len=None, generator=None):
        """Process a (B, P) prompt batch; returns ``(state, probs)``.

        ``prompt_len`` (int or (B,)) marks each row's real length in a
        padded batch; ``probs`` is the (B, V) output at each row's last
        real position and ``state.tok`` the token sampled from it.  In
        paged mode this is chunked prefill over fresh page tables."""
        if self._paged:
            return self._paged_prefill(tokens, prompt_len, generator)
        tokens = self._place_tokens(tokens)
        b, p = tokens.shape
        if p > self._cache_len:
            # a wider window would wrap padded rows over real tokens
            raise MXNetError("prompt width %d exceeds cache_len %d"
                             % (p, self._cache_len))
        if prompt_len is None:
            prompt_len = p
        lens = torch.as_tensor(prompt_len, dtype=torch.int32,
                               device=self._device).reshape(-1).expand(
            b).clone()
        probs3, caches = self._run(tokens, None, 0)
        last = torch.clamp(lens.long() - 1, 0, p - 1)
        probs = probs3[torch.arange(b, device=self._device), last]
        return DecodeState(caches, lens, self._sample(probs, generator)), \
            probs

    def step(self, state, generator=None):
        """One decode step: append ``state.tok``'s K/V, attend, sample.
        Returns ``(state', probs)``; the caches of ``state`` are updated
        in place, so ``state`` must not be reused."""
        if self._paged:
            out = self.paged_step(state, self._paged_lens, generator)
            self._paged_lens += 1
            return out
        probs3, caches = self._run(state.tok, state.caches, state.lens)
        probs = probs3[:, 0]
        return DecodeState(caches, state.lens + 1,
                           self._sample(probs, generator)), probs

    def generate(self, tokens, prompt_len=None, max_new_tokens=16, seed=0,
                 eos_id=None):
        """Prefill + ``max_new_tokens`` decode steps; returns a (B, N)
        int32 numpy array of sampled tokens (rows keep decoding past
        their EOS — slice per row)."""
        gen = None
        if not self._greedy:
            gen = torch.Generator(device=self._device)
            gen.manual_seed(int(seed))
        state, _ = self.prefill(tokens, prompt_len, gen)
        out = [state.tok.cpu().numpy()]
        done = (out[0][:, 0] == eos_id) if eos_id is not None else None
        for _ in range(max_new_tokens - 1):
            if done is not None and done.all():
                break
            state, _ = self.step(state, gen)
            out.append(state.tok.cpu().numpy())
            if done is not None:
                done |= out[-1][:, 0] == eos_id
        return np.concatenate(out, axis=1)


def _insert(state, one, slot):
    """Splice the batch-1 state ``one`` into row ``slot`` of ``state``, in
    place."""
    for full, single in zip(_cache_leaves(state.caches),
                            _cache_leaves(one.caches)):
        full[slot] = single[0]
    state.lens[slot] = one.lens[0]
    state.tok[slot] = one.tok[0]


def _empty_batch_state(one, slots):
    """An all-zero batch state with ``slots`` rows shaped like ``one``."""
    def zeros(x):
        return torch.zeros((slots,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)

    caches = tuple(tuple(
        _attn.QuantKV(zeros(c.data), zeros(c.scale))
        if isinstance(c, _attn.QuantKV) else zeros(c) for c in pair)
        for pair in one.caches)
    return DecodeState(caches, zeros(one.lens), zeros(one.tok))


def _nearest_rank(values, q):
    """Nearest-rank percentile of a sorted list (None when empty)."""
    if not values:
        return None
    return values[min(len(values) - 1, max(0, math.ceil(q * len(values))
                                           - 1))]


class DecodeServer:
    """Continuous batching over a :class:`DecodePredictor`.

    ``slots`` sequences decode as one batch; between steps, finished
    sequences (EOS or per-request cap) retire and free slots refill from
    the queue.  Single-threaded: callers queue with :meth:`submit` and
    drain with :meth:`run`.  Over a paged predictor the loop admits one
    request at a time in prefill chunks interleaved with decode steps,
    maps prefix-cache hits instead of recomputing them, forks shared pages
    before divergent writes and frees a retiring request's pages at once.
    """

    def __init__(self, predictor, max_prefill, slots=None, eos_id=None,
                 max_new_tokens=None, seed=0):
        self._pred = predictor
        self._max_prefill = int(max_prefill)
        if self._max_prefill > predictor.cache_len:
            raise MXNetError("max_prefill %d exceeds the predictor's "
                             "cache_len %d" % (self._max_prefill,
                                               predictor.cache_len))
        self._slots = int(slots or _config.get("MXNET_DECODE_SLOTS"))
        self._eos_id = eos_id
        self._max_new = int(max_new_tokens) if max_new_tokens is not None \
            else int(_config.get("MXNET_DECODE_MAX_NEW"))
        self._seed = int(seed)
        self._queue = deque()
        self._next_id = 0
        self._req = {}          # rid -> submit/admit/first/retire times
        # paged chunk width: the predictor's chunk clamped to the
        # admission window
        self._chunk_w = min(int(predictor._prefill_chunk or max_prefill),
                            int(max_prefill))
        self.steps = 0          # decode steps executed
        self.tokens_out = 0     # tokens delivered to finished requests

    def submit(self, tokens, max_new_tokens=None):
        """Queue a prompt (1-D int sequence); returns the request id."""
        tokens = np.asarray(tokens).reshape(-1)
        if tokens.size > self._max_prefill:
            raise MXNetError("prompt length %d exceeds max_prefill %d"
                             % (tokens.size, self._max_prefill))
        rid = self._next_id
        self._next_id += 1
        cap = int(max_new_tokens) if max_new_tokens is not None \
            else self._max_new
        self._queue.append({"rid": rid, "prompt": tokens, "cap": cap})
        self._req[rid] = {"submit": time.perf_counter()}
        return rid

    def _generator(self):
        if self._pred._greedy:
            return None
        gen = torch.Generator(device=self._pred.device)
        gen.manual_seed(self._seed)
        return gen

    def _deliver(self, rec, emitted):
        """Append emitted tokens to a request, honoring its cap and
        stopping at an EOS."""
        toks = rec["toks"]
        for t in emitted:
            if len(toks) >= rec["cap"]:
                break
            toks.append(int(t))
            if self._eos_id is not None and t == self._eos_id:
                break

    def _retire_finished(self, active, results, on_retire=None):
        """Retire every finished request in ``active`` (EOS delivered or
        cap reached): record the result and free the slot."""
        for slot in list(active):
            rec = active[slot]
            rid, toks = rec["rid"], rec["toks"]
            if (self._eos_id is not None and toks
                    and toks[-1] == self._eos_id) \
                    or len(toks) >= rec["cap"]:
                results[rid] = np.asarray(toks, np.int32)
                self.tokens_out += len(toks)
                req = self._req[rid]
                req["retire"] = time.perf_counter()
                req["tokens"] = len(toks)
                del active[slot]
                if on_retire is not None:
                    on_retire(slot)

    def stats(self):
        """Loop counters, time-to-first-token percentiles (seconds from
        submit) and, in paged mode, pool and prefix-cache accounting."""
        done = [r for r in self._req.values() if "retire" in r]
        out = {"steps": self.steps, "tokens_out": self.tokens_out,
               "requests_completed": len(done),
               "requests_queued": len(self._queue)}
        if done:
            tf = sorted(r["first"] - r["submit"] for r in done)
            out["ttft_p50_s"] = _nearest_rank(tf, 0.50)
            out["ttft_p95_s"] = _nearest_rank(tf, 0.95)
        if self._pred._paged and self._pred._manager is not None:
            out.update(self._pred._manager.stats())
        return out

    def run(self):
        """Drain the queue; returns ``{request_id: np.int32 array}`` of
        generated tokens (EOS included when hit)."""
        if self._pred._paged:
            return self._run_paged()
        pred = self._pred
        gen = self._generator()
        state = None
        active = {}
        results = {}
        while self._queue or active:
            # admit: prefill one request per free slot, splice into batch
            while self._queue and len(active) < self._slots:
                entry = self._queue.popleft()
                rid, prompt = entry["rid"], entry["prompt"]
                one, _ = pred.prefill(_pad_window(prompt, self._max_prefill),
                                      prompt.size, gen)
                first = int(one.tok[0, 0])
                rec = self._req[rid]
                rec["admit"] = rec["first"] = time.perf_counter()
                slot = next(s for s in range(self._slots)
                            if s not in active)
                if state is None:
                    state = _empty_batch_state(one, self._slots)
                _insert(state, one, slot)
                active[slot] = {"rid": rid, "toks": [first],
                                "cap": entry["cap"]}
            self._retire_finished(active, results)
            if not active:
                continue
            state, _ = pred.step(state, gen)
            self.steps += 1
            toks = state.tok[:, 0].cpu().numpy()
            for slot, rec in active.items():
                self._deliver(rec, toks[slot:slot + 1])
            self._retire_finished(active, results)
        return results

    def _run_paged(self):
        pred = self._pred
        slots = self._slots
        gen = self._generator()
        state = pred.paged_batch_state(slots)
        mgr = pred._manager
        active = {}
        results = {}
        slot_lens = np.zeros(slots, np.int64)
        act_mask = np.zeros(slots, np.int32)
        pending = None      # the one admission mid-chunked-prefill

        def on_retire(slot):
            act_mask[slot] = 0
            # pages back to the pool now: the next admission sees them
            mgr.free_slot(slot)

        while self._queue or active or pending is not None:
            # (1) admission gate: at most one request starts prefill
            if pending is None and self._queue and len(active) < slots:
                pending = self._admit(mgr, active)
                if pending is None and not active:
                    # nothing running to free pages: spill the prefix
                    # cache; then the pool is genuinely too small
                    if mgr.prefix_cache is not None:
                        mgr.prefix_cache.evict(mgr.pool_pages)
                        pending = self._admit(mgr, active)
                    if pending is None:
                        raise MXNetError(
                            "KV page pool (%d pages) cannot admit a "
                            "%d-token request even with an empty batch — "
                            "raise MXNET_KV_POOL_PAGES"
                            % (mgr.pool_pages,
                               self._queue[0]["prompt"].size))
            # (2) one prefill chunk of the in-flight admission
            if pending is not None:
                p = pending
                n = min(self._chunk_w, p["prompt"].size - p["pos"])
                copies = mgr.ensure(p["slot"], p["pos"], p["pos"] + n)
                if copies:
                    pred._run_forks(state.caches, copies)
                _, _, tok = pred._chunk(
                    state.caches, p["slot"],
                    p["prompt"][p["pos"]:p["pos"] + n], p["pos"],
                    self._chunk_w, gen)
                p["pos"] += n
                if p["pos"] >= p["prompt"].size:
                    # (3) commit: the slot joins the batch
                    slot, plen = p["slot"], p["prompt"].size
                    first = int(tok[0, 0])
                    state.lens[slot] = plen
                    state.tok[slot, 0] = first
                    mgr.publish(slot, p["prompt"], plen)
                    active[slot] = {"rid": p["rid"], "toks": [first],
                                    "cap": p["cap"]}
                    slot_lens[slot] = plen
                    act_mask[slot] = 1
                    self._req[p["rid"]]["first"] = time.perf_counter()
                    pending = None
                    self._retire_finished(active, results, on_retire)
            if not active:
                continue
            # (4) one decode step over the active slots
            state, _ = pred.paged_step(state, slot_lens, gen, act_mask)
            self.steps += 1
            toks = state.tok[:, 0].cpu().numpy()
            for slot, rec in active.items():
                self._deliver(rec, toks[slot:slot + 1])
            slot_lens += act_mask.astype(np.int64)
            self._retire_finished(active, results, on_retire)
        return results

    def _admit(self, mgr, active):
        """Gate the queue head through the page allocator; returns its
        pending-prefill record, or None on backpressure."""
        entry = self._queue[0]
        prompt = entry["prompt"]
        gate = mgr.gate(prompt, prompt.size, entry["cap"])
        if gate is None:
            return None
        self._queue.popleft()
        matched, pages, reserve_n = gate
        slot = next(s for s in range(self._slots) if s not in active)
        mgr.map_slot(slot, pages, reserve_n)
        self._req[entry["rid"]]["admit"] = time.perf_counter()
        return {"slot": slot, "rid": entry["rid"],
                "prompt": prompt.astype(np.int64), "cap": entry["cap"],
                "pos": int(matched)}

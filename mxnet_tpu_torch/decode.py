"""KV-cached autoregressive decoding and continuous-batching serving —
the port of ``mxnet_tpu/decode.py``.

:class:`DecodePredictor` runs an ``attention_lm``-style symbol in two
modes over one graph walk (:meth:`DecodePredictor._run`):

* **prefill** — a full causal forward over the prompt that captures every
  ``dot_product_attention`` node's K/V into a ring-buffer cache (dense
  mode), or chunked prefill through the page pools (paged mode);
* **decode step** — one token per call: append its K/V, attend the query
  against the cache with a length mask, sample the next token;
* **verify step** — speculative decoding: append the last token and k
  drafted tokens, score all k+1 positions in one pass, accept a prefix
  of the drafts and draw one more token (:func:`~mxnet_tpu_torch.ops.
  sample.speculative_accept`); rejection rolls back the lengths only.

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
request with each decode step.  With speculation armed (``spec_k`` /
``MXNET_SPEC_K``, a ``proposer`` or a ``draft`` predictor) each step
is a verify step over k drafts per slot from :class:`NGramProposer`
(n-gram lookup in each request's own history) or
:class:`DraftProposer` (a small dense predictor); greedy speculation
emits exactly the target's greedy tokens.

Paged serving runs as compiled programs (:mod:`~mxnet_tpu_torch.programs`):
the decode step (``paged_decode_step``), the speculative verify step
(``paged_verify_step``), the prefill chunk (``prefill_chunk``, one per
chunk width), the slot commit (``slot_commit``) and the copy-on-write
page fork (``page_fork``) are each a
:class:`~mxnet_tpu_torch.programs.GraphProgram` — on the card a
CUDA graph captured once per argument signature and replayed on every
later call, as the JAX package jits each once.  :attr:`DecodePredictor.
trace_counts` counts the captures under the JAX package's keys, and
:meth:`DecodePredictor.prepare_programs` captures them all before the
first request.  The graphs bake in pointers, so the predictor keeps one
set of pools and state buffers per (slots, pool pages), zeroed in place
by :meth:`DecodePredictor.paged_batch_state`; page tables and activity
masks live in device buffers refreshed only when they change.  The
dense (ring-buffer) predictor, its verify step included, runs eagerly.
Page extract / install, the mesh plan, the fleet layer,
swap/preemption, metrics and roofline hooks are not ported yet.
"""
from __future__ import annotations

import hashlib
import json
import math
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from . import config as _config
from . import programs as _programs
from .base import MXNetError
from .context import resolve_device
from .ops import attention as _attn
from .ops.sample import (is_greedy_policy, policy_logits, sample_tokens,
                         speculative_accept)
from .programs import GraphPool, GraphProgram, ProgramSpec
from .registry import OpContext
from .serve import PagedKVManager
from .weights import to_tensors

__all__ = ["DecodePredictor", "DecodeServer", "DecodeState",
           "DraftProposer", "NGramProposer"]

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


class _PagedBuffers(NamedTuple):
    """A paged batch's device buffers, kept per (slots, pool pages): the
    programs are captured over them."""

    pools: tuple    # as DecodeState.caches
    lens: object    # (slots,) int32
    tok: object     # (slots, 1) int32
    tables: object  # (slots, M) int32 page tables
    act: object     # (slots,) int32 activity mask


# trace_counts keys (the JAX package's)
_TRACE_KINDS = ("prefill", "decode", "verify", "chunk", "fork", "commit",
                "extract", "install")


class DecodePredictor:
    """Incremental-decode executor for an attention LM.

    Parameters
    ----------
    symbol : Symbol or str
        The network, or its JSON text, or a ``*-symbol.json`` path.
    params : dict, str, or bytes
        Parameters as NDArrays, tensors or numpy arrays (``arg:``/``aux:``
        prefixes optional) — e.g.
        :func:`~mxnet_tpu_torch.weights.params_from_jax` — or a
        ``.params`` file path, or the file's bytes.
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

        from .predictor import _as_param_dicts

        arg_params, aux_params = _as_param_dicts(params)
        self._env = to_tensors({n: v.data for n, v in
                                {**arg_params, **aux_params}.items()},
                               self._device)
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
        self._buffers = {}            # (slots, pool pages) -> buffers
        self._live = None             # the current batch's buffers
        self._tables_dev = None       # (manager, version) shipped
        self._act_key = None          # activity mask shipped
        self._table_ships = 0         # host-to-device table copies
        self._gen = None              # see _sampling_generator
        self._program_specs = {}      # kind -> ProgramSpec (owned here)
        self._prepared = None         # the last prepare_programs report
        # the (B, k+1, V) target probabilities of the last verify step
        # (paged: valid until the next program call)
        self.verify_probs = None
        if self._paged:
            # the serving programs share one graph memory pool; each
            # binds the predictor's own buffers (pools, lens, tok,
            # tables, mask) and copies the rest in
            pool = GraphPool()
            self._decode_fn = GraphProgram(
                "paged_decode_step", self._decode_body, bind=range(5),
                pool=pool)
            self._verify_fn = GraphProgram(
                "paged_verify_step", self._verify_body, bind=range(5),
                pool=pool)
            self._chunk_fn = GraphProgram("prefill_chunk", self._chunk_body,
                                          bind=(0,), pool=pool)
            self._commit_fn = GraphProgram("slot_commit", self._commit_body,
                                           bind=(0, 1), pool=pool)
            self._fork_fn = GraphProgram("page_fork", self._fork_body,
                                         bind=(0,), pool=pool)

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

    def _policy_probs(self, probs):
        """The distribution :meth:`_sample` draws from, as probability
        vectors: the softmax of the same ``policy_logits`` (what the
        speculative acceptance rule compares against)."""
        logits = torch.log(probs.float() + 1e-30)
        return torch.softmax(
            policy_logits(logits, self._temperature, self._top_k), dim=-1)

    def _accept(self, probs3, draft_toks, draft_probs, generator):
        """``speculative_accept`` over a verify window's (B, k+1, V)
        probabilities under the predictor's sampling policy."""
        greedy = self._greedy
        pi = probs3 if greedy else self._policy_probs(probs3)
        return speculative_accept(pi, draft_toks, draft_probs,
                                  greedy=greedy, generator=generator)

    def _draft_tensor(self, draft_toks):
        """(B, k) int32 drafts: host numpy as a host tensor (a program
        copies it in), a tensor as it is."""
        if isinstance(draft_toks, torch.Tensor):
            return draft_toks.to(torch.int32)
        return torch.from_numpy(np.ascontiguousarray(draft_toks, np.int32))

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

    def _pools_like(self, shape_of, device):
        """Zeroed pools (or, on the meta device, their shapes) after the
        probed cache template: ``shape_of(template_leaf)`` per leaf."""
        if self._pools_template is None:
            self._pools_template = self._probe_cache_shapes()

        def one(like):
            return torch.zeros(shape_of(like), dtype=like.dtype,
                               device=device)

        return tuple(tuple(
            _attn.QuantKV(one(c.data), one(c.scale))
            if isinstance(c, _attn.QuantKV) else one(c) for c in pair)
            for pair in self._pools_template)

    def paged_batch_state(self, slots):
        """Fresh paged serving state over ``slots`` slots: a new
        :class:`~mxnet_tpu_torch.serve.PagedKVManager` and zeroed pools.
        The pools, lengths, tokens, tables and activity mask are the
        predictor's buffers for this (slots, pool pages) sizing, zeroed
        in place, so every program captured over them stays valid."""
        slots = int(slots)
        self._manager = PagedKVManager(
            slots, self._cache_len, self._page_tokens,
            pool_pages=self._pool_pages,
            prefix_cache=self._prefix_cache_on)
        pp = self._manager.pool_pages
        m = self._manager.pages_per_slot
        buf = self._buffers.get((slots, pp))
        if buf is None:
            dev = self._device
            pt = self._page_tokens
            buf = self._buffers[(slots, pp)] = _PagedBuffers(
                self._pools_like(lambda c: (pp, pt, c.shape[2]), dev),
                torch.zeros((slots,), dtype=torch.int32, device=dev),
                torch.zeros((slots, 1), dtype=torch.int32, device=dev),
                torch.zeros((slots, m), dtype=torch.int32, device=dev),
                torch.zeros((slots,), dtype=torch.int32, device=dev))
        else:
            for t in _cache_leaves(buf.pools) + list(buf[1:]):
                t.zero_()
        self._live = buf
        self._tables_dev = None
        self._act_key = None
        self._paged_lens = np.zeros(slots, np.int64)
        return DecodeState(buf.pools, buf.lens, buf.tok)

    def _run_forks(self, caches, copies):
        """Execute manager-planned (src, dst) copy-on-write page copies
        in every pool (the fork program, ids as data) before the append
        that needs them."""
        for src, dst in copies:
            self._fork_fn(caches, torch.tensor([src, dst],
                                               dtype=torch.int64))

    def _device_tables(self):
        """The manager's page tables in the batch's device buffer,
        re-shipped only after the manager changed them."""
        mgr = self._manager
        if self._tables_dev != (mgr, mgr.version):
            self._live.tables.copy_(torch.from_numpy(mgr.tables))
            self._tables_dev = (mgr, mgr.version)
            self._table_ships += 1
        return self._live.tables

    def paged_prepare(self, state, lens_h, width, active=None):
        """Make positions [lens, lens + width) of every active row
        writable (allocate / copy-on-write fork through the manager) and
        return ``(tables, active)``: the batch's device buffers, the mask
        re-shipped only when it changed."""
        mgr = self._manager
        act = np.ones(mgr.slots, np.int32) if active is None \
            else np.asarray(active).astype(np.int32).reshape(-1)
        for s in range(mgr.slots):
            if act[s]:
                copies = mgr.ensure(s, int(lens_h[s]),
                                    int(lens_h[s]) + int(width))
                if copies:
                    self._run_forks(state.caches, copies)
        key = act.tobytes()
        if key != self._act_key:
            self._live.act.copy_(torch.from_numpy(act))
            self._act_key = key
        return self._device_tables(), self._live.act

    def paged_step(self, state, lens_h, generator=None, active=None):
        """One paged decode step over the batch (the decode program);
        rows with ``active`` 0 keep their length and token.  The caller
        owns the host length vector ``lens_h`` and advances it by the
        activity.  The returned state holds the batch's length and token
        buffers, updated in place; ``probs`` is valid until the next
        program call."""
        tables, act = self.paged_prepare(state, lens_h, 1, active)
        live = self._live
        # a state built elsewhere (a teacher-forced token) lands in the
        # batch's buffers, which the program is captured over
        for mine, given in ((live.lens, state.lens), (live.tok, state.tok)):
            if given is not mine:
                mine.copy_(given)
        probs = self._decode_fn(state.caches, live.lens, live.tok, tables,
                                act, generator)
        return DecodeState(state.caches, live.lens, live.tok), probs

    def _decode_body(self, caches, lens, tok, tables, act, generator):
        """The decode program: one token per active row, in place."""
        probs3, _ = self._run(tok, caches, lens, tables=tables, active=act)
        probs = probs3[:, 0]
        new = self._sample(probs, generator)
        tok.copy_(torch.where(act.bool()[:, None], new, tok))
        lens.add_(act)
        return probs

    def paged_verify(self, state, lens_h, draft_toks, draft_probs=None,
                     generator=None, active=None):
        """One paged speculative verify step (the verify program; see
        :meth:`verify_step`): positions [lens, lens + k + 1) of every
        active row are made writable first (page allocation and forks
        run here, outside the program).  Rows with ``active`` 0 commit
        no token and keep theirs.  Returns ``(state', out_toks (B, k+1),
        counts (B,))``; the caller advances ``lens_h`` by the counts.
        ``out_toks``, ``counts`` and :attr:`verify_probs` are valid
        until the next program call."""
        draft = self._draft_tensor(draft_toks)
        tables, act = self.paged_prepare(state, lens_h, draft.shape[1] + 1,
                                         active)
        live = self._live
        for mine, given in ((live.lens, state.lens), (live.tok, state.tok)):
            if given is not mine:
                mine.copy_(given)
        out, counts, self.verify_probs = self._verify_fn(
            state.caches, live.lens, live.tok, tables, act, draft,
            draft_probs, generator)
        return DecodeState(state.caches, live.lens, live.tok), out, counts

    def _verify_body(self, caches, lens, tok, tables, act, draft_toks,
                     draft_probs, generator):
        """The verify program: append the last token and the k drafts
        of every row (inactive rows write the scratch page), score the
        k+1 positions, accept; active rows advance by their counts."""
        k = draft_toks.shape[1]
        toks_in = torch.cat([tok, draft_toks.to(tok.dtype)], dim=1)
        probs3, _ = self._run(toks_in, caches, lens, tables=tables,
                              active=act)
        counts, out = self._accept(probs3, draft_toks, draft_probs,
                                   generator)
        on = act.bool()
        counts = torch.where(on, counts, 0)
        last = torch.gather(out, 1, torch.clamp(counts.long() - 1, 0,
                                                k)[:, None])
        tok.copy_(torch.where(on[:, None], last, tok))
        lens.add_(counts)
        return out, counts, probs3

    def _chunk(self, caches, slot, toks, pos0, width, generator=None):
        """One fixed-width prefill chunk for one slot (the chunk
        program): append the chunk's K/V at [pos0, pos0 + len(toks)) of
        the slot's pages (pad positions are never written), attend
        causally against everything cached, sample at the last real
        position.  Returns ``(caches, probs (1, V), tok (1, 1))``, valid
        until the next program call."""
        n = int(np.asarray(toks).size)
        probs, tok = self._chunk_fn(
            caches, self._device_tables()[slot:slot + 1],
            torch.from_numpy(_pad_window(toks, width)),
            torch.tensor([pos0, n], dtype=torch.int32), generator)
        return caches, probs, tok

    def _chunk_body(self, caches, table1, tokens, meta, generator):
        """The chunk program; ``meta`` = [pos0, real tokens]."""
        valid = meta[1:2]
        probs3, _ = self._run(
            tokens, caches, meta[0:1], tables=table1,
            active=torch.ones((1,), dtype=torch.int32,
                              device=tokens.device), valid=valid)
        last = torch.clamp(valid.long() - 1, 0, tokens.shape[1] - 1)
        probs = probs3.index_select(1, last)[:, 0]
        return probs, self._sample(probs, generator)

    def _commit(self, state, slot, new_len, new_tok):
        """Activate a freshly prefilled slot (the commit program, the slot
        as data): ``lens[slot] = new_len``, ``tok[slot, 0] = new_tok``."""
        self._commit_fn(state.lens, state.tok,
                        torch.tensor([slot, new_len], dtype=torch.int32),
                        new_tok)

    @staticmethod
    def _commit_body(lens, tok, meta, new_tok):
        slot = meta[0:1].long()
        lens.index_copy_(0, slot, meta[1:2])
        tok.index_copy_(0, slot, new_tok.reshape(1, 1).to(tok.dtype))

    @staticmethod
    def _fork_body(caches, ids):
        """The fork program: page ``ids[0]`` -> ``ids[1]`` in every pool
        (page ids are one global space)."""
        for pool in _cache_leaves(caches):
            _attn.paged_copy(pool, ids[0:1], ids[1:2])

    def _chunked_fill(self, caches, slot, prompt, start, generator=None):
        """Prefill [start, len(prompt)) of one slot's prompt in
        fixed-width chunks; returns (caches, first token, its probs),
        valid until the next program call."""
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
        probs_out = []
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
            state.tok[row:row + 1].copy_(tok)
            probs_out.append(probs.clone())
        self._paged_lens = lens_h
        state.lens.copy_(torch.from_numpy(lens_h.astype(np.int32)))
        return state, torch.cat(probs_out, dim=0)

    # ------------------------------------------------------------------
    # the compiled programs
    # ------------------------------------------------------------------
    @property
    def trace_counts(self):
        """Captures per program kind under the JAX package's keys (one
        per argument signature: ``verify`` counts one for deterministic
        drafts and one for drafts with probabilities; ``prefill``,
        ``extract`` and ``install`` have no program here and stay 0)."""
        out = dict.fromkeys(_TRACE_KINDS, 0)
        for kind, prog in self._programs().items():
            out[kind] = prog.traces
        return out

    def _programs(self):
        """kind -> the paged serving program (none in dense mode)."""
        if not self._paged:
            return {}
        return {"chunk": self._chunk_fn, "decode": self._decode_fn,
                "verify": self._verify_fn, "commit": self._commit_fn,
                "fork": self._fork_fn}

    def _sampling_generator(self, seed=None):
        """The predictor's one generator for sampled decoding (the
        programs are captured with it registered), seeded with ``seed``
        when given; None under the greedy policy."""
        if self._greedy:
            return None
        if self._gen is None:
            self._gen = torch.Generator(device=self._device)
        if seed is not None:
            self._gen.manual_seed(int(seed))
        return self._gen

    def _symbol_fingerprint(self):
        """Digest of the model graph, part of every program's key.
        Generated op-node names are replaced by their topological index
        first: their counters depend on how many symbols the process
        built before, and two hosts building the same model must get the
        same key."""
        d = getattr(self, "_sym_digest", None)
        if d is None:
            g = json.loads(self._symbol.tojson())
            for i, node in enumerate(g.get("nodes", ())):
                if node.get("op") not in (None, "null"):
                    node["name"] = "n%d" % i
            blob = json.dumps(g, sort_keys=True)
            d = self._sym_digest = hashlib.blake2b(
                blob.encode(), digest_size=16).hexdigest()
        return d

    def _serving_args(self, slots, chunk_w=None, spec_k=0):
        """Each paged program's arguments at batch width ``slots`` as
        ``meta`` tensors (shapes and dtypes only: no pool is allocated
        and nothing runs); the verify program's only when ``spec_k`` is
        set (deterministic drafts)."""
        if not self._paged:
            raise MXNetError("serving programs need a paged predictor")
        slots = int(slots)
        pt = self._page_tokens
        m = self._cache_len // pt
        pp = PagedKVManager.pool_sizing(slots, self._cache_len, pt,
                                        self._pool_pages)
        caches = self._pools_like(lambda c: (pp, pt, c.shape[2]), "meta")

        def meta(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        env = {n: meta(*v.shape, dtype=v.dtype) for n, v in self._env.items()}
        cw = int(chunk_w or self._prefill_chunk or self._cache_len)
        out = {
            "chunk": (env, caches, meta(1, m),
                      meta(1, cw, dtype=torch.float32), meta(2)),
            "decode": (env, caches, meta(slots), meta(slots, 1),
                       meta(slots, m), meta(slots)),
            "commit": (meta(slots), meta(slots, 1), meta(2), meta(1, 1)),
            "fork": (caches, meta(2, dtype=torch.int64)),
        }
        if spec_k:
            out["verify"] = (env, caches, meta(slots), meta(slots, 1),
                             meta(slots, m), meta(slots),
                             meta(slots, int(spec_k)), None)
        return out

    def _program_spec(self, kind, args):
        """The :class:`~mxnet_tpu_torch.programs.ProgramSpec` of one paged
        program at ``args``: trace counter and identity extras."""
        prog = self._programs()[kind]
        extra = {"symbol": self._symbol_fingerprint(),
                 "cache_len": self._cache_len,
                 "page_tokens": self._page_tokens,
                 "kv_dtype": str(self._kv_dtype),
                 "temperature": self._temperature, "top_k": self._top_k,
                 "plain": self._plain, "kind": kind}
        return ProgramSpec(prog.name, prog, owner=self,
                           abstract_args=lambda a=args: a,
                           trace_count=lambda p=prog: p.traces,
                           device=self._device, fingerprint_extra=extra)

    def program_fingerprints(self, slots, chunk_w=None, spec_k=0):
        """kind -> content address of each paged program at this sizing
        (the verify program's with ``spec_k``): equal keys across hosts
        mean the same programs on the same kernels."""
        return {kind: self._program_spec(kind, args).fingerprint(args)
                for kind, args in self._serving_args(slots, chunk_w,
                                                    spec_k).items()}

    def prepare_programs(self, slots, chunk_w=None, spec_k=0):
        """Capture every paged program at batch width ``slots`` (chunk
        width ``chunk_w``; with ``spec_k``, the verify program over
        ``spec_k`` deterministic drafts) before the first request, each
        driven once on inert inputs (inactive rows, zero drafts, no
        valid chunk token: every write lands in the scratch page), then
        zero the state.  Registers each program's spec.  Returns the
        readiness report ``{"signature", "programs": {kind: {"name",
        "source", "key", "seconds"}}, "wall_s"}``: ``source`` is
        "capture", or "resident" for a program captured before.
        Idempotent per signature (slots, chunk width, spec_k)."""
        cw = int(chunk_w or self._prefill_chunk or self._cache_len)
        sig = (int(slots), cw, int(spec_k or 0))
        if self._prepared is not None and self._prepared["signature"] == sig:
            return self._prepared
        t_all = time.perf_counter()
        avals = self._serving_args(slots, cw, spec_k)
        state = self.paged_batch_state(slots)
        live = self._live
        gen = self._sampling_generator()
        dev = self._device
        calls = {
            "chunk": lambda: self._chunk_fn(
                state.caches, live.tables[0:1],
                torch.zeros((1, cw), dtype=torch.float32),
                torch.zeros((2,), dtype=torch.int32), gen),
            "decode": lambda: self._decode_fn(
                state.caches, live.lens, live.tok, live.tables, live.act,
                gen),
            "verify": lambda: self._verify_fn(
                state.caches, live.lens, live.tok, live.tables, live.act,
                torch.zeros((int(slots), int(spec_k)), dtype=torch.int32),
                None, gen),
            "commit": lambda: self._commit_fn(
                live.lens, live.tok, torch.zeros((2,), dtype=torch.int32),
                torch.zeros((1, 1), dtype=torch.int32, device=dev)),
            "fork": lambda: self._fork_fn(
                state.caches, torch.zeros((2,), dtype=torch.int64)),
        }
        report = {"signature": sig, "programs": {}}
        for kind, args in avals.items():
            spec = self._program_specs[kind] = _programs.registry.register(
                self._program_spec(kind, args))
            before = self._programs()[kind].traces
            t0 = time.perf_counter()
            calls[kind]()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            report["programs"][kind] = {
                "name": spec.name,
                "source": "capture" if spec.trace_count() > before
                else "resident",
                "key": spec.fingerprint(args),
                "seconds": time.perf_counter() - t0}
        self.paged_batch_state(slots)
        report["wall_s"] = time.perf_counter() - t_all
        self._prepared = report
        return report

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

    def verify_step(self, state, draft_toks, draft_probs=None,
                    generator=None):
        """One speculative step: verify k drafted tokens in one forward
        pass and commit the accepted prefix plus one drawn token.

        ``draft_toks`` (B, k) int32 (numpy or a tensor); ``draft_probs``
        (B, k, V), the distributions they were drawn from, or None for a
        deterministic proposer.  Returns ``(state', out_toks, counts)``:
        ``out_toks`` (B, k+1) are the emitted tokens, valid through
        ``counts`` (B,) in [1, k+1]; ``state'.tok`` is the last emitted
        token and ``state'.lens`` advanced by ``counts`` (rejected
        entries stay in the cache, masked, until overwritten).  The
        caller keeps the window inside the ring: ``lens + k + 1 <=
        cache_len`` for every row.  In paged mode this is the verify
        program and the host lengths advance by the counts it reads
        back; the dense predictor runs it eagerly and consumes
        ``state`` as :meth:`step` does."""
        if self._paged:
            out = self.paged_verify(state, self._paged_lens, draft_toks,
                                    draft_probs, generator)
            self._paged_lens += out[2].cpu().numpy().astype(np.int64)
            return out
        draft = self._draft_tensor(draft_toks).to(self._device)
        toks_in = torch.cat([state.tok.to(torch.int32), draft], dim=1)
        probs3, caches = self._run(toks_in, state.caches, state.lens)
        self.verify_probs = probs3
        counts, out = self._accept(probs3, draft, draft_probs, generator)
        tok = torch.gather(out, 1, (counts.long() - 1)[:, None])
        return DecodeState(caches, state.lens + counts, tok), out, counts

    def generate_speculative(self, tokens, prompt_len=None,
                             max_new_tokens=16, seed=0, eos_id=None, k=None,
                             draft=None, proposer=None):
        """Speculative :meth:`generate`: a (B, N) int32 array, each loop
        iteration drafting ``k`` tokens (``MXNET_SPEC_K``, else 4) and
        committing 1..k+1 of them through one verify step.  With
        ``eos_id`` a row stops at its EOS: the rest of that window is
        discarded and the row pads with its last token.  ``draft`` (a
        dense predictor over the same vocabulary) drafts through a
        :class:`DraftProposer`; otherwise ``proposer`` or an
        :class:`NGramProposer`.  Greedy speculation emits exactly the
        greedy tokens of :meth:`generate`.  Where a window would wrap
        the ring (or the draft's), plain steps run instead."""
        if k is None:
            k = int(_config.get("MXNET_SPEC_K")) or 4
        k = int(k)
        if k <= 0:
            raise MXNetError("speculative k must be positive (got %d)" % k)
        gen = self._sampling_generator(seed)
        tokens = np.asarray(tokens)
        b = tokens.shape[0]
        if prompt_len is None:
            prompt_len = tokens.shape[1]
        lens_h = np.broadcast_to(
            np.asarray(prompt_len, np.int64).reshape(-1), (b,)).copy()
        state, _ = self.prefill(tokens, prompt_len, gen)
        if proposer is None:
            proposer = DraftProposer(draft, k) if draft is not None \
                else NGramProposer(k)
        else:
            # the proposer's draft width is the verify shape
            k = int(getattr(proposer, "k", k))
        dgen = _proposer_generator(proposer, seed)
        hist = [list(tokens[i, :lens_h[i]].astype(np.int64))
                for i in range(b)]
        first = state.tok[:, 0].cpu().numpy()
        rows = [[int(t)] for t in first]
        for i in range(b):
            hist[i].append(int(first[i]))
        if getattr(proposer, "needs_prefill", False):
            proposer.start(tokens, prompt_len, dgen)
        done = np.array([eos_id is not None and rows[i][-1] == eos_id
                         for i in range(b)])
        limit = _window_limit(self._cache_len, proposer)
        while True:
            live = [i for i in range(b) if len(rows[i]) < max_new_tokens
                    and not done[i]]
            if not live:
                break
            if max(lens_h[i] for i in live) + k + 1 <= limit:
                draft_toks, draft_probs = proposer.propose(
                    hist, state, lens_h, dgen)
                state, out, counts = self.verify_step(
                    state, draft_toks, draft_probs, gen)
                out_h, counts_h = _read_window(out, counts)
            else:
                state, _ = self.step(state, gen)
                out_h = state.tok.cpu().numpy()
                counts_h = np.ones(b, np.int64)
            lens_h += counts_h
            for i in range(b):
                emitted = [int(t) for t in out_h[i, :counts_h[i]]]
                # the history holds everything committed to the cache,
                # a window's tail past an EOS included
                hist[i].extend(emitted)
                if i in live:
                    if eos_id is not None and eos_id in emitted:
                        emitted = emitted[:emitted.index(eos_id) + 1]
                        done[i] = True
                    rows[i].extend(emitted)
        n = min(max_new_tokens, max(len(r) for r in rows))
        out = np.zeros((b, n), np.int32)
        for i in range(b):
            out[i] = (rows[i] + [rows[i][-1]] * n)[:n]
        return out

    def generate(self, tokens, prompt_len=None, max_new_tokens=16, seed=0,
                 eos_id=None):
        """Prefill + ``max_new_tokens`` decode steps; returns a (B, N)
        int32 numpy array of sampled tokens (rows keep decoding past
        their EOS — slice per row)."""
        gen = self._sampling_generator(seed)
        state, _ = self.prefill(tokens, prompt_len, gen)
        out = [state.tok.cpu().numpy().copy()]
        done = (out[0][:, 0] == eos_id) if eos_id is not None else None
        for _ in range(max_new_tokens - 1):
            if done is not None and done.all():
                break
            state, _ = self.step(state, gen)
            out.append(state.tok.cpu().numpy().copy())
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


def _window_limit(cache_len, proposer):
    """The largest length a verify window may reach: the target's ring,
    and a draft's ring plus one (the draft appends k entries to its
    own)."""
    if getattr(proposer, "cache_len", None):
        return min(cache_len, proposer.cache_len + 1)
    return cache_len


def _read_window(out, counts):
    """A verify step's (B, k+1) tokens and (B,) counts on the host as
    int64 numpy, in one device-to-host copy."""
    both = torch.cat([out, counts[:, None]], dim=1).cpu().numpy()
    both = both.astype(np.int64)
    return both[:, :-1], both[:, -1]


def _proposer_generator(proposer, seed):
    """The draft predictor's generator, seeded with ``seed`` (None for a
    proposer without a predictor, or a greedy draft)."""
    pred = getattr(proposer, "predictor", None)
    return pred._sampling_generator(seed) if pred is not None else None


class NGramProposer:
    """Model-free draft proposer: n-gram lookup in each sequence's own
    history (prompt lookup / self-speculation).

    Matches the last ``ngram`` committed tokens (``MXNET_SPEC_NGRAM``)
    against the earlier history and proposes the k tokens that followed
    their most recent earlier occurrence, backing off to shorter
    suffixes and finally to repeating the last token: always exactly k
    proposals, so the verify shape stays fixed.  Deterministic, so its
    proposals need no probabilities (``draft_probs`` None).  Host numpy
    only: it costs no device work."""

    cache_len = None      # no draft ring to keep inside
    needs_prefill = False

    def __init__(self, k, ngram=None):
        self.k = int(k)
        if self.k <= 0:
            raise MXNetError("NGramProposer k must be positive")
        self.ngram = int(ngram) if ngram is not None \
            else int(_config.get("MXNET_SPEC_NGRAM"))
        self.ngram = max(1, self.ngram)

    def propose(self, histories, state=None, lens=None, generator=None):
        """``(draft_toks (B, k) int32 numpy, None)`` for B histories."""
        out = np.zeros((len(histories), self.k), np.int32)
        for r, h in enumerate(histories):
            out[r] = self._row(np.asarray(h, np.int64).reshape(-1))
        return out, None

    def _row(self, h):
        k = self.k
        if h.size == 0:
            return np.zeros(k, np.int32)
        for n in range(min(self.ngram, h.size - 1), 0, -1):
            # every window start with a continuation: the body drops the
            # last element, which also leaves out the suffix itself
            body = h[:-1]
            if body.size < n:
                continue
            win = np.lib.stride_tricks.sliding_window_view(body, n)
            hits = np.flatnonzero((win == h[-n:]).all(axis=1))
            if hits.size:
                i = int(hits[-1])            # the most recent match
                cont = h[i + n:i + n + k]
                pad = np.full(k - cont.size, cont[-1], np.int64)
                return np.concatenate([cont, pad]).astype(np.int32)
        return np.full(k, h[-1], np.int32)


class DraftProposer:
    """Draft-model proposer: k decode steps of a small dense
    :class:`DecodePredictor` over the same vocabulary.

    The draft keeps its own ring caches in step with the target's
    committed prefix: each call resumes from the target's (lens, tok),
    so rejected draft entries sit past ``lens``, masked until the next
    append overwrites them.  Committed tokens the draft never stepped
    through (the k-th draft of a fully accepted window, tokens of plain
    steps near the ring's end) are replayed first, teacher-forced, from
    the caller's histories (the per-row ``filled`` counters stay on the
    host).  A greedy draft proposes deterministically (``draft_probs``
    None); a sampled one returns its per-step sampling distributions."""

    needs_prefill = True

    def __init__(self, predictor, k):
        if getattr(predictor, "_paged", False):
            raise MXNetError(
                "DraftProposer needs a dense-cache DecodePredictor: the "
                "draft's per-admission prefill would reset a paged "
                "predictor's page bookkeeping")
        self._pred = predictor
        self.k = int(k)
        if self.k <= 0:
            raise MXNetError("DraftProposer k must be positive")
        self.cache_len = predictor.cache_len
        self._state = None
        self._filled = None     # (B,) host int64: cache valid through

    @property
    def predictor(self):
        return self._pred

    def start(self, tokens, prompt_len, generator=None):
        """Prefill the draft on the same (B, P) prompt batch (the
        fixed-batch :meth:`DecodePredictor.generate_speculative`
        path)."""
        self._state, _ = self._pred.prefill(tokens, prompt_len, generator)
        b = self._state.lens.shape[0]
        self._filled = np.broadcast_to(
            np.asarray(prompt_len, np.int64).reshape(-1), (b,)).copy()

    def admit(self, tokens, prompt_len, slot, slots, generator=None):
        """Prefill one request and splice it into draft slot ``slot``
        (the serving loop's admission)."""
        one, _ = self._pred.prefill(tokens, prompt_len, generator)
        if self._state is None:
            self._state = _empty_batch_state(one, slots)
            self._filled = np.zeros(slots, np.int64)
        _insert(self._state, one, slot)
        self._filled[slot] = int(prompt_len)

    @staticmethod
    def _hist_tok(histories, pos):
        """(B, 1) int32 of each row's committed token at ``pos``
        (clamped: a row past its history replays its last token, which
        only touches dead cache slots)."""
        out = np.zeros((len(histories), 1), np.int32)
        for r, h in enumerate(histories):
            out[r, 0] = int(h[min(int(pos[r]), len(h) - 1)])
        return out

    def propose(self, histories, state, lens, generator=None):
        """Teacher-forced catch-up to the target's committed prefix,
        then k draft steps; returns ``(draft_toks (B, k), draft_probs
        (B, k, V) or None)`` on the draft's device.  ``lens`` is the
        caller's host committed-length vector."""
        if self._state is None:
            raise MXNetError("DraftProposer.propose before start()/admit()")
        pred = self._pred
        dev = pred.device
        lens_h = np.broadcast_to(np.asarray(lens, np.int64).reshape(-1),
                                 (self._state.lens.shape[0],)).copy()
        # catch-up: replay the committed tokens the draft never saw.  A
        # row already caught up re-appends its pending token at ``lens``,
        # the slot the proposal steps below overwrite first
        cur = np.minimum(self._filled, lens_h)
        st = self._state
        for _ in range(int((lens_h - cur).max()) if cur.size else 0):
            st = DecodeState(
                st.caches,
                torch.as_tensor(cur.astype(np.int32), device=dev),
                torch.as_tensor(self._hist_tok(histories, cur), device=dev))
            st, _ = pred.step(st, generator)
            cur = np.minimum(cur + 1, lens_h)
        # k proposal steps from the target's committed (lens, tok)
        st = DecodeState(st.caches,
                         state.lens.to(dev, torch.int32).clone(),
                         state.tok.to(dev, torch.int32).clone())
        toks, qs = [], []
        for _ in range(self.k):
            st, probs = pred.step(st, generator)
            toks.append(st.tok)
            if not pred._greedy:
                qs.append(pred._policy_probs(probs))
        self._state = st
        # the appended inputs [tok, d_1..d_{k-1}] are valid through the
        # accepted prefix, which the caller's next ``lens`` reveals
        self._filled = lens_h + self.k
        return (torch.cat(toks, dim=1),
                torch.stack(qs, dim=1) if qs else None)


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

    Speculation: ``spec_k`` (default ``MXNET_SPEC_K``) drafts per slot
    and step from ``proposer``, else from a :class:`DraftProposer` over
    ``draft`` (k = ``spec_k`` or 4), else from an :class:`NGramProposer`
    when ``spec_k`` is set.  Each step then verifies the drafts and
    commits 1..k+1 tokens a slot; a request that ends inside a window
    retires at once, the rest of the window discarded.  Plain steps run
    instead where a window would wrap the ring and, in paged mode,
    while an admission is mid-prefill.
    """

    def __init__(self, predictor, max_prefill, slots=None, eos_id=None,
                 max_new_tokens=None, seed=0, spec_k=None, proposer=None,
                 draft=None):
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
        if spec_k is None:
            spec_k = int(_config.get("MXNET_SPEC_K"))
        if proposer is not None:
            spec_k = int(getattr(proposer, "k", spec_k))
        elif draft is not None:
            spec_k = int(spec_k) or 4
            proposer = DraftProposer(draft, spec_k)
        elif spec_k:
            proposer = NGramProposer(spec_k)
        self._spec_k = int(spec_k or 0)
        self._proposer = proposer
        if getattr(proposer, "cache_len", None) \
                and self._max_prefill > proposer.cache_len:
            raise MXNetError("max_prefill %d exceeds the draft's cache_len "
                             "%d" % (self._max_prefill, proposer.cache_len))
        self.steps = 0          # device steps executed (verify included)
        self.spec_steps = 0     # of which speculative verify steps
        self.chunks = 0         # paged prefill chunks executed
        self.tokens_out = 0     # tokens delivered to finished requests
        self.proposed = 0       # drafted tokens offered to verify
        self.accepted = 0       # drafted tokens accepted

    @property
    def accept_rate(self):
        """Share of drafted tokens the target accepted."""
        return self.accepted / max(self.proposed, 1)

    def _note_step(self, spec=False):
        self.steps += 1
        self.spec_steps += int(spec)

    def _note_accept(self, proposed, accepted):
        self.proposed += proposed
        self.accepted += accepted

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
        return self._pred._sampling_generator(self._seed)

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
        out = {"steps": self.steps, "spec_steps": self.spec_steps,
               "proposed": self.proposed, "accepted": self.accepted,
               "accept_rate": self.accept_rate,
               "tokens_out": self.tokens_out,
               "requests_completed": len(done),
               "requests_queued": len(self._queue)}
        if done:
            tf = sorted(r["first"] - r["submit"] for r in done)
            out["ttft_p50_s"] = _nearest_rank(tf, 0.50)
            out["ttft_p95_s"] = _nearest_rank(tf, 0.95)
        if self._pred._paged and self._pred._manager is not None:
            out.update(self._pred._manager.stats())
        return out

    def _verify(self, state, lens_h, active, histories, gen, dgen,
                act_mask=None):
        """One speculative step over the batch: propose, verify, deliver
        each active slot's emitted tokens; returns ``(state', counts)``
        with counts read back to the host (0 for inactive rows)."""
        pred = self._pred
        k = self._spec_k
        hists = [histories.get(s) or [0] for s in range(self._slots)]
        draft_toks, draft_probs = self._proposer.propose(hists, state,
                                                         lens_h, dgen)
        if act_mask is None:
            state, out, counts = pred.verify_step(state, draft_toks,
                                                  draft_probs, gen)
        else:
            state, out, counts = pred.paged_verify(
                state, lens_h, draft_toks, draft_probs, gen, act_mask)
        out_h, counts_h = _read_window(out, counts)
        self._note_step(spec=True)
        for slot, rec in active.items():
            emitted = out_h[slot, :counts_h[slot]]
            self._note_accept(k, int(counts_h[slot]) - 1)
            self._deliver(rec, emitted)
            histories[slot].extend(int(t) for t in emitted)
        return state, counts_h

    def run(self):
        """Drain the queue; returns ``{request_id: np.int32 array}`` of
        generated tokens (EOS included when hit)."""
        if self._pred._paged:
            return self._run_paged()
        pred = self._pred
        gen = self._generator()
        proposer = self._proposer
        dgen = _proposer_generator(proposer, self._seed)
        k = self._spec_k
        limit = _window_limit(pred.cache_len, proposer)
        state = None
        active = {}
        results = {}
        histories = {}      # slot -> committed tokens (proposer food)
        slot_lens = np.zeros(self._slots, np.int64)
        while self._queue or active:
            # admit: prefill one request per free slot, splice into batch
            while self._queue and len(active) < self._slots:
                entry = self._queue.popleft()
                rid, prompt = entry["rid"], entry["prompt"]
                padded = _pad_window(prompt, self._max_prefill)
                one, _ = pred.prefill(padded, prompt.size, gen)
                first = int(one.tok[0, 0])
                rec = self._req[rid]
                rec["admit"] = rec["first"] = time.perf_counter()
                slot = next(s for s in range(self._slots)
                            if s not in active)
                if state is None:
                    state = _empty_batch_state(one, self._slots)
                _insert(state, one, slot)
                if getattr(proposer, "needs_prefill", False):
                    proposer.admit(padded, prompt.size, slot, self._slots,
                                   dgen)
                active[slot] = {"rid": rid, "toks": [first],
                                "cap": entry["cap"]}
                histories[slot] = list(prompt.astype(np.int64)) + [first]
                slot_lens[slot] = prompt.size
            self._retire_finished(active, results)
            if not active:
                continue
            if proposer is not None and k > 0 \
                    and max(slot_lens[s] for s in active) + k + 1 <= limit:
                state, counts_h = self._verify(state, slot_lens, active,
                                               histories, gen, dgen)
                slot_lens += counts_h
            else:
                state, _ = pred.step(state, gen)
                self._note_step()
                toks = state.tok[:, 0].cpu().numpy()
                for slot, rec in active.items():
                    self._deliver(rec, toks[slot:slot + 1])
                    histories[slot].append(int(toks[slot]))
                slot_lens += 1
            self._retire_finished(active, results)
        return results

    def _run_paged(self):
        pred = self._pred
        slots = self._slots
        gen = self._generator()
        proposer = self._proposer
        dgen = _proposer_generator(proposer, self._seed)
        k = self._spec_k
        limit = _window_limit(pred.cache_len, proposer)
        state = pred.paged_batch_state(slots)
        mgr = pred._manager
        active = {}
        results = {}
        histories = {}      # slot -> committed tokens (proposer food)
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
                self.chunks += 1
                p["pos"] += n
                if p["pos"] >= p["prompt"].size:
                    # (3) commit: the slot joins the batch
                    slot, plen = p["slot"], p["prompt"].size
                    first = int(tok[0, 0])
                    pred._commit(state, slot, plen, tok)
                    mgr.publish(slot, p["prompt"], plen)
                    if getattr(proposer, "needs_prefill", False):
                        proposer.admit(
                            _pad_window(p["prompt"], self._max_prefill),
                            plen, slot, slots, dgen)
                    active[slot] = {"rid": p["rid"], "toks": [first],
                                    "cap": p["cap"]}
                    histories[slot] = list(p["prompt"]) + [first]
                    slot_lens[slot] = plen
                    act_mask[slot] = 1
                    self._req[p["rid"]]["first"] = time.perf_counter()
                    pending = None
                    self._retire_finished(active, results, on_retire)
            if not active:
                continue
            # (4) one decode or verify step over the active slots; no
            # speculation while an admission is mid-prefill
            if proposer is not None and k > 0 and pending is None \
                    and max(slot_lens[s] for s in active) + k + 1 <= limit:
                state, counts_h = self._verify(state, slot_lens, active,
                                               histories, gen, dgen,
                                               act_mask)
                slot_lens += counts_h
            else:
                state, _ = pred.paged_step(state, slot_lens, gen, act_mask)
                self._note_step()
                toks = state.tok[:, 0].cpu().numpy()
                for slot, rec in active.items():
                    self._deliver(rec, toks[slot:slot + 1])
                    histories[slot].append(int(toks[slot]))
                slot_lens += act_mask.astype(np.int64)
            self._retire_finished(active, results, on_retire)
        return results

    def _admit(self, mgr, active):
        """Gate the queue head through the page allocator; returns its
        pending-prefill record, or None on backpressure."""
        entry = self._queue[0]
        prompt = entry["prompt"]
        gate = mgr.gate(prompt, prompt.size, entry["cap"], self._spec_k)
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

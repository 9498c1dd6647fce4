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

Page extract / install (``page_extract`` / ``page_install``, two more
programs: a slot's pages gathered to the host and scattered back in
place, one fixed (M,) table row whatever the page count) carry
:class:`DecodeServer`'s preemption by page swap and the fleet's page
migration (:mod:`~mxnet_tpu_torch.serve.fleet`).  The paged server runs
as a session, one :meth:`DecodeServer.serve_tick` at a time.  Every
program call is timed around its replay for the roofline table and the
trace timeline (:mod:`~mxnet_tpu_torch.obs`, ``MXNET_TELEMETRY``);
nothing of the telemetry runs inside a captured body.

**A mesh** (``mesh=`` a ``MeshConfig`` or a ``DeviceMesh``) makes the
predictor one rank of a (data x model x expert) mesh of processes, one rank a
process (the reference's ``jax.sharding.Mesh`` lives in one process):
each rank holds its shards of the Megatron plan, placed as the
training executor places them (``parallel.tp_exec.TensorParallel``, the
records in ``_sharding_coverage``; the plan's ``rules_from_plan`` rules
go into the programs' specs), and the graph walk runs through the
training executor's tensor-parallel walk (``parallel.tp_exec.
GraphWalk``: kernel A at the shard widths, the vocab-parallel
embedding, the gather before the head), the attention nodes on the
rank's local heads (kernel B on its local kv-heads, ``sdpa`` or C at
prefill).  Dense rings hold the rank's batch rows (``data``) and
kv-heads (``model``); paged pools its kv-heads, every page (a data rank
appends every slot's K/V, gathered over the data group, and attends its
own slot rows).  The probabilities are gathered over the data group, so
every rank samples the same tokens and its page manager decides the
same.  An attention node whose heads do not divide the model axis runs
on gathered q / k / v with its cache replicated, recorded in
``_replicated_degrades`` (the reference E-splits such a cache finer than
a head).  An ``expert`` axis keeps the expert stacks whole on every rank
(the reference's predictor shards only the Megatron plan) and each
MoEFFN splits its tokens over data x expert and runs the rank's experts
(``ops.moe``'s sharded all-to-all; a token count that does not divide
keeps the global path).  ``seq`` and ``pipe`` axes replicate.  The paged
programs of a mesh rank hold collectives, so they
run eagerly (``GraphProgram(eager=True)``: ``trace_counts`` stays 0 and
``prepare_programs`` reports ``"eager"``), as the reference keeps mesh
predictors off AOT.

:meth:`DecodePredictor.decode_artifact`, :meth:`~DecodePredictor.
verify_artifact` and :meth:`~DecodePredictor.prefill_artifact` export
the bodies those programs run (the dense step's, verify's and
prefill's when not paged) with ``torch.export``
(:mod:`~mxnet_tpu_torch.analysis`): kernels A and B are operators, so
with the kernels on each graph holds one ``paged_decode`` node an
attention layer.  The trace runs on fake tensors: nothing is computed
and no buffer is written.
"""
from __future__ import annotations

import hashlib
import json
import time
import weakref
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from . import config as _config
from . import obs as _obs
from . import programs as _programs
from .base import MXNetError
from .context import resolve_device
from .parallel import collectives as _coll
from .ops import attention as _attn
from .ops.moe import moe_flops
from .ops.sample import (is_greedy_policy, policy_logits, sample_tokens,
                         speculative_accept)
from .obs.metrics import percentile as _percentile
from .obs.roofline import tensor_bytes
from .programs import GraphPool, GraphProgram, ProgramSpec
from .registry import OpContext
from .serve import PagedKVManager
from .serve.swap import SwappedRequest
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


def _map_caches(fn, caches, *others):
    """``caches``' structure with ``fn(leaf, *other leaves)`` at every
    tensor (QuantKV planes included)."""
    def one(c, *o):
        if isinstance(c, _attn.QuantKV):
            return _attn.QuantKV(fn(c.data, *(x.data for x in o)),
                                 fn(c.scale, *(x.scale for x in o)))
        return fn(c, *o)

    return tuple(tuple(one(c, *(o[i][j] for o in others))
                       for j, c in enumerate(pair))
                 for i, pair in enumerate(caches))


def _host_array(t):
    """A host tensor as numpy: dtypes numpy lacks (bf16) as their bits."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


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
    mesh : MeshConfig or DeviceMesh, optional
        Serve as this process's rank of a mesh over the process group
        (see the module docstring); it must cover the group.
    """

    def __init__(self, symbol, params, cache_len, device=None, mesh=None,
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
        env = {n: v.data for n, v in {**arg_params, **aux_params}.items()}
        self._mesh = None             # module.executor_group.MeshRuntime
        self._tp = None               # this rank's TensorParallel
        self._sharding_coverage = None
        self._replicated_degrades = []
        self._partition_rules = None
        if mesh is not None:
            env = self._mesh_setup(mesh, symbol, arg_params, env)
        self._env = to_tensors(env, self._device)
        free = [n for n in symbol.list_arguments() if n not in self._env]
        if data_name not in free:
            raise MXNetError("%r is not a free input of the symbol (free "
                             "inputs: %s)" % (data_name, free))
        attn_nodes = [n for n in symbol._topo() if not n.is_variable
                      and n.op.name == "dot_product_attention"]
        if not attn_nodes:
            raise MXNetError("symbol has no dot_product_attention node; "
                             "nothing to cache")
        # the grouped-query layout (any node with num_kv_heads <
        # num_heads): a swapped record's pages carry it, a restore checks
        # it
        self._grouped_kv_heads = self._grouped_kv_heads_of(symbol)
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
        self._costs = {}              # program name -> roofline inputs
        # the (B, k+1, V) target probabilities of the last verify step
        # (paged: valid until the next program call)
        self.verify_probs = None
        if self._paged:
            # the serving programs share one graph memory pool; each
            # binds the predictor's own buffers (pools, lens, tok,
            # tables, mask) and copies the rest in.  A mesh of several
            # ranks runs them eagerly: collectives between its nodes
            pool = GraphPool()
            eager = self._mesh is not None and self._mesh.mesh is not None

            def program(name, body, bind):
                return GraphProgram(name, body, bind=bind, pool=pool,
                                    eager=eager)

            self._decode_fn = program("paged_decode_step",
                                      self._decode_body, range(5))
            self._verify_fn = program("paged_verify_step",
                                      self._verify_body, range(5))
            self._chunk_fn = program("prefill_chunk", self._chunk_body,
                                     (0,))
            self._commit_fn = program("slot_commit", self._commit_body,
                                      (0, 1))
            self._fork_fn = program("page_fork", self._fork_body, (0,))
            self._extract_fn = program("page_extract", self._extract_body,
                                       (0,))
            self._install_fn = program("page_install", self._install_body,
                                       (0,))

    def _mesh_setup(self, mesh, symbol, arg_params, env):
        """Resolve ``mesh`` against the process group, place the
        parameters by the Megatron plan (``TensorParallel``'s realization,
        the training executor's) and return this rank's ``{name:
        tensor}`` (its shards; aux states whole)."""
        from .module.executor_group import MeshRuntime
        from .parallel.tp_exec import TensorParallel
        from .parallel.tp_rules import kv_cache_pspec, kv_pool_pspec
        from .programs.partition import rules_from_plan

        rt = self._mesh = MeshRuntime(mesh, replicate=("seq", "pipe"))
        sizes = dict(rt.sizes)
        # the expert stacks stay whole here (the reference's predictor
        # shards only the Megatron plan); MoEFFN splits its tokens and
        # the rank's experts over the expert group when it runs
        self._tp = TensorParallel(
            symbol, {n: tuple(env[n].shape) for n in arg_params}, rt.model,
            rt.model_rank, rt.model_group, data=rt.data,
            data_group=rt.data_group, mesh_shape=sizes, expert=rt.expert,
            expert_rank=rt.expert_rank, expert_group=rt.expert_group,
            data_rank=rt.data_rank, shard_experts=False)
        self._sharding_coverage = self._tp.coverage_record()
        # the plan as the programs' partition rules (metadata)
        self._partition_rules = rules_from_plan(
            self._tp.plan if rt.model > 1 else {})
        # the reference's grouped-K/V degrade record (kv heads that do
        # not divide the model axis)
        pspec = kv_pool_pspec if self._paged else kv_cache_pspec
        pspec(sizes, num_kv_heads=self._grouped_kv_heads_of(symbol),
              degrades=self._replicated_degrades)
        return {n: self._tp.shard(n, torch.as_tensor(v)).contiguous()
                for n, v in env.items()}

    @staticmethod
    def _grouped_kv_heads_of(symbol):
        """The fewest kv-heads of a grouped attention node, or None."""
        grouped = []
        for n in symbol._topo():
            if n.is_variable or n.op.name != "dot_product_attention":
                continue
            a = n.parsed_attrs()
            kvh = a.get("num_kv_heads", 0) or a.get("num_heads", 1)
            if kvh != a.get("num_heads", 1):
                grouped.append(int(kvh))
        return min(grouped) if grouped else None

    def _degrade(self, node, heads, kv_heads):
        """Record (once) that ``node`` runs on gathered q / k / v with
        its cache replicated."""
        rec = {"site": "kv_pool" if self._paged else "kv_cache",
               "node": node.name,
               "reason": "num_heads=%d, num_kv_heads=%d over model=%d: q / "
                         "k / v gathered, the node's %s replicated"
                         % (heads, kv_heads, self._mesh.model,
                            "pool" if self._paged else "cache")}
        if rec not in self._replicated_degrades:
            self._replicated_degrades.append(rec)

    @property
    def mesh_shape(self):
        """``{axis: size}`` of the mesh this predictor is a rank of, or
        None."""
        return dict(self._mesh.sizes) if self._mesh is not None else None

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
    # telemetry: host-side only, around each program call
    # ------------------------------------------------------------------
    def _dispatch(self, prog, *args):
        """One call of a paged program.  With telemetry on, the call is
        timed (host wall, and CUDA events around the replay on the card)
        into the program's roofline row and the timeline, and its static
        cost is registered at the first call; the program itself, and
        so every captured graph, is the same on or off."""
        if not _obs.enabled():
            return prog(*args)
        with _obs.program_span(prog.name, self._device):
            out = prog(*args)
        if prog.name not in self._costs:
            self._costs[prog.name] = (self._program_rows(prog, args),
                                      tensor_bytes(args), tensor_bytes(out))
            ref = weakref.ref(self)
            _obs.programs.register_static(prog.name, lambda n=prog.name: (
                ref()._program_cost(n) if ref() is not None else None))
        return out

    def _program_rows(self, prog, args):
        """Token rows one call of ``prog`` pushes through the model (0
        for the programs that only move pages or lengths)."""
        if prog is self._decode_fn:
            return int(args[1].shape[0])
        if prog is self._verify_fn:
            return int(args[1].shape[0]) * (int(args[5].shape[1]) + 1)
        if prog is self._chunk_fn:
            return int(args[2].shape[1])
        return 0

    def _serving_flops(self, rows):
        """FLOPs of ``rows`` token rows through the model against a full
        cache: 2·rows·K·N for each FullyConnected / FusedLNLinear,
        4·rows·cache_len·hd·heads for each attention (the tables'
        capacity: what the argument shapes give), and each MoEFFN's
        router and expert products over ``rows`` tokens
        (:func:`~mxnet_tpu_torch.ops.moe.moe_flops`)."""
        if self._pools_template is None:
            self._pools_template = self._probe_cache_shapes()
        flops = 0
        ci = 0
        for node in self._symbol._topo():
            if node.is_variable:
                continue
            attrs = node.parsed_attrs()
            if node.op.name in ("FullyConnected", "FusedLNLinear"):
                names = node.op.list_arguments(attrs)
                w = self._env.get(node.inputs[names.index("weight")][0].name)
                if w is not None:
                    flops += 2 * rows * int(w.shape[1]) * int(w.shape[0])
            elif node.op.name == "dot_product_attention":
                heads = attrs.get("num_heads", 1)
                kvh = attrs.get("num_kv_heads", 0) or heads
                k = self._pools_template[ci][0]
                e_kv = int((k.data if isinstance(k, _attn.QuantKV)
                            else k).shape[2])
                flops += 4 * rows * self._cache_len * (e_kv // kvh) * heads
                ci += 1
            elif node.op.name == "MoEFFN":
                names = node.op.list_arguments(attrs)
                wg = self._env.get(
                    node.inputs[names.index("gate_weight")][0].name)
                if wg is not None:
                    flops += moe_flops(attrs, rows, int(wg.shape[0]))
        return flops

    def _program_cost(self, name):
        """The roofline row's static columns of program ``name``: FLOPs
        of its token rows, and bytes of its arguments (the weights too,
        for the programs that run the model) and outputs, each read or
        written once."""
        rows, arg_bytes, out_bytes = self._costs[name]
        if rows:
            arg_bytes += tensor_bytes(self._env)
        return {"flops": self._serving_flops(rows) if rows else 0,
                "bytes": arg_bytes + out_bytes}

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
        if self._tp is not None:
            return self._run_mesh(tokens, caches, pos0, tables, active,
                                  valid, env, plain)
        b, t = tokens.shape[0], tokens.shape[1]
        dev = tokens.device
        octx = OpContext(plain=plain)
        new_caches = []
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
                out, pair = self._attend(attrs, *ins, caches, len(new_caches),
                                         pos0, tables, active, valid, plain)
                new_caches.append(pair)
                outs = [out]
            else:
                ins = self._position_rows(node, ins, pos0, t, dev)
                outs, _ = node.op.fcompute(attrs, ins, aux_ins, octx)
            for i, o in enumerate(outs):
                values[(id(node), i)] = o
        head_node, head_idx = self._symbol._outputs[0]
        return self._head(values[(id(head_node), head_idx)], b, t), \
            tuple(new_caches)

    def _run_mesh(self, tokens, caches, pos0, tables, active, valid, env,
                  plain):
        """:meth:`_run` as this rank of the mesh: the tensor-parallel walk
        over the rank's shards (its batch rows when the data axis splits
        a batch of more than one row), the attention nodes here, on the
        heads the walk gives them; the probabilities gathered over the
        data group."""
        rt, tp = self._mesh, self._tp
        b, t = tokens.shape[0], tokens.shape[1]
        dev = tokens.device
        rows = rt.data_rows(b) if b > 1 else None
        pos = torch.as_tensor(pos0, dtype=torch.int32, device=dev).reshape(-1)
        pos_l = pos[rows] if rows is not None and pos.numel() == b else pos
        toks = tokens[rows] if rows is not None else tokens
        walk = tp.walk(OpContext(plain=plain), data_split=rows is not None)
        new_caches = []
        for node in self._symbol._topo():
            key = (id(node), 0)
            if node.is_variable:
                if node.name == self._data_name:
                    walk.put(key, toks, None)
                elif node.name in env:
                    walk.put(key, env[node.name], tp.sharded.get(node.name),
                             param=node.name)
                else:
                    walk.put(key, torch.zeros((toks.shape[0], t),
                                              dtype=torch.float32,
                                              device=dev), None)
                continue
            attrs = node.parsed_attrs()
            ins = node.inputs[:node.op.n_inputs(attrs)]
            if node.op.name == "dot_product_attention":
                got = walk.attention_split(attrs, ins)
                if got is None:
                    heads = attrs.get("num_heads", 1)
                    self._degrade(node, heads,
                                  attrs.get("num_kv_heads", 0) or heads)
                    qkv, local, st = [walk.rep(walk.key(e)) for e in ins], \
                        attrs, None
                else:
                    (qkv, local), st = got, -1
                out, pair = self._attend(local, *qkv, caches,
                                         len(new_caches), pos, tables,
                                         active, valid, plain, rows=rows)
                new_caches.append(pair)
                walk.put(key, out, st)
                continue
            if node.op.name in _POSITION_BROADCAST_OPS:
                vals = [walk.rep(walk.key(e)) for e in ins]
                moved = self._position_rows(node, vals, pos_l, t, dev)
                if moved is not vals:
                    outs, _ = node.op.fcompute(attrs, moved, [],
                                               walk.octx)
                    walk.put(key, outs[0], None)
                    continue
            outs, states, _ = walk.node(node, attrs)
            for i, (o, st) in enumerate(zip(outs, states)):
                walk.put((id(node), i), o, st)
        head_node, head_idx = self._symbol._outputs[0]
        out = self._head(walk.rep((id(head_node), head_idx)),
                         toks.shape[0], t)
        if rows is not None:
            out = _coll.all_gather(out, 0, rt.data_group)
        return out, tuple(new_caches)

    @staticmethod
    def _head(out, b, t):
        """The head's output as (B, t, V)."""
        if out.dim() == 2 and out.shape[0] == b * t:
            return out.reshape(b, t, -1)
        if out.dim() != 3:
            raise MXNetError("decode: head output shape %s is not (B*t, V) "
                             "or (B, t, V)" % (tuple(out.shape),))
        return out

    @staticmethod
    def _position_rows(node, ins, pos0, t, dev):
        """A learned (1, S, E) position table met by the (B, t, E)
        activation stream through a broadcast op: the table's rows for
        the CURRENT positions (``ins`` itself when the node is no such
        meeting)."""
        if node.op.name not in _POSITION_BROADCAST_OPS or len(ins) != 2 \
                or ins[0].dim() != 3 or ins[1].dim() != 3 \
                or ins[0].shape[1] == ins[1].shape[1] \
                or t not in (ins[0].shape[1], ins[1].shape[1]):
            return ins
        big_i = 0 if ins[0].shape[1] != t else 1
        big = ins[big_i]
        if big.shape[0] != 1:
            raise MXNetError(
                "decode: node %r mixes time-lengths %s without a "
                "broadcastable (1, S, E) side"
                % (node.name, (tuple(ins[0].shape), tuple(ins[1].shape))))
        idx = (torch.as_tensor(pos0, dtype=torch.int64,
                               device=dev).reshape(-1, 1)
               + torch.arange(t, device=dev)[None, :])
        idx = torch.clamp(idx, 0, big.shape[1] - 1)
        ins = list(ins)
        ins[big_i] = big[0][idx]
        return ins

    def _attend(self, attrs, q, k, v, caches, ci, pos0, tables, active,
                valid, plain, rows=None):
        """One attention node: ``(output, (k cache, v cache))``.
        Prefill (``caches`` None) attends causally and fills fresh rings;
        otherwise K/V append at ``pos0`` and the queries attend the cache
        (``tables``: the page pools).  ``rows`` (a mesh rank's slot rows
        of a data-split batch): the dense rings hold those rows; a page
        pool takes every slot's K/V, gathered over the data group, and
        the rows attend through their own tables."""
        heads = attrs.get("num_heads", 1)
        # grouped-query attention: K/V (and so the caches) are kv_heads
        # wide
        kv_heads = attrs.get("num_kv_heads", 0) or heads
        scale = attrs.get("scale", 0.0) or None
        t = q.shape[1]
        if caches is None:
            out = _attn.sdpa(q, k, v, num_heads=heads,
                             causal=attrs.get("causal", False), scale=scale,
                             num_kv_heads=kv_heads)
            return out, (self._fill_cache(k, kv_heads),
                         self._fill_cache(v, kv_heads))
        kc, vc = caches[ci]
        pos = torch.as_tensor(pos0, dtype=torch.int32,
                              device=q.device).reshape(-1)
        if tables is None:
            if rows is not None and pos.numel() > 1:
                pos = pos[rows]
            _attn.cache_append(kc, k, pos, num_heads=kv_heads)
            _attn.cache_append(vc, v, pos, num_heads=kv_heads)
            return _attn.cache_attend(q, kc, vc, pos + t, num_heads=heads,
                                      scale=scale, num_kv_heads=kv_heads,
                                      plain=plain), (kc, vc)
        if rows is not None:
            group = self._mesh.data_group
            k = _coll.all_gather(k.contiguous(), 0, group)
            v = _coll.all_gather(v.contiguous(), 0, group)
        _attn.paged_append(kc, tables, k, pos, num_heads=kv_heads,
                           active=active, valid=valid)
        _attn.paged_append(vc, tables, v, pos, num_heads=kv_heads,
                           active=active, valid=valid)
        if rows is not None:
            tables, pos = tables[rows], pos[rows]
        return _attn.paged_attend(q, kc, vc, tables, pos + t,
                                  num_heads=heads, scale=scale,
                                  num_kv_heads=kv_heads,
                                  plain=plain), (kc, vc)

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
            self._dispatch(self._fork_fn, caches,
                           torch.tensor([src, dst], dtype=torch.int64))

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
        probs = self._dispatch(self._decode_fn, state.caches, live.lens,
                               live.tok, tables, act, generator)
        return DecodeState(state.caches, live.lens, live.tok), probs

    def _decode_body(self, caches, lens, tok, tables, act, generator,
                     env=None):
        """The decode program: one token per active row, in place.
        ``env`` (the weights by name; the predictor's by default) lets an
        export trace the body over weights it holds as buffers."""
        probs3, _ = self._run(tok, caches, lens, tables=tables, active=act,
                              env=env)
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
        out, counts, self.verify_probs = self._dispatch(
            self._verify_fn, state.caches, live.lens, live.tok, tables,
            act, draft, draft_probs, generator)
        return DecodeState(state.caches, live.lens, live.tok), out, counts

    def _verify_body(self, caches, lens, tok, tables, act, draft_toks,
                     draft_probs, generator, env=None):
        """The verify program: append the last token and the k drafts
        of every row (inactive rows write the scratch page), score the
        k+1 positions, accept; active rows advance by their counts."""
        k = draft_toks.shape[1]
        toks_in = torch.cat([tok, draft_toks.to(tok.dtype)], dim=1)
        probs3, _ = self._run(toks_in, caches, lens, tables=tables,
                              active=act, env=env)
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
        probs, tok = self._dispatch(
            self._chunk_fn, caches, self._device_tables()[slot:slot + 1],
            torch.from_numpy(_pad_window(toks, width)),
            torch.tensor([pos0, n], dtype=torch.int32), generator)
        return caches, probs, tok

    def _chunk_body(self, caches, table1, tokens, meta, generator,
                    env=None):
        """The chunk program; ``meta`` = [pos0, real tokens]."""
        valid = meta[1:2]
        probs3, _ = self._run(
            tokens, caches, meta[0:1], tables=table1,
            active=torch.ones((1,), dtype=torch.int32,
                              device=tokens.device), valid=valid, env=env)
        last = torch.clamp(valid.long() - 1, 0, tokens.shape[1] - 1)
        probs = probs3.index_select(1, last)[:, 0]
        return probs, self._sample(probs, generator)

    def _commit(self, state, slot, new_len, new_tok):
        """Activate a freshly prefilled slot (the commit program, the slot
        as data): ``lens[slot] = new_len``, ``tok[slot, 0] = new_tok``."""
        self._dispatch(self._commit_fn, state.lens, state.tok,
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

    @staticmethod
    def _extract_body(caches, row):
        """The extract program: gather one slot's (M,) table row out of
        every pool (data and scale planes; fp8 planes as their bytes)
        into fresh outputs.  The page ids are data, so one capture
        serves every migration and swap-out; unmapped entries (0)
        gather the scratch page, whose content is never read."""
        return _map_caches(lambda pool: _attn._raw(pool).index_select(
            0, row), caches)

    @staticmethod
    def _install_body(caches, row, data):
        """The install program: scatter extracted page contents back
        into the pools, in place, at a (freshly allocated) table row.
        Unmapped entries (0) write the scratch page, so one fixed-(M,)
        program carries any live page count."""
        for pool, d in zip(_cache_leaves(caches), _cache_leaves(data)):
            _attn._raw(pool).index_copy_(0, row, d)

    def extract_pages(self, caches, row):
        """Host (numpy) copy of one slot's pages, the shippable payload of
        page migration and swap-out: per attention node the K and V
        planes (quantized data and per-(token, head) scales) in
        table-row order, ``(M, page_tokens, E)`` each.  ``row`` is the
        slot's (M,) page-table row (0 = unmapped).  On the card the
        program's outputs go to pinned host buffers."""
        row_t = torch.from_numpy(np.asarray(row, np.int64).reshape(-1))
        out = self._dispatch(self._extract_fn, caches, row_t)
        if self._device.type != "cuda":
            return _map_caches(lambda t: _host_array(t.clone()), out)
        host = _map_caches(lambda t: torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True), out)
        for h, t in zip(_cache_leaves(host), _cache_leaves(out)):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self._device).synchronize()
        return _map_caches(_host_array, host)

    def install_pages(self, caches, row, data):
        """Write a shipped page payload (:meth:`extract_pages`' form)
        into this predictor's pools, in place, at table row ``row`` (0 =
        unmapped, redirected to the scratch page).  The payload is
        staged into the program's input buffers before the replay.
        Returns the pools."""
        row_t = torch.from_numpy(np.asarray(row, np.int64).reshape(-1))

        def staged(pool, a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            raw = _attn._raw(pool)
            return t.view(raw.dtype) if t.dtype != raw.dtype else t

        self._dispatch(self._install_fn, caches, row_t,
                       _map_caches(staged, caches, data))
        return caches

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
        drafts and one for drafts with probabilities; ``prefill`` has no
        program here and stays 0).  A mesh rank's programs run eagerly
        and never capture: every count stays 0."""
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
                "fork": self._fork_fn, "extract": self._extract_fn,
                "install": self._install_fn}

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

    def serving_avals(self, slots, chunk_w=None, spec_k=0):
        """The argument signature of every paged program at batch width
        ``slots`` as ``meta`` tensors (shapes and dtypes only): the
        decode step, the prefill chunk (width ``chunk_w``), commit,
        fork, ``page_extract`` and ``page_install``, and with ``spec_k``
        the verify step over ``spec_k`` deterministic drafts.  The
        programs that run the model take the weights first (``{name:
        tensor}``, the module's buffers in an export); the others take
        their arguments as called.  No pool is allocated and nothing is
        captured or run, so a fleet host fingerprints its programs
        (:meth:`program_fingerprints`) before it allocates."""
        if not self._paged:
            raise MXNetError("serving_avals needs a paged predictor")
        slots = int(slots)
        pt = self._page_tokens
        m = self._cache_len // pt
        pp = PagedKVManager.pool_sizing(slots, self._cache_len, pt,
                                        self._pool_pages)
        caches = self._pools_like(lambda c: (pp, pt, c.shape[2]), "meta")
        # one slot's extracted pages, in the pools' raw (byte-indexed)
        # dtypes: what page_install stages
        pages = _map_caches(_attn._raw, self._pools_like(
            lambda c: (m, pt, c.shape[2]), "meta"))

        def meta(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        env = {n: meta(*v.shape, dtype=v.dtype) for n, v in self._env.items()}
        cw = int(chunk_w or self._prefill_chunk or self._cache_len)
        row = meta(m, dtype=torch.int64)
        out = {
            "chunk": (env, caches, meta(1, m),
                      meta(1, cw, dtype=torch.float32), meta(2)),
            "decode": (env, caches, meta(slots), meta(slots, 1),
                       meta(slots, m), meta(slots)),
            "commit": (meta(slots), meta(slots, 1), meta(2), meta(1, 1)),
            "fork": (caches, meta(2, dtype=torch.int64)),
            "extract": (caches, row),
            "install": (caches, row, pages),
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
                           device=self._device, fingerprint_extra=extra,
                           program=lambda a, k=kind: self._spec_program(
                               k, a),
                           partition_rules=self._partition_rules,
                           mesh_shape=self.mesh_shape,
                           artifact_meta=self._mesh_meta())

    def _spec_program(self, kind, args):
        """``(module, example args)`` of paged program ``kind``'s body at
        :meth:`serving_avals`' arguments (the weights first for the
        programs that run the model; they become the module's buffers,
        and the generator is None): what ``ProgramSpec.artifact``
        exports."""
        from .analysis.artifact import BufferModule

        body = self._programs()[kind].body
        if kind in ("chunk", "decode", "verify"):
            return BufferModule(body, args[0]), tuple(args[1:]) + (None,)
        return BufferModule(body), tuple(args)

    def program_fingerprints(self, slots, chunk_w=None, spec_k=0):
        """kind -> content address of each paged program at this sizing
        (the verify program's with ``spec_k``): equal keys across hosts
        mean the same programs on the same kernels."""
        return {kind: self._program_spec(kind, args).fingerprint(args)
                for kind, args in self.serving_avals(slots, chunk_w,
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
        Idempotent per signature (slots, chunk width, spec_k).  A mesh
        rank's programs run eagerly (their bodies hold collectives):
        each is driven once all the same, and reports ``"eager"``."""
        cw = int(chunk_w or self._prefill_chunk or self._cache_len)
        sig = (int(slots), cw, int(spec_k or 0))
        if self._prepared is not None and self._prepared["signature"] == sig:
            return self._prepared
        t_all = time.perf_counter()
        avals = self.serving_avals(slots, cw, spec_k)
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
            if kind not in calls:
                continue        # extract / install: captured at first use
            spec = self._program_specs[kind] = _programs.registry.register(
                self._program_spec(kind, args))
            before = self._programs()[kind].traces
            t0 = time.perf_counter()
            calls[kind]()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prog = self._programs()[kind]
            report["programs"][kind] = {
                "name": spec.name,
                "source": "eager" if prog.eager else "capture"
                if spec.trace_count() > before else "resident",
                "key": spec.fingerprint(args),
                "seconds": time.perf_counter() - t0}
        self.paged_batch_state(slots)
        report["wall_s"] = time.perf_counter() - t_all
        self._prepared = report
        return report

    # ------------------------------------------------------------------
    # artifacts: torch.export of the bodies the programs run
    # ------------------------------------------------------------------
    def cache_bytes(self, state):
        """Bytes of the caches (dense rings or page pools) behind
        ``state``, data and scale planes, counted from the tensors."""
        return sum(t.numel() * t.element_size()
                   for t in _cache_leaves(state.caches))

    def pool_bytes(self):
        """Bytes of the shared page pools of the current paged batch (the
        paged serving memory bill), data and scale planes."""
        if self._manager is None:
            raise MXNetError("pool_bytes before any paged prefill/serve")
        pp, pt = self._manager.pool_pages, self._page_tokens
        return sum(t.numel() * t.element_size() for t in _cache_leaves(
            self._pools_like(lambda c: (pp, pt, c.shape[2]), "meta")))

    def _cache_meta(self, state):
        """The cache metadata of the step artifacts: byte budget, stored
        data dtypes, layout, the kernel promise (``decode_kernel``: the
        graph must hold a ``paged_decode`` operator for every attention
        node) and the grouped-head and page sizes."""
        planes = [c.data if isinstance(c, _attn.QuantKV) else c
                  for pair in state.caches for c in pair]
        meta = {"cache_len": self._cache_len,
                "cache_bytes": self.cache_bytes(state),
                "kv_dtype": str(self._kv_dtype)
                if self._kv_dtype is not None else None,
                "cache_data_dtypes": sorted({str(c.dtype) for c in planes}),
                "cache_layout": "paged" if self._paged else "dense",
                "kv_paged": self._paged,
                "decode_kernel": not self._plain}
        if self._grouped_kv_heads is not None:
            meta["num_kv_heads"] = int(self._grouped_kv_heads)
            meta["cache_kv_dims"] = sorted({int(c.shape[2]) for c in planes})
        if self._paged:
            meta["page_tokens"] = self._page_tokens
            if self._manager is not None:
                meta["pool_pages"] = self._manager.pool_pages
        meta.update(self._mesh_meta())
        return meta

    def _mesh_meta(self):
        """A mesh rank's artifact metadata: the partition records
        (``sharding_coverage``) and the caches' degrades."""
        if self._mesh is None:
            return {}
        meta = {"sharding_coverage": self._sharding_coverage}
        if self._replicated_degrades:
            meta["replicated_degrades"] = [
                dict(r) for r in self._replicated_degrades]
        return meta

    def _artifact(self, body, args, name, env=None, **kw):
        from .analysis.artifact import BufferModule, artifact_from_export

        return artifact_from_export(
            BufferModule(body, self._env if env is None else env), args,
            name, mesh_shape=self.mesh_shape, **kw)

    def _paged_step_inputs(self, state):
        """The page tables and activity mask a paged step over ``state``
        reads: the batch's device buffers, or zeros at its width."""
        b = int(state.lens.shape[0])
        live = self._live
        if live is not None and int(live.lens.shape[0]) == b:
            return live.tables, live.act
        m = self._cache_len // self._page_tokens
        dev = state.lens.device
        return (torch.zeros((b, m), dtype=torch.int32, device=dev),
                torch.zeros((b,), dtype=torch.int32, device=dev))

    def prefill_artifact(self, b, p, name="prefill"):
        """:class:`~mxnet_tpu_torch.analysis.ProgramArtifact` of the
        prefill at batch ``b`` and prompt width ``p``.  Dense: the full
        causal forward that builds the rings.  Paged: the prefill-chunk
        program at chunk width ``p`` (a batch prefills slot by slot, one
        call a chunk: ``meta["slots_per_call"]`` 1), over the batch's
        pools, or over ``meta`` tensors before the first paged batch."""
        b, p = int(b), int(p)
        if not self._paged:
            dev = self._device
            return self._artifact(
                self._prefill_body,
                (torch.zeros((b, p), dtype=torch.float32, device=dev),
                 torch.full((b,), p, dtype=torch.int32, device=dev), None),
                name, trace_count=self.trace_counts["prefill"],
                expected_traces=1, cache_len=self._cache_len,
                cache_layout="dense", decode_kernel=False,
                **self._mesh_meta())
        m = self._cache_len // self._page_tokens
        env = None
        if self._live is not None:
            pools, dev = self._live.pools, self._device
        else:
            pp = PagedKVManager.pool_sizing(b, self._cache_len,
                                            self._page_tokens,
                                            self._pool_pages)
            pt = self._page_tokens
            dev = torch.device("meta")
            pools = self._pools_like(lambda c: (pp, pt, c.shape[2]), dev)
            env = {n: torch.empty(v.shape, dtype=v.dtype, device=dev)
                   for n, v in self._env.items()}
        args = (pools, torch.zeros((1, m), dtype=torch.int32, device=dev),
                torch.zeros((1, p), dtype=torch.float32, device=dev),
                torch.zeros((2,), dtype=torch.int32, device=dev), None)
        state = DecodeState(pools, None, None)
        return self._artifact(
            self._chunk_body, args, name, env=env,
            donated_leaves=len(_cache_leaves(pools)),
            trace_count=self.trace_counts["chunk"], expected_traces=1,
            program="prefill_chunk", slots_per_call=1,
            **self._cache_meta(state))

    def decode_artifact(self, state, name="decode_step"):
        """:class:`~mxnet_tpu_torch.analysis.ProgramArtifact` of the
        decode step at ``state``'s shapes (the paged decode program's
        body, or the dense step): one ``paged_decode`` operator for every
        attention node when the kernels are on.  ``donated_leaves``
        counts the buffers the step writes in place; the cache metadata
        is :meth:`_cache_meta`'s.  The trace reads shapes only: no
        buffer is written."""
        leaves = len(_cache_leaves(state.caches))
        if self._paged:
            tables, act = self._paged_step_inputs(state)
            body = self._decode_body
            args = (state.caches, state.lens, state.tok, tables, act, None)
            leaves += 2
        else:
            body = self._step_body
            args = (state.caches, state.lens, state.tok, None)
        return self._artifact(
            body, args, name, donated_leaves=leaves,
            trace_count=self.trace_counts["decode"], expected_traces=1,
            **self._cache_meta(state))

    def verify_artifact(self, state, k, draft_probs=None,
                        name="verify_step"):
        """:class:`~mxnet_tpu_torch.analysis.ProgramArtifact` of the
        speculative verify step at ``state``'s shapes and draft width
        ``k``; ``draft_probs`` (a (B, k, V) tensor) selects the variant
        with the proposal distribution, None the deterministic one."""
        b = int(state.lens.shape[0])
        draft = torch.zeros((b, int(k)), dtype=torch.int32,
                            device=state.lens.device)
        leaves = len(_cache_leaves(state.caches))
        if self._paged:
            tables, act = self._paged_step_inputs(state)
            body = self._verify_body
            args = (state.caches, state.lens, state.tok, tables, act, draft,
                    draft_probs, None)
            leaves += 2
            expected = max(self._verify_fn.traces, 1)
        else:
            body = self._dense_verify_body
            args = (state.caches, state.lens, state.tok, draft, draft_probs,
                    None)
            expected = 1
        return self._artifact(
            body, args, name, donated_leaves=leaves,
            trace_count=self.trace_counts["verify"],
            expected_traces=expected, spec_k=int(k),
            **self._cache_meta(state))

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
        probs, tok, caches = self._prefill_body(tokens, lens, generator)
        return DecodeState(caches, lens, tok), probs

    def _prefill_body(self, tokens, lens, generator, env=None):
        """The dense prefill: the full causal forward over (B, P) tokens,
        fresh ring caches, the probabilities at each row's last real
        position and the token sampled from them."""
        b, p = tokens.shape
        probs3, caches = self._run(tokens, None, 0, env=env)
        last = torch.clamp(lens.long() - 1, 0, p - 1)
        probs = probs3[torch.arange(b, device=tokens.device), last]
        return probs, self._sample(probs, generator), caches

    def _step_body(self, caches, lens, tok, generator, env=None):
        """The dense decode step: ``tok``'s K/V appended to the ring caches
        in place, the probabilities and the next token."""
        probs3, _ = self._run(tok, caches, lens, env=env)
        probs = probs3[:, 0]
        return probs, self._sample(probs, generator)

    def _dense_verify_body(self, caches, lens, tok, draft, draft_probs,
                           generator, env=None):
        """The dense verify step: the last token and the drafts appended
        to the ring caches in place, the k + 1 positions scored and the
        drafts accepted; returns ``(out, counts, probs3)``."""
        toks_in = torch.cat([tok.to(torch.int32), draft], dim=1)
        probs3, _ = self._run(toks_in, caches, lens, env=env)
        counts, out = self._accept(probs3, draft, draft_probs, generator)
        return out, counts, probs3

    def step(self, state, generator=None):
        """One decode step: append ``state.tok``'s K/V, attend, sample.
        Returns ``(state', probs)``; the caches of ``state`` are updated
        in place, so ``state`` must not be reused."""
        if self._paged:
            out = self.paged_step(state, self._paged_lens, generator)
            self._paged_lens += 1
            return out
        probs, tok = self._step_body(state.caches, state.lens, state.tok,
                                     generator)
        return DecodeState(state.caches, state.lens + 1, tok), probs

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
        out, counts, self.verify_probs = self._dense_verify_body(
            state.caches, state.lens, state.tok, draft, draft_probs,
            generator)
        tok = torch.gather(out, 1, (counts.long() - 1)[:, None])
        return DecodeState(state.caches, state.lens + counts, tok), out, \
            counts

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

    The paged loop is also a fleet citizen (:mod:`~mxnet_tpu_torch.
    serve.fleet`): it runs as a persistent session, one
    :meth:`serve_tick` at a time, so a router can interleave hosts;
    accepts page-restorable records through :meth:`inject` (migrated
    prefills, swapped-out requests); publishes its routing view through
    :meth:`serve_summary` (``/metrics.json`` with ``metrics_port`` /
    ``MXNET_METRICS_PORT``); and preempts under pressure — a
    higher-priority waiter, or any waiter after
    ``MXNET_FLEET_DECODE_BOUND`` pool-blocked iterations, swaps the
    lowest-priority slot's pages to host RAM (``MXNET_FLEET_SWAP``); the
    victim readmits bit-exactly here or on any other host.  ``host``
    labels the per-host ``mx_fleet_*`` metric children.  Request times
    are wall-clock (``time.time()``): a swapped record carries them
    across hosts.
    """

    def __init__(self, predictor, max_prefill, slots=None, eos_id=None,
                 max_new_tokens=None, seed=0, spec_k=None, proposer=None,
                 draft=None, metrics_port=None, host=None):
        self._pred = predictor
        self._host = str(host) if host is not None else "local"
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
        self._done_rids = deque()   # retired rids, oldest first (pruning)
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
        # registry mirrors of the loop counters (scrapeable over
        # /metrics; the ints above stay the callers' source)
        self._m_steps = _obs.registry.counter(
            "mx_serve_steps", "device steps executed by the serving loop")
        self._m_spec = _obs.registry.counter(
            "mx_serve_spec_steps", "speculative verify steps")
        self._m_tokens = _obs.registry.counter(
            "mx_serve_tokens", "tokens delivered to finished requests")
        self._m_proposed = _obs.registry.counter(
            "mx_spec_proposed", "drafted tokens offered to verify")
        self._m_accepted = _obs.registry.counter(
            "mx_spec_accepted", "drafted tokens accepted by the target")
        # preemption (paged loop): after this many consecutive
        # pool-gate-blocked iterations the lowest-priority slot swaps out
        self._fair_bound = int(_config.get("MXNET_FLEET_DECODE_BOUND"))
        self._swap_armed = bool(_config.get("MXNET_FLEET_SWAP"))
        self._preempt_cb = None     # serve.fleet routes records back out
        self._verify_restore = False   # re-extract and compare restores
        self._ps = None             # the persistent paged session
        self.swap_outs = 0
        self.swap_ins = 0
        self.metrics_server = None
        self._summary_key = None
        self._bind_host_metrics(self._host)
        # the process-wide HTTP exporter (one per port): /metrics,
        # /metrics.json (with this server's mx_serve_summary:<host>
        # section), /trace, /healthz
        if metrics_port is None:
            metrics_port = int(_config.get("MXNET_METRICS_PORT"))
        if metrics_port:
            self.metrics_server = _obs.serve_metrics(metrics_port)
            self._register_summary()

    def _register_summary(self):
        """(Re)register this server's ``/metrics.json`` section under
        its current host label (a rename drops the old key)."""
        if self.metrics_server is None:
            return
        key = "mx_serve_summary:%s" % self._host
        if self._summary_key and self._summary_key != key:
            self.metrics_server.remove_json(self._summary_key)
        self._summary_key = key
        self.metrics_server.add_json(key, self.serve_summary)

    def _bind_host_metrics(self, host):
        """(Re)bind the per-host ``mx_fleet_*`` children: the fleet
        names its hosts after construction, and the labeled series
        follow the name."""
        self._host = str(host)
        self._register_summary()
        lab = {"host": self._host}
        reg = _obs.registry
        self._m_swapped_pages = reg.counter(
            "mx_fleet_swapped_pages",
            "pages moved to host RAM by preemption swap-outs",
            labels=("host",)).labels(**lab)
        self._m_migrated_pages = reg.counter(
            "mx_fleet_migrated_pages",
            "pages installed from migrated/restored records",
            labels=("host",)).labels(**lab)
        self._m_queue_depth = reg.gauge(
            "mx_fleet_queue_depth", "requests waiting in the host queue",
            labels=("host",)).labels(**lab)
        self._m_free_pages = reg.gauge(
            "mx_fleet_free_pages", "free pages in the host's KV pool",
            labels=("host",)).labels(**lab)
        self._m_ttft = reg.histogram(
            "mx_fleet_ttft", "seconds from submit to first token",
            labels=("host",)).labels(**lab)

    @property
    def accept_rate(self):
        """Share of drafted tokens the target accepted."""
        return self.accepted / max(self.proposed, 1)

    def _note_step(self, spec=False):
        self.steps += 1
        self._m_steps.inc()
        if spec:
            self.spec_steps += 1
            self._m_spec.inc()

    def _note_accept(self, proposed, accepted):
        self.proposed += proposed
        self.accepted += accepted
        self._m_proposed.inc(proposed)
        self._m_accepted.inc(accepted)

    def submit(self, tokens, max_new_tokens=None, priority=0):
        """Queue a prompt (1-D int sequence); returns the request id.

        ``priority`` matters only under preemption (paged mode with
        ``MXNET_FLEET_SWAP``): higher values are swapped out last when
        the pool runs dry.  Admission order stays FIFO."""
        tokens = np.asarray(tokens).reshape(-1)
        if tokens.size > self._max_prefill:
            raise MXNetError("prompt length %d exceeds max_prefill %d"
                             % (tokens.size, self._max_prefill))
        rid = self._next_id
        self._next_id += 1
        cap = int(max_new_tokens) if max_new_tokens is not None \
            else self._max_new
        self._queue.append({"rid": rid, "prompt": tokens, "cap": cap,
                            "prio": int(priority), "swap": None})
        self._req[rid] = {"submit": time.time()}
        return rid

    def inject(self, record, front=False):
        """Queue a restorable :class:`~mxnet_tpu_torch.serve.swap.
        SwappedRequest` — a migrated prefill from a prefill worker, or a
        request another host swapped out.  It admits through the normal
        reservation gate and restores by installing its saved pages (no
        prefill); its times carry over, so fleet TTFT stays honest.
        Returns this host's rid."""
        rid = self._next_id
        self._next_id += 1
        entry = {"rid": rid, "prompt": record.prompt, "cap": record.cap,
                 "prio": record.priority, "swap": record}
        (self._queue.appendleft if front else self._queue.append)(entry)
        self._req[rid] = {"submit": record.submit_ts
                          if record.submit_ts is not None else time.time()}
        return rid

    # retained retired-request records (stats percentiles); older ones
    # are pruned so a long-lived server cannot grow without bound
    _REQ_CAP = 4096

    def _finish(self, rid, ntokens):
        """Close a request's record and publish it to the profiler
        (queue wait, time to first token, decode tokens/s)."""
        from . import profiler as _prof

        rec = self._req.get(rid)
        if rec is None or "retire" in rec:
            return
        now = time.time()
        rec["retire"] = now
        rec["tokens"] = int(ntokens)
        first = rec.get("first", now)
        self._m_ttft.observe(max(first - rec["submit"], 0.0))
        _prof.record_request(
            rec.get("admit", rec["submit"]) - rec["submit"],
            first - rec["submit"], ntokens, now - first)
        _obs.instant("retire", cat="serve",
                     args={"rid": rid, "tokens": int(ntokens)})
        self._done_rids.append(rid)
        while len(self._done_rids) > self._REQ_CAP:
            self._req.pop(self._done_rids.popleft(), None)

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
        cap reached): record the result, close its record, free the
        slot (``on_retire(slot)``: the paged loop frees its pages)."""
        for slot in list(active):
            rec = active[slot]
            rid, toks = rec["rid"], rec["toks"]
            if (self._eos_id is not None and toks
                    and toks[-1] == self._eos_id) \
                    or len(toks) >= rec["cap"]:
                results[rid] = np.asarray(toks, np.int32)
                self.tokens_out += len(toks)
                self._m_tokens.inc(len(toks))
                self._finish(rid, len(toks))
                del active[slot]
                if on_retire is not None:
                    on_retire(slot)

    def stats(self):
        """Loop counters, per-request percentiles (queue wait, TTFT,
        decode tokens/s; seconds from submit) and, in paged mode, pool
        and prefix-cache accounting, with the swap counts."""
        done = [r for r in self._req.values() if "retire" in r]
        out = {"steps": self.steps, "spec_steps": self.spec_steps,
               "proposed": self.proposed, "accepted": self.accepted,
               "accept_rate": self.accept_rate,
               "tokens_out": self.tokens_out,
               "requests_completed": len(done),
               "requests_queued": len(self._queue)}
        if done:
            qw = sorted(r.get("admit", r["submit"]) - r["submit"]
                        for r in done)
            tf = sorted(r.get("first", r["retire"]) - r["submit"]
                        for r in done)
            out["queue_wait_p50_s"] = _percentile(qw, 0.50)
            out["queue_wait_p95_s"] = _percentile(qw, 0.95)
            out["ttft_p50_s"] = _percentile(tf, 0.50)
            out["ttft_p95_s"] = _percentile(tf, 0.95)
            rates = sorted(
                (r["tokens"] - 1)
                / max(r["retire"] - r.get("first", r["retire"]), 1e-9)
                for r in done if r["tokens"] > 1)
            if rates:
                out["decode_tokens_per_sec_p50"] = _percentile(rates, 0.50)
                out["decode_tokens_per_sec_p95"] = _percentile(rates, 0.95)
        if self._pred._paged and self._pred._manager is not None:
            out.update(self._pred._manager.stats())
        out["swap_outs"] = self.swap_outs
        out["swap_ins"] = self.swap_ins
        return out

    def serve_summary(self):
        """The routing view a fleet front end scores this host by: the
        free-page and queue-depth load signals and the prefix-cache
        chain summary (``PrefixCache.summary``) the cache-aware policy
        matches prompts against.  Served inside ``/metrics.json`` (the
        ``mx_serve_summary:<host>`` key) when the exporter is armed."""
        mgr = getattr(self._pred, "_manager", None)
        active = len(self._ps["active"]) if self._ps is not None else 0
        pending = 1 if self._ps is not None and self._ps["pending"] else 0
        out = {"host": self._host,
               "slots": self._slots,
               "active": active + pending,
               "queue_depth": len(self._queue),
               "free_pages": mgr.allocator.free_pages
               if mgr is not None else None,
               "swap_outs": self.swap_outs,
               "chains": None}
        if mgr is not None and mgr.prefix_cache is not None:
            out["chains"] = mgr.prefix_cache.summary()
        return out

    def _generator(self):
        return self._pred._sampling_generator(self._seed)

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
        generated tokens (EOS included when hit).  A paged predictor
        runs the session's tick loop (:meth:`serve_tick`) on a fresh
        session."""
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
                rec["admit"] = rec["first"] = time.time()
                slot = next(s for s in range(self._slots)
                            if s not in active)
                _obs.instant("admit", cat="serve",
                             args={"rid": rid, "slot": slot})
                if state is None:
                    state = _empty_batch_state(one, self._slots)
                _insert(state, one, slot)
                if getattr(proposer, "needs_prefill", False):
                    proposer.admit(padded, prompt.size, slot, self._slots,
                                   dgen)
                active[slot] = {"rid": rid, "toks": [first],
                                "cap": entry["cap"], "prio": entry["prio"],
                                "prompt": prompt}
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

    # ------------------------------------------------------------------
    # the paged serving schedule: a persistent session driven one
    # iteration at a time (serve_tick), so a fleet router can interleave
    # hosts, inject migrated state and collect preemptions between
    # iterations; run() drives the same tick loop to drain the queue
    # ------------------------------------------------------------------
    def serve_open(self):
        """Get-or-create the paged serving session: the predictor's pools
        zeroed in place, a fresh page manager and batch bookkeeping, the
        sampling generators seeded.  Idempotent while a session is live;
        :meth:`serve_reset` closes it (the captured programs are the
        predictor's and survive: a reopened session captures nothing)."""
        if self._ps is not None:
            return self._ps
        slots = self._slots
        self._ps = {
            "gen": self._generator(),
            "dgen": _proposer_generator(self._proposer, self._seed),
            "state": self._pred.paged_batch_state(slots),
            "active": {},       # slot -> request record
            "results": {},
            "histories": {},    # slot -> committed tokens (proposer food)
            "slot_lens": np.zeros(slots, np.int64),
            "act_mask": np.zeros(slots, np.int32),
            "pending": None,    # the one admission mid-chunked-prefill
            "blocked": 0,       # consecutive pool-gate-blocked ticks
        }
        return self._ps

    def serve_reset(self):
        """Close the paged session.  The predictor's manager is dropped
        now, not at reopen: a router polls :meth:`serve_summary` before
        the first tick, and the previous session's chains would mis-route
        the first burst."""
        self._ps = None
        if self._pred._paged:
            self._pred._manager = None

    @property
    def has_work(self):
        """Whether the session still has queued, mid-prefill or decoding
        requests."""
        if self._ps is None:
            return bool(self._queue)
        ps = self._ps
        return bool(self._queue or ps["active"] or ps["pending"])

    def serve_results(self, clear=True):
        """``{rid: np.int32 tokens}`` finished since the session opened
        (or since the last ``clear``)."""
        if self._ps is None:
            return {}
        out = dict(self._ps["results"])
        if clear:
            self._ps["results"].clear()
        return out

    def _run_paged(self):
        """Drain the local queue through the tick loop on a fresh
        session."""
        self.serve_reset()
        self.serve_open()
        while self.has_work:
            self.serve_tick()
        return self.serve_results(clear=True)

    def _on_retire_paged(self, ps):
        def on_retire(slot):
            ps["act_mask"][slot] = 0
            # pages back to the pool now: the next admission sees them
            self._pred._manager.free_slot(slot)
        return on_retire

    def _admit_one(self, ps):
        """Gate the queue head: a fresh prompt starts chunked prefill
        (returns its pending record, stored in ``ps``); a restorable
        record installs its pages and its slot activates at once
        (returns True).  None: the pool cannot cover it yet
        (backpressure)."""
        mgr = self._pred._manager
        entry = self._queue[0]
        if entry["swap"] is not None:
            return self._try_restore(ps, entry)
        rid, prompt, cap = entry["rid"], entry["prompt"], entry["cap"]
        gate = mgr.gate(prompt, prompt.size, cap, self._spec_k)
        if gate is None:
            return None
        self._queue.popleft()
        matched, pages, reserve_n = gate
        slot = next(s for s in range(self._slots) if s not in ps["active"])
        mgr.map_slot(slot, pages, reserve_n)
        self._req[rid]["admit"] = time.time()
        _obs.instant("admit", cat="serve",
                     args={"rid": rid, "slot": slot,
                           "prefix_matched": int(matched)})
        ps["pending"] = {"slot": slot, "rid": rid,
                         "prompt": np.asarray(prompt).reshape(-1)
                         .astype(np.int64), "cap": cap,
                         "prio": entry["prio"], "pos": int(matched)}
        return ps["pending"]

    def _try_restore(self, ps, entry):
        """Admit a :class:`~mxnet_tpu_torch.serve.swap.SwappedRequest`
        by restoring its pages: reserve through the normal gate, allocate
        fresh pages at the same ring positions, scatter the saved
        contents back (the install program), set the slot's length and
        token (the commit program).  No prefill, no new capture; with
        ``_verify_restore`` the pages are extracted again and held
        against the record byte for byte."""
        pred = self._pred
        mgr = pred._manager
        rec = entry["swap"]
        if getattr(rec, "kv_heads", None) != pred._grouped_kv_heads:
            # page planes are raw pool bytes with no head structure of
            # their own: another grouped layout would misread every page
            raise MXNetError(
                "swap restore: record kv layout (kv_heads=%r) does not "
                "match this host's (kv_heads=%r)"
                % (rec.kv_heads, pred._grouped_kv_heads))
        m = mgr.pages_per_slot
        remaining = max(rec.cap - len(rec.delivered), 0)
        total = rec.lens + remaining + self._spec_k + 1
        target = min(-(-min(total, pred.cache_len) // mgr.page_tokens), m)
        # a record that re-publishes its prompt chain and will wrap
        # budgets one fork per prompt page up front (the gate's
        # budget_wrap_forks rule)
        fork = -(-rec.prompt.size // mgr.page_tokens) \
            if rec.publish and total > pred.cache_len else 0
        need = rec.n_pages + max(target - rec.n_pages, 0) + fork
        if not mgr.gate_pages(need):
            return None
        self._queue.popleft()
        slot = next(s for s in range(self._slots) if s not in ps["active"])
        row = mgr.restore_slot(slot, rec.row_valid, need)
        state = ps["state"]
        pred.install_pages(state.caches, row, rec.data)
        pred._commit(state, slot, rec.lens,
                     torch.tensor([[rec.tok]], dtype=torch.int32))
        if self._verify_restore:
            back = pred.extract_pages(state.caches, row)
            for a, b in zip(_cache_leaves(back), _cache_leaves(rec.data)):
                if not np.array_equal(np.asarray(a)[rec.row_valid],
                                      np.asarray(b)[rec.row_valid]):
                    raise MXNetError("restored pages are not bit-identical")
        if rec.publish:
            mgr.publish(slot, rec.prompt, rec.prompt.size)
        if getattr(self._proposer, "needs_prefill", False):
            self._proposer.admit(
                _pad_window(rec.prompt, self._max_prefill),
                rec.prompt.size, slot, self._slots, ps["dgen"])
        rid = entry["rid"]
        req = self._req[rid]
        req["admit"] = time.time()
        req["first"] = rec.first_ts if rec.first_ts is not None \
            else req["admit"]
        ps["active"][slot] = {"rid": rid, "toks": list(rec.delivered),
                              "cap": rec.cap, "prio": rec.priority,
                              "prompt": rec.prompt}
        ps["histories"][slot] = list(rec.history)
        ps["slot_lens"][slot] = rec.lens
        ps["act_mask"][slot] = 1
        if rec.kind == "swap":
            self.swap_ins += 1
        else:
            self._m_migrated_pages.inc(rec.n_pages)
        _obs.instant("swap_in" if rec.kind == "swap" else "page_migrate",
                     cat="serve", args={"rid": rid, "slot": slot,
                                        "pages": rec.n_pages})
        self._retire_finished(ps["active"], ps["results"],
                              self._on_retire_paged(ps))
        return True

    def _swap_out(self, ps, slot):
        """Preempt ``slot``: extract its pages to host RAM (the extract
        program), free them, and hand the restorable record to the
        fleet's preemption callback — or re-queue it here at the back,
        so the blocked waiter admits and the victim resumes later.
        Returns the record."""
        pred = self._pred
        mgr = pred._manager
        rec = ps["active"][slot]
        row = mgr.tables[slot].copy()
        data = pred.extract_pages(ps["state"].caches, row)
        req = self._req.get(rec["rid"], {})
        record = SwappedRequest(
            rec["prompt"], rec["toks"], ps["histories"][slot],
            rec["cap"], rec["prio"], int(ps["slot_lens"][slot]),
            int(ps["state"].tok[slot, 0]), row != 0, data, kind="swap",
            submit_ts=req.get("submit"), first_ts=req.get("first"),
            rid=rec["rid"], kv_heads=pred._grouped_kv_heads)
        mgr.free_slot(slot)
        ps["act_mask"][slot] = 0
        ps["slot_lens"][slot] = 0
        del ps["active"][slot]
        del ps["histories"][slot]
        self.swap_outs += 1
        self._m_swapped_pages.inc(record.n_pages)
        _obs.instant("swap_out", cat="serve",
                     args={"rid": record.rid, "slot": int(slot),
                           "pages": record.n_pages})
        if self._preempt_cb is not None:
            # the request's times travel with the record; the readmitting
            # host makes its own entry
            self._req.pop(record.rid, None)
            self._preempt_cb(record)
        else:
            self._queue.append({"rid": record.rid, "prompt": record.prompt,
                                "cap": record.cap, "prio": record.priority,
                                "swap": record})
        return record

    def _preempt_for_waiter(self, ps, allow_bound):
        """The preemption rule, for both blocking modes (slots full, pool
        gate blocked): the queue head evicts the lowest-priority (then
        longest-running) slot when it strictly outranks it — or, with
        ``allow_bound``, once the fair-admission bound is reached.
        Swaps out, readmits, restarts the blocked count; returns the
        readmission's result (None: no preemption, or still blocked)."""
        active = ps["active"]
        if not (self._swap_armed and active and self._queue):
            return None
        victim = min(active, key=lambda s: (active[s]["prio"],
                                            -int(ps["slot_lens"][s])))
        bound_hit = allow_bound and self._fair_bound > 0 \
            and ps["blocked"] >= self._fair_bound
        if active[victim]["prio"] >= self._queue[0]["prio"] \
                and not bound_hit:
            return None
        self._swap_out(ps, victim)
        got = self._admit_one(ps)
        # one swap per bound window, even when the waiter is still
        # blocked: preemption cannot cascade through every resident
        ps["blocked"] = 0
        return got

    def serve_tick(self):
        """One iteration of the paged serving schedule.

        (1) gate at most one queued request through the page allocator
        (a reservation failure is backpressure: the request waits for
        retirements); a waiter that outranks the lowest-priority slot,
        or any waiter after ``MXNET_FLEET_DECODE_BOUND`` blocked
        iterations, swaps that slot out (``MXNET_FLEET_SWAP``); (2) run
        one prefill chunk of the admission in flight (prefix-cache
        matched pages were mapped at the gate); (3) on its last chunk,
        set the slot's length and first token, publish the prompt's
        pages to the prefix cache and activate the slot; (4) run one
        decode (or speculative verify) step over the active slots,
        inactive rows masked; (5) retire finished requests, freeing their
        pages at once.  Page tables, masks, slot indices, page ids and
        swapped page contents are all data: nothing is captured again."""
        pred = self._pred
        ps = self.serve_open()
        mgr = pred._manager
        slots = self._slots
        active = ps["active"]
        histories = ps["histories"]
        slot_lens = ps["slot_lens"]
        act_mask = ps["act_mask"]
        gen, dgen = ps["gen"], ps["dgen"]
        proposer = self._proposer
        k = self._spec_k
        limit = _window_limit(pred.cache_len, proposer)
        on_retire = self._on_retire_paged(ps)

        def retire():
            self._retire_finished(active, ps["results"], on_retire)

        # (1a) slots full: a waiter that outranks the lowest-priority
        # resident evicts it; equal priorities wait for a retirement
        if ps["pending"] is None and len(active) >= slots:
            self._preempt_for_waiter(ps, allow_bound=False)
        # (1) admission gate: one request starts (or restores)
        if ps["pending"] is None and self._queue and len(active) < slots:
            got = self._admit_one(ps)
            if got is None:
                ps["blocked"] += 1
                if not active:
                    # nothing running to free pages: spill the prefix
                    # cache; then the pool is genuinely too small
                    if mgr.prefix_cache is not None:
                        mgr.prefix_cache.evict(mgr.pool_pages)
                        got = self._admit_one(ps)
                    if got is None:
                        raise MXNetError(
                            "KV page pool (%d pages) cannot admit a "
                            "%d-token request even with an empty batch — "
                            "raise MXNET_KV_POOL_PAGES"
                            % (mgr.pool_pages,
                               self._queue[0]["prompt"].size))
                else:
                    got = self._preempt_for_waiter(ps, allow_bound=True)
            if got is not None:
                ps["blocked"] = 0
        # (2) one prefill chunk of the admission in flight
        if ps["pending"] is not None:
            p = ps["pending"]
            state = ps["state"]
            n = min(self._chunk_w, p["prompt"].size - p["pos"])
            copies = mgr.ensure(p["slot"], p["pos"], p["pos"] + n)
            if copies:
                pred._run_forks(state.caches, copies)
            _obs.instant("prefill_chunk", cat="serve",
                         args={"slot": p["slot"], "pos": p["pos"],
                               "tokens": int(n)})
            _, _, tok = pred._chunk(
                state.caches, p["slot"], p["prompt"][p["pos"]:p["pos"] + n],
                p["pos"], self._chunk_w, gen)
            self.chunks += 1
            p["pos"] += n
            if p["pos"] >= p["prompt"].size:
                # (3) commit: the slot joins the batch
                slot, plen = p["slot"], p["prompt"].size
                first = int(tok[0, 0])
                pred._commit(state, slot, plen, tok)
                mgr.publish(slot, p["prompt"], plen)
                if getattr(proposer, "needs_prefill", False):
                    proposer.admit(_pad_window(p["prompt"],
                                               self._max_prefill),
                                   plen, slot, slots, dgen)
                active[slot] = {"rid": p["rid"], "toks": [first],
                                "cap": p["cap"], "prio": p["prio"],
                                "prompt": p["prompt"]}
                histories[slot] = list(p["prompt"]) + [first]
                slot_lens[slot] = plen
                act_mask[slot] = 1
                self._req[p["rid"]]["first"] = time.time()
                ps["pending"] = None
                retire()        # a first-token EOS / cap-1 request
        self._note_gauges()
        if not active:
            return
        # (4) one decode or verify step over the active slots; no
        # speculation while an admission is mid-prefill
        if proposer is not None and k > 0 and ps["pending"] is None \
                and max(slot_lens[s] for s in active) + k + 1 <= limit:
            _, counts_h = self._verify(ps["state"], slot_lens, active,
                                       histories, gen, dgen, act_mask)
            slot_lens += counts_h
        else:
            state, _ = pred.paged_step(ps["state"], slot_lens, gen,
                                       act_mask)
            self._note_step()
            toks = state.tok[:, 0].cpu().numpy()
            for slot, rec in active.items():
                self._deliver(rec, toks[slot:slot + 1])
                histories[slot].append(int(toks[slot]))
            slot_lens += act_mask.astype(np.int64)
        # (5) retire
        retire()

    def _note_gauges(self):
        """Refresh the per-host queue-depth and free-page gauges (the
        router's load and headroom signals)."""
        self._m_queue_depth.set(len(self._queue))
        mgr = self._pred._manager
        if mgr is not None:
            self._m_free_pages.set(mgr.allocator.free_pages)

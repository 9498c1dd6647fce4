"""The tensor-parallel plan realized on one rank: which parameters this
rank holds a shard of, and the graph walk that runs each node at its
local attributes with the model-axis collectives where the plan's state
changes (the port's counterpart of what the reference's GSPMD
partitioner inserts from ``executor_group._param_sharding``'s
annotations).

The plan (:func:`~mxnet_tpu_torch.parallel.tp_rules.
plan_tensor_parallel`, or under ``MXNET_TP_MODE=naive`` dim 0 of every
parameter whose dim 0 divides the axis) is made concrete parameter by
parameter: a planned dim that does not divide by the model axis
replicates, with the reference's coverage record.  The walk then keeps,
for every activation, the dim it is split on over the model group (None
= replicated) as it REALLY is, so a degraded parameter re-derives the
states after it.  The collectives (:mod:`~mxnet_tpu_torch.parallel.
collectives`) go where a node needs its input in another state:

* a column-parallel FullyConnected / Convolution / FusedLNLinear takes
  its replicated input through *f* (identity, all-reduce of the
  gradient: each rank's gradient is a partial sum over its columns) and
  gives a feature-split output at ``num_hidden / M`` (``num_filter /
  M``); a FusedLNLinear keeps its LN affine inside the kernel and takes
  gamma and beta through *f* too (F's gradients of both are partial sums
  over the local columns); a residual is sliced to the local columns;
* a row-parallel one computes a partial sum over its input slice, sums
  it with *g*, and then adds the bias (and FusedLNLinear's residual)
  once, as one elementwise pass after the all-reduce: inside the
  kernel's epilogue they would be added M times;
* a vocab-parallel Embedding looks up its rows, masks the ids outside
  them to zero, then *g*;
* attention over feature-split q / k / v runs at ``num_heads / M`` (and
  ``num_kv_heads / M``) when both divide; otherwise q / k / v are
  gathered and it runs replicated;
* BatchNorm on a channel-split activation keeps its statistics and aux
  states local; elementwise ops and Pooling keep the split;
* every other op (SoftmaxOutput, Flatten, Reshape ...) gets its split
  inputs gathered along their split dim, and sharded parameters it reads
  gathered, and runs replicated; the graph's outputs leave replicated.

The walk (:class:`GraphWalk`, from :meth:`TensorParallel.walk`) is
shared: the training executor drives it through
:meth:`TensorParallel.run_graph`, and a mesh
:class:`~mxnet_tpu_torch.decode.DecodePredictor` drives it node by node,
taking only ``dot_product_attention`` into its own hands (the caches)
with the heads the walk decides (:meth:`GraphWalk.attention_split`).

Over a data group of more than one rank BatchNorm's training statistics
are summed over the group (the reference's mesh-wide batch statistics),
and SoftmaxOutput's and MakeLoss's 'batch' / 'valid' normalization
divide by the whole batch's rows / valid count (one all-reduce of the
count for 'valid').  Any other reduction over dim 0 of a value the batch
reaches (``mean`` before MakeLoss) raises there: each rank would reduce
its slice alone.

An ``expert`` axis of more than one rank holds this rank's block of each
MoE expert stack (dim 0, an op-declared ``OpDef.mesh_axes`` axis taking
precedence over the Megatron plan, with the reference's coverage record
and its "indivisible" degrade), and ``MoEFFN`` runs
:mod:`~mxnet_tpu_torch.ops.moe`'s mesh paths: the sharded all-to-all
over the expert group, or the reference's global semantics.  Over a data
group alone ``MoEFFN`` keeps those global semantics too (one capacity
quota over the whole batch, f and P averaged over it), where each rank
would otherwise route its slice alone.  Every other value is computed
alike on the expert ranks.

Over a seq group of more than one rank (the realization of what GSPMD
does for the reference's ``seq`` axis) the walk also keeps, for every
value, which dim holds this rank's block of the sequence
(:class:`SeqSplit`; the executor group splits the T dim of every input
whose layout has N and T).  A per-token op keeps the split: the element-
wise and broadcast families, ``FullyConnected`` on rows or with
``flatten=False``, ``FusedLNLinear``, ``Embedding``, softmax over
another axis, reductions over other axes, a ``Reshape`` that merges
the leading (N, T) dims (the LM's rows), ``SoftmaxOutput`` on split rows
(its 'batch' / 'valid' normalization over data x seq).  A whole operand
that carries every position (``attention_lm``'s ``pos_embed_weight``) is
cut to the block; one broadcast along T is used as it is when it is a
parameter (its gradient, a partial sum over the rank's tokens, is summed
with the others) and through *f* over the seq group when it is not.
``dot_product_attention`` on split q / k / v runs the ring
(:mod:`~mxnet_tpu_torch.parallel.ring`, ``MXNET_RING_ATTENTION``; on
the rank's heads under a model axis) or gathers K and V
(``collectives.seq_gather``) for the rank's queries.  Any other op runs
on its split inputs gathered, every seq rank computing the same values,
its parameters' gradients taken at 1 / seq each, so the one all-reduce
over data x seq (the executor group's) restores them.  A reduction over
T of a split value raises.
"""
from __future__ import annotations

import functools
from collections import namedtuple

import numpy as np
import torch

from ..base import MXNetError
from . import collectives as C
from .tp_rules import ELEMENTWISE_OPS, plan_tensor_parallel

__all__ = ["TensorParallel", "GraphWalk", "param_mesh_axes", "SeqSplit",
           "gather_seq", "slice_seq"]

# A value split over the seq group: its dim ``dim`` is (outer, t) with
# this rank's block of ``t`` (of t x seq) positions inner (outer 1 on an
# input's T dim; the (B, T) dims merged into rows are (B, t)).
SeqSplit = namedtuple("SeqSplit", "dim t")


def param_mesh_axes(symbol, axis_sizes):
    """``{variable name: mesh axis}`` for every variable that feeds an
    argument an op declares on a mesh axis (``OpDef.mesh_axes``) whose
    size is above 1."""
    out = {}
    for node in symbol._topo():
        if node.is_variable or not node.op.mesh_axes:
            continue
        names = node.op.list_arguments(node.parsed_attrs())
        for (inode, _), arg in zip(node.inputs, names):
            axis = node.op.mesh_axes.get(arg)
            if axis and inode.is_variable and axis_sizes.get(axis, 1) > 1:
                out[inode.name] = axis
    return out


class TensorParallel:
    """One rank's realization of the plan over ``model_group`` (``model``
    ranks, this one ``model_rank``); ``data_group`` (``data`` ranks) is
    where BatchNorm's statistics are summed; ``seq_group`` (``seq``
    ranks, this one ``seq_rank``) splits the inputs named in
    ``seq_inputs`` ({name: T dim}) and ``grad_group`` spans data x seq.
    ``shapes`` maps every parameter and aux state to its GLOBAL shape;
    ``mode`` is "megatron" or "naive"."""

    def __init__(self, symbol, shapes, model, model_rank, model_group,
                 data=1, data_group=None, mode="megatron",
                 mesh_shape=None, seq=1, seq_rank=0, seq_group=None,
                 grad_group=None, seq_inputs=None, expert=1, expert_rank=0,
                 expert_group=None, data_rank=0, shard_experts=True):
        if mode not in ("megatron", "naive"):
            raise MXNetError("MXNET_TP_MODE must be 'megatron' or 'naive', "
                             "not %r" % (mode,))
        self.model = int(model)
        self.model_rank = int(model_rank)
        self.group = model_group
        self.data = int(data)
        self.data_group = data_group
        self.seq = int(seq)
        self.seq_rank = int(seq_rank)
        self.seq_group = seq_group
        # the group the parameter gradients are summed over (data x seq)
        self.grad_group = grad_group
        # {input name: its T dim}: the inputs split over the seq group
        self.seq_inputs = dict(seq_inputs or {})
        # the seq split of each graph output of the last run (None: whole)
        self.out_seq = []
        self.data_rank = int(data_rank)
        self.expert = int(expert)
        self.expert_rank = int(expert_rank)
        self.expert_group = expert_group
        self.mode = mode
        self.mesh_shape = dict(mesh_shape or {"model": self.model})
        self.plan = plan_tensor_parallel(symbol) if mode == "megatron" \
            else None
        # {name: axis} of the parameters an op declares on a mesh axis
        # (OpDef.mesh_axes: the MoE expert stacks); a predictor keeps them
        # whole (``shard_experts`` False), as the reference's does
        self.param_axes = param_mesh_axes(symbol, {"expert": self.expert}) \
            if shard_experts else {}
        self.coverage = {}
        self.sharded = {}           # name -> the dim split over the group
        self.expert_sharded = set()     # names split on dim 0 over expert
        for name, shape in shapes.items():
            dim = self._realize(name, tuple(shape))
            if dim is not None:
                self.sharded[name] = dim

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def _realize(self, name, shape):
        """The dim of ``name`` split over the model group (None:
        replicated), stamping its coverage record as the reference's
        ``_param_sharding`` does."""
        rec = {"shape": [int(d) for d in shape],
               "source": "scalar" if not shape else "default"}
        self.coverage[name] = rec
        if self.param_axes.get(name) == "expert" and shape:
            # the op's declared axis first (the reference's order)
            if shape[0] % self.expert == 0:
                rec["source"] = "mesh_axes"
                rec["spec"] = ["expert"] + [None] * (len(shape) - 1)
                self.expert_sharded.add(name)
                return None
            # losing the declared axis to divisibility is the degrade the
            # sharding-coverage pass errors on
            rec["source"], rec["degrade"] = "mesh_axes", "indivisible"
        if self.model <= 1 or not shape:
            return None
        if self.plan is not None:
            spec = self.plan.get(name)
            if spec is None:
                return None
            if len(spec) != len(shape):
                rec["source"], rec["degrade"] = "plan", "rank-mismatch"
                return None
            for dim, ax in enumerate(spec):
                if ax is not None and shape[dim] % self.model != 0:
                    rec["source"], rec["degrade"] = "plan", "indivisible"
                    return None
            rec["source"], rec["spec"] = "plan", list(spec)
            return next(d for d, ax in enumerate(spec) if ax is not None)
        if shape[0] % self.model != 0:
            return None
        if rec.get("degrade") is None:
            rec["source"] = "naive"
            rec["spec"] = ["model"] + [None] * (len(shape) - 1)
        return 0

    def local_shape(self, name, shape):
        """This rank's shape of ``name`` (global ``shape``): a sharded
        parameter's split dim over the model axis, a seq-split input's T
        dim over the seq axis."""
        shape = list(shape)
        dim = self.sharded.get(name)
        if dim is not None:
            shape[dim] //= self.model
        if name in self.expert_sharded:
            shape[0] //= self.expert
        tdim = self.seq_inputs.get(name)
        if tdim is not None:
            shape[tdim] //= self.seq
        return tuple(shape)

    def shard(self, name, full):
        """This rank's block of the full tensor ``full`` of ``name``."""
        if name in self.expert_sharded:
            n = full.shape[0] // self.expert
            return full.narrow(0, self.expert_rank * n, n)
        dim = self.sharded.get(name)
        if dim is None:
            return full
        n = full.shape[dim] // self.model
        return full.narrow(dim, self.model_rank * n, n)

    def unshard(self, name, local):
        """The full tensor of ``name`` from every rank's ``local`` block
        (a collective over the model group, or the expert group for an
        expert stack: every rank calls it)."""
        if name in self.expert_sharded:
            return C.all_gather(local, 0, self.expert_group)
        dim = self.sharded.get(name)
        if dim is None:
            return local
        return C.all_gather(local, dim, self.group)

    def mesh_axes(self):
        """``{name: parallel.compat.MeshAxis}`` of the data, model and
        expert axes as this rank sees them."""
        from .compat import MeshAxis

        return {"data": MeshAxis("data", self.data_group, self.data,
                                 self.data_rank),
                "model": MeshAxis("model", self.group, self.model,
                                  self.model_rank),
                "expert": MeshAxis("expert", self.expert_group, self.expert,
                                   self.expert_rank)}

    def coverage_record(self):
        """The ``meta['sharding_coverage']`` the sharding-coverage pass
        reads: the mesh shape and a record a parameter."""
        return {"mesh": dict(self.mesh_shape),
                "leaves": {n: dict(r) for n, r in self.coverage.items()}}

    # ------------------------------------------------------------------
    # the walk
    # ------------------------------------------------------------------
    def walk(self, octx, data_split=True):
        """A fresh :class:`GraphWalk` over this rank's shards
        (``data_split``: whether the batch's rows arrive split over the
        data group, as the training executor splits them)."""
        return GraphWalk(self, octx, data_split)

    def run_graph(self, symbol, env_args, env_aux, octx, tap=None):
        """``executor.run_graph`` over this rank's shards: returns the
        (replicated) outputs and the new aux states (this rank's blocks
        of the sharded ones)."""
        walk = self.walk(octx)
        new_aux = dict(env_aux)
        for node in symbol._topo():
            if node.is_variable:
                src = env_aux if node.is_aux_var else env_args
                if node.name not in src:
                    raise MXNetError("no value bound for %r" % node.name)
                value = src[node.name]
                walk.put((id(node), 0), value, self.sharded.get(node.name),
                         param=node.name)
                if node.name not in self.coverage:
                    walk.batched.add((id(node), 0))
                tdim = self.seq_inputs.get(node.name)
                if tdim is not None and self.seq > 1:
                    walk.seq[(id(node), 0)] = SeqSplit(
                        tdim, value.shape[tdim])
                continue
            attrs = node.parsed_attrs()
            batched = any(walk.key(e) in walk.batched for e in node.inputs)
            if batched and self.data > 1:
                _refuse_batch_reduction(node, attrs, walk, self.data)
            ins, out_seq = None, None
            if self.seq > 1:
                ins, out_seq, attrs = walk.seq_prepare(node, attrs)
            outs, states, node_aux = walk.node(node, attrs, ins)
            walk.seq_factor = 1
            for i, (o, st) in enumerate(zip(outs, states)):
                walk.put((id(node), i), o, st)
                if batched:
                    walk.batched.add((id(node), i))
                if out_seq is not None:
                    walk.seq_put((id(node), i), o, outs[0], out_seq)
            if tap is not None:
                names = node.op.list_outputs(attrs)
                for i in range(node.op.n_visible_outputs(attrs)):
                    tap("%s_%s" % (node.name, names[i] if i < len(names)
                                   else i), outs[i])
            n_args = node.op.n_inputs(attrs)
            for (anode, _), val in zip(node.inputs[n_args:], node_aux):
                new_aux[anode.name] = val
        outs = [walk.rep((id(n), i)) for n, i in symbol._outputs]
        self.out_seq = [walk.seq.get((id(n), i)) for n, i in symbol._outputs]
        return outs, new_aux


class GraphWalk:
    """The values and split dims of one run of the walk, with each
    conversion made once an entry (so q, k and v share one *f* of their
    input, and its backward all-reduces their summed gradient once).
    :meth:`put` enters a value, :meth:`node` runs a node and returns its
    outputs with their split dims, :meth:`rep` reads a value
    replicated."""

    def __init__(self, tp, octx, data_split=True):
        self.tp = tp
        self.octx = octx
        self.data_split = data_split and tp.data > 1
        self.values = {}
        self.states = {}
        self.params = {}
        self.cache = {}
        self.batched = set()        # the entries the batch reaches
        self.seq = {}               # entry -> SeqSplit (None: whole)
        self.seq_factor = 1         # the node running: its rows' split
        self._aliases = []

    def put(self, key, value, state, param=None):
        if state is not None:
            state %= value.dim()
        self.values[key] = value
        self.states[key] = state
        if param is not None:
            self.params[key] = param

    @staticmethod
    def key(entry):
        return (id(entry[0]), entry[1])

    def _cached(self, key, kind, make):
        ck = (key, kind)
        if ck not in self.cache:
            self.cache[ck] = make()
        return self.cache[ck]

    def rep(self, key):
        st = self.states[key]
        if st is None:
            return self.values[key]
        return self._cached(key, "rep", lambda: C.gather_from(
            self.values[key], st, self.tp.group))

    def copy(self, key):
        """The replicated value through *f*."""
        return self._cached(key, "copy", lambda: C.copy_to(
            self.rep(key), self.tp.group))

    def split(self, key, dim):
        """The value split along ``dim`` (normalized)."""
        st = self.states[key]
        if st == dim:
            return self.values[key]
        return self._cached(key, ("split", dim), lambda: C.scatter_to(
            self.rep(key), dim, self.tp.group))

    def wdim(self, entry):
        """The split dim of a sharded parameter input, else None."""
        return self.tp.sharded.get(self.params.get(self.key(entry)))

    # ------------------------------------------------------------------
    # the seq axis
    # ------------------------------------------------------------------
    def _is_param(self, key):
        return key in self.params and key not in self.batched

    def _alias(self, key, value):
        """A fresh entry for ``value``, a form of entry ``key`` (its model
        state, parameter name and batch mark carried over)."""
        alias = _Alias()
        self._aliases.append(alias)
        akey = (id(alias), 0)
        self.values[akey] = value
        self.states[akey] = self.states[key]
        if key in self.params:
            self.params[akey] = self.params[key]
        if key in self.batched:
            self.batched.add(akey)
        return (alias, 0)

    def _seq_form(self, entry, kind):
        """``entry`` converted for its node (cached a kind): "share" a
        parameter's gradient over the seq ranks (a replicated node),
        "bcast" a whole operand broadcast against a split one (a non-
        parameter's gradient summed over the group), ("slice", SeqSplit)
        a whole operand cut to this rank's block, ("gather", SeqSplit) a
        split value gathered."""
        key = self.key(entry)
        tp = self.tp
        ck = (key, ("seq",) + tuple(kind if isinstance(kind, tuple)
                                    else (kind,)))
        if ck in self.cache:
            return self.cache[ck]
        value = self.values[key]
        param = self._is_param(key)
        if kind == "share":
            out = C.share_grad(value, 1.0 / tp.seq) if param else None
        elif kind == "bcast":
            out = None if param else C.copy_to(value, tp.seq_group)
        elif kind[0] == "slice":
            out = slice_seq(value, kind[1], tp.seq, tp.seq_rank,
                            None if param else tp.seq_group)
        else:
            out = gather_seq(value, kind[1], tp.seq_group)
        self.cache[ck] = entry if out is None else self._alias(key, out)
        return self.cache[ck]

    def seq_prepare(self, node, attrs):
        """``(inputs, out SeqSplit or None, attrs)`` for ``node`` under a
        seq axis above 1: a node that keeps its rows' split (a per-token
        op on split inputs) runs on them with its whole operands cut or
        broadcast; any other node runs on its inputs gathered, every rank
        computing the same values, its parameters' gradients shared over
        the seq ranks (each rank's is then 1 / seq of the whole, and the
        gradient sum over the data x seq group restores it)."""
        n_args = node.op.n_inputs(attrs)
        ins = list(node.inputs[:n_args])
        keys = [self.key(e) for e in ins]
        sts = [self.seq.get(k) for k in keys]
        self.seq_factor = 1
        if any(st is not None for st in sts):
            vals = [self.values[k] for k in keys]
            rule = _SEQ_RULES.get(node.op.name)
            if rule is None and node.op.name in _pointwise_ops():
                rule = _seq_pointwise
            got = rule(self, node, attrs, vals, sts) if rule else None
            if got is not None:
                conv, out_st, new_attrs = got
                self.seq_factor = self.tp.seq
                return ([e if c is None else self._seq_form(e, c)
                         for e, c in zip(ins, conv)], out_st,
                        new_attrs or attrs)
            ins = [e if st is None else self._seq_form(e, ("gather", st))
                   for e, st in zip(ins, sts)]
        return [self._seq_form(e, "share") for e in ins], None, attrs

    def seq_put(self, key, out, first, st):
        """Record output ``out``'s split (``st`` as for the node's first
        output ``first``; an output of another rank or length is
        whole)."""
        dim = st.dim % first.dim()
        if out.dim() == first.dim() and out.shape[dim] == first.shape[dim]:
            self.seq[key] = SeqSplit(dim, st.t)

    # ------------------------------------------------------------------
    def node(self, node, attrs, ins=None):
        name = node.op.name
        n_args = node.op.n_inputs(attrs)
        if ins is None:
            ins = node.inputs[:n_args]
        handler = _HANDLERS.get(name)
        if handler is not None:
            got = handler(self, node, attrs, ins)
            if got is not None:
                return got
        if name in ELEMENTWISE_OPS:
            got = self._elementwise(node, attrs, ins)
            if got is not None:
                return got
        return self.replicated(node, attrs, ins)

    def _compute(self, node, attrs, inputs, aux):
        outs, new_aux = node.op.fcompute(attrs, inputs, aux, self.octx)
        return list(outs), list(new_aux)

    def replicated(self, node, attrs, ins):
        """The op on replicated inputs (split ones gathered); sharded aux
        states are read gathered and written back as this rank's
        block."""
        n_args = len(ins)
        inputs = [self.rep(self.key(e)) for e in ins]
        aux_entries = node.inputs[n_args:]
        aux = [self.rep(self.key(e)) for e in aux_entries]
        outs, new_aux = self._compute(node, attrs, inputs, aux)
        new_aux = [self._aux_back(e, v) for e, v in zip(aux_entries,
                                                        new_aux)]
        return outs, [None] * len(outs), new_aux

    def _aux_back(self, entry, value):
        name = self.params.get(self.key(entry))
        return self.tp.shard(name, value) if name is not None else value

    def _elementwise(self, node, attrs, ins):
        sts = [self.states[self.key(e)] for e in ins]
        if not sts or any(s is None for s in sts) or len(set(sts)) != 1:
            return None
        outs, new_aux = self._compute(
            node, attrs, [self.values[self.key(e)] for e in ins], [])
        return outs, [sts[0]] * len(outs), new_aux

    # ------------------------------------------------------------------
    # the ops with a sharded form
    # ------------------------------------------------------------------
    def _bias_after(self, out, bias_entry, cdim):
        """``out + bias`` with the (replicated) bias along ``cdim``."""
        if bias_entry is None:
            return out
        b = self.rep(self.key(bias_entry))
        shape = [1] * out.dim()
        shape[cdim] = -1
        return out + b.reshape(shape).to(out.dtype)

    def fully_connected(self, node, attrs, ins):
        wdim = self.wdim(ins[1])
        if wdim is None:
            return None
        bias = ins[2] if len(ins) > 2 else None
        data_key = self.key(ins[0])
        w = self.values[self.key(ins[1])]
        flatten = attrs.get("flatten", True)
        if wdim == 0:
            local = dict(attrs, num_hidden=w.shape[0])
            inputs = [self.copy(data_key), w]
            if bias is not None:
                inputs.append(self._column_bias(bias))
            outs, _ = self._compute(node, local, inputs, [])
            return outs, [outs[0].dim() - 1], []
        x = self.values[data_key]
        fdim = 1 if flatten and x.dim() > 2 else x.dim() - 1
        x = self.split(data_key, fdim)
        part, _ = self._compute(node, dict(attrs, no_bias=True), [x, w], [])
        out = C.reduce_from(part[0], self.tp.group)
        return [self._bias_after(out, bias, out.dim() - 1)], [None], []

    def _column_bias(self, entry):
        if self.wdim(entry) == 0:
            return self.values[self.key(entry)]
        return self.split(self.key(entry), 0)

    def convolution(self, node, attrs, ins):
        wdim = self.wdim(ins[1])
        if wdim is None or attrs.get("num_group", 1) != 1:
            return None
        bias = ins[2] if len(ins) > 2 else None
        data_key = self.key(ins[0])
        w = self.values[self.key(ins[1])]
        cdim = 3 if attrs.get("layout") == "NHWC" else 1
        if wdim == 0:
            local = dict(attrs, num_filter=w.shape[0])
            inputs = [self.copy(data_key), w]
            if bias is not None:
                inputs.append(self._column_bias(bias))
            outs, _ = self._compute(node, local, inputs, [])
            return outs, [cdim], []
        x = self.split(data_key, cdim)
        part, _ = self._compute(node, dict(attrs, no_bias=True), [x, w], [])
        out = C.reduce_from(part[0], self.tp.group)
        return [self._bias_after(out, bias, cdim)], [None], []

    def fused_ln_linear(self, node, attrs, ins):
        from ..ops.fused_lm import _arg_names

        args = _arg_names(attrs)
        entry = dict(zip(args, ins))
        wdim = self.wdim(entry["weight"])
        if wdim is None:
            return None
        data_key = self.key(entry["data"])
        w = self.values[self.key(entry["weight"])]
        if wdim == 0:
            # the replicated data, gamma and beta through f: F's
            # gradients of all three are partial sums over the local
            # columns (q, k and v share each f, so one all-reduce a
            # segment group sums their three)
            inputs = []
            for arg, e in entry.items():
                k = self.key(e)
                if arg in ("data", "gamma", "beta"):
                    inputs.append(self.copy(k))
                elif arg == "residual":
                    inputs.append(self.split(k, self.values[k].dim() - 1))
                elif arg == "weight":
                    inputs.append(w)
                else:
                    inputs.append(self._column_bias(e))
            local = dict(attrs, num_hidden=w.shape[0])
            outs, _ = self._compute(node, local, inputs, [])
            return outs, [outs[0].dim() - 1], []
        if not attrs.get("no_affine", False):
            return None
        x = self.split(data_key, self.values[data_key].dim() - 1)
        zero = torch.zeros((w.shape[0],), dtype=w.dtype, device=w.device)
        part, _ = self._compute(node, dict(attrs, has_residual=False),
                                [x, w, zero], [])
        out = C.reduce_from(part[0], self.tp.group)
        # the bias and the residual once, after the all-reduce
        out = self._bias_after(out, entry["bias"], out.dim() - 1)
        if attrs.get("has_residual", False):
            out = out + self.rep(self.key(entry["residual"]))
        return [out], [None], []

    def embedding(self, node, attrs, ins):
        from ..ops.tensor import _gather_ids

        if self.wdim(ins[1]) != 0:
            return None
        w = self.values[self.key(ins[1])]
        n = w.shape[0]
        start = self.tp.model_rank * n
        ids = _gather_ids(self.rep(self.key(ins[0])).detach(),
                          attrs["input_dim"]) - start
        inside = (ids >= 0) & (ids < n)
        rows = w[ids.clamp(0, n - 1)]
        part = rows * inside.unsqueeze(-1).to(rows.dtype)
        return [C.reduce_from(part, self.tp.group)], [None], []

    def attention_split(self, attrs, ins):
        """``(q / k / v, local attributes)`` at this rank's heads when
        q, k and v arrive split on their last dim and the heads (and kv
        heads) divide the model axis; else None (the node runs on
        gathered inputs)."""
        keys = [self.key(e) for e in ins]
        sts = [self.states[k] for k in keys]
        heads = attrs.get("num_heads", 1)
        kv = attrs.get("num_kv_heads", 0)
        m = self.tp.model
        if m <= 1 or any(s is None or s != self.values[k].dim() - 1
                         for s, k in zip(sts, keys)) \
                or heads % m or (kv and kv % m):
            return None
        local = dict(attrs, num_heads=heads // m)
        if kv:
            local["num_kv_heads"] = kv // m
        return [self.values[k] for k in keys], local

    def attention(self, node, attrs, ins):
        if self.seq_factor > 1:
            return self._seq_attention(attrs, ins)
        got = self.attention_split(attrs, ins)
        if got is None:
            return None
        outs, _ = self._compute(node, got[1], got[0], [])
        return outs, [outs[0].dim() - 1], []

    def _seq_attention(self, attrs, ins):
        """Attention on this rank's sequence blocks of q, k and v: ring
        attention over the seq group (``MXNET_RING_ATTENTION``, the
        default), on the rank's heads under a model axis (ring x TP);
        else, and where the heads or kv-heads do not divide the model
        axis, K and V gathered over the seq group and the rank's queries
        attended at their global offsets (plain ``sdpa``)."""
        from .. import config as _config
        from ..ops.attention import PATH_TAKEN, sdpa
        from .ring import ring_attention

        tp = self.tp
        heads = attrs.get("num_heads", 1)
        kv_heads = attrs.get("num_kv_heads", 0) or heads
        causal = attrs.get("causal", False)
        scale = attrs.get("scale", 0.0) or None
        got = self.attention_split(attrs, ins)
        if got is not None:
            (q, k, v), local = got
            state = q.dim() - 1
        else:
            q, k, v = (self.rep(self.key(e)) for e in ins)
            local, state = attrs, None
        if _config.get("MXNET_RING_ATTENTION") and (tp.model <= 1
                                                    or got is not None):
            out = ring_attention(
                q, k, v, tp.seq_group, num_heads=heads, causal=causal,
                scale=scale, head_axis=tp.group if tp.model > 1 else None,
                num_kv_heads=kv_heads, plain=self.octx.plain)
            PATH_TAKEN["last"] = "ring"
            return [out], [state], []
        kf = C.seq_gather(k, 1, tp.seq_group)
        vf = C.seq_gather(v, 1, tp.seq_group)
        if causal:
            # keys past this rank's last query are masked for all of its
            # queries: drop them, and sdpa's causal diagonal (tk - tq)
            # lands on the global offset
            keep = (tp.seq_rank + 1) * q.shape[1]
            kf, vf = kf[:, :keep], vf[:, :keep]
        kvl = local.get("num_kv_heads", 0) or local.get("num_heads", 1)
        out = sdpa(q, kf, vf, num_heads=local.get("num_heads", 1),
                   causal=causal, scale=scale, num_kv_heads=kvl)
        PATH_TAKEN["last"] = "einsum"
        return [out], [state], []

    def loss_head(self, node, attrs, ins):
        """SoftmaxOutput / MakeLoss over a data group of more than one
        rank, or on rows split over the seq group: ``normalization``
        'batch' and 'valid' divide the gradient by the whole batch's rows
        and valid count (the reference's global batch), not by this
        rank's slice's."""
        norm = attrs.get("normalization", "null")
        ranks = self.tp.data * self.seq_factor
        if ranks <= 1 or norm not in ("batch", "valid"):
            return None
        group = self.tp.grad_group if self.seq_factor > 1 \
            else self.tp.data_group
        inputs = [self.rep(self.key(e)) for e in ins]
        if norm == "batch":
            total = float(inputs[0].shape[0] * ranks)
        else:
            count = _valid_count(node.op.name, attrs, inputs)
            total = max(float(C.all_reduce(count, group)), 1.0)
        local = dict(attrs, normalization="null",
                     grad_scale=attrs.get("grad_scale", 1.0) / total)
        outs, _ = self._compute(node, local, inputs, [])
        return outs, [None] * len(outs), []

    def moe(self, node, attrs, ins):
        """MoEFFN on an expert axis, or on rows split over a data axis
        (:mod:`~mxnet_tpu_torch.ops.moe`'s mesh paths): the sharded
        all-to-all over the expert group, or the reference's global
        semantics (one capacity quota over the whole batch, f and P
        averaged over it), never one computed from this rank's rows
        alone.  Under a seq axis the node runs gathered, as before."""
        from ..ops import moe as _moe

        tp = self.tp
        if tp.seq > 1 or (tp.expert <= 1 and not self.data_split):
            return None
        names = node.op.list_arguments(attrs)
        stacks = [self.params.get(self.key(e)) for e, n in zip(ins, names)
                  if n.startswith("expert")]
        mesh = _moe.MoEMesh(
            tp.mesh_axes(), split=("data",) if self.data_split else (),
            local=bool(stacks) and all(n in tp.expert_sharded
                                       for n in stacks))
        y = _moe.moe_ffn(attrs, *(self.rep(self.key(e)) for e in ins),
                         mesh=mesh)
        return [y], [None], []

    def pooling(self, node, attrs, ins):
        key = self.key(ins[0])
        cdim = 3 if attrs.get("layout") == "NHWC" else 1
        if self.states[key] != cdim:
            return None
        outs, _ = self._compute(node, attrs, [self.values[key]], [])
        return outs, [cdim], []

    def batchnorm(self, node, attrs, ins):
        key = self.key(ins[0])
        x = self.values[key]
        caxis = attrs.get("axis", 1) % x.dim() if x.dim() > 1 else 0
        aux_entries = node.inputs[len(ins):]
        local = self.states[key] == caxis and all(
            self.wdim(e) == 0 for e in list(ins[1:]) + list(aux_entries))
        pick = (lambda e: self.values[self.key(e)]) if local \
            else (lambda e: self.rep(self.key(e)))
        inputs = [pick(e) for e in ins]
        aux = [pick(e) for e in aux_entries]
        if self.tp.data > 1 and self.octx.is_train \
                and not attrs.get("use_global_stats", False):
            outs, new_aux = _sync_batchnorm(attrs, inputs, aux,
                                            self.tp.data,
                                            self.tp.data_group)
        else:
            outs, new_aux = self._compute(node, attrs, inputs, aux)
        if not local:
            new_aux = [self._aux_back(e, v)
                       for e, v in zip(aux_entries, new_aux)]
            return outs, [None] * len(outs), new_aux
        return outs, [caxis, 0, 0], new_aux


class _Alias:
    """The node of an entry that is a converted form of another."""

    __slots__ = ()


def _seq_view(shape, st, blocks=1):
    """``shape`` with ``st.dim`` as (outer, t x blocks), and the index of
    its inner axis."""
    outer = shape[st.dim] // (st.t * blocks)
    return (tuple(shape[:st.dim]) + (outer, st.t * blocks)
            + tuple(shape[st.dim + 1:])), st.dim + 1


def gather_seq(x, st, group):
    """``x`` (split over the seq ``group`` as ``st``) whole, its blocks in
    rank order (``collectives.gather_from``: differentiable)."""
    view, axis = _seq_view(x.shape, st)
    y = C.gather_from(x.reshape(view), axis, group)
    shape = list(x.shape)
    shape[st.dim] = -1
    return y.reshape(shape)


def slice_seq(x, st, n, rank, group=None):
    """This rank's block (split as ``st`` over ``n`` ranks) of the whole
    ``x``: a plain slice, or with ``group`` ``collectives.scatter_to``
    (the gradient all-gathered)."""
    view, axis = _seq_view(x.shape, st, n)
    y = x.reshape(view)
    y = y.narrow(axis, rank * st.t, st.t) if group is None \
        else C.scatter_to(y, axis, group)
    shape = list(x.shape)
    shape[st.dim] //= n
    return y.reshape(shape)


@functools.lru_cache(maxsize=None)
def _pointwise_ops():
    """The ops that act on each element alone (``ops/elemwise.py``'s
    families, ``ELEMENTWISE_OPS``, the element-wise loss heads)."""
    from ..ops import elemwise as ew

    names = set(ELEMENTWISE_OPS) | set(ew._UNARY) | {
        "_copy", "Cast", "_identity_with_attr_like_rhs", "smooth_l1",
        "add_n", "BlockGrad", "clip", "_grad_add", "MakeLoss",
        "LinearRegressionOutput", "LogisticRegressionOutput",
        "MAERegressionOutput"}
    for name in ew._BINARY:
        canon = {"plus": "add", "minus": "sub"}.get(name, name)
        names |= {"_" + name, "broadcast_" + canon, "_%s_scalar" % name}
        if name in ew._RSCALAR:
            names.add("_r%s_scalar" % name)
    for name in ew._LOGIC:
        names |= {"broadcast_" + name, "_%s_scalar" % name}
    return frozenset(names)


def _whole(vals, sts, first=1):
    """"bcast" for each input from ``first`` on, or None when one is
    split (the node then runs gathered)."""
    if any(st is not None for st in sts[first:]):
        return None
    return [None] * first + ["bcast"] * (len(vals) - first)


def _seq_pointwise(walk, node, attrs, vals, sts):
    """An element-wise node (operands broadcast numpy-style): the split
    inputs agree, a whole operand is broadcast along the split dim (size
    1 there, or no such dim) or carries every position there (cut to the
    rank's block)."""
    if node.op.name == "LeakyReLU" and len(vals) > 1:
        return None             # prelu's gamma broadcasts on dim 1
    n = walk.tp.seq
    ref = next(i for i, st in enumerate(sts) if st is not None)
    st, size = sts[ref], vals[ref].shape[sts[ref].dim]
    back = st.dim - vals[ref].dim()
    conv = []
    for v, s in zip(vals, sts):
        if s is not None:
            if s.dim - v.dim() != back or s.t != st.t \
                    or v.shape[s.dim] != size:
                return None
            conv.append(None)
            continue
        ad = v.dim() + back
        if ad < 0 or v.shape[ad] == 1:
            conv.append("bcast")
        elif v.shape[ad] == size * n:
            conv.append(("slice", SeqSplit(ad, st.t)))
        else:
            return None
    return conv, SeqSplit(back, st.t), None


def _seq_reduce(walk, node, attrs, vals, sts):
    """A reduction over dims other than the split one keeps the split; a
    reduction over it raises (each rank would reduce its block alone)."""
    from ..ops.tensor import _norm_axis

    x, st = vals[0], sts[0]
    axes = tuple(range(x.dim())) if node.op.name == "norm" \
        else _norm_axis(attrs, x.dim())
    if st.dim in axes:
        raise MXNetError(
            "%s (%s) reduces over the sequence dim %d of a value split over "
            "a seq axis of %d: each rank holds a block of the sequence, so "
            "the reduction would cover the block only.  Reduce over the "
            "other axes and let a loss head normalize, or train with seq=1"
            % (node.name, node.op.name, st.dim, walk.tp.seq))
    if attrs.get("keepdims", False):
        return [None], st, None
    return [None], SeqSplit(st.dim - sum(a < st.dim for a in axes),
                            st.t), None


def _seq_softmax(walk, node, attrs, vals, sts):
    x, st = vals[0], sts[0]
    if attrs.get("axis", -1) % x.dim() == st.dim:
        return None
    return [None], st, None


def _seq_fully_connected(walk, node, attrs, vals, sts):
    x, st = vals[0], sts[0]
    conv = _whole(vals, sts)
    rows = attrs.get("flatten", True) or x.dim() == 2
    if st is None or conv is None or (st.dim != 0 if rows
                                      else st.dim == x.dim() - 1):
        return None
    return conv, st, None


def _seq_fused_ln_linear(walk, node, attrs, vals, sts):
    from ..ops.fused_lm import _arg_names

    x, st = vals[0], sts[0]
    if st is None or st.dim == x.dim() - 1:
        return None
    conv = [None]
    for arg, v, s in list(zip(_arg_names(attrs), vals, sts))[1:]:
        if arg != "residual":
            if s is not None:
                return None
            conv.append("bcast")
        elif s is not None:
            if s != st or v.shape[s.dim] != x.shape[st.dim]:
                return None
            conv.append(None)
        elif v.shape[st.dim] == x.shape[st.dim] * walk.tp.seq:
            conv.append(("slice", st))
        else:
            return None
    return conv, st, None


def _seq_embedding(walk, node, attrs, vals, sts):
    conv = _whole(vals, sts)
    if sts[0] is None or conv is None:
        return None
    return conv, sts[0], None


def _seq_reshape(walk, node, attrs, vals, sts):
    """A Reshape that merges the leading (N, T) dims of a value split on
    T (the LM head's ``shape=(-1, embed)`` and its labels' ``(-1,)``):
    the rows stay split as (N, t), the local target shape spelled out.
    Any other reshape runs gathered."""
    from ..ops.tensor import _infer_reshape

    x, st = vals[0], sts[0]
    if st.dim != 1 or x.shape[1] != st.t:
        return None
    g_in = (x.shape[0], x.shape[1] * walk.tp.seq) + tuple(x.shape[2:])
    target = attrs.get("shape", ()) or attrs.get("target_shape", ())
    g_out = tuple(_infer_reshape(tuple(target), g_in,
                                 attrs.get("reverse", False)))
    if g_out != (g_in[0] * g_in[1],) + g_in[2:]:
        return None
    local = (x.shape[0] * x.shape[1],) + tuple(x.shape[2:])
    return [None], SeqSplit(0, st.t), dict(attrs, shape=local,
                                           reverse=False, target_shape=())


def _seq_softmax_output(walk, node, attrs, vals, sts):
    """SoftmaxOutput on rows split over the seq group, its labels split
    alike (or whole, cut here)."""
    (d, label), (sd, sl) = vals, sts
    if attrs.get("multi_output", False) or attrs.get("preserve_shape",
                                                     False) \
            or d.dim() != 2 or sd is None or sd.dim != 0:
        return None
    if sl is not None:
        if sl.dim != 0 or sl.t != sd.t \
                or label.shape[0] != d.shape[0]:
            return None
        return [None, None], sd, None
    if label.shape[0] != d.shape[0] * walk.tp.seq:
        return None
    return [None, ("slice", SeqSplit(0, sd.t))], sd, None


def _seq_dot_product_attention(walk, node, attrs, vals, sts):
    """q, k and v split alike on their T dim: the ring (or the gathered
    path) in :meth:`GraphWalk._seq_attention`."""
    q, st = vals[0], sts[0]
    if q.dim() != 3 or st is None or st.dim != 1 \
            or q.shape[1] != st.t or any(s != st for s in sts) \
            or any(v.shape[1] != q.shape[1] for v in vals):
        return None
    return [None, None, None], st, None


_SEQ_RULES = {
    "FullyConnected": _seq_fully_connected,
    "FusedLNLinear": _seq_fused_ln_linear,
    "Embedding": _seq_embedding,
    "Reshape": _seq_reshape,
    "softmax": _seq_softmax,
    "log_softmax": _seq_softmax,
    "SoftmaxOutput": _seq_softmax_output,
    "dot_product_attention": _seq_dot_product_attention,
}
_SEQ_RULES.update({name: _seq_reduce for name in (
    "sum", "mean", "prod", "nansum", "nanprod", "max", "min", "norm")})


_HANDLERS = {
    "FullyConnected": GraphWalk.fully_connected,
    "Convolution": GraphWalk.convolution,
    "FusedLNLinear": GraphWalk.fused_ln_linear,
    "Embedding": GraphWalk.embedding,
    "dot_product_attention": GraphWalk.attention,
    "Pooling": GraphWalk.pooling,
    "BatchNorm": GraphWalk.batchnorm,
    "SoftmaxOutput": GraphWalk.loss_head,
    "MakeLoss": GraphWalk.loss_head,
    "MoEFFN": GraphWalk.moe,
}


_BATCH_REDUCTIONS = frozenset(("sum", "mean", "prod", "nansum", "nanprod",
                               "max", "min", "norm"))


def _refuse_batch_reduction(node, attrs, walk, data):
    """MXNetError for a reduction over dim 0 of a value the batch
    reaches, under a data axis of ``data`` ranks: each would reduce its
    slice alone, where the reference reduces the whole batch."""
    from ..ops.tensor import _norm_axis

    if node.op.name not in _BATCH_REDUCTIONS:
        return
    x = walk.values[walk.key(node.inputs[0])]
    if node.op.name != "norm" and 0 not in _norm_axis(attrs, x.dim()):
        return
    raise MXNetError(
        "%s (%s) reduces over dim 0 of a value the batch reaches; under a "
        "data axis of %d each rank holds a slice of the batch, so the "
        "reduction would cover the slice only.  Reduce over the other "
        "axes and let a loss head normalize (SoftmaxOutput / MakeLoss "
        "normalization='batch' or 'valid'), or train with data=1"
        % (node.name, node.op.name, data))


def _valid_count(op, attrs, inputs):
    """The count a loss head's 'valid' normalization divides by, on this
    rank's slice (f64, one element)."""
    if op == "MakeLoss":
        valid = inputs[0] > attrs.get("valid_thresh", 0.0)
    elif attrs.get("use_ignore", False):
        valid = inputs[1] != attrs.get("ignore_label", -1.0)
    else:
        valid = torch.ones_like(inputs[1], dtype=torch.bool)
    return valid.sum().to(torch.float64).reshape(1)


def _sync_batchnorm(attrs, inputs, aux, ranks, group):
    """Training BatchNorm with the batch statistics of all ``ranks`` of
    the data group (equal slices of the batch): the sums of x and of the
    squared deviations all-reduced, their gradients too."""
    x, gamma, beta = inputs
    moving_mean, moving_var = aux
    eps = attrs.get("eps", 1e-3)
    momentum = attrs.get("momentum", 0.9)
    caxis = attrs.get("axis", 1) % x.dim() if x.dim() > 1 else 0
    if attrs.get("fix_gamma", True):
        gamma = torch.ones_like(gamma)
    red = tuple(i for i in range(x.dim()) if i != caxis)
    bshape = tuple(x.shape[caxis] if i == caxis else 1
                   for i in range(x.dim()))
    x32 = x.float()
    count = float(x32.numel() // x.shape[caxis] * ranks)
    mean = C.sum_over(x32.sum(dim=red), group) / count
    xmu = x32 - mean.reshape(bshape)
    var = C.sum_over(xmu.square().sum(dim=red), group) / count
    inv = torch.rsqrt(var + eps)
    out = (xmu * inv.reshape(bshape) * gamma.float().reshape(bshape)
           + beta.float().reshape(bshape)).to(x.dtype)
    new_mm = momentum * moving_mean + (1 - momentum) * mean.detach()
    new_mv = momentum * moving_var + (1 - momentum) * var.detach()
    return [out, mean, var], [new_mm, new_mv]

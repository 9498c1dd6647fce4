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
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import collectives as C
from .tp_rules import ELEMENTWISE_OPS, plan_tensor_parallel

__all__ = ["TensorParallel", "GraphWalk", "param_mesh_axes"]


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
    where BatchNorm's statistics are summed.  ``shapes`` maps every
    parameter and aux state to its GLOBAL shape; ``mode`` is
    "megatron" or "naive"."""

    def __init__(self, symbol, shapes, model, model_rank, model_group,
                 data=1, data_group=None, mode="megatron",
                 mesh_shape=None):
        if mode not in ("megatron", "naive"):
            raise MXNetError("MXNET_TP_MODE must be 'megatron' or 'naive', "
                             "not %r" % (mode,))
        self.model = int(model)
        self.model_rank = int(model_rank)
        self.group = model_group
        self.data = int(data)
        self.data_group = data_group
        self.mode = mode
        self.mesh_shape = dict(mesh_shape or {"model": self.model})
        self.plan = plan_tensor_parallel(symbol) if mode == "megatron" \
            else None
        self.coverage = {}
        self.sharded = {}           # name -> the dim split over the group
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
        rec["source"] = "naive"
        rec["spec"] = ["model"] + [None] * (len(shape) - 1)
        return 0

    def local_shape(self, name, shape):
        """This rank's shape of ``name`` (global ``shape``)."""
        dim = self.sharded.get(name)
        if dim is None:
            return tuple(shape)
        shape = list(shape)
        shape[dim] //= self.model
        return tuple(shape)

    def shard(self, name, full):
        """This rank's block of the full tensor ``full`` of ``name``."""
        dim = self.sharded.get(name)
        if dim is None:
            return full
        n = full.shape[dim] // self.model
        return full.narrow(dim, self.model_rank * n, n)

    def unshard(self, name, local):
        """The full tensor of ``name`` from every rank's ``local`` block
        (a collective over the model group: every rank calls it)."""
        dim = self.sharded.get(name)
        if dim is None:
            return local
        return C.all_gather(local, dim, self.group)

    def coverage_record(self):
        """The ``meta['sharding_coverage']`` the sharding-coverage pass
        reads: the mesh shape and a record a parameter."""
        return {"mesh": dict(self.mesh_shape),
                "leaves": {n: dict(r) for n, r in self.coverage.items()}}

    # ------------------------------------------------------------------
    # the walk
    # ------------------------------------------------------------------
    def walk(self, octx):
        """A fresh :class:`GraphWalk` over this rank's shards."""
        return GraphWalk(self, octx)

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
                walk.put((id(node), 0), src[node.name],
                         self.sharded.get(node.name), param=node.name)
                if node.name not in self.coverage:
                    walk.batched.add((id(node), 0))
                continue
            attrs = node.parsed_attrs()
            batched = any(walk.key(e) in walk.batched for e in node.inputs)
            if batched and self.data > 1:
                _refuse_batch_reduction(node, attrs, walk, self.data)
            outs, states, node_aux = walk.node(node, attrs)
            for i, (o, st) in enumerate(zip(outs, states)):
                walk.put((id(node), i), o, st)
                if batched:
                    walk.batched.add((id(node), i))
            if tap is not None:
                names = node.op.list_outputs(attrs)
                for i in range(node.op.n_visible_outputs(attrs)):
                    tap("%s_%s" % (node.name, names[i] if i < len(names)
                                   else i), outs[i])
            n_args = node.op.n_inputs(attrs)
            for (anode, _), val in zip(node.inputs[n_args:], node_aux):
                new_aux[anode.name] = val
        outs = [walk.rep((id(n), i)) for n, i in symbol._outputs]
        return outs, new_aux


class GraphWalk:
    """The values and split dims of one run of the walk, with each
    conversion made once an entry (so q, k and v share one *f* of their
    input, and its backward all-reduces their summed gradient once).
    :meth:`put` enters a value, :meth:`node` runs a node and returns its
    outputs with their split dims, :meth:`rep` reads a value
    replicated."""

    def __init__(self, tp, octx):
        self.tp = tp
        self.octx = octx
        self.values = {}
        self.states = {}
        self.params = {}
        self.cache = {}
        self.batched = set()        # the entries the batch reaches

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
    def node(self, node, attrs):
        name = node.op.name
        n_args = node.op.n_inputs(attrs)
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
        got = self.attention_split(attrs, ins)
        if got is None:
            return None
        outs, _ = self._compute(node, got[1], got[0], [])
        return outs, [outs[0].dim() - 1], []

    def loss_head(self, node, attrs, ins):
        """SoftmaxOutput / MakeLoss over a data group of more than one
        rank: ``normalization`` 'batch' and 'valid' divide the gradient
        by the whole batch's rows and valid count (the reference's
        global batch), not by this rank's slice's."""
        norm = attrs.get("normalization", "null")
        if self.tp.data <= 1 or norm not in ("batch", "valid"):
            return None
        inputs = [self.rep(self.key(e)) for e in ins]
        if norm == "batch":
            total = float(inputs[0].shape[0] * self.tp.data)
        else:
            count = _valid_count(node.op.name, attrs, inputs)
            total = max(float(C.all_reduce(count, self.tp.data_group)), 1.0)
        local = dict(attrs, normalization="null",
                     grad_scale=attrs.get("grad_scale", 1.0) / total)
        outs, _ = self._compute(node, local, inputs, [])
        return outs, [None] * len(outs), []

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

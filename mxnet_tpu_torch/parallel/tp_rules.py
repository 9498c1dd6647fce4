"""Megatron-style tensor-parallel planning over the 'model' mesh axis
(the counterpart of ``mxnet_tpu/parallel/tp_rules.py``).

One topological walk tracks whether each activation is feature-sharded
('feat': its last / channel dim split over 'model') or replicated
('rep'), and gives each FullyConnected / Convolution weight a column or
row role:

    input 'rep'  -> column parallel: W[out_dim] on 'model', bias sharded,
                    output becomes 'feat'          (no collective)
    input 'feat' -> row parallel: W[in_dim] on 'model', bias replicated,
                    output 'rep'                   (one all-reduce)

Elementwise ops (Activation, Dropout, Cast, adds) keep 'feat';
BatchNorm on a 'feat' activation shards its per-channel parameters and
aux states the same way; Pooling keeps the channel split; Embedding is
vocab-parallel with a replicated output; attention over feature-sharded
q / k / v stays 'feat'; any other op resets to 'rep'.

The result is a ``{param_name: axes tuple}`` plan.  These are pure
functions of the symbol or of a mesh shape, equal key by key to the
reference's; the pspec helpers return plain tuples where the reference
returns ``PartitionSpec`` (a tuple subclass with the same items).  The
plan is realized by :mod:`~mxnet_tpu_torch.parallel.tp_exec`: the
port inserts the collectives itself where the reference's partitioner
does.
"""
from __future__ import annotations

import warnings

__all__ = ["plan_tensor_parallel", "kv_cache_pspec", "kv_pool_pspec",
           "ELEMENTWISE_OPS"]

# ops through which a feature-sharded activation stays feature-sharded
# (their compute is pointwise over the sharded dim, or reduces other dims)
ELEMENTWISE_OPS = {
    "Activation", "LeakyReLU", "Dropout", "Cast", "relu", "sigmoid", "tanh",
    "exp", "log", "negative", "abs", "_plus", "_minus", "_mul", "_div",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "_plus_scalar", "_minus_scalar", "_mul_scalar", "_div_scalar",
    "_maximum", "_minimum", "clip", "identity", "BlockGrad", "stop_gradient",
}


def _fused_arg_names(attrs):
    """FusedLNLinear's argument list (``ops.fused_lm._arg_names``)."""
    from ..ops.fused_lm import _arg_names

    return _arg_names(attrs)


def _kv_head_axis(sizes, head_axis, num_kv_heads, what, degrades=None):
    """The trailing-dim mesh axis for a K/V cache or pool, kv-head aware.

    MHA (``num_kv_heads`` None/0) keeps the unconditional E-split.  A
    grouped layout's trailing dim is H_kv head slices, so the split is
    legal only when ``num_kv_heads % axis_size == 0``; otherwise it
    degrades visibly to replicated-group sharding with a warning, and
    ``degrades`` (a list) receives ``{"site", "reason"}``.
    """
    size = sizes.get(head_axis, 1)
    if size <= 1:
        return None
    if num_kv_heads:
        kvh = int(num_kv_heads)
        if kvh % size:
            warnings.warn(
                "%s: num_kv_heads=%d not divisible by %r axis size %d — "
                "degrading to replicated-group sharding (each model shard "
                "holds the full grouped K/V)" % (what, kvh, head_axis,
                                                 size))
            if degrades is not None:
                degrades.append({
                    "site": what,
                    "reason": "num_kv_heads=%d %% %s=%d != 0"
                    % (kvh, head_axis, size)})
            return None
    return head_axis


def kv_cache_pspec(mesh_shape, batch_axis="data", head_axis="model",
                   num_kv_heads=None, degrades=None):
    """Axes of a (B, C, E_kv) decode KV cache on a mesh: the batch dim on
    ``batch_axis``, the ring-slot dim replicated, the trailing E dim on
    ``head_axis`` (an E-split is a head-group split).  Axes of size 1
    drop out; ``num_kv_heads`` gates the trailing split as
    :func:`_kv_head_axis` says."""
    sizes = dict(mesh_shape)
    return (batch_axis if sizes.get(batch_axis, 1) > 1 else None, None,
            _kv_head_axis(sizes, head_axis, num_kv_heads,
                          "kv_cache_pspec", degrades=degrades))


def kv_pool_pspec(mesh_shape, head_axis="model", num_kv_heads=None,
                  degrades=None):
    """Axes of a (P, page_tokens, E_kv) paged KV pool on a mesh: pages
    and tokens replicated (page ids are one global space), the trailing
    E dim on ``head_axis``.  ``num_kv_heads`` behaves as in
    :func:`kv_cache_pspec`."""
    sizes = dict(mesh_shape)
    return (None, None,
            _kv_head_axis(sizes, head_axis, num_kv_heads,
                          "kv_pool_pspec", degrades=degrades))


def plan_tensor_parallel(symbol):
    """One topological walk -> ``{param_name: axes tuple}``.

    Tuples name the mesh axis 'model' (``('model', None)`` for a
    column-parallel FC weight); parameters absent from the plan
    replicate.  Divisibility is the consumer's to check, parameter by
    parameter: an unshardable member of a pair replicates, and the
    realization re-derives the states after it.
    """
    plan = {}
    state = {}  # (id(node), out_idx) -> 'rep' | 'feat'

    def instate(entry):
        return state.get((id(entry[0]), entry[1]), "rep")

    for node in symbol._topo():
        if node.is_variable:
            state[(id(node), 0)] = "rep"
            continue
        attrs = node.parsed_attrs()
        n_args = node.op.n_inputs(attrs)
        ins = node.inputs[:n_args]
        aux_ins = node.inputs[n_args:]
        name = node.op.name
        out_state = "rep"

        if name == "FullyConnected":
            data_st = instate(ins[0])
            wnode = ins[1][0]
            bnode = ins[2][0] if len(ins) > 2 else None
            if wnode.is_variable:
                if data_st == "feat":
                    plan[wnode.name] = (None, "model")
                    out_state = "rep"
                else:
                    plan[wnode.name] = ("model", None)
                    if bnode is not None and bnode.is_variable:
                        plan[bnode.name] = ("model",)
                    out_state = "feat"
        elif name == "FusedLNLinear":
            # gamma / beta are per-INPUT-feature and only valid
            # replicated, so the row role is taken only by no_affine
            # segments
            args = _fused_arg_names(attrs)
            data_st = instate(ins[0])
            wnode = ins[args.index("weight")][0]
            bnode = ins[args.index("bias")][0]
            if wnode.is_variable:
                if data_st == "feat" and attrs.get("no_affine", False):
                    plan[wnode.name] = (None, "model")
                    out_state = "rep"
                else:
                    plan[wnode.name] = ("model", None)
                    if bnode.is_variable:
                        plan[bnode.name] = ("model",)
                    out_state = "feat"
        elif name == "Convolution":
            data_st = instate(ins[0])
            wnode = ins[1][0]
            bnode = ins[2][0] if len(ins) > 2 else None
            if wnode.is_variable and attrs.get("num_group", 1) == 1:
                if data_st == "feat":
                    plan[wnode.name] = (None, "model", None, None)
                    out_state = "rep"
                else:
                    plan[wnode.name] = ("model", None, None, None)
                    if bnode is not None and bnode.is_variable:
                        plan[bnode.name] = ("model",)
                    out_state = "feat"
        elif name == "BatchNorm":
            data_st = instate(ins[0])
            if data_st == "feat":
                for pnode, _ in ins[1:]:
                    if pnode.is_variable:
                        plan[pnode.name] = ("model",)
                for anode, _ in aux_ins:
                    plan[anode.name] = ("model",)
                out_state = "feat"
        elif name == "Pooling":
            # pooling reduces spatial dims only: the channel split stays
            out_state = instate(ins[0])
        elif name == "Embedding":
            # vocab-parallel: a masked local lookup and one all-reduce,
            # and a REPLICATED output, so q/k/v start column-parallel
            wnode = ins[1][0]
            if wnode.is_variable:
                plan[wnode.name] = ("model", None)
                out_state = "rep"
        elif name == "dot_product_attention":
            # q / k / v all feature-sharded: each rank attends over its
            # head group, and the out-projection becomes row-parallel
            sts = [instate(e) for e in ins]
            out_state = "feat" if sts and all(s == "feat" for s in sts) \
                else "rep"
        elif name in ELEMENTWISE_OPS:
            sts = [instate(e) for e in ins]
            out_state = "feat" if sts and all(s == "feat" for s in sts) \
                else "rep"

        for i in range(node.op.n_outputs(attrs)):
            state[(id(node), i)] = out_state
    return plan

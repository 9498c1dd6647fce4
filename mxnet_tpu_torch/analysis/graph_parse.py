"""Static parsing of traced FX graphs — the counterpart of
``mxnet_tpu/analysis/hlo_parse.py``.

The reference reads lowered StableHLO and compiled HLO text; the port's
programs are traced (``torch.export`` or ``make_fx``, see
:mod:`.artifact`) into ``torch.fx`` graphs of ATen operators and the
kernels' operators, and every quantity is read from the graph's nodes
and the fake values they carry (``node.meta["val"]``):

* FLOP accounting — :func:`parse_graph`'s ``dots``: each dot-like node
  with its FLOPs (2·M·N·K for ``mm`` / ``addmm`` / ``bmm`` / ``linear``
  / ``matmul``, 4·B·H·Tq·Tk·hd for ``scaled_dot_product_attention``,
  2·out·(C_in/groups)·kernel for convolutions, and the kernels'
  operators by their own formulas, :data:`KERNEL_FLOPS`: the formulas
  ``obs/roofline.py`` uses), and ``uncounted_ops``, the dot-like nodes
  no formula models;
* byte accounting — materialized gather and sort / scatter results (2x
  their bytes, the reference's rule; a scatter written in place into a
  program input is that input's update, not an intermediate),
  collective nodes (``_c10d_functional.*`` / ``c10d.*``) with their
  result bytes, and the bytes of the program's inputs and outputs by
  dtype;
* program metadata — the program inputs written in place (schema
  ``(a!)`` arguments and in-place ATen ops, followed back through views
  to the placeholders: the counterpart of compiled HLO's
  ``input_output_alias``), and host transfers (``.item()``, copies to
  the CPU, data-dependent shapes).

Higher-order operators that wrap a subgraph (``torch.export`` puts
``no_grad`` regions in ``wrap_with_set_grad_enabled``) are walked
through, their placeholders mapped onto the operands.
"""
from __future__ import annotations

import operator
import re

import torch

__all__ = ["DTYPE_BITS", "KERNEL_FLOPS", "dtype_bits", "parse_graph",
           "value_bytes"]

# bits per element of each torch dtype the byte accounting knows; a
# dtype missing here is reported, never silently sized
DTYPE_BITS = {
    "float64": 64, "float32": 32, "float16": 16, "bfloat16": 16,
    "float8_e4m3fn": 8, "float8_e5m2": 8, "float8_e4m3fnuz": 8,
    "float8_e5m2fnuz": 8, "float8_e8m0fnu": 8, "float4_e2m1fn_x2": 8,
    "int64": 64, "int32": 32, "int16": 16, "int8": 8,
    "uint64": 64, "uint32": 32, "uint16": 16, "uint8": 8,
    "bool": 8, "complex32": 32, "complex64": 64, "complex128": 128,
}

# matmul-like ATen ops the counter models (by overload packet name)
_MATMUL = ("mm", "addmm", "bmm", "baddbmm", "addbmm", "matmul", "linear",
           "mv", "addmv", "dot", "vdot", "outer", "ger")
_CONV = ("convolution", "_convolution", "conv1d", "conv2d", "conv3d",
         "conv_transpose1d", "conv_transpose2d", "conv_transpose3d",
         "cudnn_convolution", "convolution_backward")
_SDPA = ("scaled_dot_product_attention",
         "_scaled_dot_product_efficient_attention",
         "_scaled_dot_product_flash_attention",
         "_scaled_dot_product_cudnn_attention",
         "_scaled_dot_product_flash_attention_for_cpu")
_SDPA_BWD = tuple(n + "_backward" for n in _SDPA[1:])
# dot-like op names: one of them that no formula models is an uncounted
# op (``_scaled_mm``, ``_int_mm``, ``bilinear``, ``tensordot``, ...)
_DOT_LIKE = re.compile(r"(mm|matmul|einsum|tensordot|dot|bilinear|"
                       r"trilinear|convolution|conv[123]d|"
                       r"conv_transpose[123]d|attention|mm_activation|"
                       r"multi_dot|addr)(_backward)?$")
# materialized gathers (indexed reads) and sorts / scatters
_GATHER = ("embedding", "index_select", "gather", "index", "take",
           "take_along_dim")
_SORT = ("sort", "argsort", "topk")
_SCATTER = ("scatter", "scatter_add", "scatter_reduce", "index_put",
            "index_add", "index_copy", "masked_scatter", "index_fill")
# collectives: functional (traceable) and the process-group ops, in the
# reference's (compiled-HLO) spelling
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast": "collective-broadcast",
    "broadcast_": "collective-broadcast", "send": "collective-permute",
    "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")


def _prod(dims):
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _shape(x):
    v = x.meta.get("val") if isinstance(x, torch.fx.Node) else x
    return tuple(int(d) for d in v.shape) if isinstance(v, torch.Tensor) \
        else None


def _fused_fwd_flops(args, out):
    x, w = args[0], args[3]
    m, k = _shape(x)
    return 2 * m * k * int(_shape(w)[0])


def _fused_bwd_flops(args, out):
    # dx (M, N) x (N, K) and dW (N, M) x (M, K)
    x, w = args[0], args[4]
    m, k = _shape(x)
    return 4 * m * k * int(_shape(w)[0])


def _flash_flops(args, out):
    # q (B*H, T, hd) against T keys: QK^T and PV (forward), dP and dQ
    # (kernel D), dV and dK (kernel E): 4·rows·keys·hd each
    bh, t, hd = _shape(args[0])
    keys = _shape(args[1])[1]
    return 4 * bh * t * keys * hd


def _paged_decode_flops(args, out):
    # q (B, tq, H·hd) against the tables' capacity (pages x page tokens)
    q, k_data, table = args[0], args[1], args[5]
    b, tq, e = _shape(q)
    return 4 * b * tq * e * _shape(table)[1] * _shape(k_data)[1]


# the kernels' operators (mxnet_tpu_torch::<name>): FLOPs from their
# argument shapes — obs/roofline.py's formulas (2·M·K·N a product,
# 4·rows·keys·hd an attention; a backward counts its two products)
KERNEL_FLOPS = {
    "fused_fwd": _fused_fwd_flops,
    "fused_bwd": _fused_bwd_flops,
    "flash_fwd": _flash_flops,
    "flash_bwd_dq": _flash_flops,
    "flash_bwd_dkv": _flash_flops,
    "paged_decode": _paged_decode_flops,
    "multi_tensor_update": None,      # element-wise: no dot
}


def dtype_bits(dtype):
    """Bits of one element of a torch dtype, or None when the width
    table lacks it."""
    return DTYPE_BITS.get(str(dtype).replace("torch.", ""))


def value_bytes(val, unknown=None):
    """Bytes of a tensor value (or nested tuples / lists of them); a
    dtype missing from the table adds its name to ``unknown``."""
    if isinstance(val, (tuple, list)):
        return sum(value_bytes(v, unknown) for v in val)
    if not isinstance(val, torch.Tensor):
        return 0
    bits = dtype_bits(val.dtype)
    if bits is None:
        if unknown is not None:
            unknown.add(str(val.dtype).replace("torch.", ""))
        return 0
    return (_prod(val.shape) * bits + 7) // 8


def _op_names(target):
    """(namespace, name) of an operator target."""
    if isinstance(target, torch._ops.OpOverload):
        return target.namespace, target._schema.name.split("::")[-1]
    if isinstance(target, torch._ops.HigherOrderOperator):
        return "higher_order", target.name()
    return None, getattr(target, "__name__", str(target))


def _base(name):
    """``add_`` -> ``add``; ``index_put_`` -> ``index_put``."""
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _matmul_flops(name, args, out_shape):
    shapes = [_shape(a) for a in args if isinstance(a, torch.fx.Node)]
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        shapes = shapes[1:]
    if name == "linear":
        x, w = shapes[0], shapes[1]
        return 2 * _prod(x) * int(w[0]) if w else None
    if len(shapes) < 2 or shapes[0] is None or shapes[1] is None:
        return None
    a = shapes[0]
    k = a[-1] if a else 1
    if out_shape is None:
        return None
    if name == "addbmm":
        # sum over the batch of (n, k) x (k, m)
        return 2 * int(a[0]) * _prod(out_shape) * k
    return 2 * _prod(out_shape) * k


def _conv_flops(name, node, args):
    if name == "convolution_backward":
        # (grad_out, input, weight, ..., output_mask): each of the two
        # products the mask asks for costs one forward
        grad_out, w = _shape(args[0]), _shape(args[2])
        mask = args[-1] if isinstance(args[-1], (list, tuple)) \
            else (True, True, False)
        per = 2 * _prod(grad_out) * _prod(w[1:])
        return per * (int(bool(mask[0])) + int(bool(mask[1])))
    x, w = _shape(args[0]), _shape(args[1])
    out = _shape(node)
    if w is None or out is None:
        return None
    transposed = "transpose" in name or (
        name in ("convolution", "_convolution") and len(node.args) > 6
        and bool(node.args[6]))
    if transposed:
        # each input element meets every (C_out/groups x kernel) weight
        return 2 * _prod(x) * _prod(w[1:])
    return 2 * _prod(out) * _prod(w[1:])


def _einsum_flops(args):
    """2 x the product of every index's size for a two-operand einsum
    (each output element sums the products over the contracted
    indices); None for any other operand count."""
    eq, ops = args[0], args[1]
    if not isinstance(eq, str) or not isinstance(ops, (list, tuple)) \
            or len(ops) != 2:
        return None
    lhs = eq.replace(" ", "").split("->")[0].split(",")
    sizes = {}
    for spec, op in zip(lhs, ops):
        shape = _shape(op)
        if shape is None:
            return None
        if "..." in spec:
            head, tail = spec.split("...")
            n = len(shape) - len(head) - len(tail)
            spec = head + "".join(chr(0x100 + i) for i in range(n)) + tail
        if len(spec) != len(shape):
            return None
        for c, d in zip(spec, shape):
            sizes[c] = max(sizes.get(c, 1), int(d))
    return 2 * _prod(sizes.values())


def _sdpa_flops(args):
    q, k = _shape(args[0]), _shape(args[1])
    if q is None or k is None:
        return None
    return 4 * _prod(q[:-1]) * int(k[-2]) * int(q[-1])


def _origins(node, env):
    """The placeholder names ``node`` may alias (through views, detach and
    the aliased outputs of list-returning views), mapped through the
    subgraphs' operands by ``env``."""
    seen = set()
    out = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if not isinstance(n, torch.fx.Node) or n in seen:
            continue
        seen.add(n)
        if n in env:
            stack.extend(env[n])
            continue
        if n.op == "placeholder":
            out.add(n.name)
            continue
        if n.op != "call_function":
            continue
        if n.target is operator.getitem:
            stack.append(n.args[0])
            continue
        target = n.target
        if not isinstance(target, torch._ops.OpOverload):
            continue
        rets = target._schema.returns
        ainfo = rets[0].alias_info if rets else None
        if ainfo is None:
            continue
        sets = set(ainfo.before_set)
        for arg, a in zip(target._schema.arguments, n.args):
            if a is not None and arg.alias_info is not None \
                    and sets & set(arg.alias_info.before_set):
                stack.extend(a if isinstance(a, (list, tuple)) else [a])
    return out


def _subgraph_call(node, owner):
    """``(graph_module, operands)`` of a higher-order operator node that
    runs a subgraph on its operands, else None."""
    for i, a in enumerate(node.args):
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            sub = getattr(owner, a.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                return sub, list(node.args[i + 1:])
    return None


def _nodes(gm, env=None):
    """Every computing node of ``gm``'s graph with the alias map it is
    read under, subgraphs walked through in place of their HOP node."""
    env = {} if env is None else env
    for node in gm.graph.nodes:
        if node.op == "call_function" and \
                isinstance(node.target, torch._ops.HigherOrderOperator):
            sub = _subgraph_call(node, gm)
            if sub is not None:
                sub_gm, operands = sub
                inner = dict(env)
                phs = [n for n in sub_gm.graph.nodes
                       if n.op == "placeholder"]
                for ph, a in zip(phs, operands):
                    if isinstance(a, torch.fx.Node):
                        inner[ph] = [a]
                yield from _nodes(sub_gm, inner)
                continue
        yield node, env


def _device_of(val):
    if isinstance(val, (tuple, list)):
        for v in val:
            d = _device_of(v)
            if d is not None:
                return d
        return None
    return val.device if isinstance(val, torch.Tensor) else None


def parse_graph(gm, mutated_inputs=()):
    """One pass over a traced program's graph (``gm`` a
    ``torch.fx.GraphModule``).  ``mutated_inputs``: placeholder names the
    tracer reports written besides the graph's own in-place nodes (an
    exported program's signature).  Returns::

        {"flops": int, "dots": [{"op", "dtype", "flops", "line"}],
         "uncounted_ops": [{"op", "count"}],
         "gather": {"count", "bytes"}, "sort_scatter": {op: {"count",
         "bytes"}, "total": ...}, "collectives": {op: {"count", "bytes"},
         "total": ...}, "host_transfers": [{"op", "count"}],
         "written_inputs": [placeholder names], "inputs": [names],
         "bytes_by_dtype": {dtype: bytes}, "unknown_dtypes": [...],
         "io_bytes": int, "kernel_ops": {name: count}}
    """
    dots, uncounted, host = [], {}, {}
    gather = {"count": 0, "bytes": 0}
    sortsc, coll, kernels = {}, {}, {}
    written = set(mutated_inputs)
    unknown = set()

    def note(table, key, nbytes):
        e = table.setdefault(key, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += int(nbytes)

    inputs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, env in _nodes(gm):
        if node.op != "call_function":
            continue
        ns, name = _op_names(node.target)
        val = node.meta.get("val")
        out_shape = _shape(node)
        args = list(node.args)
        line = node.format_node() or str(node)
        # in-place writes, followed back to the program's inputs
        if isinstance(node.target, torch._ops.OpOverload):
            schema = node.target._schema.arguments
            given = list(zip(schema, args)) + [
                (s, node.kwargs[s.name]) for s in schema
                if s.name in node.kwargs]
            for arg, a in given:
                if arg.alias_info is not None and arg.alias_info.is_write:
                    for x in (a if isinstance(a, (list, tuple)) else [a]):
                        written |= _origins(x, env)
        if ns == "mxnet_tpu_torch":
            kernels[name] = kernels.get(name, 0) + 1
            if name in KERNEL_FLOPS:
                fn = KERNEL_FLOPS[name]
                if fn is not None:
                    flops = fn(args, val)
                    dots.append({"op": "mxnet_tpu_torch." + name,
                                 "dtype": str(_shape_dtype(args[0])),
                                 "flops": int(flops), "line": line})
            else:
                uncounted[ns + "." + name] = \
                    uncounted.get(ns + "." + name, 0) + 1
            continue
        if ns in _COLLECTIVE_NS:
            op = _COLLECTIVES.get(name)
            if op is not None:
                note(coll, op, value_bytes(val))
            continue
        if ns != "aten":
            continue
        base = _base(name)
        if name in ("_local_scalar_dense", "item"):
            host["item"] = host.get("item", 0) + 1
            continue
        if name in ("nonzero", "masked_select", "unique", "_unique2",
                    "unique_consecutive"):
            host[name] = host.get(name, 0) + 1
        if base == "copy":
            # copy(self, src) / copy_(self, src): from src into self
            dst, src = (_device_of(a.meta.get("val")) for a in args[:2])
        elif name in ("_to_copy", "to", "_copy_from"):
            src, dst = _device_of(args[0].meta.get("val")), _device_of(val)
        else:
            src = dst = None
        if src is not None and dst is not None and src.type != "cpu" \
                and dst.type == "cpu":
            host["d2h-copy"] = host.get("d2h-copy", 0) + 1
        flops = None
        if base in _MATMUL:
            flops = _matmul_flops(base, args, out_shape)
        elif base in _CONV:
            flops = _conv_flops(base, node, args)
        elif base in _SDPA:
            flops = _sdpa_flops(args)
        elif base in _SDPA_BWD:
            # dQ, dK, dV and dP from (grad_out, q, k, v, ...): twice the
            # forward's products
            flops = _sdpa_flops(args[1:])
            flops = None if flops is None else 2 * flops
        elif name == "einsum":
            if isinstance(args[1], (list, tuple)) and len(args[1]) == 1:
                continue        # a transpose or a sum: no product
            flops = _einsum_flops(args)
        elif base in _GATHER:
            gather["count"] += 1
            gather["bytes"] += 2 * value_bytes(val)
            continue
        elif base in _SORT or base in _SCATTER:
            inplace = name.endswith("_") and isinstance(args[0],
                                                        torch.fx.Node) \
                and _origins(args[0], env)
            if not inplace:
                note(sortsc, "sort" if base in _SORT else "scatter",
                     2 * value_bytes(val))
            continue
        else:
            if _DOT_LIKE.search(base):
                uncounted["aten." + name] = \
                    uncounted.get("aten." + name, 0) + 1
            continue
        if flops is None:
            uncounted["aten." + name] = uncounted.get("aten." + name, 0) + 1
            continue
        dots.append({"op": "aten." + name, "dtype": str(_val_dtype(val)),
                     "flops": int(flops), "line": line})
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    by_dtype = {}
    io = 0
    for v in [n.meta.get("val") for n in inputs] + _leaves(out_node.args):
        for t in _tensor_leaves(v):
            nbytes = value_bytes(t, unknown)
            io += nbytes
            key = str(t.dtype).replace("torch.", "")
            by_dtype[key] = by_dtype.get(key, 0) + nbytes
    for t in (n.meta.get("val") for n in gm.graph.nodes):
        for x in _tensor_leaves(t):
            value_bytes(x, unknown)
    for table in (sortsc, coll):
        table["total"] = {"count": sum(e["count"] for e in table.values()),
                          "bytes": sum(e["bytes"] for e in table.values())}
    return {
        "flops": sum(d["flops"] for d in dots),
        "dots": dots,
        "uncounted_ops": [{"op": k, "count": v}
                          for k, v in sorted(uncounted.items())],
        "gather": gather,
        "sort_scatter": sortsc,
        "collectives": coll,
        "host_transfers": [{"op": k, "count": v}
                           for k, v in sorted(host.items())],
        "written_inputs": [n.name for n in inputs if n.name in written],
        "inputs": [n.name for n in inputs],
        "bytes_by_dtype": by_dtype,
        "unknown_dtypes": sorted(unknown),
        "io_bytes": io,
        "kernel_ops": kernels,
    }


def _val_dtype(val):
    if isinstance(val, (tuple, list)):
        val = val[0] if val else None
    return str(getattr(val, "dtype", None)).replace("torch.", "")


def _shape_dtype(x):
    v = x.meta.get("val") if isinstance(x, torch.fx.Node) else x
    return _val_dtype(v)


def _tensor_leaves(v):
    if isinstance(v, (tuple, list)):
        out = []
        for x in v:
            out.extend(_tensor_leaves(x))
        return out
    return [v] if isinstance(v, torch.Tensor) else []


def _leaves(args):
    """The fake values of an output node's arguments."""
    out = []

    def visit(a):
        if isinstance(a, torch.fx.Node):
            out.append(a.meta.get("val"))
        elif isinstance(a, (tuple, list)):
            for x in a:
                visit(x)
    visit(args)
    return out

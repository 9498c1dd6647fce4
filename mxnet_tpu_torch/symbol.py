"""Symbol — declarative graph composition.

The port's copy of ``mxnet_tpu/symbol.py``: variables (with an
``init`` attr), composition with auto-naming and auto-created argument
variables (variadic ops fill their input count), multi-output indexing,
iteration and ``Group``, ``get_internals`` / ``get_children``, the
arithmetic operators (``-s`` and ``s ** x`` included), ``infer_shape``
/ ``infer_shape_partial`` / ``infer_type``, ``attr`` / ``attr_dict``,
graph walks, ``tojson``/``load_json``, and ``bind`` / ``simple_bind`` /
``eval`` onto an :class:`~mxnet_tpu_torch.executor.Executor` (on the
card unless given ``cpu()``).
The JSON layout is the JAX package's byte for byte, so a graph saved by
either package loads in the other.  ``sym.<Op>`` functions are generated
from the registry by :func:`_init_symbol_module`.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import registry as _reg
from .attrs import parse_tuple
from .base import AttrScope, MXNetError, NameManager
from .context import gpu, resolve_device

__all__ = ["Symbol", "Variable", "Group", "load", "load_json"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "is_aux_var")

    def __init__(self, op, name, attrs, inputs):
        self.op = op          # OpDef or None for variables
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.inputs = list(inputs)  # list of (node, out_index)
        self.is_aux_var = False

    @property
    def is_variable(self):
        return self.op is None

    def parsed_attrs(self):
        return self.op.parse_attrs(self.attrs)


class Symbol:
    """A (multi-)output symbolic expression."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list of (node, index)

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("Cannot find output %s in %s"
                                 % (index, names))
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    # -- graph walk --------------------------------------------------------
    def _topo(self):
        order, seen = [], set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for inp, _ in node.inputs:
                visit(inp)
            order.append(node)

        for node, _ in self._outputs:
            visit(node)
        return order

    def list_arguments(self):
        return [n.name for n in self._topo()
                if n.is_variable and not n.is_aux_var]

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
            else:
                outs = node.op.list_outputs(node.parsed_attrs())
                suffix = outs[idx] if idx < len(outs) else str(idx)
                names.append("%s_%s" % (node.name, suffix))
        return names

    def list_auxiliary_states(self):
        return [n.name for n in self._topo() if n.is_aux_var]

    def get_internals(self):
        """Every node's visible outputs as one grouped symbol (variables
        by their name, op outputs as ``<node>_<output>``)."""
        entries = []
        for node in self._topo():
            if node.is_variable:
                entries.append((node, 0))
            else:
                n_vis = node.op.n_visible_outputs(node.parsed_attrs())
                entries.extend((node, i) for i in range(n_vis))
        return Symbol(entries)

    def get_children(self):
        """The inputs of the output nodes as one grouped symbol (None for
        a variable)."""
        nodes = []
        for node, _ in self._outputs:
            nodes.extend(node.inputs)
        return Symbol(nodes) if nodes else None

    # -- attributes --------------------------------------------------------
    def attr(self, key):
        """The attribute ``key`` of a single-output symbol's node (None
        when absent or when the symbol is grouped)."""
        if len(self._outputs) == 1:
            return self._outputs[0][0].attrs.get(key, None)
        return None

    def attr_dict(self):
        """``{node name: {attr: str}}`` for every node with attributes."""
        return {node.name: {k: str(v) for k, v in node.attrs.items()}
                for node in self._topo() if node.attrs}

    # -- arithmetic --------------------------------------------------------
    def _binop(self, other, opname, scalar_opname, rop=False):
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if rop else (self, other)
            return _create(opname, [lhs, rhs], {})
        if isinstance(other, (int, float)):
            return _create(scalar_opname, [self],
                           {"scalar": str(float(other))})
        raise TypeError(str(type(other)))

    def __add__(self, other):
        return self._binop(other, "_plus", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "_minus", "_minus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "_minus", "_rminus_scalar", rop=True)

    def __mul__(self, other):
        return self._binop(other, "_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __div__(self, other):
        return self._binop(other, "_div", "_div_scalar")

    __truediv__ = __div__

    def __rdiv__(self, other):
        return self._binop(other, "_div", "_rdiv_scalar", rop=True)

    __rtruediv__ = __rdiv__

    def __pow__(self, other):
        return self._binop(other, "_power", "_power_scalar")

    def __neg__(self):
        return self * (-1.0)

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")

    # -- shape inference ---------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input
        shapes (positional in ``list_arguments`` order, or by name)."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None for every shape the given
        ones do not determine, instead of an error."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        for name, shape in zip(arg_names, args):
            if shape is not None:
                known[name] = tuple(shape)
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})

        shapes = {}   # (id(node), idx) -> shape
        var_shapes = {}
        aux_shapes = {}
        for node in self._topo():
            if node.is_variable:
                shape = known.get(node.name)
                if shape is None and "__shape__" in node.attrs:
                    shape = parse_tuple(node.attrs["__shape__"])
                if node.is_aux_var:
                    aux_shapes[node.name] = shape
                else:
                    var_shapes[node.name] = shape
                shapes[(id(node), 0)] = shape
                continue
            attrs = node.parsed_attrs()
            n_args = node.op.n_inputs(attrs)
            in_entries = node.inputs[:n_args]
            aux_entries = node.inputs[n_args:]
            in_shapes = [shapes.get((id(n), i)) for n, i in in_entries]
            if any(s is None for s in in_shapes) and \
                    (node.op.infer_shape_fn is None or in_shapes[0] is None):
                if partial:
                    for i in range(node.op.n_outputs(attrs)):
                        shapes[(id(node), i)] = None
                    continue
                unknown = [inode.name for (inode, _), s
                           in zip(in_entries, in_shapes) if s is None]
                raise MXNetError(
                    "Cannot infer shape for node %s (op %s): inputs %s have "
                    "unknown shapes" % (node.name, node.op.name, unknown))
            try:
                new_in, out_sh, aux_sh = node.op.infer_shape(
                    attrs, in_shapes,
                    [shapes.get((id(n), i)) for n, i in aux_entries])
            except MXNetError:
                if not partial:
                    raise
                for i in range(node.op.n_outputs(attrs)):
                    shapes[(id(node), i)] = None
                continue
            for (inode, iidx), s in zip(in_entries, new_in):
                if s is None:
                    continue
                prev = shapes.get((id(inode), iidx))
                if prev is not None and tuple(prev) != tuple(s):
                    raise MXNetError("Shape mismatch for %s: %s vs %s"
                                     % (inode.name, prev, s))
                shapes[(id(inode), iidx)] = tuple(s)
                if inode.is_variable:
                    var_shapes[inode.name] = tuple(s)
            for (anode, aidx), s in zip(aux_entries, aux_sh or []):
                if s is not None:
                    shapes[(id(anode), aidx)] = tuple(s)
                    aux_shapes[anode.name] = tuple(s)
            for i, s in enumerate(out_sh):
                shapes[(id(node), i)] = tuple(s) if s is not None else None

        arg_res = [var_shapes.get(n) for n in arg_names]
        out_res = [shapes.get((id(n), i)) for n, i in self._outputs]
        aux_res = [aux_shapes.get(n) for n in self.list_auxiliary_states()]
        if not partial and any(s is None for s in arg_res + out_res):
            missing = [n for n, s in zip(arg_names, arg_res) if s is None]
            raise MXNetError("Cannot fully infer shapes; missing: %s"
                             % missing)
        return arg_res, out_res, aux_res

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` propagated from the given
        input dtypes (positional or by name; numpy dtypes or their
        names): the JAX package's unification rule.  An op's unresolved
        inputs take the dtype promoted over its known floating inputs
        (integer inputs such as ids neither promote nor type a weight),
        so declaring only ``data=float16`` types every weight after it
        float16; ops with their own rule (Embedding, BatchNorm) give it
        as ``infer_type`` on their OpDef.  Types are numpy dtypes, with
        ``torch.bfloat16`` for bfloat16; unresolved ones are float32."""
        arg_names = self.list_arguments()
        known = {}
        for name, dt in zip(arg_names, args):
            if dt is not None:
                known[name] = _np_dtype(dt)
        known.update({k: _np_dtype(v) for k, v in kwargs.items()
                      if v is not None})
        f32 = np.dtype(np.float32)
        entry_t, var_t, aux_t = {}, {}, {}
        for node in self._topo():
            if node.is_variable:
                dt = known.get(node.name)
                if dt is None and node.attrs.get("__dtype__"):
                    dt = _np_dtype(node.attrs["__dtype__"])
                (aux_t if node.is_aux_var else var_t)[node.name] = dt
                entry_t[(id(node), 0)] = dt
                continue
            attrs = node.parsed_attrs()
            n_args = node.op.n_inputs(attrs)
            in_entries = node.inputs[:n_args]
            aux_entries = node.inputs[n_args:]
            in_types = [entry_t.get((id(s), i)) for s, i in in_entries]
            aux_types = [entry_t.get((id(s), i)) for s, i in aux_entries]
            if node.op.infer_type_fn is not None:
                new_in, out_types, new_aux = node.op.infer_type_fn(
                    attrs, in_types, aux_types)
            else:
                resolved = [t for t in in_types if t is not None]
                floats = [t for t in resolved if _floating(t)]
                if floats:
                    base = _promote(floats)
                elif resolved and len(resolved) == len(in_types):
                    base = _promote(resolved)
                else:
                    base = f32
                new_in = [t if t is not None else base for t in in_types]
                out_types = [base] * node.op.n_outputs(attrs)
                new_aux = [t if t is not None else base for t in aux_types]
            for entries, table, types in ((in_entries, var_t, new_in),
                                          (aux_entries, aux_t, new_aux or [])):
                for (src, i), t in zip(entries, types):
                    if t is None:
                        continue
                    entry_t[(id(src), i)] = t
                    if src.is_variable and table.get(src.name) is None:
                        table[src.name] = t
            for i, t in enumerate(out_types):
                entry_t[(id(node), i)] = t
        return ([var_t.get(n) or f32 for n in arg_names],
                [entry_t.get((id(n), i)) or f32 for n, i in self._outputs],
                [aux_t.get(n) or f32 for n in self.list_auxiliary_states()])

    # -- serialization -----------------------------------------------------
    def tojson(self):
        nodes = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "attrs": {k: str(v) for k, v in n.attrs.items()},
                "inputs": [[nid[id(src)], idx, 0] for src, idx in n.inputs],
                "is_aux": n.is_aux_var,
            })
        heads = [[nid[id(n)], idx, 0] for n, idx in self._outputs]
        return json.dumps({"nodes": jnodes, "heads": heads,
                           "arg_nodes": [i for i, n in enumerate(nodes)
                                         if n.is_variable]},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """An :class:`~mxnet_tpu_torch.executor.Executor` over zeroed
        arrays of the shapes ``kwargs`` determine, on ``ctx``.
        ``group2ctx`` (model-parallel placement) is not ported."""
        from .executor import simple_bind

        _no_group2ctx(group2ctx)
        return simple_bind(self, resolve_device(ctx), grad_req=grad_req,
                           type_dict=type_dict, shared_exec=shared_exec,
                           **kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An :class:`~mxnet_tpu_torch.executor.Executor` over the given
        arrays (a list in ``list_arguments`` order or a dict; NDArrays,
        tensors or numpy), on ``ctx``: an array already there is bound as
        it is, any other is copied there."""
        from .executor import Executor

        _no_group2ctx(group2ctx)
        dev = resolve_device(ctx)

        def place(table):
            if table is None:
                return None
            if isinstance(table, dict):
                return {k: _on(v, dev) for k, v in table.items()}
            return [_on(v, dev) for v in table]

        return Executor(self, dev, place(args), place(args_grad), grad_req,
                        place(aux_states))

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` (every argument by name) on ``ctx`` (the card
        by default) and run one inference forward; returns the outputs."""
        return self.bind(ctx if ctx is not None else gpu(0),
                         kwargs).forward()


def _no_group2ctx(group2ctx):
    if group2ctx:
        raise MXNetError("group2ctx (model-parallel placement) is not "
                         "ported")


def _on(value, dev):
    """``value`` as an NDArray on ``dev``: itself when it is one there."""
    from .ndarray import NDArray, array

    if isinstance(value, NDArray) and value.data.device == dev:
        return value
    return array(value, dev)


def _np_dtype(dt):
    """A numpy dtype, or ``torch.bfloat16`` (numpy has none)."""
    if dt is torch.bfloat16 or str(dt) == "bfloat16":
        return torch.bfloat16
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).numpy().dtype
    return np.dtype(dt)


def _floating(dt):
    return dt is torch.bfloat16 or dt.kind == "f"


def _promote(dts):
    """numpy's promotion; bfloat16 with any other type widens to
    float32 (or beyond), as the JAX package's rule does."""
    if all(d is torch.bfloat16 for d in dts):
        return torch.bfloat16
    rest = [d for d in dts if d is not torch.bfloat16]
    if len(rest) < len(dts):
        rest.append(np.dtype(np.float32))
    out = rest[0]
    for d in rest[1:]:
        if d != out:
            try:
                out = np.promote_types(out, d)
            except TypeError:
                out = np.dtype(np.float32)
    return out


def Variable(name, attr=None, shape=None, init=None, **kwargs):
    """Create a variable symbol; ``init`` (an initializer) rides on it as
    its ``__init__`` attr and overrides the global initializer."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attr = AttrScope.current().get(attr)
    attr = dict(attr) if attr else {}
    if shape is not None:
        attr["__shape__"] = str(tuple(shape))
    if init is not None:
        attr["__init__"] = init.dumps() if hasattr(init, "dumps") \
            else str(init)
    attr.update(kwargs)
    return Symbol([(_Node(None, name, attr, []), 0)])


def Group(symbols):
    """One multi-output symbol from the outputs of ``symbols``."""
    entries = []
    for s in symbols:
        entries.extend(s._outputs)
    return Symbol(entries)


def load_json(json_str):
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        if jn["op"] == "null":
            node = _Node(None, jn["name"], jn.get("attrs", {}), [])
            node.is_aux_var = jn.get("is_aux", False)
        else:
            op = _reg.get_op(jn["op"])
            inputs = [(nodes[i], idx) for i, idx, _ in jn["inputs"]]
            node = _Node(op, jn["name"], jn.get("attrs", {}), inputs)
        nodes.append(node)
    heads = [(nodes[i], idx) for i, idx, _ in data["heads"]]
    return Symbol(heads)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------------------
# op-function generation (sym.FullyConnected etc.)
# ---------------------------------------------------------------------------

def _create(op_name, sym_inputs, attrs, name=None):
    op = _reg.get_op(op_name)
    if op.key_var_num_args and op.key_var_num_args not in attrs:
        attrs = dict(attrs)
        attrs[op.key_var_num_args] = str(len(sym_inputs))
    scope_attrs = AttrScope.current().get(None)
    node_attrs = dict(scope_attrs) if scope_attrs else {}
    node_attrs.update(attrs)
    parsed = op.parse_attrs(node_attrs)
    name = NameManager.current().get(name, op.hint)

    arg_names = op.list_arguments(parsed)
    aux_names = op.list_aux(parsed)
    entries = []
    for s in sym_inputs:
        if len(s._outputs) != 1:
            raise MXNetError("Cannot compose multi-output symbol as one "
                             "input")
        entries.append(s._outputs[0])
    n_args = len(arg_names)
    user_aux = entries[n_args:]
    entries = entries[:n_args]
    # auto-create missing argument variables (``fc0_weight`` ...)
    while len(entries) < n_args:
        vname = "%s_%s" % (name, arg_names[len(entries)])
        entries.append(Variable(vname)._outputs[0])
    for i, aux_name in enumerate(aux_names):
        if i < len(user_aux):
            entry = user_aux[i]
            if entry[0].is_variable:
                entry[0].is_aux_var = True
            entries.append(entry)
        else:
            v = Variable("%s_%s" % (name, aux_name))
            v._outputs[0][0].is_aux_var = True
            entries.append(v._outputs[0])

    node = _Node(op, name, node_attrs, entries)
    return Symbol([(node, i) for i in range(op.n_visible_outputs(parsed))])


def _make_sym_func(op_name):
    op = _reg.get_op(op_name)

    def sym_func(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_inputs = list(args)
        attrs = {}
        maybe_names = None
        for k, v in list(kwargs.items()):
            if isinstance(v, Symbol):
                if maybe_names is None:
                    probe = {pk: pv for pk, pv in kwargs.items()
                             if not isinstance(pv, Symbol)}
                    if op.key_var_num_args \
                            and op.key_var_num_args not in probe:
                        probe[op.key_var_num_args] = str(len(args) or 1)
                    try:
                        parsed_probe = op.parse_attrs(probe)
                        maybe_names = (op.list_arguments(parsed_probe)
                                       + op.list_aux(parsed_probe))
                    except MXNetError:
                        maybe_names = []
                kwargs.pop(k)
                sym_inputs.append((maybe_names.index(k) if k in maybe_names
                                   else 10_000, v))
            else:
                attrs[k] = v
        # order keyword symbol inputs by argument position
        if sym_inputs and isinstance(sym_inputs[-1], tuple):
            positional = [s for s in sym_inputs if isinstance(s, Symbol)]
            keyword = sorted([s for s in sym_inputs if isinstance(s, tuple)],
                             key=lambda t: t[0])
            sym_inputs = positional + [s for _, s in keyword]
        if attr:
            merged = dict(attr)
            merged.update({k: str(v) for k, v in attrs.items()})
            attrs = merged
        return _create(op_name, sym_inputs, attrs, name=name)

    sym_func.__name__ = op_name
    sym_func.__doc__ = op.doc + "\n\nParameters\n----------\n" \
        + op.schema.doc()
    return sym_func


def _init_symbol_module():
    import sys

    mod = sys.modules[__name__]
    for name in _reg.list_ops():
        setattr(mod, name, _make_sym_func(name))

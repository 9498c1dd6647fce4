"""Symbol — declarative graph composition.

The port's copy of the parts of ``mxnet_tpu/symbol.py`` that serving,
``Module`` and the RNN cells use: variables (with an ``init`` attr),
composition with auto-naming and auto-created argument variables
(variadic ops fill their input count), multi-output indexing and
``Group``, the arithmetic operators, ``infer_shape``, ``attr_dict``,
graph walks, and ``tojson``/``load_json``.
The JSON layout is the JAX package's byte for byte, so a graph saved by
either package loads in the other.  ``sym.<Op>`` functions are generated
from the registry by :func:`_init_symbol_module`.
"""
from __future__ import annotations

import json

from . import registry as _reg
from .attrs import parse_tuple
from .base import AttrScope, MXNetError, NameManager

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

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")

    # -- shape inference ---------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input
        shapes (positional in ``list_arguments`` order, or by name)."""
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
                unknown = [inode.name for (inode, _), s
                           in zip(in_entries, in_shapes) if s is None]
                raise MXNetError(
                    "Cannot infer shape for node %s (op %s): inputs %s have "
                    "unknown shapes" % (node.name, node.op.name, unknown))
            new_in, out_sh, aux_sh = node.op.infer_shape(
                attrs, in_shapes,
                [shapes.get((id(n), i)) for n, i in aux_entries])
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
        if any(s is None for s in arg_res + out_res):
            missing = [n for n, s in zip(arg_names, arg_res) if s is None]
            raise MXNetError("Cannot fully infer shapes; missing: %s"
                             % missing)
        return arg_res, out_res, aux_res

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

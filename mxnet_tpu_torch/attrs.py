"""Declarative operator-parameter system.

The port's copy of ``mxnet_tpu/attrs.py``: each op declares a schema of
typed fields; attribute dicts arriving as strings (symbol JSON, frontend
kwargs) are parsed into a hashable :class:`FrozenAttrs`.
"""
from __future__ import annotations

import ast

from .base import MXNetError

__all__ = ["Param", "ParamSchema", "FrozenAttrs", "parse_tuple",
           "parse_bool"]


def parse_bool(s):
    if isinstance(s, bool):
        return s
    if isinstance(s, (int, float)):
        return bool(s)
    s = str(s).strip().lower()
    if s in ("true", "1"):
        return True
    if s in ("false", "0"):
        return False
    raise ValueError("cannot parse bool from %r" % s)


def parse_tuple(s, elem_type=int):
    """Parse '(2,2)' / '[2, 2]' / '2' / (2, 2) into a tuple."""
    if isinstance(s, (tuple, list)):
        return tuple(elem_type(x) for x in s)
    if isinstance(s, (int, float)):
        return (elem_type(s),)
    s = str(s).strip()
    if s.startswith("(") or s.startswith("["):
        val = ast.literal_eval(s)
        if isinstance(val, (int, float)):
            return (elem_type(val),)
        return tuple(elem_type(x) for x in val)
    return (elem_type(ast.literal_eval(s)),)


def _identity(x):
    return x


_PARSERS = {
    int: lambda s: int(float(s)),
    float: float,
    bool: parse_bool,
    str: str,
    tuple: parse_tuple,
    "shape": parse_tuple,
    "float_tuple": lambda s: parse_tuple(s, float),
    None: _identity,
}


class Param:
    """One declared field of an op's parameter struct."""

    __slots__ = ("name", "type", "default", "required", "doc", "enum")

    def __init__(self, name, type=str, default=None, required=False, doc="",
                 enum=None):
        self.name = name
        self.type = type
        self.default = default
        self.required = required
        self.doc = doc
        self.enum = enum

    def parse(self, value):
        parser = _PARSERS.get(self.type, self.type if callable(self.type)
                              else _identity)
        val = parser(value)
        if self.enum is not None and val not in self.enum:
            raise MXNetError(
                "Invalid value %r for parameter %s; expected one of %s"
                % (val, self.name, self.enum))
        return val


class FrozenAttrs:
    """Immutable, hashable attribute mapping."""

    __slots__ = ("_items", "_hash")

    def __init__(self, mapping):
        self._items = tuple(sorted(mapping.items()))
        self._hash = hash(self._items)

    def __getitem__(self, key):
        for k, v in self._items:
            if k == key:
                return v
        raise KeyError(key)

    def get(self, key, default=None):
        for k, v in self._items:
            if k == key:
                return v
        return default

    def __contains__(self, key):
        return any(k == key for k, _ in self._items)

    def __iter__(self):
        return (k for k, _ in self._items)

    def items(self):
        return self._items

    def keys(self):
        return [k for k, _ in self._items]

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, FrozenAttrs) and self._items == other._items

    def __repr__(self):
        return "FrozenAttrs(%s)" % dict(self._items)

    def as_dict(self):
        return dict(self._items)


class ParamSchema:
    """Ordered collection of :class:`Param` declarations for one op."""

    def __init__(self, *params):
        self.params = {p.name: p for p in params}

    def parse(self, raw_attrs):
        """Parse raw (possibly string-valued) attrs into FrozenAttrs.
        Unknown keys are kept as given (system attrs such as
        ``ctx_group`` or ``__shape__`` ride along for graph passes)."""
        out = {}
        raw = dict(raw_attrs) if raw_attrs else {}
        for name, p in self.params.items():
            if name in raw:
                try:
                    out[name] = p.parse(raw.pop(name))
                except (ValueError, SyntaxError) as e:
                    raise MXNetError("Failed to parse parameter %s=%r: %s"
                                     % (name, raw_attrs[name], e))
            elif p.required:
                raise MXNetError("Required parameter %s is missing" % name)
            else:
                out[name] = p.default
        for key, value in raw.items():
            out[key] = value if not isinstance(value, list) else tuple(value)
        return FrozenAttrs(out)

    def doc(self):
        lines = []
        for p in self.params.values():
            t = getattr(p.type, "__name__", str(p.type))
            d = "required" if p.required else "default=%r" % (p.default,)
            lines.append("%s : %s, %s\n    %s" % (p.name, t, d, p.doc))
        return "\n".join(lines)

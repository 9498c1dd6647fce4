"""Base utilities: errors, name management, attribute scopes.

The PyTorch port's copy of ``mxnet_tpu/base.py``: the same automatic
naming (``{hint}{count}``) and attribute scopes, so a model built through
either package yields the same symbol JSON.
"""
from __future__ import annotations

import threading

__all__ = ["MXNetError", "NameManager", "AttrScope", "string_types",
           "numeric_types"]

string_types = (str,)
numeric_types = (float, int)


class MXNetError(Exception):
    """Error raised by the framework."""


class _ScopeStack(threading.local):
    def __init__(self):
        self.stack = []


class NameManager:
    """Automatic symbol naming: ``{op}{count}`` names for anonymous
    symbols, e.g. ``fullyconnected0``."""

    _state = _ScopeStack()

    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name is not None:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        NameManager._state.stack.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        NameManager._state.stack.pop()

    @classmethod
    def current(cls):
        if not cls._state.stack:
            cls._state.stack.append(NameManager())
        return cls._state.stack[-1]


class AttrScope:
    """Attribute scoping for symbols: ``with AttrScope(ctx_group='dev1'):``
    attaches the attributes to every symbol created inside the scope."""

    _state = _ScopeStack()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, string_types):
                raise ValueError("Attributes need to be strings")
        self._attr = kwargs

    def get(self, attr):
        """Merge user-supplied attrs with scope attrs (user wins)."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        # inherit outer scope attributes
        if AttrScope._state.stack:
            merged = AttrScope._state.stack[-1]._attr.copy()
            merged.update(self._attr)
            self._attr = merged
        AttrScope._state.stack.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        AttrScope._state.stack.pop()

    @classmethod
    def current(cls):
        if not cls._state.stack:
            cls._state.stack.append(AttrScope())
        return cls._state.stack[-1]

"""Runtime environment-variable configuration registry.

The port's copy of ``mxnet_tpu/config.py`` with the knobs the serving
slice reads.  There is no kernel on/off knob: on the card the kernels
always run, on the CPU their plain versions do.
"""
from __future__ import annotations

import os

__all__ = ["EnvVar", "register", "get", "describe", "refresh"]

_REGISTRY = {}


def _parse_bool(s):
    return str(s).lower() in ("1", "true", "yes", "on")


class EnvVar:
    """One declared runtime flag."""

    __slots__ = ("name", "type", "default", "doc", "_value", "_loaded")

    def __init__(self, name, type, default, doc):
        self.name = name
        self.type = type
        self.default = default
        self.doc = doc
        self._value = None
        self._loaded = False

    def get(self):
        if not self._loaded:
            raw = os.environ.get(self.name)
            if raw is None:
                self._value = self.default
            elif self.type is bool:
                self._value = _parse_bool(raw)
            else:
                self._value = self.type(raw)
            self._loaded = True
        return self._value

    def reset(self):
        self._loaded = False


def register(name, type, default, doc):
    """Declare a runtime flag; returns the EnvVar."""
    var = EnvVar(name, type, default, doc)
    _REGISTRY[name] = var
    return var


def get(name):
    """Read a declared flag (cached after first read)."""
    return _REGISTRY[name].get()


def refresh(name=None):
    """Drop the cached value(s) so the next get() re-reads the
    environment."""
    if name is not None:
        _REGISTRY[name].reset()
    else:
        for var in _REGISTRY.values():
            var.reset()


def describe():
    """Human-readable catalog of every declared flag."""
    lines = []
    for name in sorted(_REGISTRY):
        var = _REGISTRY[name]
        lines.append("%s (%s, default=%r)\n    %s"
                     % (name, var.type.__name__, var.default, var.doc))
    return "\n".join(lines)


register("MXNET_DECODE_SLOTS", int, 8,
         "Batch width of the continuous-batching serving loop "
         "(decode.DecodeServer): the decode step always runs this many "
         "sequence slots; free slots refill from the request queue after "
         "every step.")
register("MXNET_KV_DTYPE", str, "",
         "Storage dtype for the decode KV caches: 'int8', 'float8_e4m3fn' "
         "('f8e4m3') or 'float8_e5m2' ('f8e5m2') quantize K/V on append "
         "with per-(token, kv-head) fp32 scales; the paged decode kernel "
         "dequantizes them as it loads each page.  Empty (default) stores "
         "full-precision K/V.")
register("MXNET_KV_PAGED", bool, False,
         "Store decode KV caches as fixed-size pages in one shared pool "
         "per attention node, addressed through per-slot page tables "
         "(copy-on-write prefix sharing and chunked prefill ride on it).")
register("MXNET_KV_PAGE_TOKENS", int, 16,
         "Tokens per KV page in paged mode; cache_len must divide by it.")
register("MXNET_KV_POOL_PAGES", int, 0,
         "Total pages in the shared KV pool (page 0 is the scratch page). "
         "0 (default) sizes the pool to fit every slot at full capacity.")
register("MXNET_PREFILL_CHUNK", int, 0,
         "Chunk width for paged-mode prefill: prompts are admitted in "
         "chunks of this many tokens, interleaved with decode steps.  0 "
         "(default) prefills each prompt's tail in one chunk.")
register("MXNET_DECODE_MAX_NEW", int, 256,
         "Default cap on generated tokens per request in the serving loop "
         "when the caller gives no explicit max_new_tokens.")

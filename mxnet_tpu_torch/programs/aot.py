"""The program-cache directory — the port's part of
``mxnet_tpu/programs/aot.py``.

The reference serializes compiled executables into a content-addressed
cache (``save`` / ``load`` / ``load_or_compile``, ``AotDispatch``,
``AOT_STATS``) so a fleet host cold-starts by deserializing its serving
programs.  Those have no counterpart here: a captured CUDA graph cannot
be serialized (it holds device pointers of one process), and the kernel
build cache (``cuda_build``) already covers the compile half of a cold
start.  Deployment goes through ``torch.export`` instead
(``Predictor.export`` / ``predictor.load_exported``).

What the port keeps is the directory itself: the tuning cache
(``ops/tuning.py``) writes its records there.
"""
from __future__ import annotations

import os

__all__ = ["cache_dir"]

_DEFAULT_DIR = os.path.join("~", ".cache", "mxnet_tpu_torch", "programs")


def cache_dir(create=False):
    """The program-cache directory (``MXNET_PROGRAM_CACHE``, default
    ``~/.cache/mxnet_tpu_torch/programs``), created on demand."""
    from .. import config as _config

    path = _config.get("MXNET_PROGRAM_CACHE") or _DEFAULT_DIR
    path = os.path.expanduser(path)
    if create:
        os.makedirs(path, exist_ok=True)
    return path

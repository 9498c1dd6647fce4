"""The port's loader for the native RecordIO codec (``src/recordio.cc``,
a small C ABI over ctypes), the counterpart of ``mxnet_tpu/_native.py``.

The shared library is built on first use with g++ into
``mxnet_tpu_torch/_build/`` (never into the JAX package's tree).  As in
the JAX package, the pure-Python codec serves when no compiler or
source is found: this is host I/O, not the device.  Which codec runs is
logged once.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "src", "recordio.cc")
_LIBDIR = os.path.join(_HERE, "_build")

_lock = threading.Lock()
_recordio = None
_recordio_tried = False


def _build(src_path, lib_path):
    """Compile to a private name, then rename: concurrent processes never
    see (or map) a half-written library."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp_path = "%s.tmp.%d" % (lib_path, os.getpid())
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
           src_path, "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.rename(tmp_path, lib_path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def _configure(lib):
    c = ctypes
    lib.rio_last_error.restype = c.c_char_p
    lib.rio_writer_open.restype = c.c_void_p
    lib.rio_writer_open.argtypes = [c.c_char_p]
    lib.rio_writer_tell.restype = c.c_int64
    lib.rio_writer_tell.argtypes = [c.c_void_p]
    lib.rio_writer_write.restype = c.c_int64
    lib.rio_writer_write.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.rio_writer_close.argtypes = [c.c_void_p]
    lib.rio_reader_open.restype = c.c_void_p
    lib.rio_reader_open.argtypes = [c.c_char_p]
    lib.rio_reader_seek.argtypes = [c.c_void_p, c.c_int64]
    lib.rio_reader_tell.restype = c.c_int64
    lib.rio_reader_tell.argtypes = [c.c_void_p]
    lib.rio_reader_next.restype = c.c_int
    lib.rio_reader_next.argtypes = [c.c_void_p, c.POINTER(c.c_void_p),
                                    c.POINTER(c.c_uint64)]
    lib.rio_reader_close.argtypes = [c.c_void_p]
    lib.rio_build_index.restype = c.c_int64
    lib.rio_build_index.argtypes = [c.c_char_p,
                                    c.POINTER(c.POINTER(c.c_int64))]
    lib.rio_free.argtypes = [c.c_void_p]
    return lib


def recordio_lib():
    """The native RecordIO library, built on first use; None when it
    cannot be built or loaded (the pure-Python codec serves then)."""
    global _recordio, _recordio_tried
    with _lock:
        if _recordio_tried:
            return _recordio
        _recordio_tried = True
        lib_path = os.path.join(_LIBDIR, "libmxtorch_io.so")
        try:
            if not os.path.isfile(_SRC):
                raise OSError("no source at %s" % _SRC)
            if (not os.path.isfile(lib_path)
                    or os.path.getmtime(lib_path) < os.path.getmtime(_SRC)):
                _build(_SRC, lib_path)
            _recordio = _configure(ctypes.CDLL(lib_path))
            logging.info("RecordIO: the native codec (%s)", lib_path)
        except (OSError, subprocess.CalledProcessError) as exc:
            logging.info("RecordIO: the pure-Python codec (native codec "
                         "unavailable: %s)", exc)
            _recordio = None
        return _recordio


def native_error(lib):
    return lib.rio_last_error().decode()

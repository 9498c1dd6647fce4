"""The port's loader for the native RecordIO codec (``src/recordio.cc``,
a small C ABI over ctypes), the counterpart of ``mxnet_tpu/_native.py``;
it also builds the MXPred* C ABI (``csrc/predict_api.cc``).

The shared library is built on first use with g++ into
``mxnet_tpu_torch/_build/`` (never into the JAX package's tree).  As in
the JAX package, the pure-Python codec serves when no compiler or
source is found: this is host I/O, not the device.  Which codec runs is
logged once.

:func:`predict_lib` builds ``libmxtorch_predict-<digest>.so`` (the C
ABI, against the running interpreter's headers and without libpython,
whose symbols the loading process provides) and loads it with ctypes;
:func:`predict_client` builds the standalone C++ client
(``csrc/predict_client.cc`` with the C ABI and the RecordIO codec,
linked against libpython).  Both raise when g++ or the interpreter's
``python3-config --embed`` is missing: there is no other route.
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
_PREDICT_SRC = os.path.join(_HERE, "csrc", "predict_api.cc")
_CLIENT_SRC = os.path.join(_HERE, "csrc", "predict_client.cc")

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


def _python_config():
    """The ``python3-config`` of the running interpreter (its own
    ``<python>-config`` when there is one)."""
    import shutil
    import sys

    for cand in (sys.executable + "-config", "python3-config"):
        if shutil.which(cand):
            return cand
    raise OSError("no python3-config: the C ABI needs the interpreter's "
                  "headers")


def _config_flags(*args):
    out = subprocess.run([_python_config(), "--embed"] + list(args),
                         check=True, capture_output=True, text=True)
    return out.stdout.split()


def _digest(srcs, flags):
    """A short digest of the sources' contents and the interpreter's
    build flags: part of a built file's name, so an edited source or
    another Python rebuilds it."""
    import hashlib

    h = hashlib.blake2b(digest_size=6)
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()


def _gxx(cmd, out):
    """Run g++ ``cmd`` writing ``out`` through a private name."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = "%s.tmp.%d" % (out, os.getpid())
    try:
        subprocess.run(cmd + ["-o", tmp], check=True, capture_output=True,
                       text=True)
        os.rename(tmp, out)
    except subprocess.CalledProcessError as exc:
        raise OSError("g++ failed: %s" % exc.stderr[-4000:]) from exc
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_predict = None


def predict_lib():
    """The MXPred* C ABI built into ``_build/libmxtorch_predict-<digest>.so``
    (at first use; the digest covers the source and the interpreter's
    flags) and loaded with ctypes, its argument types declared."""
    global _predict
    with _lock:
        if _predict is not None:
            return _predict
        flags = _config_flags("--includes")
        lib_path = os.path.join(_LIBDIR, "libmxtorch_predict-%s.so"
                                % _digest([_PREDICT_SRC], flags))
        if not os.path.isfile(lib_path):
            _gxx(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                  _PREDICT_SRC] + flags, lib_path)
        c = ctypes
        lib = ctypes.CDLL(lib_path)
        lib.MXGetLastError.restype = c.c_char_p
        lib.MXPredCreate.argtypes = [
            c.c_char_p, c.c_uint64, c.c_int, c.c_int, c.c_uint32,
            c.POINTER(c.c_char_p), c.POINTER(c.c_uint32),
            c.POINTER(c.c_uint32), c.POINTER(c.c_void_p)]
        lib.MXPredSetInput.argtypes = [
            c.c_void_p, c.c_char_p, c.POINTER(c.c_float), c.c_uint32,
            c.POINTER(c.c_uint32), c.c_uint32]
        lib.MXPredForward.argtypes = [c.c_void_p]
        lib.MXPredGetOutputShape.argtypes = [
            c.c_void_p, c.c_uint32, c.POINTER(c.POINTER(c.c_uint32)),
            c.POINTER(c.c_uint32)]
        lib.MXPredGetOutput.argtypes = [c.c_void_p, c.c_uint32,
                                        c.POINTER(c.c_float), c.c_uint32]
        lib.MXPredFree.argtypes = [c.c_void_p]
        _predict = lib
        return lib


def predict_client():
    """The path of the standalone C++ client, built into
    ``_build/predict_client-<digest>`` at first use (the digest covers
    the sources and the interpreter's flags)."""
    import sysconfig

    libdir = sysconfig.get_config_var("LIBDIR") or ""
    flags = _config_flags("--cflags") + _config_flags("--ldflags") + (
        ["-Wl,-rpath," + libdir] if libdir else [])
    srcs = [_CLIENT_SRC, _PREDICT_SRC, _SRC]
    exe = os.path.join(_LIBDIR, "predict_client-%s" % _digest(srcs, flags))
    with _lock:
        if not os.path.isfile(exe):
            _gxx(["g++", "-O2", "-std=c++17"] + srcs + flags, exe)
    return exe

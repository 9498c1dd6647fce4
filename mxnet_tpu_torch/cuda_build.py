"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds.  Builds happen at first use
(never at import: the CPU tests import every module), all sources in
parallel, into ``_build/`` next to this file (listed in ``.gitignore``).
A library's file name carries a digest of its source, of every shared
header (``csrc/*.cuh``) and of the flags, so an edited source or header
rebuilds and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

from .base import MXNetError

__all__ = ["SOURCES", "build", "lib", "BUILD_LOG"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("fused_fwd", "paged_decode", "flash_attention", "fused_bwd",
           "multi_tensor_update")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> loaded ctypes library; name -> nvcc's stderr (ptxas register
# and shared-memory report) from the build that produced it
_LIBS = {}
BUILD_LOG = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise MXNetError("nvcc not found: the CUDA kernels build only on a "
                         "machine with the CUDA toolkit")
    return path


def _target(name):
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0"
                          + f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so"
                        % (name, digest.hexdigest()[:12]))


def _declare(name, cdll):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "fused_fwd":
        # dtype, x, scale, shift, w, bias, residual, y, ysum, ysumsq,
        # M, K, N, relu, variant, stream
        cdll.fused_fwd.argtypes = [i, p, p, p, p, p, p, p, p, p,
                                   i, i, i, i, i, p]
        cdll.fused_fwd.restype = i
    elif name == "fused_bwd":
        # dtype, x, dy, scale, shift, w, dx, dw, dscale, dshift, M, K, N,
        # relu, variant_dx, variant_dw, splits, dw_part, stream
        cdll.fused_bwd.argtypes = [i, p, p, p, p, p, p, p, p, p,
                                   i, i, i, i, i, i, i, p, p]
        cdll.fused_bwd.restype = i
    elif name == "flash_attention":
        # dtype, hd, q, k, v, o, lse, BH, T, G, scale, causal, stream
        cdll.flash_fwd.argtypes = [i, i, p, p, p, p, p, i, i, i, f, i, p]
        # dtype, hd, q, k, v, dout, lse, delta, dq, BH, T, G, scale,
        # causal, stream
        cdll.flash_bwd_dq.argtypes = [i, i, p, p, p, p, p, p, p,
                                      i, i, i, f, i, p]
        # dtype, hd, q, k, v, dout, lse, delta, dk, dv, BH_kv, T, G,
        # scale, causal, stream
        cdll.flash_bwd_dkv.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                       i, i, i, f, i, p]
        for fn in (cdll.flash_fwd, cdll.flash_bwd_dq, cdll.flash_bwd_dkv):
            fn.restype = i
    elif name == "multi_tensor_update":
        # kind, nslots, master, wc_code, w, g, s0, s1, wc, lr, wd, nblocks,
        # rescale, clip, h2, h3, h4, stream
        cdll.multi_tensor_update.argtypes = [i, i, i, i, p, p, p, p, p, p, p,
                                             i, f, f, f, f, f, p]
        cdll.multi_tensor_update.restype = i
    else:
        # variant, pool dtype, q, kpool, vpool, kscale, vscale, table,
        # lens, acc, m, l, B, tq, H, Hkv, Dk, Dv, pt, M, S, pps, rows,
        # epl, vec, scale, stream
        cdll.paged_decode.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p,
                                      i, i, i, i, i, i, i, i, i, i, i, i, i,
                                      f, p]
        cdll.paged_decode.restype = i
        # out dtype, acc, m, l, out, B, tq, H, S, Dv, stream
        cdll.paged_combine.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
        cdll.paged_combine.restype = i
    cdll.mx_error_string.argtypes = [i]
    cdll.mx_error_string.restype = ctypes.c_char_p
    return cdll


def build(names=SOURCES):
    """Compile (all at once) and load every named kernel library that is
    not loaded yet; returns ``{name: ctypes.CDLL}``."""
    todo = [n for n in names if n not in _LIBS]
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in todo:
            out = _target(name)
            if os.path.exists(out):
                continue
            procs[name] = (out, subprocess.Popen(
                [_nvcc()] + NVCC_FLAGS
                + ["-o", out + ".tmp", os.path.join(CSRC, name + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        failed = []
        for name, (out, proc) in procs.items():
            stdout, stderr = proc.communicate()
            BUILD_LOG[name] = (stdout + stderr).decode(errors="replace")
            if proc.returncode != 0:
                failed.append("%s:\n%s" % (name, BUILD_LOG[name]))
            else:
                os.replace(out + ".tmp", out)
        if failed:
            raise MXNetError("nvcc failed for " + "\n".join(failed))
        for name in todo:
            _LIBS[name] = _declare(name, ctypes.CDLL(_target(name)))
    return {n: _LIBS[n] for n in names}


def lib(name):
    """The loaded library of one kernel, built at first use."""
    got = _LIBS.get(name)
    return got if got is not None else build((name,))[name]


def check(cdll, rc, what):
    """Raise when a launch returned a CUDA error (``cudaGetLastError``
    right after the launch: a refused launch never runs, and a later
    synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d (%s)"
                           % (what, rc, cdll.mx_error_string(rc).decode()))

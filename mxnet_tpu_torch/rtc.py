"""Runtime device-kernel registration — the port of ``mxnet_tpu/rtc.py``.

The reference lets users hand the framework raw device-kernel source at
run time (``python/mxnet/rtc.py``: CUDA strings compiled via ``MXRtc*``)
and call it on NDArrays; the JAX package's counterpart is a Pallas
kernel that Mosaic compiles at first trace (``register_pallas_op``).  In
the port a user kernel is CUDA C++ again: :func:`build` compiles a
source string with the same ``nvcc`` and flags as the package's own
kernels (``cuda_build``) into ``_build/rtc_<digest>.so`` at first use and
returns the ``ctypes.CDLL``, and :func:`register_cuda_op` wires a
forward (and optionally a backward) around it into the op registry, so
it is callable as ``mx.nd.<name>`` / ``mx.sym.<name>`` and composes with
autograd, ``Module`` training and the captured train step like a
built-in op.  ``register_pallas_op`` has no counterpart: the port's user
kernels are CUDA.

The source exports plain ``extern "C"`` launch functions that take the
stream; a forward launches on ``torch.cuda.current_stream()``, so it is
captured inside a compiled ``Module`` step.  As for the package's own
kernels, a forward runs its plain PyTorch version on tensors that are
not on the card (the CPU, and the ``meta`` tensors shape inference
hands it).  Worked example::

    import ctypes, torch
    import mxnet_tpu_torch as mx

    lib = mx.rtc.build(r'''
    #include <cuda_runtime.h>
    __global__ void k(const float* x, const float* y, float* o, float a,
                      int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) o[i] = x[i] * a + y[i];
    }
    extern "C" int scale_add(const void* x, const void* y, void* o,
                             float a, int n, void* stream) {
      k<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
          (const float*)x, (const float*)y, (float*)o, a, n);
      return (int)cudaGetLastError();
    }
    ''')
    p = ctypes.c_void_p
    lib.scale_add.argtypes = [p, p, p, ctypes.c_float, ctypes.c_int, p]

    def forward(x, y, alpha=2.0):
        if x.device.type != "cuda":
            return x * alpha + y                  # the plain version
        x, y = x.contiguous(), y.contiguous()
        o = torch.empty_like(x)
        rc = lib.scale_add(x.data_ptr(), y.data_ptr(), o.data_ptr(), alpha,
                           x.numel(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("scale_add: CUDA error %d" % rc)
        return o

    def backward(inputs, outputs, cotangents, alpha=2.0):
        (g,) = cotangents
        return [g * alpha, g]

    mx.rtc.register_cuda_op("scale_add", forward, backward=backward,
                            num_inputs=2, attr_params={"alpha": 2.0})
    out = mx.nd.scale_add(a, b, alpha=3.0)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

from .attrs import Param, ParamSchema
from .base import MXNetError
from .registry import OpDef, register_op

__all__ = ["register_cuda_op", "build"]

# source digest -> loaded library
_LIBS = {}


def build(source):
    """Compile a user's CUDA C++ ``source`` (``extern "C"`` launch
    functions) with ``nvcc`` for ``sm_90a``, the flags of the package's
    own kernels, into ``mxnet_tpu_torch/_build/rtc_<digest>.so`` (reused
    while the source and flags are unchanged) and return the loaded
    ``ctypes.CDLL``; declare its functions' ``argtypes`` before calling
    them.  Raises MXNetError where there is no ``nvcc`` or it fails."""
    from . import cuda_build

    digest = hashlib.sha1((" ".join(cuda_build.NVCC_FLAGS) + "\0"
                           + source).encode()).hexdigest()[:16]
    got = _LIBS.get(digest)
    if got is not None:
        return got
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    base = os.path.join(cuda_build.BUILD_DIR, "rtc_" + digest)
    out = base + ".so"
    if not os.path.exists(out):
        with open(base + ".cu", "w") as f:
            f.write(source)
        proc = subprocess.run(
            [cuda_build._nvcc()] + cuda_build.NVCC_FLAGS
            + ["-o", out + ".tmp", base + ".cu"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise MXNetError("nvcc failed for the rtc source %s:\n%s"
                             % (digest, proc.stdout + proc.stderr))
        os.replace(out + ".tmp", out)
    got = _LIBS[digest] = ctypes.CDLL(out)
    return got


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


class _UserOp(torch.autograd.Function):
    """A user op's forward, differentiable through its ``backward``;
    without one, differentiating it raises."""

    @staticmethod
    def forward(ctx, spec, *ins):
        name, fwd, bwd, kw = spec
        outs = tuple(_as_list(fwd(*ins, **kw)))
        ctx.spec = spec
        ctx.n_in = len(ins)
        if bwd is not None:
            ctx.save_for_backward(*ins, *outs)
        return outs

    @staticmethod
    def backward(ctx, *cts):
        name, fwd, bwd, kw = ctx.spec
        if bwd is None:
            raise MXNetError("op %r was registered without a backward: it "
                             "cannot be differentiated" % name)
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        grads = bwd(list(ins), list(outs), list(cts), **kw)
        if len(grads) != len(ins):
            raise MXNetError("%s.backward returned %d cotangents for %d "
                             "inputs" % (name, len(grads), len(ins)))
        return (None,) + tuple(grads)


def register_cuda_op(name, forward, backward=None, num_inputs=1,
                     num_outputs=1, infer_shape=None, attr_params=None,
                     doc=""):
    """Register a user CUDA kernel as a first-class operator.

    Args:
      name: op name (becomes ``mx.nd.<name>`` / ``mx.sym.<name>``).
      forward: ``forward(*inputs, **attrs) -> output(s)`` — tensors in,
        tensor or list out; on CUDA tensors it launches the user kernel
        (a library from :func:`build`) on the current stream, on any
        other device it computes the same in plain PyTorch.
      backward: optional ``backward(inputs, outputs, cotangents,
        **attrs) -> [input cotangents]``.  When given, the op is
        differentiable (a ``torch.autograd.Function``); without it,
        differentiating the op raises (the reference's Rtc kernels are
        likewise forward-only).
      num_inputs / num_outputs: arity (ints).
      infer_shape: optional ``(attrs, in_shapes, aux_shapes) -> (in,
        out, aux)`` hook; defaults to running ``forward`` on ``meta``
        tensors.
      attr_params: {name: default} scalar attributes forwarded to both
        ``forward`` and ``backward`` as keyword arguments.
      doc: docstring for the generated wrappers.

    The op name must not collide with an existing operator, nor with an
    attribute of ``mx.nd`` / ``mx.sym``.
    """
    from . import ndarray as nd_mod
    from . import registry
    from . import symbol as sym_mod

    if registry.has_op(name):
        raise MXNetError("op %r already registered" % name)
    # the wrappers install into mx.nd / mx.sym: refuse to shadow ANY
    # existing attribute there (e.g. nd.array, sym.Variable)
    if hasattr(nd_mod, name) or hasattr(sym_mod, name):
        raise MXNetError(
            "name %r would shadow an existing mx.nd/mx.sym attribute" % name)

    attr_params = dict(attr_params or {})
    schema = ParamSchema(*[Param(k, type(v), default=v)
                           for k, v in attr_params.items()])

    def fcompute(attrs, inputs, aux, octx):
        kw = {k: attrs.get(k, d) for k, d in attr_params.items()}
        return list(_UserOp.apply((name, forward, backward, kw),
                                  *inputs)), []

    register_op(OpDef(
        name, fcompute, schema=schema, num_inputs=num_inputs,
        num_outputs=num_outputs, infer_shape=infer_shape,
        hint=name.lower(), user_defined=True,
        doc=doc or ("User-registered CUDA kernel op (rtc; reference "
                    "python/mxnet/rtc.py).")))
    # expose wrappers on the generated namespaces (ops registered after
    # import must install their functions explicitly)
    setattr(nd_mod, name, nd_mod._make_op_func(registry.get_op(name)))
    setattr(sym_mod, name, sym_mod._make_sym_func(name))
    return registry.get_op(name)

// MXPred* C ABI over the PyTorch port (the counterpart of
// src/predict_api.cc): MXPredCreate / MXPredSetInput / MXPredForward /
// MXPredGetOutputShape / MXPredGetOutput / MXPredFree and MXGetLastError,
// with the same symbols and signatures.
//
// The artifact is a Predictor.export blob (a saved torch.export program,
// weights included); the embedded interpreter runs it through
// mxnet_tpu_torch.predictor.load_exported, whose graph calls the kernels'
// operators.  dev_type / dev_id are honored: 1 is the CPU, 2 is
// cuda:dev_id; dev_type 2 without a card fails in MXPredCreate with the
// error in MXGetLastError.  Input keys are given in the artifact's feed
// order and declared shapes are checked against it at create.  In a
// process that already runs Python (a ctypes load) the library uses that
// interpreter; otherwise it starts one, which must find torch and
// mxnet_tpu_torch on PYTHONPATH.
//
// Build (mxnet_tpu_torch/_native.py does this at first use):
//   g++ -O2 -std=c++17 -shared -fPIC predict_api.cc \
//       $(python3-config --embed --cflags --ldflags) -o libmxtorch_predict.so

#include <Python.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

void set_error(const std::string &m) { g_error = m; }

// Helper module executed inside the embedded interpreter: owns the
// deserialized executables and the staging buffers.
const char *kHelperSrc = R"PY(
import numpy as np
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import predictor as _predictor

_handles = {}
_next = [1]

def _context(dev_type, dev_id):
    if dev_type == 1:
        return mt.cpu(dev_id)
    if dev_type == 2:
        if not torch.cuda.is_available():
            raise ValueError("dev_type 2 (gpu(%d)) needs a CUDA card and "
                             "none is available" % dev_id)
        return mt.gpu(dev_id)
    raise ValueError("dev_type %d: 1 (cpu) or 2 (gpu)" % dev_type)

def create(blob, keys, shapes, dev_type, dev_id):
    ctx = _context(dev_type, dev_id)
    run = _predictor.load_exported(bytes(blob), device=ctx)
    want = run.input_shapes
    if len(keys) != len(want):
        raise ValueError("artifact expects %d inputs, %d keys declared"
                         % (len(want), len(keys)))
    if shapes is not None:
        if len(shapes) != len(want):
            raise ValueError("declared %d input shapes, artifact expects %d"
                             % (len(shapes), len(want)))
        for key, shp, w in zip(keys, shapes, want):
            if tuple(shp) != tuple(w):
                raise ValueError(
                    "declared shape %s for input %r does not match the "
                    "artifact's %s" % (tuple(shp), key, tuple(w)))
    h = _next[0]; _next[0] += 1
    _handles[h] = {"run": run, "keys": list(keys), "in": {}, "out": None}
    return h

def set_input(h, key, mv, shape):
    d = _handles[h]
    if key not in d["keys"]:
        raise KeyError("unknown input %r (artifact inputs: %s)"
                       % (key, d["keys"]))
    d["in"][key] = np.frombuffer(mv, np.float32).reshape(shape).copy()

def forward(h):
    d = _handles[h]
    missing = [k for k in d["keys"] if k not in d["in"]]
    if missing:
        raise ValueError("inputs not set: %s" % missing)
    outs = d["run"](*[d["in"][k] for k in d["keys"]])
    d["out"] = [o.detach().float().cpu().numpy() for o in outs]

def out_shape(h, i):
    return list(_handles[h]["out"][i].shape)

def get_output(h, i, mv):
    out = _handles[h]["out"][i].ravel()
    dst = np.frombuffer(mv, np.float32)
    if dst.size != out.size:
        raise ValueError("output buffer size %d != %d" % (dst.size, out.size))
    dst[:] = out

def free(h):
    _handles.pop(h, None)
)PY";

std::atomic<PyObject *> g_helper{nullptr};
std::mutex g_init_mu;
// Guarded by the GIL (read/modified only between a PyGILState_Ensure and
// the next potential GIL release).  No C++ mutex may be held across the
// helper exec: PyRun_String imports torch/numpy, whose file I/O drops and
// re-acquires the GIL internally — a mutex held there deadlocks against
// any host thread that calls in with the GIL held (ctypes.PyDLL).
std::atomic<bool> g_init_in_progress{false};

// First-call initialization must be race-free: the ABI promises
// thread-safe use, and two FFI threads hitting a naked null check could
// both run Py_InitializeEx (UB) or leak a helper module.  A failed init
// does NOT latch: a later call retries — e.g. after the caller fixes
// PYTHONPATH, as the error message suggests.
bool ensure_python() {
  if (g_helper.load(std::memory_order_acquire) != nullptr) return true;
  {
    // interpreter bring-up only; no GIL interplay inside the lock (if
    // another thread holds the GIL the interpreter is already
    // initialized and this section is a no-op)
    std::lock_guard<std::mutex> lock(g_init_mu);
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the GIL the initializing thread holds, so MXPred* calls
      // from ANY thread can PyGILState_Ensure without deadlocking
      PyEval_SaveThread();
    }
  }
  PyGILState_STATE gs = PyGILState_Ensure();
  // Serialize the helper exec with a GIL-guarded claim: between the
  // check and the store below the GIL is never released, so exactly one
  // thread claims; waiters sleep WITHOUT holding the GIL or any lock.
  while (g_init_in_progress.load(std::memory_order_relaxed)) {
    Py_BEGIN_ALLOW_THREADS
    std::this_thread::sleep_for(std::chrono::milliseconds(5));
    Py_END_ALLOW_THREADS
  }
  if (g_helper.load(std::memory_order_acquire) != nullptr) {
    PyGILState_Release(gs);
    return true;
  }
  g_init_in_progress.store(true, std::memory_order_relaxed);
  bool ok = false;
  PyObject *mod = PyModule_New("_mxtorch_predict_embed");
  PyObject *dict = PyModule_GetDict(mod);
  PyDict_SetItemString(dict, "__builtins__", PyEval_GetBuiltins());
  PyObject *res = PyRun_String(kHelperSrc, Py_file_input, dict, dict);
  if (res == nullptr) {
    PyErr_Print();
    set_error("failed to initialize the embedded predict runtime (are "
              "torch and mxnet_tpu_torch importable? set PYTHONPATH to "
              "the repository and the site-packages that hold torch)");
    Py_DECREF(mod);
  } else {
    Py_DECREF(res);
    g_helper.store(mod, std::memory_order_release);
    ok = true;
  }
  g_init_in_progress.store(false, std::memory_order_relaxed);
  PyGILState_Release(gs);
  return ok;
}

// Build an argument tuple from already-owned references; PyTuple_SetItem
// STEALS each reference, so nothing here leaks (PyTuple_Pack would add
// its own references on top of the fresh ones, leaking one per call).
PyObject *pack_args(std::initializer_list<PyObject *> items) {
  PyObject *t = PyTuple_New(static_cast<Py_ssize_t>(items.size()));
  Py_ssize_t i = 0;
  for (PyObject *o : items) PyTuple_SetItem(t, i++, o);
  return t;
}

// Call helper.<name>(args...); returns new ref or nullptr (error set).
PyObject *call(const char *name, PyObject *args) {
  PyObject *helper = g_helper.load(std::memory_order_acquire);
  if (helper == nullptr) {
    set_error("predict runtime not initialized");
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *fn = PyObject_GetAttrString(helper, name);
  if (fn == nullptr) {
    set_error(std::string("helper missing ") + name);
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *out = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (out == nullptr) {
    PyObject *t, *v, *tb;
    PyErr_Fetch(&t, &v, &tb);
    PyObject *s = v ? PyObject_Str(v) : nullptr;
    set_error(s ? PyUnicode_AsUTF8(s) : "embedded call failed");
    Py_XDECREF(s);
    Py_XDECREF(t); Py_XDECREF(v); Py_XDECREF(tb);
    return nullptr;
  }
  return out;
}

struct Pred {
  long handle = 0;
  std::vector<uint32_t> last_shape;
};

}  // namespace

extern "C" {

const char *MXGetLastError() { return g_error.c_str(); }

// artifact: a Predictor.export blob.  input_keys list the artifact's
// inputs in its feed order; shapes come CSR-style through indptr, as the
// reference's MXPredCreate takes them, and are checked against the
// artifact (nullptr for both skips the check).  dev_type 1 runs on the
// CPU, 2 on cuda:dev_id.
int MXPredCreate(const char *artifact, uint64_t artifact_len,
                 int dev_type, int dev_id, uint32_t num_input_nodes,
                 const char **input_keys, const uint32_t *input_shape_indptr,
                 const uint32_t *input_shape_data, void **out) {
  if (!ensure_python()) return -1;
  PyGILState_STATE gs = PyGILState_Ensure();
  PyObject *blob = PyBytes_FromStringAndSize(artifact,
                                             static_cast<Py_ssize_t>(artifact_len));
  PyObject *keys = PyList_New(num_input_nodes);
  for (uint32_t i = 0; i < num_input_nodes; ++i) {
    PyList_SetItem(keys, i, PyUnicode_FromString(input_keys[i]));
  }
  PyObject *shapes;
  if (input_shape_indptr != nullptr && input_shape_data != nullptr) {
    shapes = PyList_New(num_input_nodes);
    for (uint32_t i = 0; i < num_input_nodes; ++i) {
      uint32_t lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
      PyObject *shp = PyTuple_New(hi - lo);
      for (uint32_t j = lo; j < hi; ++j) {
        PyTuple_SetItem(shp, j - lo,
                        PyLong_FromUnsignedLong(input_shape_data[j]));
      }
      PyList_SetItem(shapes, i, shp);
    }
  } else {
    shapes = Py_None;
    Py_INCREF(Py_None);
  }
  PyObject *res = call("create",
                       pack_args({blob, keys, shapes,
                                  PyLong_FromLong(dev_type),
                                  PyLong_FromLong(dev_id)}));
  int rc = -1;
  if (res != nullptr) {
    Pred *p = new Pred();
    p->handle = PyLong_AsLong(res);
    Py_DECREF(res);
    *out = p;
    rc = 0;
  }
  PyGILState_Release(gs);
  return rc;
}

int MXPredSetInput(void *handle, const char *key, const float *data,
                   uint32_t size, const uint32_t *shape, uint32_t ndim) {
  Pred *p = static_cast<Pred *>(handle);
  PyGILState_STATE gs = PyGILState_Ensure();
  PyObject *mv = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<float *>(data)),
      static_cast<Py_ssize_t>(size) * 4, PyBUF_READ);
  PyObject *shp = PyTuple_New(ndim);
  for (uint32_t i = 0; i < ndim; ++i) {
    PyTuple_SetItem(shp, i, PyLong_FromUnsignedLong(shape[i]));
  }
  PyObject *res = call("set_input",
                       pack_args({PyLong_FromLong(p->handle),
                                  PyUnicode_FromString(key), mv, shp}));
  int rc = res ? 0 : -1;
  Py_XDECREF(res);
  PyGILState_Release(gs);
  return rc;
}

int MXPredForward(void *handle) {
  Pred *p = static_cast<Pred *>(handle);
  PyGILState_STATE gs = PyGILState_Ensure();
  PyObject *res = call("forward",
                       pack_args({PyLong_FromLong(p->handle)}));
  int rc = res ? 0 : -1;
  Py_XDECREF(res);
  PyGILState_Release(gs);
  return rc;
}

int MXPredGetOutputShape(void *handle, uint32_t index,
                         uint32_t **shape_data, uint32_t *shape_ndim) {
  Pred *p = static_cast<Pred *>(handle);
  PyGILState_STATE gs = PyGILState_Ensure();
  PyObject *res = call("out_shape",
                       pack_args({PyLong_FromLong(p->handle),
                                  PyLong_FromUnsignedLong(index)}));
  int rc = -1;
  if (res != nullptr) {
    Py_ssize_t n = PyList_Size(res);
    p->last_shape.resize(n);
    for (Py_ssize_t i = 0; i < n; ++i) {
      p->last_shape[i] = static_cast<uint32_t>(
          PyLong_AsLong(PyList_GetItem(res, i)));
    }
    Py_DECREF(res);
    *shape_data = p->last_shape.data();
    *shape_ndim = static_cast<uint32_t>(n);
    rc = 0;
  }
  PyGILState_Release(gs);
  return rc;
}

int MXPredGetOutput(void *handle, uint32_t index, float *data,
                    uint32_t size) {
  Pred *p = static_cast<Pred *>(handle);
  PyGILState_STATE gs = PyGILState_Ensure();
  PyObject *mv = PyMemoryView_FromMemory(reinterpret_cast<char *>(data),
                                         static_cast<Py_ssize_t>(size) * 4,
                                         PyBUF_WRITE);
  PyObject *res = call("get_output",
                       pack_args({PyLong_FromLong(p->handle),
                                  PyLong_FromUnsignedLong(index), mv}));
  int rc = res ? 0 : -1;
  Py_XDECREF(res);
  PyGILState_Release(gs);
  return rc;
}

int MXPredFree(void *handle) {
  Pred *p = static_cast<Pred *>(handle);
  if (g_helper.load(std::memory_order_acquire) != nullptr) {
    PyGILState_STATE gs = PyGILState_Ensure();
    PyObject *res = call("free",
                         pack_args({PyLong_FromLong(p->handle)}));
    Py_XDECREF(res);
    PyGILState_Release(gs);
  }
  delete p;
  return 0;
}

}  // extern "C"

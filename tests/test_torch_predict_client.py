"""The MXPred* C ABI over the port (``mxnet_tpu_torch/csrc/
predict_api.cc``) and its C++ client (``csrc/predict_client.cc``), the
counterpart of ``tests/test_predict_client.py``: g++ builds both here
(``_native.predict_lib`` / ``predict_client``), and the argmax classes of
a forward through the ABI equal the port's Python ``Predictor``'s and
the JAX package's on the same numpy weights.  ``dev_type`` 2 without a
card fails cleanly in ``MXPredCreate``; declared shapes that do not
match, and a blob that is not an artifact, fail at create.
"""
import ctypes
import os
import re
import shutil
import struct
import subprocess
import sysconfig

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _toolchain():
    if shutil.which("g++") is None:
        return False
    try:
        _native._config_flags("--ldflags")
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


pytestmark = pytest.mark.skipif(not _toolchain(),
                                reason="g++ or python3-config --embed "
                                       "unavailable")


def _net(sym):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=3, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _weights():
    rng = np.random.RandomState(0)
    return {"fc1_weight": rng.randn(16, 8).astype(np.float32) * 0.5,
            "fc1_bias": rng.randn(16).astype(np.float32) * 0.1,
            "fc2_weight": rng.randn(3, 16).astype(np.float32) * 0.5,
            "fc2_bias": rng.randn(3).astype(np.float32) * 0.1}


def _batch():
    return np.random.RandomState(1).randn(8, 8).astype(np.float32)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(artifact path, port probabilities, JAX probabilities)."""
    import mxnet_tpu as mx
    from mxnet_tpu.predictor import Predictor as JaxPredictor

    d = tmp_path_factory.mktemp("capi")
    x = _batch()
    with mt.cpu():
        pred = mt.Predictor(_net(mt.sym), _weights(), {"data": (8, 8)},
                            ctx=mt.cpu())
        path = str(d / "model.pt2")
        pred.export(path)
        pred.forward(data=x)
        got = pred.get_output(0).asnumpy()
    jpred = JaxPredictor(_net(mx.sym),
                         {k: mx.nd.array(v) for k, v in _weights().items()},
                         input_shapes={"data": (8, 8)}, ctx=mx.cpu())
    jpred.forward(data=mx.nd.array(x))
    want = jpred.get_output(0).asnumpy()
    return path, got, want


def _records(path, rows):
    w = mt.recordio.MXRecordIO(path, "w")
    for row in rows:
        w.write(np.asarray(row, "<f4").tobytes())
    w.close()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, sysconfig.get_paths()["purelib"],
         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    return env


def _floats(a):
    a = np.ascontiguousarray(a, np.float32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _create(lib, blob, dev_type, shape):
    c = ctypes
    h = c.c_void_p()
    keys = (c.c_char_p * 1)(b"data")
    indptr = (c.c_uint32 * 2)(0, len(shape))
    shp = (c.c_uint32 * len(shape))(*shape)
    rc = lib.MXPredCreate(blob, len(blob), dev_type, 0, 1, keys, indptr,
                          shp, c.byref(h))
    return rc, h, shp


def test_in_process_abi_matches_both_predictors(artifact):
    """The library loaded into this interpreter with ctypes: the forward
    equals the port's Python Predictor bit for bit (the same exported
    program on the same device) and the JAX package's within 1e-5."""
    path, got, want = artifact
    lib = _native.predict_lib()
    with open(path, "rb") as f:
        blob = f.read()
    rc, h, shp = _create(lib, blob, 1, (8, 8))
    assert rc == 0, lib.MXGetLastError()
    x, xp = _floats(_batch())
    assert lib.MXPredSetInput(h, b"data", xp, x.size, shp, 2) == 0
    assert lib.MXPredForward(h) == 0, lib.MXGetLastError()
    oshape = ctypes.POINTER(ctypes.c_uint32)()
    ndim = ctypes.c_uint32()
    assert lib.MXPredGetOutputShape(h, 0, ctypes.byref(oshape),
                                    ctypes.byref(ndim)) == 0
    assert [oshape[i] for i in range(ndim.value)] == [8, 3]
    out, op = _floats(np.zeros((8, 3)))
    assert lib.MXPredGetOutput(h, 0, op, out.size) == 0
    assert lib.MXPredFree(h) == 0
    np.testing.assert_array_equal(out, got)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    assert (out.argmax(1) == want.argmax(1)).all()


def test_gpu_dev_type_fails_cleanly_without_a_card(artifact):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path, _, _ = artifact
    lib = _native.predict_lib()
    with open(path, "rb") as f:
        blob = f.read()
    rc, _, _ = _create(lib, blob, 2, (8, 8))
    assert rc == -1
    assert b"needs a CUDA card" in lib.MXGetLastError()


def test_cpp_client_matches_both_predictors(artifact, tmp_path):
    path, got, want = artifact
    rec = str(tmp_path / "batch.rec")
    _records(rec, _batch())
    exe = _native.predict_client()
    out = subprocess.check_output([exe, path, rec, "8", "8"], env=_env(),
                                  text=True, stderr=subprocess.STDOUT,
                                  timeout=240)
    cls = {int(m.group(1)): int(m.group(2)) for m in re.finditer(
        r"record (\d+): class (\d+) prob ([0-9.]+)", out)}
    assert sorted(cls) == list(range(8)), out
    assert [cls[i] for i in range(8)] == list(got.argmax(1)) \
        == list(want.argmax(1))


def test_cpp_client_gpu_without_a_card_fails_at_create(artifact, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path, _, _ = artifact
    rec = str(tmp_path / "batch.rec")
    _records(rec, _batch())
    proc = subprocess.run([_native.predict_client(), "--dev-type", "2",
                           path, rec, "8", "8"], env=_env(),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert "MXPredCreate" in proc.stderr and "CUDA card" in proc.stderr
    assert "Traceback" not in proc.stderr, proc.stderr


def test_cpp_client_shape_mismatch_fails_at_create(artifact, tmp_path):
    path, _, _ = artifact
    rec = str(tmp_path / "four.rec")
    _records(rec, [[0.5] * 8] * 4)
    proc = subprocess.run([_native.predict_client(), path, rec, "4", "8"],
                          env=_env(), capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0
    assert "MXPredCreate" in proc.stderr
    assert "does not match" in proc.stderr, proc.stderr
    assert "Traceback" not in proc.stderr, proc.stderr


def test_cpp_client_bad_artifact_fails_cleanly(tmp_path):
    bad = str(tmp_path / "bad.pt2")
    with open(bad, "wb") as f:
        f.write(b"not an artifact")
    rec = str(tmp_path / "one.rec")
    w = mt.recordio.MXRecordIO(rec, "w")
    w.write(struct.pack("<8f", *([0.0] * 8)))
    w.close()
    proc = subprocess.run([_native.predict_client(), bad, rec, "1", "8"],
                          env=_env(), capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0
    assert "MXPredCreate" in proc.stderr

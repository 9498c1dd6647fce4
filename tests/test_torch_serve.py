"""The PyTorch port's serving slice end to end on the CPU, against the JAX
package: the same attention_lm symbol JSON, the same prefill/step
probabilities from the same numpy weights (``params_from_jax``), and
the same greedy tokens from a shared-prefix paged ``DecodeServer``.

Sizes are small (vocab 17, embed 8-16, 2 heads, 2 layers).
Probabilities are compared at rtol 1e-5 / atol 1e-6: the two packages
sum the same f32 products in other orders.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.decode import DecodePredictor as JaxPredictor
from mxnet_tpu.decode import DecodeServer as JaxServer
from mxnet_tpu.models import attention_lm as jax_lm

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.decode import DecodePredictor, DecodeServer
from mxnet_tpu_torch.models import attention_lm
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.ops import fused_bn, fused_lm
from mxnet_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

VOCAB, T, EMBED, HEADS = 17, 16, 8, 2
B = 2
TOL = dict(rtol=1e-5, atol=1e-6)


def _lm(num_kv_heads=0, embed=EMBED):
    with mx.base.NameManager():
        sym = jax_lm.get_symbol(VOCAB, T, num_layers=2, embed=embed,
                                heads=HEADS, ffn_hidden=16,
                                num_kv_heads=num_kv_heads)
    rng = np.random.RandomState(0)
    arg_shapes, _, _ = sym.infer_shape(data=(B, T), softmax_label=(B, T))
    params = {n: rng.normal(0, 0.5, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    with mt.NameManager():
        tsym = attention_lm.get_symbol(VOCAB, T, num_layers=2, embed=embed,
                                       heads=HEADS, ffn_hidden=16,
                                       num_kv_heads=num_kv_heads)
    return sym, tsym, params


@pytest.mark.parametrize("num_kv_heads", [0, 1])
def test_symbol_json_byte_identical(num_kv_heads):
    sym, tsym, params = _lm(num_kv_heads)
    assert tsym.tojson() == sym.tojson()
    # and the port reads the JAX package's graph back unchanged
    assert mt.symbol.load_json(sym.tojson()).tojson() == sym.tojson()
    t_shapes = tsym.infer_shape(data=(B, T), softmax_label=(B, T))
    j_shapes = sym.infer_shape(data=(B, T), softmax_label=(B, T))
    assert [list(map(tuple, x)) for x in t_shapes] == \
        [list(map(tuple, x)) for x in j_shapes]


@pytest.mark.parametrize("paged,kv_dtype,num_kv_heads", [
    (False, "", 0), (True, "", 0), (True, "", 1), (False, "int8", 1)])
def test_prefill_and_step_probs_match_jax(paged, kv_dtype, num_kv_heads):
    """Padded per-row prompt lengths, then teacher-forced steps (the same
    token fed to both) — dense ring and paged pools, MHA and MQA."""
    sym, tsym, params = _lm(num_kv_heads)
    rng = np.random.RandomState(1)
    x = rng.randint(0, VOCAB, (B, 9)).astype(np.float32)
    lens = np.array([5, 9], np.int32)
    kw = dict(paged=paged, kv_dtype=kv_dtype)
    if paged:
        kw.update(page_tokens=4, prefill_chunk=4)
    jp = JaxPredictor(sym, params, cache_len=T, **kw)
    tp = DecodePredictor(tsym, params_from_jax(params, device="cpu"),
                         cache_len=T, device="cpu", **kw)
    js, jprobs = jp.prefill(x, lens)
    ts, tprobs = tp.prefill(x, lens)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **TOL)
    assert fused_lm.FUSED_PATH["last"] == "plain"
    for i in range(4):
        forced = rng.randint(0, VOCAB, (B, 1)).astype(np.int32)
        js = js._replace(tok=js.tok * 0 + forced)
        ts = ts._replace(tok=torch.from_numpy(forced))
        js, jprobs = jp.step(js)
        ts, tprobs = tp.step(ts)
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                                   err_msg="step %d" % i, **TOL)
    assert tattn.DECODE_PATH["last"] == "plain"


def test_generate_past_capacity_matches_jax():
    """Greedy generation that wraps the ring (dense) and recycles pages
    (paged) emits the JAX package's tokens."""
    sym, tsym, params = _lm()
    x = np.random.RandomState(2).randint(0, VOCAB, (B, 6)).astype(
        np.float32)
    tparams = params_from_jax(params, device="cpu")
    for kw in (dict(), dict(paged=True, page_tokens=4, prefill_chunk=4)):
        want = JaxPredictor(sym, params, cache_len=8, kv_dtype="",
                            **kw).generate(x, max_new_tokens=12)
        got = DecodePredictor(tsym, tparams, cache_len=8, kv_dtype="",
                              device="cpu", **kw).generate(
            x, max_new_tokens=12)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_shared_prefix_paged_server_matches_jax(kv_dtype):
    """A shared-prefix trace through the paged server (chunked prefill,
    prefix-cache hits, copy-on-write forks, slot refills) returns the JAX
    package's greedy tokens request for request."""
    sym, tsym, params = _lm(embed=16)
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, VOCAB, 7)
    prompts = [np.concatenate([prefix, rng.randint(0, VOCAB, n)])
               for n in (2, 5, 3)] + [rng.randint(0, VOCAB, 6)]
    kw = dict(paged=True, page_tokens=4, prefill_chunk=4,
              kv_dtype=kv_dtype)
    jsrv = JaxServer(JaxPredictor(sym, params, cache_len=T, **kw), 12,
                     slots=2, max_new_tokens=6)
    tsrv = DecodeServer(DecodePredictor(
        tsym, params_from_jax(params, device="cpu"), cache_len=T,
        device="cpu", **kw), 12, slots=2, max_new_tokens=6)
    for p in prompts:
        jsrv.submit(p)
        tsrv.submit(p)
    want, got = jsrv.run(), tsrv.run()
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    stats = tsrv.stats()
    assert stats["prefix_cache_hit_rate"] > 0
    assert stats["cow_forks"] > 0
    assert stats["requests_completed"] == 4
    assert stats["used_pages"] == stats["prefix_cache_pages"]


def test_dense_server_matches_jax():
    sym, tsym, params = _lm()
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, VOCAB, n) for n in (3, 7, 5)]
    jsrv = JaxServer(JaxPredictor(sym, params, cache_len=T, kv_dtype=""),
                     8, slots=2, max_new_tokens=5)
    tsrv = DecodeServer(DecodePredictor(
        tsym, params_from_jax(params, device="cpu"), cache_len=T,
        kv_dtype="", device="cpu"), 8, slots=2, max_new_tokens=5)
    for p in prompts:
        jsrv.submit(p)
        tsrv.submit(p)
    want, got = jsrv.run(), tsrv.run()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.decode, "
            "mxnet_tpu_torch.programs, "
            "mxnet_tpu_torch.ops.decode_kernel, "
            "mxnet_tpu_torch.ops.fused_kernel, "
            "mxnet_tpu_torch.ops.fused_bn, "
            "mxnet_tpu_torch.ops.flash_kernel, mxnet_tpu_torch.module, "
            "mxnet_tpu_torch.executor, mxnet_tpu_torch.train_step, "
            "mxnet_tpu_torch.optimizer, mxnet_tpu_torch.initializer, "
            "mxnet_tpu_torch.metric, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.ndarray, mxnet_tpu_torch.weights, "
            "mxnet_tpu_torch.rnn, mxnet_tpu_torch.ops.rnn_op, "
            "mxnet_tpu_torch.module.bucketing_module, "
            "mxnet_tpu_torch.models.lstm_lm, mxnet_tpu_torch.model, "
            "mxnet_tpu_torch.callback, mxnet_tpu_torch.rnn.rnn, "
            "mxnet_tpu_torch.autograd, mxnet_tpu_torch.random, "
            "mxnet_tpu_torch.test_utils, mxnet_tpu_torch.ops.sample, "
            "mxnet_tpu_torch.image, mxnet_tpu_torch.recordio, "
            "mxnet_tpu_torch._native, mxnet_tpu_torch.operator, "
            "mxnet_tpu_torch.ops.contrib_ops, mxnet_tpu_torch.ops.spatial, "
            "mxnet_tpu_torch.models.ssd, "
            "mxnet_tpu_torch.module.python_module, "
            "mxnet_tpu_torch.module.sequential_module, "
            "mxnet_tpu_torch.obs, mxnet_tpu_torch.profiler, "
            "mxnet_tpu_torch.serve.swap, mxnet_tpu_torch.serve.fleet, "
            "mxnet_tpu_torch.ops.moe, mxnet_tpu_torch.checkpoint, "
            "mxnet_tpu_torch.elastic, mxnet_tpu_torch.parallel.health, "
            "mxnet_tpu_torch.analysis, mxnet_tpu_torch.analysis.passes, "
            "mxnet_tpu_torch.analysis.programs, "
            "mxnet_tpu_torch.analysis.schedule, "
            "mxnet_tpu_torch.analysis.graph_parse, "
            "mxnet_tpu_torch.ops.update_kernel, mxnet_tpu_torch.kvstore, "
            "mxnet_tpu_torch.kvstore_server, "
            "mxnet_tpu_torch.parallel.launch, "
            "mxnet_tpu_torch.parallel.collectives, "
            "mxnet_tpu_torch.parallel.mesh, "
            "torch.distributed.checkpoint, importlib.util; "
            "[importlib.util.spec_from_file_location(n, 'tools/%s.py' % n)"
            ".loader.load_module() for n in ('mxlint_torch', "
            "'mxstat_torch', 'bandwidth_torch')]; "
            "sys.modules['mxlint_torch'].main(['--list']); "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'mxnet_tpu.')) "
            "or m == 'mxnet_tpu'); print(json.dumps(bad))")
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", "import json; " + code],
                         capture_output=True, text=True, env=env, cwd=root,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_entry_points_refuse_a_missing_card():
    """No device argument means the card: without one, entry points
    raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tsym, params = _lm()
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        DecodePredictor(tsym, params, cache_len=T)
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        params_from_jax(params)
    # kernel B4's benchmarks time the card and take no CPU
    for entry in (fused_bn.bench_cases, fused_bn.sweep):
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            entry()
    # an explicit CPU is fine
    assert DecodePredictor(tsym, params, cache_len=T,
                           device=mt.cpu()).device.type == "cpu"

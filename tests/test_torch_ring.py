"""Sequence parallelism through the port: ``parallel.ring.ring_attention``
under ``parallel.compat.shard_map`` and a ``Module`` with a ``seq`` mesh
axis, over gloo ranks on the CPU, against the JAX package's ring, dense
attention and mesh ``Module`` on its 8-virtual-device harness
(``tests/test_seq_parallel.py``'s and ``tests/test_gqa.py``'s cases).

This file is its own worker: ``python tests/test_torch_ring.py <rank> 4
<host:port> <host:port2> <outdir>`` runs one rank (it imports only
PyTorch and the port) and writes what it computed to
``<outdir>/r<rank>.pkl``.  One spawn of 4 ranks serves every case: the
ops at seq 2 (a (data=2, seq=2) mesh, the data axis replicating) and
seq 4, ring x TP at (seq=2, model=2), the Modules at (data=2, seq=2) and
(seq=2, model=2); then ranks 0 and 1 form a group of 2 at the second
address for the Module at ``MeshConfig(seq=2)``.  The reference's seq 8
is held at 4 here (4 ranks a spawn keep the file inside its time).
What is held:

* ``ring_attention`` (B 2, T 16, 2 heads of 64, and 1 kv-head for
  G = 2), forward and the gradients of ``sum(out * w)``, on both paths:
  ``flash`` (kernels C, D and E through their operators, whose CPU
  implementations are the plain versions) and ``streaming``
  (``use_flash=False``), causal and not, G 1 and 2, at seq 2 and 4,
  against the JAX ``ring_attention`` (its streaming path under
  ``shard_map``) and ``dense_attention``: 1e-5 relative / 1e-6 absolute
  (f32; the same sums in another order); the flash path's two schedules
  ``torch.equal``;
* ``compat.shard_map`` over a ``MeshConfig`` builds its mesh and groups
  once, when it is called, and no more at each call of the mapped
  function;
* ring x TP (4 heads of 64, embed split over model=2 with
  ``head_axis``), both paths, against the JAX ``dense_attention``; the
  indivisible heads and kv-heads raise the reference's ``ValueError``s;
* ``collectives.COUNTS`` of the flash ring at seq 4: per rank n - 1 K and
  V blocks sent forward, n - 1 more and n dK / dV rotations backward, and
  G = 2 half the bytes of G = 1;
* three planted faults fail the parity check: the causal mask at local
  offsets, dK / dV not rotated home, one hop's merge dropped;
* two SGD steps of ``attention_lm`` (T 16, embed 128, 2 heads, 2 layers:
  ``pos_embed_weight`` and the ``NT`` layouts) at the three meshes
  against the JAX mesh ``Module`` (outputs row for row 1e-5 / 1e-6,
  every parameter 1e-5 / 1e-6), ``PATH_TAKEN`` "ring" and ``RING_PATH``
  "flash"; the same with ``MXNET_RING_ATTENTION=0`` (the gathered path,
  ``PATH_TAKEN`` "einsum"); a reduction over T raises.
"""
import functools
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
PROC_TIMEOUT = 240
WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-6)
B, T, HD = 2, 16, 64
OP_CASES = [(seq, causal, groups) for seq in (2, 4) for causal in (False, True)
            for groups in (1, 2)]
PATHS = ("flash", "streaming")
LM = dict(vocab_size=32, seq_len=T, num_layers=2, embed=128, heads=2,
          ffn_hidden=64)
LM_BATCH, LM_LR, LM_STEPS = 4, 0.1, 2
MESHES = {"data2_seq2": dict(data=2, seq=2), "seq2_model2": dict(data=1,
                                                                seq=2,
                                                                model=2),
          "seq2": dict(data=1, seq=2)}
FAULTS = ("local_mask", "not_home", "hop_dropped")


# ---------------------------------------------------------------------------
# data, the same for both packages
# ---------------------------------------------------------------------------

def _op_inputs(heads, kv_heads, seed=0):
    rng = np.random.RandomState(seed)

    def r(e):
        return rng.normal(size=(B, T, e)).astype(np.float32)

    return r(heads * HD), r(kv_heads * HD), r(kv_heads * HD), r(heads * HD)


def _lm_params(sym, **shapes):
    rng = np.random.RandomState(13)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    args = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        vals = rng.normal(0, 0.3 / np.sqrt(max(fan, 1)), shape)
        if name.endswith("gamma"):
            vals = 1.0 + 0.1 * vals
        args[name] = vals.astype(np.float32)
    return args


def _lm_data():
    rng = np.random.RandomState(4)
    x = rng.randint(0, LM["vocab_size"], (LM_BATCH, T)).astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((LM_BATCH, 1), np.float32)],
                       axis=1)
    return x, y


def run_lm(pkg, ctx, mesh_config):
    """Two SGD steps of the LM bound with ``NT`` layouts: (outputs of an
    inference forward after them, parameters)."""
    from importlib import import_module

    sym = import_module(pkg.__name__ + ".models").attention_lm.get_symbol(
        **LM)
    x, y = _lm_data()
    args = _lm_params(sym, data=x.shape, softmax_label=y.shape)
    kw = {} if mesh_config is None else {"mesh_config": mesh_config}
    mod = pkg.mod.Module(sym, context=ctx, **kw)
    mod.bind(data_shapes=[pkg.io.DataDesc("data", x.shape, layout="NT")],
             label_shapes=[pkg.io.DataDesc("softmax_label", y.shape,
                                           layout="NT")])
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in args.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": LM_LR})
    batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
    for _ in range(LM_STEPS):
        mod.forward_backward(batch)
        mod.update()
    mod.forward(batch, is_train=False)
    return (mod.get_outputs()[0].asnumpy(),
            {k: v.asnumpy() for k, v in mod.get_params()[0].items()})


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _ring_run(mt, mesh, heads, kv_heads, causal, path, double_buffer=True,
              spec=(None, "seq", None), head_axis=None, seed=0):
    """The global output and the gradients of sum(out * w) through the ring
    under ``compat.shard_map``, and the path that ran."""
    import torch
    from mxnet_tpu_torch.parallel import compat, ring

    q, k, v, w = (torch.tensor(a) for a in _op_inputs(heads, kv_heads, seed))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    fn = compat.shard_map(
        lambda q_, k_, v_: ring.ring_attention(
            q_, k_, v_, "seq", num_heads=heads, causal=causal,
            num_kv_heads=kv_heads, double_buffer=double_buffer,
            use_flash=path == "flash", head_axis=head_axis),
        mesh, (spec,) * 3, spec)
    out = fn(*leaves)
    taken = ring.RING_PATH["last"]
    (out * w).sum().backward()
    return ([out.detach().numpy()] + [x.grad.numpy() for x in leaves],
            taken)


def _op_cases(mt, res):
    import torch
    from mxnet_tpu_torch.parallel import MeshConfig, build_mesh
    from mxnet_tpu_torch.parallel import collectives as C

    meshes = {2: build_mesh(MeshConfig(data=2, seq=2)),
              4: build_mesh(MeshConfig(data=1, seq=4))}
    for seq, causal, groups in OP_CASES:
        for path in PATHS:
            got, taken = _ring_run(mt, meshes[seq], 2, 2 // groups, causal,
                                   path)
            case = res[("op", seq, causal, groups, path)] = {
                "got": got, "path": taken}
            if path == "flash":
                serial, _ = _ring_run(mt, meshes[seq], 2, 2 // groups,
                                      causal, path, double_buffer=False)
                case["schedules_equal"] = all(
                    np.array_equal(a, b) for a, b in zip(got, serial))
    # the bytes of the flash ring at seq 4: forward, then the whole
    for groups in (1, 2):
        q, k, v, _ = (torch.tensor(a) for a in _op_inputs(2, 2 // groups))
        from mxnet_tpu_torch.parallel import compat, ring

        leaves = [x.requires_grad_() for x in (q, k, v)]
        fn = compat.shard_map(
            lambda q_, k_, v_: ring.ring_attention(
                q_, k_, v_, "seq", num_heads=2, causal=True,
                num_kv_heads=2 // groups),
            meshes[4], ((None, "seq", None),) * 3, (None, "seq", None))
        C.reset_counts()
        out = fn(*leaves)
        fwd = dict(C.COUNTS.get("send", {}))
        out.sum().backward()
        res[("bytes", groups)] = {"fwd": fwd,
                                  "all": dict(C.COUNTS.get("send", {}))}


def _mesh_config_case(mt, res):
    """shard_map over a MeshConfig, its mapped function called twice: the
    process groups created at the shard_map call and at each call."""
    import torch
    import torch.distributed.distributed_c10d as c10d
    from mxnet_tpu_torch.parallel import MeshConfig, compat

    def groups():
        return c10d._world.group_count

    x = torch.arange(2 * T, dtype=torch.float32).reshape(2, T)
    before = groups()
    fn = compat.shard_map(lambda x_: x_ * 2.0, MeshConfig(data=1, seq=4),
                          ((None, "seq"),), (None, "seq"))
    at_map = groups()
    outs = [fn(x), fn(x)]
    res["mesh_config"] = {
        "new_at_map": at_map - before, "new_at_calls": groups() - at_map,
        "right": all(torch.equal(o, x * 2.0) for o in outs)}


def _tp_op_cases(mt, res):
    from mxnet_tpu_torch.parallel import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(data=1, seq=2, model=2))
    spec = (None, "seq", "model")
    for causal in (False, True):
        for path in PATHS:
            got, taken = _ring_run(mt, mesh, 4, 4, causal, path, spec=spec,
                                   head_axis="model")
            res[("tp", causal, path)] = {"got": got, "path": taken}
    for key, heads, kv_heads in (("heads", 3, 3), ("kv_heads", 4, 1)):
        try:
            _ring_run(mt, mesh, heads, kv_heads, True, "streaming",
                      spec=(None, "seq", "model"), head_axis="model")
            res[("tp_raise", key)] = None
        except ValueError as exc:
            res[("tp_raise", key)] = str(exc)


def _fault_cases(mt, res):
    """The flash ring at seq 4, causal, with one planted fault each."""
    from unittest import mock

    from mxnet_tpu_torch.ops import flash_kernel as fl
    from mxnet_tpu_torch.parallel import MeshConfig, build_mesh, ring

    mesh = build_mesh(MeshConfig(data=1, seq=4))
    real_post, real_fwd = ring._post, fl.flash_fwd
    calls = []

    def post_not_home(tensors, ring_, tags):
        # the last dK / dV rotation skipped: the accumulators end a rank
        # short of home
        if tags == ring._tags("dkv", ring_[1] - 1):
            return ring._Done(tensors)
        return real_post(tensors, ring_, tags)

    def fwd_drop_one(q, k, v, scale, causal, groups=1):
        # the second hop's partial reaches the merge with lse -inf
        o, lse = real_fwd(q, k, v, scale, causal, groups)
        calls.append(1)
        if len(calls) == 2:
            lse = lse.new_full(lse.shape, float("-inf"))
        return o, lse

    plants = {
        "local_mask": mock.patch.object(
            ring, "_hop", lambda ring_, hop, causal: "diag" if causal
            else "full"),
        "not_home": mock.patch.object(ring, "_post", post_not_home),
        "hop_dropped": mock.patch.object(fl, "flash_fwd", fwd_drop_one)}
    for name in FAULTS:
        calls.clear()
        with plants[name]:
            got, _ = _ring_run(mt, mesh, 2, 2, True, "flash")
        res[("fault", name)] = got


def _module_cases(mt, res, names):
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.attention import PATH_TAKEN
    from mxnet_tpu_torch.parallel import MeshConfig
    from mxnet_tpu_torch.parallel.ring import RING_PATH

    ctx = mt.cpu()
    for name in names:
        for ring_on in (True, False):
            PATH_TAKEN["last"] = RING_PATH["last"] = None
            with config.overrides(MXNET_RING_ATTENTION=ring_on):
                out, params = run_lm(mt, ctx, MeshConfig(**MESHES[name]))
            res[("module", name, ring_on)] = {
                "out": out, "params": params,
                "path": PATH_TAKEN["last"], "ring_path": RING_PATH["last"]}
    if "data2_seq2" in names:
        sym = mt.sym
        net = sym.Embedding(sym.Variable("data"), input_dim=8, output_dim=4,
                            name="embed")
        net = sym.FullyConnected(sym.sum(net, axis=1), num_hidden=3,
                                 name="fc")
        net = sym.SoftmaxOutput(net, name="softmax")
        mod = mt.mod.Module(net, context=ctx,
                            mesh_config=MeshConfig(**MESHES["data2_seq2"]))
        mod.bind(data_shapes=[mt.io.DataDesc("data", (4, 8), layout="NT")],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(mt.initializer.Xavier())
        try:
            mod.forward(mt.io.DataBatch([mt.nd.zeros((4, 8))],
                                        [mt.nd.zeros((4,))]))
            res["raise_t_sum"] = None
        except MXNetError as exc:
            res["raise_t_sum"] = str(exc)


def _worker_main(argv):
    rank, world, address, address2, outdir = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import launch

    launch.init(address, world, rank, backend="gloo", timeout=120)
    res = {}
    with mt.cpu():
        _op_cases(mt, res)
        _mesh_config_case(mt, res)
        _tp_op_cases(mt, res)
        _fault_cases(mt, res)
        _module_cases(mt, res, ("data2_seq2", "seq2_model2"))
    launch.shutdown()
    if rank < 2:
        # MeshConfig(seq=2) alone: a group of 2
        launch.init(address2, 2, rank, backend="gloo", timeout=120)
        with mt.cpu():
            _module_cases(mt, res, ("seq2",))
        launch.shutdown()
    with open(os.path.join(outdir, "r%d.pkl" % rank), "wb") as f:
        pickle.dump(res, f)
    print("RING_RANK_%d_OK" % rank, flush=True)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_grads(fn, heads, kv_heads, seed=0):
    import jax

    q, k, v, w = _op_inputs(heads, kv_heads, seed)

    def loss(q_, k_, v_):
        return (fn(q_, k_, v_) * w).sum()

    out = np.asarray(fn(q, k, v))
    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    return [out] + [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _jax_dense(heads, kv_heads, causal):
    from mxnet_tpu.parallel.ring import dense_attention

    return _jax_grads(lambda q, k, v: dense_attention(
        q, k, v, num_heads=heads, causal=causal, num_kv_heads=kv_heads),
        heads, kv_heads)


@functools.lru_cache(maxsize=None)
def _jax_ring(seq, heads, kv_heads, causal):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from mxnet_tpu.parallel.compat import shard_map
    from mxnet_tpu.parallel.ring import ring_attention

    if len(jax.devices()) < seq:
        pytest.skip("needs the 8-virtual-device harness")
    mesh = Mesh(np.array(jax.devices()[:seq]), ("seq",))
    spec = P(None, "seq", None)
    fn = jax.jit(shard_map(
        lambda q, k, v: ring_attention(q, k, v, axis_name="seq",
                                       num_heads=heads, causal=causal,
                                       num_kv_heads=kv_heads,
                                       use_flash=False),
        mesh=mesh, in_specs=(spec,) * 3, out_specs=spec))
    return _jax_grads(fn, heads, kv_heads)


def _close_all(got, want, what):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, err_msg="%s %s" % (what, name),
                                   **TOL)


# ---------------------------------------------------------------------------
# the ranks (started first) and the JAX Modules (built while they run)
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("ring"))
    addresses = ["127.0.0.1:%d" % _free_port() for _ in range(2)]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, HERE, str(r), str(WORLD)] + addresses + [outdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True, cwd=ROOT) for r in range(WORLD)]
    yield procs, outdir
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def jax_modules(spawned):
    """The JAX mesh Module's two steps at every mesh (and at (data=2,
    seq=2) with its ring off), computed while the ranks run."""
    import jax

    import mxnet_tpu as mx
    from mxnet_tpu import config as jconfig
    from mxnet_tpu.ops.attention import PATH_TAKEN
    from mxnet_tpu.parallel import MeshConfig

    if len(jax.devices()) < 4:
        pytest.skip("needs the 8-virtual-device harness")
    out = {}
    for name, sizes in MESHES.items():
        n = int(np.prod(list(sizes.values())))
        PATH_TAKEN["last"] = None
        out[name] = run_lm(mx, [mx.cpu(i) for i in range(n)],
                           MeshConfig(**sizes)) + (PATH_TAKEN["last"],)
    os.environ["MXNET_RING_ATTENTION"] = "0"
    jconfig.refresh("MXNET_RING_ATTENTION")
    try:
        PATH_TAKEN["last"] = None
        out["data2_seq2_off"] = run_lm(
            mx, [mx.cpu(i) for i in range(4)],
            MeshConfig(**MESHES["data2_seq2"])) + (PATH_TAKEN["last"],)
    finally:
        del os.environ["MXNET_RING_ATTENTION"]
        jconfig.refresh("MXNET_RING_ATTENTION")
    return out


@pytest.fixture(scope="module")
def ranks(spawned, jax_modules):
    procs, outdir = spawned
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=PROC_TIMEOUT)
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RING_RANK_%d_OK" % r in out, \
            "rank %d:\n%s" % (r, out[-6000:])
    got = []
    for r in range(WORLD):
        with open(os.path.join(outdir, "r%d.pkl" % r), "rb") as f:
            got.append(pickle.load(f))
    return got


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("seq,causal,groups", OP_CASES)
def test_ring_matches_jax_ring_and_dense(ranks, seq, causal, groups, path):
    """Forward and gradients of both paths against the JAX ring (its
    streaming path) and dense attention, on every rank; the path that
    ran is the one asked for."""
    kv_heads = 2 // groups
    want_ring = _jax_ring(seq, 2, kv_heads, causal)
    want_dense = _jax_dense(2, kv_heads, causal)
    for r, res in enumerate(ranks):
        case = res[("op", seq, causal, groups, path)]
        assert case["path"] == path
        what = "rank %d seq %d causal %s G %d %s" % (r, seq, causal, groups,
                                                     path)
        _close_all(case["got"], want_ring, what + " vs JAX ring")
        _close_all(case["got"], want_dense, what + " vs JAX dense")


@pytest.mark.parametrize("seq", (2, 4))
def test_schedules_bit_identical(ranks, seq):
    """The flash path's serial and double-buffered rings: equal outputs
    and gradients (the streaming path has one schedule)."""
    for res in ranks:
        for seq_, causal, groups in OP_CASES:
            if seq_ == seq:
                assert res[("op", seq, causal, groups, "flash")][
                    "schedules_equal"]


def test_shard_map_over_a_mesh_config_builds_its_groups_once(ranks):
    """The mesh's groups come at the shard_map call (one a mesh dim of
    more than one rank); calling the mapped function again makes none."""
    for res in ranks:
        got = res["mesh_config"]
        assert got["right"]
        assert got["new_at_calls"] == 0, got
        assert got["new_at_map"] >= 1, got


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_tp_matches_jax_dense(ranks, causal, path):
    """Ring x TP on (seq=2, model=2): each model rank rotates its own two
    heads' K/V; the whole against the JAX dense attention."""
    want = _jax_dense(4, 4, causal)
    for r, res in enumerate(ranks):
        case = res[("tp", causal, path)]
        assert case["path"] == path
        _close_all(case["got"], want, "rank %d ring x TP causal %s %s"
                   % (r, causal, path))


def test_ring_tp_indivisible_heads_raise(ranks):
    for res in ranks:
        assert "num_heads=3 not divisible by 'model' axis size 2" \
            in res[("tp_raise", "heads")]
        assert "num_kv_heads=1 not divisible by 'model' axis size 2" \
            in res[("tp_raise", "kv_heads")]


def test_ring_without_an_axis_raises():
    import torch

    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel.ring import ring_attention

    x = torch.zeros(1, 4, 8)
    with pytest.raises(MXNetError, match="mesh axis 'seq' is not bound"):
        ring_attention(x, x, x, "seq")


def test_flash_ring_send_bytes(ranks):
    """Per rank at seq 4: n - 1 K and n - 1 V blocks forward; n - 1 of each
    again and n dK and n dV rotations (f32, as K / V here) backward; the
    grouped ring moves half the bytes."""
    n, t_local = 4, T // 4
    for res in ranks:
        for groups in (1, 2):
            block = B * (2 // groups) * t_local * HD * 4
            got = res[("bytes", groups)]
            assert got["fwd"] == {"calls": 2 * (n - 1),
                                  "bytes": 2 * (n - 1) * block,
                                  "s": got["fwd"]["s"]}
            assert got["all"]["calls"] == 4 * (n - 1) + 2 * n
            assert got["all"]["bytes"] == (4 * (n - 1) + 2 * n) * block
        assert res[("bytes", 2)]["all"]["bytes"] * 2 \
            == res[("bytes", 1)]["all"]["bytes"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_parity_check(ranks, fault):
    """Each planted fault makes the check that passes on the tree fail:
    the causal mask at local offsets (every hop's block masked as the
    diagonal), the dK / dV accumulators not rotated home (the last
    rotation skipped), one hop's partial dropped from the merge."""
    want = _jax_dense(2, 2, True)
    for res in ranks:
        with pytest.raises(AssertionError):
            _close_all(res[("fault", fault)], want, fault)


# ---------------------------------------------------------------------------
# the Module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring_on", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_module_two_steps_match_jax_mesh_module(ranks, jax_modules, mesh,
                                                ring_on):
    """Two SGD steps of the LM over the seq axis: outputs row for row
    (gathered over seq along T, then over data) and every parameter
    against the JAX mesh Module; the ring ran (kernels C-E's structure),
    or with the knob off the gathered path."""
    out, params, jax_path = jax_modules[mesh]
    assert jax_path == "ring"
    for r, res in enumerate(ranks):
        if ("module", mesh, ring_on) not in res:
            continue            # seq2 runs on ranks 0 and 1
        got = res[("module", mesh, ring_on)]
        if ring_on:
            assert (got["path"], got["ring_path"]) == ("ring", "flash")
        else:
            assert (got["path"], got["ring_path"]) == ("einsum", None)
        np.testing.assert_allclose(got["out"], out,
                                   err_msg="rank %d outputs" % r, **TOL)
        assert sorted(got["params"]) == sorted(params)
        for name, w in params.items():
            np.testing.assert_allclose(got["params"][name], w,
                                       err_msg="rank %d %s" % (r, name),
                                       **TOL)


def test_module_gathered_path_matches_jax_einsum(ranks, jax_modules):
    """The knob off on both sides: the port's gathered path against the
    reference's GSPMD einsum."""
    out, params, jax_path = jax_modules["data2_seq2_off"]
    assert jax_path == "einsum"
    for res in ranks:
        got = res[("module", "data2_seq2", False)]
        np.testing.assert_allclose(got["out"], out, **TOL)
        for name, w in params.items():
            np.testing.assert_allclose(got["params"][name], w, err_msg=name,
                                       **TOL)


def test_reduction_over_t_raises(ranks):
    for res in ranks:
        msg = res["raise_t_sum"]
        assert msg is not None and "reduces over the sequence dim" in msg \
            and "seq axis of 2" in msg, msg


if __name__ == "__main__":
    _worker_main(sys.argv[1:])

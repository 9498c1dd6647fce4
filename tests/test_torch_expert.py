"""Expert parallelism through the port: ``ops/moe.py``'s sharded
all-to-all over an expert group, the ``expert`` axis of a mesh
``Module`` and of a mesh ``DecodePredictor``, over gloo ranks on the
CPU, against the JAX package's sharded path, mesh ``Module`` and mesh
``DecodePredictor`` on its 8-virtual-device harness
(``tests/test_moe.py``'s cases).

This file is its own worker: ``python tests/test_torch_expert.py mesh
<rank> 4 <host:port> <host:port2> <outdir>`` runs one rank (it imports
only PyTorch and the port) and writes what it computed to
``<outdir>/mesh_r<rank>.pkl`` (``data <rank> 2 ...``: the data-axis
case).  One spawn of 4 ranks serves every case: the
op at ``expert`` 4, ``data 2 x expert 2`` and ``expert 2 x model 2``;
the Modules at the last two; then ranks 0 and 1 form a group of 2 at
the second address for the op and the Module at ``expert`` 2 and the
predictor.  The reference's 8-device meshes are held at 4 ranks here
(``(data=2, expert=4)`` at ``(data=2, expert=2)``, ``(data=2, expert=2,
model=2)`` at its two 4-rank faces), so a spawn stays inside its time.
What is held, at the reference's tolerances (outputs rtol 1e-4 / atol
1e-5, gradients rtol 1e-3 / atol 1e-4, ``tests/test_moe.py``):

* the op's output, drop set (rows all zero), aux term and six
  gradients against ``_moe_forward_sparse_sharded`` (top-1 and top-2,
  dropless, ``MXNET_MOE_DISPATCH`` sort and onehot), against the
  reference's sparse path over the global batch where the sharded
  guards fail (6 experts over 4 ranks; 30 tokens over 4), and against
  ``_moe_forward`` for the dense oracle, each under a JAX mesh of the
  same axes; ``MOE_PATH`` and ``MOE_DEGRADE``; 2 exchanges a forward
  and 6 a training step (``collectives.COUNTS["all_to_all"]``);
* ``Module`` over ``MeshConfig(data=2, expert=2)`` and ``(expert=2,
  model=2)``: the reference's three test nets (outputs, every
  gradient, the input gradient, the stacks' coverage records) and one
  SGD step of the tiny MoE LM (vocab 32, T 16, embed 16, 4 heads, FFN
  32, 4 experts, top-2, capacity factor 1.25: outputs and every
  parameter) against the JAX mesh ``Module``; at ``MeshConfig(expert=2)``
  the LM step too;
* ``DecodePredictor(mesh=MeshConfig(expert=2))``: the tiny MoE LM's
  greedy tokens through a paged ``DecodeServer`` equal the JAX mesh
  predictor's on every rank.

The data-axis case runs in a spawn of its own (2 ranks): a sparse MoE
net through ``Module(mesh_config=MeshConfig(data=2))`` with capacity
binding, held to the JAX ``Module`` on a 2-device data mesh, which routes
the global batch with one capacity quota and takes f and P over all of
it.
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
TOL_OUT = dict(rtol=1e-4, atol=1e-5)
TOL_GRAD = dict(rtol=1e-3, atol=1e-4)
# the op: N tokens of width D, E experts of hidden H, the aux weight
N, D, E, H, COEFF = 32, 8, 4, 12, 0.5
# (name, k, cf, dropless, dispatch, experts, tokens)
OP_CASES = {
    "top2": (2, 0.75, False, "sort", E, N),
    "top1": (1, 0.75, False, "sort", E, N),
    "dropless": (2, 0.75, True, "sort", E, N),
    "onehot": (2, 0.75, False, "onehot", E, N),
    # the guards fail: one quota over the whole batch (a tighter cf so
    # rows still drop)
    "few_experts": (2, 0.25, False, "sort", 6, N),
    "few_tokens": (2, 0.25, False, "sort", E, 30),
    "dense": (2, 0.0, False, "sort", E, N),
}
# mesh -> (sizes, the op cases run there)
OP_MESHES = {
    "e4": (dict(data=1, expert=4), ("top2", "top1", "onehot", "few_experts",
                                    "dense")),
    "d2e2": (dict(data=2, expert=2), ("top2", "dropless", "few_tokens",
                                      "dense")),
    "e2m2": (dict(data=1, expert=2, model=2), ("top2", "top1", "dense")),
    "e2": (dict(data=1, expert=2), ("top2", "dropless", "onehot",
                                    "dense")),
}
MODULE_MESHES = {"d2e2": dict(data=2, expert=2),
                 "e2m2": dict(data=1, expert=2, model=2)}
LM = dict(vocab_size=32, seq_len=16, num_layers=1, embed=16, heads=4,
          ffn_hidden=32, moe_experts=4, moe_top_k=2,
          moe_capacity_factor=1.25)
LM_BATCH, LM_LR = 4, 0.1
SERVE_LM = dict(vocab_size=17, seq_len=16, num_layers=2, embed=16, heads=2,
                ffn_hidden=16, moe_experts=4, moe_top_k=2,
                moe_capacity_factor=1.25)
PARAM_NAMES = ["moe_gate_weight", "moe_expert1_weight", "moe_expert1_bias",
               "moe_expert2_weight", "moe_expert2_bias"]


# ---------------------------------------------------------------------------
# data, the same for both packages
# ---------------------------------------------------------------------------

def _op_inputs(e, n, seed=11):
    rng = np.random.RandomState(seed)
    arrs = [rng.normal(size=(n, D)), rng.normal(0, 0.5, (D, e)),
            rng.normal(0, 0.5, (e, D, H)), rng.normal(0, 0.1, (e, H)),
            rng.normal(0, 0.5, (e, H, D)), rng.normal(0, 0.1, (e, D))]
    dy = rng.normal(size=(n, D))
    return [a.astype(np.float32) for a in arrs], dy.astype(np.float32)


def _net(sym, name):
    """The reference's test nets: ``dense`` (tests/test_moe.py:133),
    ``sparse_fc`` (:424) and ``composed`` (:341)."""
    data = sym.Variable("data")
    if name == "composed":
        # capacity factor 0.25 (the reference's 0.75 drops no whole row
        # here when the 32 tokens form one or two quotas)
        return sym.MoEFFN(data, num_experts=E, hidden_size=H,
                          capacity_factor=0.25, num_experts_per_tok=2,
                          aux_loss_coeff=COEFF, name="moe")
    kw = {"capacity_factor": float(E)} if name == "sparse_fc" else {}
    net = sym.MoEFFN(data, num_experts=E, hidden_size=H, name="moe", **kw)
    net = sym.FullyConnected(net, num_hidden=3, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


def _net_params(name):
    arrs, _ = _op_inputs(E, N, seed=2)
    out = dict(zip(PARAM_NAMES, arrs[1:]))
    if not name == "composed":
        rng = np.random.RandomState(3)
        out["fc_weight"] = rng.normal(0, 0.4, (3, D)).astype(np.float32)
        out["fc_bias"] = rng.normal(0, 0.1, (3,)).astype(np.float32)
    return out


def _net_batch():
    rng = np.random.RandomState(5)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.randint(0, 3, size=(N,)).astype(np.float32))


def run_net(pkg, ctx, mesh_config, name):
    """One forward / backward of a test net: (outputs, the parameters'
    gradients, the input gradient)."""
    x, y = _net_batch()
    kw = {"mesh_config": mesh_config} if mesh_config is not None else {}
    if pkg.__name__ == "mxnet_tpu":
        kw["compute_dtype"] = "float32"
    composed = name == "composed"
    mod = pkg.mod.Module(_net(pkg.sym, name), context=ctx,
                         label_names=() if composed
                         else ("softmax_label",), **kw)
    labels = [] if composed else [("softmax_label", (N,))]
    mod.bind(data_shapes=[("data", (N, D))], label_shapes=labels or None,
             for_training=True, inputs_need_grad=True)
    mod.init_params(arg_params={k: pkg.nd.array(v)
                                for k, v in _net_params(name).items()})
    batch = pkg.io.DataBatch([pkg.nd.array(x)],
                             [] if composed else [pkg.nd.array(y)])
    mod.forward(batch, is_train=True)
    out = mod.get_outputs()[0].asnumpy()
    if composed:
        head = pkg.nd.ones((N, D))
        if pkg.__name__ == "mxnet_tpu" and mesh_config is not None:
            mod._exec_group._place(head, sharded=True)   # on the mesh
        mod.backward(out_grads=[head])
    else:
        mod.backward()
    group = mod._exec_group
    grads = {n: _full_grad(pkg, mod, n, g) for n, g in
             zip(group.param_names, group.grad_arrays) if g is not None}
    return out, grads, mod.get_input_grads()[0].asnumpy()


def _full_grad(pkg, mod, name, g):
    """A gradient whole (an expert stack's blocks gathered in the port)."""
    tp = getattr(mod._exec_group, "tp", None)
    if pkg.__name__ == "mxnet_tpu" or tp is None:
        return np.asarray(g.asnumpy())
    return tp.unshard(name, g.data).numpy()


def _lm_params(sym, batch):
    rng = np.random.RandomState(13)
    shapes, _, _ = sym.infer_shape(data=(batch, LM["seq_len"]),
                                   softmax_label=(batch, LM["seq_len"]))
    out = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        vals = rng.normal(0, 0.5 / np.sqrt(max(fan, 1)), shape)
        if name.endswith("gamma"):
            vals = 1.0 + 0.1 * vals
        out[name] = vals.astype(np.float32)
    return out


def _lm_data():
    rng = np.random.RandomState(4)
    x = rng.randint(0, LM["vocab_size"], (LM_BATCH, LM["seq_len"])) \
        .astype(np.float32)
    y = np.concatenate([x[:, 1:], np.zeros((LM_BATCH, 1), np.float32)],
                       axis=1)
    return x, y


def run_lm(pkg, ctx, mesh_config):
    """One SGD step of the tiny MoE LM: (the outputs of the step's
    forward, the parameters after it)."""
    from importlib import import_module

    with pkg.NameManager() if hasattr(pkg, "NameManager") \
            else pkg.base.NameManager():
        sym = import_module(pkg.__name__ + ".models").attention_lm \
            .get_symbol(**LM)
    x, y = _lm_data()
    kw = {"mesh_config": mesh_config} if mesh_config is not None else {}
    if pkg.__name__ == "mxnet_tpu":
        kw["compute_dtype"] = "float32"
    mod = pkg.mod.Module(sym, context=ctx, **kw)
    mod.bind(data_shapes=[pkg.io.DataDesc("data", x.shape, layout="NT")],
             label_shapes=[pkg.io.DataDesc("softmax_label", y.shape,
                                           layout="NT")])
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in
                                _lm_params(sym, LM_BATCH).items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": LM_LR})
    mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(x)],
                                          [pkg.nd.array(y)]))
    out = mod.get_outputs()[0].asnumpy()
    mod.update()
    return out, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _serve_prompts():
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, SERVE_LM["vocab_size"], 7)
    return [np.concatenate([prefix, rng.randint(0, SERVE_LM["vocab_size"],
                                                n)]) for n in (2, 5, 3)] \
        + [rng.randint(0, SERVE_LM["vocab_size"], 6)]


def _serve_params(sym):
    rng = np.random.RandomState(0)
    shapes, _, _ = sym.infer_shape(data=(2, 16), softmax_label=(2, 16))
    return {n: rng.normal(0, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


SERVE_KW = dict(paged=True, page_tokens=4, prefill_chunk=4, kv_dtype="int8")


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _op_run(name, mesh, coeff=COEFF):
    """The port's op on ``mesh`` (global arrays on every rank): y, aux,
    the gradients of sum(y * dy) + coeff * aux, the path, the degrade
    record and the exchange counts (forward, then the whole step through
    ``MoEFn``)."""
    import torch
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.ops import moe
    from mxnet_tpu_torch.parallel import collectives as C

    k, cf, dropless, algo, e, n = OP_CASES[name]
    arrs, dy = _op_inputs(e, n)
    mm = moe.MoEMesh.of(mesh)
    with config.overrides(MXNET_MOE_DISPATCH=algo):
        fwd = moe._forward_impl(e, cf, k, dropless, mm)
        leaves = [torch.tensor(a).requires_grad_() for a in arrs]
        y, aux = fwd(*leaves)
        path = moe.MOE_PATH["last"]
        degrade = moe.MOE_DEGRADE["last"]
        ((y * torch.tensor(dy)).sum() + coeff * aux).backward()
        got = [y.detach().numpy(), float(aux)] \
            + [t.grad.numpy() for t in leaves]
        # the exchanges of one forward and of a training step (MoEFn)
        leaves = [torch.tensor(a).requires_grad_() for a in arrs]
        C.reset_counts()
        out = moe.MoEFn.apply(fwd, coeff, *leaves)
        fwd_calls = dict(C.COUNTS.get("all_to_all", {"calls": 0}))
        out.backward(torch.tensor(dy))
        step_calls = dict(C.COUNTS.get("all_to_all", {"calls": 0}))
        dispatch = moe.MOE_DISPATCH["last"]
    return {"got": got, "path": path, "degrade": degrade,
            "dispatch": dispatch, "fwd": fwd_calls, "step": step_calls}


def _op_cases(res, names):
    from mxnet_tpu_torch.parallel import MeshConfig, build_mesh

    for name in names:
        sizes, cases = OP_MESHES[name]
        mesh = build_mesh(MeshConfig(**sizes))
        for case in cases:
            res[("op", name, case)] = _op_run(case, mesh)


def _module_cases(mt, res, names, nets=True):
    from mxnet_tpu_torch.ops import moe
    from mxnet_tpu_torch.parallel import MeshConfig

    ctx = mt.cpu()
    for name in names:
        mc = MeshConfig(**MODULE_MESHES.get(name, OP_MESHES[name][0]))
        if nets:
            for net in ("dense", "sparse_fc", "composed"):
                moe.MOE_PATH["last"] = None
                out, grads, dx = run_net(mt, ctx, mc, net)
                res[("net", name, net)] = {
                    "out": out, "grads": grads, "dx": dx,
                    "path": moe.MOE_PATH["last"]}
            mod = mt.mod.Module(_net(mt.sym, "composed"), context=ctx,
                                label_names=(), mesh_config=mc)
            mod.bind(data_shapes=[("data", (N, D))], label_shapes=None)
            res[("coverage", name)] = {
                "record": mod._exec_group.tp.coverage_record(),
                "local": {n: list(mod._exec_group.exec_.arg_dict[n].shape)
                          for n in PARAM_NAMES}}
        moe.MOE_PATH["last"] = None
        out, params = run_lm(mt, ctx, mc)
        res[("lm", name)] = {"out": out, "params": params,
                             "path": moe.MOE_PATH["last"]}


def _serve_case(mt, res):
    from mxnet_tpu_torch.models import attention_lm
    from mxnet_tpu_torch.ops import moe
    from mxnet_tpu_torch.parallel import MeshConfig

    with mt.NameManager():
        sym = attention_lm.get_symbol(**SERVE_LM)
    pred = mt.decode.DecodePredictor(
        sym, _serve_params(sym), cache_len=16, device="cpu",
        mesh=MeshConfig(data=1, expert=2), **SERVE_KW)
    srv = mt.decode.DecodeServer(pred, 12, slots=2, max_new_tokens=6)
    ids = [srv.submit(p) for p in _serve_prompts()]
    moe.MOE_PATH["last"] = None
    out = srv.run()
    res["serve"] = {"tokens": [np.asarray(out[i]).tolist() for i in ids],
                    "path": moe.MOE_PATH["last"],
                    "coverage": pred._sharding_coverage}


def _data_case(mt, res):
    """The data-axis case: the sparse test net at MeshConfig(data=2)."""
    from mxnet_tpu_torch.ops import moe
    from mxnet_tpu_torch.parallel import MeshConfig

    moe.MOE_PATH["last"] = None
    out, grads, dx = run_net(mt, mt.cpu(), MeshConfig(data=2), "composed")
    res["data2"] = {"out": out, "grads": grads, "dx": dx,
                    "path": moe.MOE_PATH["last"]}


def _worker_main(argv):
    mode, rank, world, address, address2, outdir = argv
    rank, world = int(rank), int(world)
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel import launch

    res = {}
    if mode == "data":
        launch.init(address, world, rank, backend="gloo", timeout=120)
        with mt.cpu():
            _data_case(mt, res)
        launch.shutdown()
    else:
        launch.init(address, world, rank, backend="gloo", timeout=120)
        with mt.cpu():
            _op_cases(res, ("e4", "d2e2", "e2m2"))
            _module_cases(mt, res, ("d2e2", "e2m2"))
        launch.shutdown()
        if rank < 2:
            launch.init(address2, 2, rank, backend="gloo", timeout=120)
            with mt.cpu():
                _op_cases(res, ("e2",))
                _module_cases(mt, res, ("e2",), nets=False)
                _serve_case(mt, res)
            launch.shutdown()
    with open(os.path.join(outdir, "%s_r%d.pkl" % (mode, rank)), "wb") as f:
        pickle.dump(res, f)
    print("EXPERT_RANK_%d_OK" % rank, flush=True)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_mesh(sizes):
    import jax
    from jax.sharding import Mesh

    names = tuple(a for a in ("data", "expert", "model")
                  if sizes.get(a, 1) > 1)
    shape = tuple(sizes[a] for a in names)
    n = int(np.prod(shape))
    if len(jax.devices()) < n:
        pytest.skip("needs the 8-virtual-device harness")
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


@functools.lru_cache(maxsize=None)
def _jax_op(mesh_name, name):
    """The reference on the same inputs: the sharded path (its guards
    holding), the sparse path over the global batch (failing), the
    dense oracle; y, aux and the gradients of sum(y * dy) + coeff * aux,
    and whether the guards held."""
    import jax
    import jax.numpy as jnp

    from mxnet_tpu import config as jconfig
    from mxnet_tpu.ops import moe as jmoe

    k, cf, dropless, algo, e, n = OP_CASES[name]
    arrs, dy = _op_inputs(e, n)
    mesh = _jax_mesh(OP_MESHES[mesh_name][0])
    sharded = bool(cf) and jmoe._sharded_ok(arrs[0], e, mesh)

    def fn(*a):
        if not cf:
            return jmoe._moe_forward(*a, e, num_experts_per_tok=k)
        if sharded:
            return jmoe._moe_forward_sparse_sharded(
                *a, e, cf, mesh, num_experts_per_tok=k, dropless=dropless)
        return jmoe._moe_forward_sparse(*a, e, cf, mesh,
                                        num_experts_per_tok=k,
                                        dropless=dropless)

    def loss(*a):
        y, aux = fn(*a)
        return (y * dy).sum() + COEFF * aux

    with jconfig.overrides(MXNET_MOE_DISPATCH=algo):
        y, aux = jax.jit(fn)(*arrs)
        grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*arrs)
    return ([np.asarray(y), float(aux)] + [np.asarray(g) for g in grads],
            sharded)


def _jax_run(kind, sizes, name=None):
    import jax

    import mxnet_tpu as mx
    from mxnet_tpu.parallel import MeshConfig

    n = int(np.prod(list(sizes.values())))
    if len(jax.devices()) < n:
        pytest.skip("needs the 8-virtual-device harness")
    ctx = [mx.cpu(i) for i in range(n)]
    if kind == "net":
        return run_net(mx, ctx, MeshConfig(**sizes), name)
    return run_lm(mx, ctx, MeshConfig(**sizes))


@pytest.fixture(scope="module")
def jax_side(spawned):
    """The JAX package's results, computed while the ranks run."""
    from mxnet_tpu.ops import moe as jmoe

    out = {}
    for mesh_name, (sizes, cases) in OP_MESHES.items():
        for case in cases:
            out[("op", mesh_name, case)] = _jax_op(mesh_name, case)
    for name in ("d2e2", "e2m2"):
        for net in ("dense", "sparse_fc", "composed"):
            jmoe.MOE_PATH["last"] = None
            got = _jax_run("net", MODULE_MESHES[name], net)
            out[("net", name, net)] = got + (jmoe.MOE_PATH["last"],)
    for name, sizes in list(MODULE_MESHES.items()) + [
            ("e2", OP_MESHES["e2"][0])]:
        out[("lm", name)] = _jax_run("lm", sizes)
    return out


def _jax_serve_tokens():
    import jax

    import mxnet_tpu as mx
    from mxnet_tpu.decode import DecodePredictor, DecodeServer
    from mxnet_tpu.models import attention_lm
    from mxnet_tpu.parallel import MeshConfig, build_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs the 8-virtual-device harness")
    with mx.base.NameManager():
        sym = attention_lm.get_symbol(**SERVE_LM)
    mesh = build_mesh(MeshConfig(data=1, expert=2),
                      devices=jax.devices()[:2])
    srv = DecodeServer(DecodePredictor(sym, _serve_params(sym),
                                       cache_len=16, mesh=mesh, **SERVE_KW),
                       12, slots=2, max_new_tokens=6)
    ids = [srv.submit(p) for p in _serve_prompts()]
    out = srv.run()
    return [np.asarray(out[i]).tolist() for i in ids]


# ---------------------------------------------------------------------------
# the ranks (started first)
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(mode, world, outdir):
    addresses = ["127.0.0.1:%d" % _free_port() for _ in range(2)]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, HERE, mode, str(r), str(world)] + addresses
        + [outdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True, cwd=ROOT) for r in range(world)]


def _collect(procs, mode, outdir):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "EXPERT_RANK_%d_OK" % r in out, \
            "rank %d:\n%s" % (r, out[-6000:])
    got = []
    for r in range(len(procs)):
        with open(os.path.join(outdir, "%s_r%d.pkl" % (mode, r)), "rb") as f:
            got.append(pickle.load(f))
    return got


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("expert"))
    procs = _spawn("mesh", WORLD, outdir)
    yield procs, outdir
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def ranks(spawned, jax_side):
    procs, outdir = spawned
    return _collect(procs, "mesh", outdir)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **tol)


def _drops(y):
    return (np.asarray(y) == 0).all(-1)


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

OP_PARAMS = [(m, c) for m, (_, cases) in OP_MESHES.items() for c in cases]


@pytest.mark.parametrize("mesh,case", OP_PARAMS)
def test_op_matches_jax_sharded_path(ranks, jax_side, mesh, case):
    """Output, drop set, aux and the six gradients against the
    reference's path for the case (the sharded all-to-all where its
    guards hold), on every rank; the path, the degrade record and the
    dispatch knob."""
    want, sharded = jax_side[("op", mesh, case)]
    k, cf, dropless, algo, e, n = OP_CASES[case]
    names = ["y", "aux", "d_data"] + ["d_" + p[4:] for p in PARAM_NAMES]
    for r, rk in enumerate(ranks):
        got = rk.get(("op", mesh, case))
        if got is None:
            assert mesh == "e2" and r >= 2
            continue
        what = "rank %d %s %s" % (r, mesh, case)
        want_path = "dense" if not cf else "sparse_a2a" if sharded \
            else "sparse"
        assert got["path"] == want_path, (what, got["path"])
        if cf:
            assert got["dispatch"] == algo
            assert (got["degrade"] is None) == sharded, got["degrade"]
        assert np.array_equal(_drops(got["got"][0]), _drops(want[0])), what
        if cf and not dropless:
            assert _drops(want[0]).sum() > 0, "capacity never bound"
        if dropless:
            assert _drops(want[0]).sum() == 0
        for i, (nm, a, b) in enumerate(zip(names, got["got"], want)):
            _close(a, b, TOL_OUT if i < 2 else TOL_GRAD,
                   "%s %s" % (what, nm))
        fwd = got["fwd"]["calls"]
        step = got["step"]["calls"]
        assert (fwd, step) == ((2, 6) if want_path == "sparse_a2a"
                               else (0, 0)), (what, fwd, step)


def test_degrade_records_name_the_guard(ranks):
    rk = ranks[0]
    assert "6 experts do not divide the expert axis of 4" \
        in rk[("op", "e4", "few_experts")]["degrade"]
    assert "30 tokens do not divide data x expert = 4" \
        in rk[("op", "d2e2", "few_tokens")]["degrade"]


def test_exchange_bytes(ranks):
    """At expert 4 top-2 each exchange moves the (E, C_loc, d) table:
    C_loc = ceil(0.75 * 2 * 8 / 4) = 3 slots, f32."""
    got = ranks[0][("op", "e4", "top2")]
    table = E * 3 * D * 4
    assert got["fwd"]["bytes"] == 2 * table
    assert got["step"]["bytes"] == 6 * table


def test_all_to_all_over_one_rank_is_the_identity():
    """One process: the identity for a group of one (no count)."""
    import torch

    from mxnet_tpu_torch.parallel import collectives as C

    C.reset_counts()
    x = torch.arange(12.0).reshape(3, 4)
    assert C.all_to_all(x, 0, 1, None) is x
    assert "all_to_all" not in C.COUNTS


# ---------------------------------------------------------------------------
# the Module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["dense", "sparse_fc", "composed"])
@pytest.mark.parametrize("mesh", list(MODULE_MESHES))
def test_module_nets_match_jax_mesh_module(ranks, jax_side, mesh, net):
    """The reference's test nets through the mesh Module (8 devices
    there, 4 ranks here): outputs, every gradient (an expert stack's
    blocks gathered) and the input gradient; the composed net's drop
    set and path."""
    out, grads, dx, path = jax_side[("net", mesh, net)]
    want_path = "dense" if net == "dense" else "sparse_a2a"
    assert path == want_path
    for r, rk in enumerate(ranks):
        got = rk[("net", mesh, net)]
        what = "rank %d %s %s" % (r, mesh, net)
        assert got["path"] == want_path, what
        _close(got["out"], out, TOL_OUT, what + " out")
        if net == "composed":
            assert _drops(out).sum() > 0
            assert np.array_equal(_drops(got["out"]), _drops(out))
        assert sorted(got["grads"]) == sorted(grads)
        for name, g in grads.items():
            _close(got["grads"][name], g, TOL_GRAD, what + " " + name)
        _close(got["dx"], dx, TOL_GRAD, what + " d_data")


@pytest.mark.parametrize("mesh", list(MODULE_MESHES))
def test_expert_stacks_shard_on_the_expert_axis(ranks, mesh):
    """The coverage records (the reference's ``_param_sharding``) and the
    local shapes: the stacks split on dim 0 over expert, the router
    whole."""
    for rk in ranks:
        got = rk[("coverage", mesh)]
        leaves = got["record"]["leaves"]
        assert got["record"]["mesh"]["expert"] == 2
        for name in PARAM_NAMES[1:]:
            assert leaves[name]["source"] == "mesh_axes"
            assert leaves[name]["spec"][0] == "expert"
            assert got["local"][name][0] == E // 2
        assert got["local"]["moe_gate_weight"] == [D, E]


@pytest.mark.parametrize("mesh", ["d2e2", "e2m2", "e2"])
def test_moe_lm_step_matches_jax_mesh_module(ranks, jax_side, mesh):
    """One SGD step of the tiny MoE LM: the step's outputs and every
    parameter after it against the JAX mesh Module, on every rank."""
    out, params = jax_side[("lm", mesh)]
    for r, rk in enumerate(ranks):
        if ("lm", mesh) not in rk:
            assert mesh == "e2" and r >= 2
            continue
        got = rk[("lm", mesh)]
        assert got["path"] == "sparse_a2a"
        _close(got["out"], out, TOL_OUT, "rank %d %s out" % (r, mesh))
        assert sorted(got["params"]) == sorted(params)
        for name, w in params.items():
            _close(got["params"][name], w, TOL_OUT,
                   "rank %d %s %s" % (r, mesh, name))


# ---------------------------------------------------------------------------
# the predictor
# ---------------------------------------------------------------------------

def test_predictor_over_an_expert_axis_matches_jax(ranks):
    """Greedy tokens of the tiny MoE LM through a paged DecodeServer over
    ``DecodePredictor(mesh=MeshConfig(expert=2))``: the same on both
    ranks and equal to the JAX mesh predictor's; the sharded path ran;
    the expert stacks stay whole (the reference's predictor)."""
    want = _jax_serve_tokens()
    for rk in ranks[:2]:
        got = rk["serve"]
        assert got["path"] == "sparse_a2a"
        assert got["tokens"] == want
        leaves = got["coverage"]["leaves"]
        assert "spec" not in leaves["layer0_moe_expert1_weight"]


# ---------------------------------------------------------------------------
# the data axis
# ---------------------------------------------------------------------------

def test_data_axis_routes_the_global_batch(tmp_path):
    """A sparse MoE net through ``Module(mesh_config=MeshConfig(data=2))``
    with capacity binding: outputs, drop set, the router's and every
    gradient (the balance term's counted once over the data group) and
    the input gradient equal the JAX Module's on a 2-device data mesh,
    which routes the global batch with one quota."""
    procs = _spawn("data", 2, str(tmp_path))
    from mxnet_tpu.ops import moe as jmoe

    jmoe.MOE_PATH["last"] = None
    out, grads, dx = _jax_run("net", dict(data=2), "composed")
    assert jmoe.MOE_PATH["last"] == "sparse"
    assert _drops(out).sum() > 0
    for r, rk in enumerate(_collect(procs, "data", str(tmp_path))):
        got = rk["data2"]
        what = "rank %d" % r
        assert got["path"] == "sparse"
        assert np.array_equal(_drops(got["out"]), _drops(out)), what
        _close(got["out"], out, TOL_OUT, what + " out")
        for name, g in grads.items():
            _close(got["grads"][name], g, TOL_GRAD, what + " " + name)
        _close(got["dx"], dx, TOL_GRAD, what + " d_data")


if __name__ == "__main__":
    _worker_main(sys.argv[1:])

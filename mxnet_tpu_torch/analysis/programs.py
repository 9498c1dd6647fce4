"""The canonical programs the lint audits (the port of
``mxnet_tpu/analysis/programs.py``), each driven as the reference drives
it, at the reference's dims, on ``device`` (the card by default):

* ``train_step`` / ``eval_step`` — a bfloat16-compute MLP classifier's
  captured step (SGD-momentum: the slab plan armed, so kernel B1's
  operator is promised) and its eval program;
* ``prefill`` / ``decode_step`` — the dense attention LM's prefill and
  one-token decode step;
* ``decode_step_q`` / ``draft_step`` / ``verify_step`` — the int8
  target, the draft model and the verify step of a real mixed-length
  speculative serve;
* ``paged_decode_step`` / ``paged_verify_step`` — the paged programs of
  a real shared-prefix paged serve (kernel B's operator promised);
* ``gqa_decode_step`` — the paged decode step under a grouped layout;
* ``ckpt_train_step`` — the step of a real ``fit`` under async fenced
  checkpointing;
* ``ring_tp_step`` / ``moe_train_step`` — the meshed programs: the port
  has no mesh yet (ROADMAP queue A item 7), so their availability
  returns a note and a report shows the gap.

Every program is driven at least twice at identical shapes before its
artifact is taken, so the retrace pass checks that the second call
reused the first capture.  Each artifact is a trace on fake tensors:
the build's cost is the drive, not the trace.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..programs import registry as _registry

__all__ = ["CANONICAL_PROGRAMS", "build_canonical_artifacts"]

# the reference's tiny-but-structured dims
_MLP = dict(batch=8, features=32, hidden=32, classes=8)
_LM = dict(vocab=32, seq_len=16, embed=16, heads=4, ffn=32, layers=1,
           batch=2)
_DRAFT = dict(embed=8, heads=2, ffn=16, layers=1)
_SPEC_K = 3

# the port's meshes are ranks of processes, each training eagerly (its
# collectives outside any graph): no single traced program to build
_MESH_NOTE = ("a %s mesh program: the port's mesh (one rank a process, "
              "eager) traces no single graph, and a multi-rank artifact "
              "without one is ROADMAP.md queue A item 7 step 8")


def _context(device):
    from .. import context as _ctx

    dev = _ctx.resolve_device(device)
    return _ctx.cpu() if dev.type == "cpu" else _ctx.gpu(dev.index or 0)


def _mlp_symbol():
    from .. import symbol as sym

    d = _MLP
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=d["hidden"], name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=d["classes"], name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _mlp_module(device, compute_dtype="bfloat16"):
    """A classifier Module with the captured train step armed (bfloat16
    compute, so the dtype lint audits a mixed-precision program)."""
    from .. import initializer, ndarray as nd
    from ..io import DataBatch
    from ..module import Module

    d = _MLP
    ctx = _context(device)
    mod = Module(_mlp_symbol(), context=ctx, compute_dtype=compute_dtype)
    mod.bind(data_shapes=[("data", (d["batch"], d["features"]))],
             label_shapes=[("softmax_label", (d["batch"],))])
    mod.init_params(initializer.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    rng = np.random.RandomState(0)
    x = nd.array(rng.uniform(-1, 1, (d["batch"], d["features"]))
                 .astype(np.float32), ctx=ctx)
    y = nd.array(rng.randint(0, d["classes"], (d["batch"],))
                 .astype(np.float32), ctx=ctx)
    return mod, DataBatch([x], [y])


def _lm_symbol(**kw):
    from ..models import attention_lm

    d = _LM
    return attention_lm.get_symbol(
        vocab_size=d["vocab"], seq_len=d["seq_len"],
        num_layers=d["layers"], embed=d["embed"], heads=d["heads"],
        ffn_hidden=d["ffn"], **kw)


def _lm_params(sym, batch, seq_len, seed=0, scale=0.02):
    """The reference's random LM weights (the same numpy draws)."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(batch, seq_len), softmax_label=(batch, seq_len))
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        params[name] = rng.normal(0, scale, shape).astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        params["aux:" + name] = np.zeros(shape, np.float32)
    return params


def _drive_step(mod, batch, steps=2):
    """Run the captured step twice at one shape (the retrace ground
    truth)."""
    for _ in range(steps):
        mod.forward_backward(batch)
        mod.update()
    if mod._train_step is None:
        raise MXNetError("the compiled train step did not arm; cannot "
                         "build its artifact (check "
                         "MXNET_FUSED_TRAIN_STEP)")
    return mod._train_step


def _eval_artifact(mod, batch):
    from .. import metric as metric_mod
    from ..train_step import CompiledEvalStep

    step = CompiledEvalStep(mod._exec_group, metric_mod.create("acc"))
    try:
        step.run(batch)
        step.run(batch)
        return step.artifact(name="eval_step")
    finally:
        step.finish()


def _build_train_eval(want, device):
    mod, batch = _mlp_module(device)
    out = []
    if "train_step" in want:
        step = _drive_step(mod, batch)
        if step.plan is None:
            raise MXNetError("the canonical MLP step built no slab plan "
                             "(SGD-momentum over f32 masters must arm "
                             "it)")
        out.append(("train_step", step.artifact(name="train_step")))
    if "eval_step" in want:
        out.append(("eval_step", _eval_artifact(mod, batch)))
    return out


def _build_decode(want, device):
    from ..decode import DecodePredictor

    d = _LM
    rng = np.random.RandomState(0)
    sym = _lm_symbol()
    pred = DecodePredictor(sym, _lm_params(sym, d["batch"], d["seq_len"]),
                           cache_len=d["seq_len"], device=device,
                           temperature=0.0, kv_dtype="")
    prompt_len = d["seq_len"] // 2
    prompts = rng.randint(0, d["vocab"], size=(d["batch"], d["seq_len"])) \
        .astype(np.float32)
    prompts[:, prompt_len:] = 0.0
    state, _ = pred.prefill(prompts, prompt_len)
    state, _ = pred.prefill(prompts, prompt_len)
    state, _ = pred.step(state)
    state, _ = pred.step(state)
    return [("prefill", pred.prefill_artifact(d["batch"], d["seq_len"])),
            ("decode_step", pred.decode_artifact(state))]


def _build_speculative(want, device):
    """decode_step_q / draft_step / verify_step, driven by a real
    mixed-length speculative serve (an int8 target, a smaller draft)."""
    from ..decode import DecodePredictor, DecodeServer, DraftProposer
    from ..models import attention_lm

    d, dd = _LM, _DRAFT
    rng = np.random.RandomState(1)
    sym = _lm_symbol()
    target = DecodePredictor(sym, _lm_params(sym, d["batch"], d["seq_len"]),
                             cache_len=d["seq_len"], device=device,
                             temperature=0.0, kv_dtype="int8")
    draft_sym = attention_lm.get_symbol(
        vocab_size=d["vocab"], seq_len=d["seq_len"],
        num_layers=dd["layers"], embed=dd["embed"], heads=dd["heads"],
        ffn_hidden=dd["ffn"])
    draft = DecodePredictor(
        draft_sym, _lm_params(draft_sym, d["batch"], d["seq_len"], seed=2),
        cache_len=d["seq_len"], device=device, temperature=0.0,
        kv_dtype="")
    proposer = DraftProposer(draft, _SPEC_K)
    server = DecodeServer(target, max_prefill=d["seq_len"] // 2,
                          slots=d["batch"], max_new_tokens=4,
                          proposer=proposer)
    for n in (3, 5, 7, 4):          # mixed lengths, the slots reused
        server.submit(rng.randint(0, d["vocab"], size=(n,)))
    results = server.run()
    if len(results) != 4 or server.spec_steps == 0:
        raise MXNetError("speculative serve drive did not exercise the "
                         "verify program (results=%d, spec_steps=%d)"
                         % (len(results), server.spec_steps))
    prompts = rng.randint(0, d["vocab"],
                          size=(d["batch"], d["seq_len"] // 2)) \
        .astype(np.float32)
    state, _ = target.prefill(prompts, d["seq_len"] // 2)
    state, _ = target.step(state)
    state, _ = target.step(state)
    return [("decode_step_q", target.decode_artifact(
                state, name="decode_step_q")),
            ("draft_step", proposer.predictor.decode_artifact(
                proposer._state, name="draft_step")),
            ("verify_step", target.verify_artifact(
                state, _SPEC_K, name="verify_step"))]


def _paged_serve(sym, device, seed, spec_k=None):
    """A shared-prefix paged serve (chunked prefill, prefix-cache hits,
    speculation with ``spec_k``) through a paged predictor; returns the
    predictor and the server."""
    from ..decode import DecodePredictor, DecodeServer

    d = _LM
    rng = np.random.RandomState(seed)
    pred = DecodePredictor(
        sym, _lm_params(sym, d["batch"], d["seq_len"]),
        cache_len=d["seq_len"], device=device, temperature=0.0,
        kv_dtype="", paged=True, page_tokens=4, prefill_chunk=4)
    server = DecodeServer(pred, max_prefill=12, slots=d["batch"],
                          max_new_tokens=3, spec_k=spec_k)
    prefix = rng.randint(0, d["vocab"], size=(6,))
    for n in (3, 5, 2, 4):          # shared prefix, mixed tails
        server.submit(np.concatenate(
            [prefix, rng.randint(0, d["vocab"], size=(n,))]))
    results = server.run()
    if len(results) != 4:
        raise MXNetError("paged serve drive did not complete (results=%d)"
                         % len(results))
    return pred, server


def _build_paged(want, device):
    pred, server = _paged_serve(_lm_symbol(), device, 3, spec_k=_SPEC_K)
    stats = server.stats()
    if server.spec_steps == 0 or stats.get("prefix_cache_hit_rate", 0) <= 0:
        raise MXNetError(
            "paged serve drive did not exercise the paged programs "
            "(spec_steps=%d, hit_rate=%s)"
            % (server.spec_steps, stats.get("prefix_cache_hit_rate")))
    state = pred.paged_batch_state(_LM["batch"])
    return [("paged_decode_step",
             pred.decode_artifact(state, name="paged_decode_step")),
            ("paged_verify_step",
             pred.verify_artifact(state, _SPEC_K, name="paged_verify_step"))]


def _build_gqa(want, device):
    """gqa_decode_step: the paged decode program under a grouped layout
    (4 query heads over 1 kv head), driven by a real grouped serve."""
    pred, _ = _paged_serve(_lm_symbol(num_kv_heads=1), device, 5)
    art = pred.decode_artifact(pred.paged_batch_state(_LM["batch"]),
                               name="gqa_decode_step")
    if not art.meta.get("num_kv_heads"):
        raise MXNetError("gqa_decode_step artifact carries no grouped-K/V "
                         "meta; the mha-under-gqa tripwire would be "
                         "vacuous")
    return [("gqa_decode_step", art)]


def _build_ckpt(want, device):
    """The step of a real ``fit`` under async fenced checkpointing (an
    MLP, period 3, the writer thread): the artifact is taken after at
    least one commit, so the host-sync pass audits a program that ran
    beside live checkpointing."""
    import shutil
    import tempfile

    from .. import elastic, initializer
    from ..io import NDArrayIter
    from ..module import Module

    d = _MLP
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (d["batch"] * 6, d["features"])) \
        .astype(np.float32)
    y = rng.randint(0, d["classes"], (d["batch"] * 6,)).astype(np.float32)
    it = NDArrayIter(x, y, batch_size=d["batch"])
    mod = Module(_mlp_symbol(), context=_context(device),
                 compute_dtype="bfloat16")
    tmp = tempfile.mkdtemp(prefix="mxlint_ckpt_")
    try:
        ctl = elastic.ElasticController(checkpointer=elastic.Checkpointer(
            tmp, period=3, async_write=True))
        mod.fit(it, num_epoch=2, eval_metric="acc", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=initializer.Xavier(), elastic=ctl)
        ctl.checkpointer.wait()
        if ctl.checkpointer.writes < 1:
            raise MXNetError("fit-under-checkpoint drive committed no "
                             "fence checkpoint")
        if mod._train_step is None:
            raise MXNetError("the compiled train step did not arm under "
                             "checkpointing")
        return [("ckpt_train_step",
                 mod._train_step.artifact(name="ckpt_train_step"))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _ring_available():
    return _MESH_NOTE % "(seq, model)"


def _moe_available():
    return _MESH_NOTE % "(expert, model)"


def _unbuilt(want, device):
    raise MXNetError("no canonical mesh program yet (ROADMAP.md queue A "
                     "item 7 step 8)")


if "train_step" not in _registry.canonical_names():
    # registered once per process
    _registry.register_canonical(("train_step", "eval_step"),
                                 _build_train_eval)
    _registry.register_canonical(("prefill", "decode_step"),
                                 _build_decode)
    _registry.register_canonical(
        ("decode_step_q", "draft_step", "verify_step"),
        _build_speculative)
    _registry.register_canonical(
        ("paged_decode_step", "paged_verify_step"), _build_paged)
    _registry.register_canonical(("gqa_decode_step",), _build_gqa)
    _registry.register_canonical(("ring_tp_step",), _unbuilt,
                                 availability=_ring_available)
    _registry.register_canonical(("moe_train_step",), _unbuilt,
                                 availability=_moe_available)
    _registry.register_canonical(("ckpt_train_step",), _build_ckpt)

# the catalog, enumerated from the registry
CANONICAL_PROGRAMS = _registry.canonical_names()


def build_canonical_artifacts(names=None, device=None):
    """Build the requested canonical artifacts (default: all thirteen)
    on ``device`` (None: the card).  Returns ``(artifacts, notes)``:
    ``notes`` maps a program that cannot be built (``ring_tp_step``,
    ``moe_train_step``: no mesh) to the reason."""
    return _registry.build_canonical(names, device=device)

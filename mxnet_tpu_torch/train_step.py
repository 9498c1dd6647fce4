"""CompiledTrainStep / CompiledEvalStep / CompiledForward — the whole
training step, the evaluation pass's forward and metric, and an
executor's inference forward, each as one captured program (the
counterparts of ``mxnet_tpu/train_step.py``'s steps and of
``mxnet_tpu/executor.py``'s jitted ``fwd_test``).

The JAX package compiles forward, backward, the optimizer update and
the metric's accumulation into one donated XLA program with its own
master-weight store.  The port runs the same step body as a
:class:`~mxnet_tpu_torch.programs.GraphProgram`: on the card, one CUDA
graph per executor (bucket) signature, captured after one eager warm-up
run on a side stream (the first call's real work: its update happens
once) and replayed after; on the CPU the same body over the same
buffers.  ``programs.eager()`` runs the body unrecorded.

**The store is the executor's arrays.**  The graph binds every tensor
it reads or writes by pointer: the executor's input arrays (a batch is
copied into them before each call), the parameters, aux states (written
in place), gradients, optimizer slots, the per-block / per-parameter lr
and wd (device scalars refreshed before each call) and the metric's
accumulators.  Nothing is donated or copied back: ``Module.update()``,
``get_params`` / ``set_params`` and the captured step all see one
storage, so the JAX package's flush / reload handoffs reduce to
recasting the compute copy (``load_from_executor``); there is nothing
to flush.

**The slab plan** (``ops/update_kernel.py``), armed whenever ``plan_for``
accepts the optimizer and the masters: arming packs the trainable
masters and the optimizer's slots into slabs once, then rebinds every
trainable's NDArray in the executor and each ``Updater.states`` entry to
views of those slabs.  A step's forward reads views of the compute-dtype
slab (or of the master slab in f32), autograd's gradients are copied
into the f32 grad slab (the pack the JAX package fuses into the
backward) and kernel B1 runs once a slab.  Where the plan declines (NAG,
masters that are not f32 / bf16) the body runs the optimizer's
``apply`` (its ``fused_kernel``, the eager ``update``'s arithmetic) per
parameter, as the JAX step does with no plan.
A master written outside the step (an eager update, ``set_params``)
marks the compute slab stale, and the next step recasts it first.

**Host state stays outside the body**: update counts, lr schedules and
Adam's bias correction (``fused_hyper``) run once per call on the host;
the floats the update takes as launch arguments (rescale, clip,
momentum / betas / epsilon) are part of the program's signature.  A
replay overwrites the step's outputs: ``Module.get_outputs`` clones them.
Telemetry (``obs``) times each call around the replay, never inside
it: a ``train_step`` / ``eval_step`` / ``eval_forward`` row of the
roofline table and a timeline span.

**Buckets** (``BucketingModule``): one store serves every executor group
bound against the primary's (``run(batch, group=...)``, ``compatible``,
``_entry_for``); each group gets its own program, all capturing into
one memory pool.

The compute-dtype rule is the JAX package's (``:640-650``): with a
``compute_dtype``, floating parameters and DATA inputs are cast to it
(labels keep their dtype), uint8 data is cast to it (or f32), gradients
return in the masters' dtype.  That rule casts an LM's float token ids
too, and bf16 holds integers exactly only up to 256: train such models
in f32 (``ROADMAP.md`` lists the fault).
"""
from __future__ import annotations

import pickle
import weakref

import numpy as np
import torch

from . import obs as _obs
from .base import MXNetError
from .executor import forward_backward, run_graph, uncapturable_ops
from .metric import DeviceMetricAccumulator
from .ndarray import torch_dtype
from .obs.roofline import graph_flops, symbol_shapes, tensor_bytes
from .ops import update_kernel
from .optimizer import load_states
from .programs import GraphPool, GraphProgram, ProgramSpec
from .programs import registry as _registry
from .registry import OpContext

__all__ = ["CompiledTrainStep", "CompiledEvalStep", "CompiledForward"]


def _weak_prober(step):
    """A roofline static-cost prober that does not pin the step (and its
    executors and masters) in the process-global accounting: once the
    step is collected it resolves to None."""
    ref = weakref.ref(step)

    def prober():
        live = ref()
        return live.roofline_static() if live is not None else None

    return prober


def _register_step_spec(step):
    """Register a step's :class:`ProgramSpec` (name, trace counters, the
    last call's arguments) with the live registry, held weakly."""
    ref = weakref.ref(step)
    is_train = isinstance(step, CompiledTrainStep)
    spec = ProgramSpec(
        step.telemetry_name, step, owner=step,
        abstract_args=lambda: (ref()._last_args
                               if ref() is not None else None),
        trace_count=lambda: (ref().trace_count
                             if ref() is not None else None),
        expected_traces=lambda: (ref().programs_built
                                 if ref() is not None and is_train else 1),
        device=step._device)
    return _registry.register(spec)


def _refuse_uncapturable(exe):
    """MXNetError when the executor's graph holds a node no captured
    program may hold (a Custom op, whose Python body may read values
    back to the host)."""
    names = uncapturable_ops(exe._symbol)
    if names:
        raise MXNetError("the graph holds nodes a compiled step cannot "
                         "capture (Custom): %s" % names)


def _host_to(dst, src):
    """Copy a numpy array into the device tensor ``dst`` without waiting
    on the card (through pinned memory on a CUDA device)."""
    t = torch.from_numpy(np.ascontiguousarray(src))
    if dst.device.type == "cuda":
        t = t.pin_memory()
    dst.copy_(t, non_blocking=dst.device.type == "cuda")


def _forward_body(exe, finish):
    """The inference forward over ``exe``'s graph as a program body:
    ``body(env_vals, aux_vals, generator, *rest)`` runs the graph under
    ``OpContext(is_train=False)`` and returns ``finish(env, outs,
    *rest)``.  Inference updates no aux state."""
    symbol = exe._symbol
    arg_names = list(exe.arg_dict)
    aux_names = list(exe.aux_dict)
    plain, device = exe.plain, exe._device

    def body(env_vals, aux_vals, generator, *rest):
        env = dict(zip(arg_names, env_vals))
        octx = OpContext(is_train=False, plain=plain, generator=generator,
                         device=device)
        outs, _ = run_graph(symbol, env, dict(zip(aux_names, aux_vals)),
                            octx)
        return finish(env, outs, *rest)

    return body


def _bound_args(exe):
    """An executor's argument and aux tensors and its generator: the
    bound (by pointer) head of every forward program's arguments."""
    return (tuple(a.data for a in exe.arg_dict.values()),
            tuple(a.data for a in exe.aux_dict.values()), exe.generator)


class _StepBase:
    """What the steps share: the executor's argument order, its input
    names (a group's), the device, the metric accumulator and the
    programs' trace counters."""

    def __init__(self, exe, exec_group=None):
        self._group = exec_group
        self._exec = exe
        self._device = next(iter(exe.arg_dict.values())).data.device
        self._label_names = [] if exec_group is None else \
            [n for n in exec_group.label_names if n in exe.arg_dict]
        self._pool = GraphPool()
        self._metric_acc = None
        self.trace_count = 0
        self.programs_built = 0
        self._last_args = None
        self._program_spec = None
        self._out_bytes = None      # the program's outputs (roofline)

    def _call(self, prog, args):
        if self._program_spec is None:
            self._program_spec = _register_step_spec(self)
        self._last_args = args
        traces = prog.traces
        if _obs.enabled():
            # the program's roofline row: its time around the replay
            # (host wall, and CUDA events on the card) and a lazy
            # static cost; nothing of it runs inside the captured body
            if not _obs.programs.has_static(self.telemetry_name):
                _obs.programs.register_static(self.telemetry_name,
                                              _weak_prober(self))
            with _obs.program_span(self.telemetry_name, self._device):
                outs = prog(*args)
        else:
            outs = prog(*args)
        if self._out_bytes is None:
            self._out_bytes = tensor_bytes(outs)
        self.trace_count += prog.traces - traces
        if self._metric_acc is not None:
            self._metric_acc.commit()
        return outs

    def _labels(self, group, env):
        return [env[n] for n in group.label_names if n in env]

    def roofline_static(self):
        """The step's static cost for the roofline table: FLOPs of the
        symbol's products (:func:`~mxnet_tpu_torch.obs.roofline.
        graph_flops`; a training step counts its forward three times:
        the forward and the two backward products) at the bound shapes,
        and the bytes of its arguments and outputs, each read or written
        once."""
        exe = self._exec
        shapes = {n: tuple(a.shape) for n, a in exe.arg_dict.items()}
        flops = graph_flops(exe._symbol,
                            symbol_shapes(exe._symbol, **shapes))
        if isinstance(self, CompiledTrainStep):
            flops *= 3
        return {"flops": flops,
                "bytes": tensor_bytes(self._last_args)
                + (self._out_bytes or 0)}


class CompiledTrainStep(_StepBase):
    """One store (the executor's arrays, the slabs, the optimizer's
    slots) and one captured step program per executor group."""

    telemetry_name = "train_step"

    def __init__(self, exec_group, optimizer, updater, compute_dtype=None):
        apply = optimizer.fused_kernel()
        if apply is None:
            raise MXNetError("optimizer %s has no fused kernel"
                             % type(optimizer).__name__)
        exe = exec_group.exec_
        added = [n for n in exec_group.param_names
                 if exe.grad_req.get(n, "null") == "add"]
        if added:
            raise MXNetError("the compiled train step takes grad_req "
                             "null / write only; got add for %s" % added)
        _refuse_uncapturable(exe)
        super().__init__(exe, exec_group)
        self._opt_apply = apply
        self._optimizer = optimizer
        self._updater = updater
        self._param_names = list(exec_group.param_names)
        self._grad_names = [n for n in self._param_names
                            if exe.grad_req.get(n, "null") == "write"]
        # optimizer bookkeeping is keyed by the param's index in the group,
        # as on the eager path
        self._grad_indices = [self._param_names.index(n)
                              for n in self._grad_names]
        self._cdtype = (None if compute_dtype in (None, "", "float32")
                        else torch_dtype(compute_dtype))
        self.plan = None
        self._wc_stale = False
        self._hyper_cache = None
        self._fns = {}
        self.num_steps = 0
        self.last_event = None
        plan = update_kernel.plan_for(
            optimizer, {n: exe.arg_dict[n].data for n in self._grad_names},
            self._grad_names, self._cdtype)
        if plan is not None:
            self._arm(plan)
        else:
            self._arm_per_param()
        self._fns[id(exe)] = (self._build(exec_group), exe)

    # ------------------------------------------------------------------
    # the store
    # ------------------------------------------------------------------
    def _states(self):
        """``{name: tuple of slot tensors}``: each trainable's optimizer
        state (created where the updater has none yet)."""
        exe, updater = self._exec, self._updater
        out = {}
        for n, idx in zip(self._grad_names, self._grad_indices):
            if updater.states.get(idx) is None:
                updater.states[idx] = updater.optimizer.create_state(
                    idx, exe.arg_dict[n])
            st = updater.states[idx]
            out[n] = () if st is None else \
                (st,) if isinstance(st, torch.Tensor) else tuple(st)
        return out

    def _arm(self, plan):
        """Pack masters, gradients and slots into the plan's slabs and
        rebind the executor's arrays and the updater's states to views of
        them; the per-block lr / wd live in device buffers."""
        exe = self._exec
        dev = self._device
        slots = self._states()
        self._w = plan.pack({n: exe.arg_dict[n].data
                             for n in self._grad_names}, dev)
        self._g = plan.pack({n: exe.grad_dict[n].data
                             for n in self._grad_names}, dev,
                            dtype=torch.float32)
        self._slots = plan.pack_slots(slots, dev)
        self._wc = plan.cast_slabs(self._w)
        for n, v in plan.unpack_all(self._w).items():
            exe.arg_dict[n]._set_data(v)
        self._grad_views = plan.unpack_all(self._g)
        for n, v in self._grad_views.items():
            exe.grad_dict[n]._set_data(v)
        slot_views = plan.unpack_slots(self._slots)
        for n, idx in zip(self._grad_names, self._grad_indices):
            views = slot_views[n]
            self._updater.states[idx] = None if not views else \
                views[0] if plan.kind == "sgd" else views
        # what the forward reads: the compute copy, else the masters
        self._views = {}
        for bk in plan.buckets:
            src = self._wc[bk] if plan.has_wc(bk) else self._w[bk]
            self._views.update(plan.unpack(bk, src))
        self._lrb = {bk: torch.zeros(plan.rows(bk) // update_kernel.
                                     BLOCK_ROWS, device=dev)
                     for bk in plan.buckets}
        self._wdb = {bk: torch.zeros_like(v) for bk, v in self._lrb.items()}
        self.plan = plan

    def _arm_per_param(self):
        """The per-parameter update's state: the updater's slots and one
        device lr / wd scalar a trainable."""
        self._views = {}
        slots = self._states()
        self._pslots = tuple(slots[n] for n in self._grad_names)
        n = len(self._grad_names)
        self._lrv = torch.zeros(n, device=self._device)
        self._wdv = torch.zeros(n, device=self._device)

    def compatible(self, group):
        """Whether a (bucket) executor group can train through this
        store: every parameter and aux array the primary's NDArray itself
        (shared binding shares them where the shapes match), and no
        trainable parameter of its own."""
        exe, prim = group.exec_, self._exec
        if any(exe.arg_dict.get(n) is not prim.arg_dict[n]
               for n in self._param_names):
            return False
        if any(exe.aux_dict.get(n) is not a
               for n, a in prim.aux_dict.items()):
            return False
        inputs = set(group.data_names) | set(group.label_names)
        return all(n in inputs or n in self._param_names
                   for n in exe.arg_dict)

    def _entry_for(self, group):
        """The step program of a (bucket) executor group, built on first
        use."""
        exe = group.exec_
        hit = self._fns.get(id(exe))
        if hit is not None and hit[1] is exe:
            return hit[0]
        if not self.compatible(group):
            raise MXNetError(
                "the bucket's parameters are not all shared with the "
                "train step's; demote every bucket to the eager update")
        prog = self._build(group)
        self._fns[id(exe)] = (prog, exe)
        return prog

    def load_from_executor(self):
        """The masters were written outside the step (an eager update,
        ``set_params``): the executor's arrays are the store, so only the
        compute slab is recast, before the next forward."""
        self._wc_stale = bool(self._wc) if self.plan is not None else False

    # ------------------------------------------------------------------
    # device-side metrics
    # ------------------------------------------------------------------
    def attach_metric(self, metric):
        """Fold ``metric``'s accumulation into the step.  Returns True
        when armed, False when the metric (or the graph's label routing)
        cannot accumulate on the device: the caller then keeps the host
        ``update_metric`` path."""
        if self._metric_acc is not None and self._metric_acc.metric is metric:
            return True
        if not DeviceMetricAccumulator.supported(metric):
            return False
        # the step sees only the labels the graph consumes; extra iterator
        # labels would pair differently from the host path
        if len(self._label_names) != len(self._group.label_names):
            return False
        self.detach_metric()
        acc = DeviceMetricAccumulator(metric)
        acc.install(self._device)
        self._metric_acc = acc
        self._drop_programs()  # the body changed
        return True

    def detach_metric(self):
        """Drain the device sums into the metric and take it off the
        step."""
        if self._metric_acc is None:
            return
        self._metric_acc.uninstall()
        self._metric_acc = None
        self._drop_programs()

    def _drop_programs(self):
        """Forget every executor's program (a new one is built at its next
        step) and their memory pool: a pool whose graphs are all gone
        cannot take a new capture."""
        self._fns = {}
        self._pool = GraphPool()

    # ------------------------------------------------------------------
    # the body
    # ------------------------------------------------------------------
    def _cast(self, v):
        if self._cdtype is not None and v.is_floating_point():
            return v.to(self._cdtype)
        if v.dtype == torch.uint8:
            return v.to(self._cdtype or torch.float32)
        return v

    def _build(self, group):
        """The step program over ``group``'s graph: forward, backward,
        the gradient pack, the update and the metric, in place."""
        exe = group.exec_
        symbol = exe._symbol
        arg_names = list(exe.arg_dict)
        aux_names = list(exe.aux_dict)
        casts = {n for n in arg_names
                 if n not in group.label_names and n not in self._views
                 and (n in group.data_names or n in self._param_names)}
        grad_names, plan = self._grad_names, self.plan
        plain, acc = exe.plain, self._metric_acc
        apply, device = self._opt_apply, exe._device

        def body(env_vals, aux_vals, update, mstate, generator, hyp):
            env = {n: self._cast(v) if n in casts else v
                   for n, v in zip(arg_names, env_vals)}
            aux = dict(zip(aux_names, aux_vals))
            octx = OpContext(is_train=True, plain=plain, generator=generator,
                             device=device)
            outs, new_aux, grads = forward_backward(symbol, env, aux,
                                                    grad_names, octx)
            with torch.no_grad():
                for n, v in zip(aux_names, aux_vals):
                    v.copy_(new_aux[n])
                if plan is not None:
                    w, g, slots, wc, lrb, wdb = (
                        dict(zip(keys, x)) for keys, x in zip(
                            (plan.buckets,) * 3 + (self._wc,)
                            + (plan.buckets,) * 2, update))
                    # the pack into the f32 gradient slab
                    for n, gr in zip(grad_names, grads):
                        self._grad_views[n].copy_(gr)
                    update_kernel.UPDATE_PATH["last"] = plan.apply(
                        w, g, slots, wc, lrb, wdb, hyp, plain=plain)
                else:
                    gbufs, slots, lrs, wds = update
                    params = [env_vals[arg_names.index(n)]
                              for n in grad_names]
                    for i, (w, gb, gr, s) in enumerate(
                            zip(params, gbufs, grads, slots)):
                        gb.copy_(gr)
                        apply(w, gb, s, lrs[i], wds[i])
                    update_kernel.UPDATE_PATH["last"] = "per_param"
                if acc is not None:
                    acc.update(mstate, self._labels(group, env), outs)
            return outs

        self.programs_built += 1
        return GraphProgram(self.telemetry_name, body, bind=range(6),
                            pool=self._pool)

    def _upload_hyper(self, lrs, wds):
        """Refresh the device lr / wd buffers when the per-parameter
        values change (without waiting on the card: the copies are
        ordered after the last step on the stream)."""
        cached = self._hyper_cache
        if cached is not None and np.array_equal(cached[0], lrs) \
                and np.array_equal(cached[1], wds):
            return
        if self.plan is not None:
            names = self._grad_names
            lrb, wdb = self.plan.lr_wd_blocks(dict(zip(names, lrs)),
                                              dict(zip(names, wds)))
            for bk in self.plan.buckets:
                _host_to(self._lrb[bk], lrb[bk])
                _host_to(self._wdb[bk], wdb[bk])
            self._hyper_cache = (lrs, wds, self._lrb, self._wdb)
        else:
            _host_to(self._lrv, lrs)
            _host_to(self._wdv, wds)
            self._hyper_cache = (lrs, wds, self._lrv, self._wdv)

    def _args(self, group, hyp):
        exe = group.exec_
        env = tuple(self._views[n] if n in self._views else a.data
                    for n, a in exe.arg_dict.items())
        aux = tuple(a.data for a in exe.aux_dict.values())
        if self.plan is not None:
            bks = list(self.plan.buckets)
            update = (tuple(self._w[b] for b in bks),
                      tuple(self._g[b] for b in bks),
                      tuple(self._slots[b] for b in bks),
                      tuple(self._wc.values()),
                      tuple(self._lrb[b] for b in bks),
                      tuple(self._wdb[b] for b in bks))
        else:
            update = (tuple(exe.grad_dict[n].data for n in self._grad_names),
                      self._pslots, self._lrv, self._wdv)
        acc = self._metric_acc
        return (env, aux, update, acc.state if acc is not None else (),
                exe.generator, hyp)

    def run(self, data_batch, group=None):
        """One step on ``data_batch`` through ``group``'s graph (the
        primary's by default); returns the outputs (the program's, valid
        until its next call)."""
        group = group if group is not None else self._group
        prog = self._entry_for(group)
        group.load_data_batch(data_batch)
        if self.plan is not None and self._wc_stale:
            with torch.no_grad():
                for bk, wc in self._wc.items():
                    wc.copy_(self._w[bk])
            self._wc_stale = False
        opt = self._optimizer
        lrs, wds, rescale, clip = opt.fused_hyper(self._grad_indices)
        self._upload_hyper(lrs, wds)
        hyp = (float(rescale), float(clip)) + tuple(
            float(v) for v in opt.fused_extra())
        outs = self._call(prog, self._args(group, hyp))
        self.num_steps += 1
        if self._device.type == "cuda":
            self.last_event = torch.cuda.Event()
            self.last_event.record()
        return outs

    # ------------------------------------------------------------------
    # state exchange
    # ------------------------------------------------------------------
    def _slot_views(self):
        if self.plan is not None:
            return self.plan.unpack_slots(self._slots)
        return dict(zip(self._grad_names, self._pslots))

    def get_states(self):
        """The optimizer slots as the JAX package's fused ``.states``
        payload: a pickled ``{name: tuple of numpy arrays}`` (bf16 as
        f32)."""
        host = {n: tuple(np.array((t.float() if t.dtype == torch.bfloat16
                                   else t).cpu().numpy(), copy=True)
                         for t in slots)
                for n, slots in self._slot_views().items()}
        return pickle.dumps(host)

    def set_states(self, payload):
        """Load slots from a ``.states`` payload: the fused format (keyed
        by name, numpy tuples) or an eager updater's (keyed by index)."""
        self.import_updater_states(load_states(payload), self._param_names)

    def import_updater_states(self, states, param_names):
        """Copy an updater's states (index- or name-keyed; None, one
        array or a tuple) into the slots, in place."""
        views = self._slot_views()
        index_names = dict(enumerate(param_names))
        with torch.no_grad():
            for key, state in states.items():
                name = index_names.get(key, key) \
                    if isinstance(key, int) else key
                if name not in views:
                    continue
                arrays = () if state is None else \
                    state if isinstance(state, (tuple, list)) else (state,)
                for dst, src in zip(views[name], arrays):
                    src = getattr(src, "data", src)
                    src = src if isinstance(src, torch.Tensor) \
                        else torch.as_tensor(np.asarray(src))
                    if src.data_ptr() != dst.data_ptr():
                        dst.copy_(src)

    def export_updater_states(self, updater, param_names, ctx=None):
        """Hand copies of the slots to an eager ``updater`` (indexed by
        ``param_names``), so momentum carries over."""
        views = self._slot_views()
        for idx, name in enumerate(param_names):
            if name in views:
                updater.states[idx] = self._optimizer.pack_state(
                    [t.clone() for t in views[name]])

    def reset_slots(self):
        """Zero the optimizer slots in place (a slot-less checkpoint
        restored into a training module keeps no old moments)."""
        with torch.no_grad():
            for slots in self._slot_views().values():
                for t in slots:
                    t.zero_()


class CompiledEvalStep(_StepBase):
    """The forward and the metric's device accumulation as one program
    per executor (``score``'s counterpart of the train step's metric):
    no output reaches the host; reading the metric drains the sums.

    Raises :class:`MXNetError` when the metric cannot accumulate on the
    device or the graph does not consume every label input."""

    telemetry_name = "eval_step"

    def __init__(self, exec_group, metric):
        _refuse_uncapturable(exec_group.exec_)
        super().__init__(exec_group.exec_, exec_group)
        if len(self._label_names) != len(exec_group.label_names):
            raise MXNetError("graph does not consume every label input; "
                             "metric pairing would differ from the host "
                             "path")
        try:
            acc = DeviceMetricAccumulator(metric)
        except ValueError as exc:
            raise MXNetError(str(exc))
        acc.install(self._device)
        self._metric_acc = acc
        group = exec_group

        def accumulate(env, outs, mstate):
            acc.update(mstate, self._labels(group, env), outs)

        self.programs_built = 1
        self._prog = GraphProgram(self.telemetry_name,
                                  _forward_body(self._exec, accumulate),
                                  bind=range(4), pool=self._pool)

    def run(self, data_batch):
        """Accumulate one batch on the device."""
        if self._label_names and not data_batch.label:
            raise MXNetError("eval batch is missing inputs %s"
                             % self._label_names)
        self._group.load_data_batch(data_batch)
        self._call(self._prog, _bound_args(self._exec)
                   + (self._metric_acc.state,))

    def finish(self):
        """Fold the pending device sums into the metric and detach the
        hooks (the end of an eval pass)."""
        self._metric_acc.uninstall()

    def rearm(self):
        """Re-install the metric hooks for another pass over the same
        program (the accumulators keep their storage)."""
        self._metric_acc.install(self._device)
        return self


class CompiledForward(_StepBase):
    """An executor's inference forward (``Executor.forward(is_train=
    False)``) as one captured program: the graph under
    ``OpContext(is_train=False)`` over the executor's arguments and aux
    states, bound by pointer (one capture per executor and argument
    signature: an array whose tensor is rebound, or a new executor, is a
    new signature), and its generator.  ``run`` returns fresh tensors:
    the next replay overwrites the program's own outputs."""

    telemetry_name = "eval_forward"

    def __init__(self, exe):
        super().__init__(exe)
        self.programs_built = 1
        self._prog = GraphProgram(
            self.telemetry_name,
            _forward_body(exe, lambda env, outs: outs),
            bind=range(3), pool=self._pool)

    def run(self):
        """One forward over the executor's arrays as they are now."""
        return [o.clone() for o in self._call(self._prog,
                                              _bound_args(self._exec))]

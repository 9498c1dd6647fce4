"""PipelineModule — GPipe pipeline parallelism through the Module API (the
counterpart of ``mxnet_tpu/module/pipeline_module.py``).

The user describes a pipeline with Symbols and trains it with the
ordinary ``Module.fit`` workflow (bind / init_params / init_optimizer /
fit / score); each step runs embed -> the GPipe fill-drain schedule over
the pipe group (:mod:`~mxnet_tpu_torch.parallel.pipeline`) -> head, its
reverse pipeline, and the optimizer update (the reference's one donated
program, here one eager step a rank).

Pipeline model (the reference's):

* ``stage_symbol`` — ONE stage's computation, input variable ``data``,
  one output of the same shape.  Its parameters are stacked
  ``num_stages`` times with a leading stage axis; the rank of stage s
  holds slice s.  HETEROGENEOUS stages: a LIST of per-stage symbols
  sharing graph structure and parameter names, widths free; each
  parameter is zero-padded to the largest shape across stages, which is
  exact while the ops between a stage's projections are lane-local and
  zero-preserving (bind rejects any elementwise op with f(0) != 0 on a
  padded stage).
* ``embed_symbol`` (optional) — maps the raw batch to the stage
  activation shape; it runs on the first stage's ranks.
* ``head_symbol`` — consumes the pipeline output (input ``data``) and
  the labels and ends in a loss; it runs on the last stage's ranks.

One rank a process (the reference: one device of a mesh in one
process): ``world = num_stages x data`` ranks laid out (pipe, data),
rank = stage * data + data index, ``context`` this rank's device (or a
list of one context a rank).  The batch (axis 0) splits into
``num_microbatches`` microbatches; a data rank takes its slice of each.
The embed and head parameters are replicated over the pipe group: their
gradients are computed once, on the stage that runs them, summed over
the data group with the stage gradients (one all-reduce), and broadcast
over the pipe group, so every rank applies the same update.  The update
is kernel B1 over the rank's parameter slab where the slab plan arms
(SGD, ccSGD, Adam: :class:`~mxnet_tpu_torch.train_step.SlabUpdate`),
else the optimizer's per-parameter ``apply``.

Random ops in a stage draw from a generator seeded per (step, stage,
microbatch) inside the stage call (the reference folds the stage and the
microbatch into its key), so every microbatch draws its own masks and a
recomputed stage (``remat``) draws the forward's.

Constraints (raised at bind): symbols without auxiliary state, an
optimizer with a fused kernel (all first-party ones).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import config
from .. import metric as metric_mod
from .. import ndarray as nd
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..context import Context, gpu, resolve_device
from ..executor import run_graph
from ..io import DataDesc
from ..parallel import collectives as C
from ..parallel.pipeline import Schedule
from ..registry import OpContext
from .base_module import BaseModule

__all__ = ["PipelineModule"]


def _symbol_fn(symbol):
    """A Symbol as a pure function ``fn(env, is_train, generator=None,
    tp=None) -> [outputs]`` (a walk with no aux and no placement:
    PipelineModule symbols are stateless by contract)."""
    if symbol.list_auxiliary_states():
        raise MXNetError(
            "PipelineModule symbols must not carry auxiliary state "
            "(BatchNorm moving stats etc.); use stateless normalization "
            "inside pipeline stages")

    def fn(env, is_train, generator=None, tp=None):
        dev = next(iter(env.values())).device
        outs, _ = run_graph(symbol, env, {}, OpContext(
            is_train=is_train, generator=generator, device=dev), tp=tp)
        return outs

    return fn


# attrs that set a layer's WIDTH — the one thing heterogeneous stages are
# allowed to vary; everything else (op kinds, activation types, wiring)
# must match because every stage runs stage 0's graph
_WIDTH_ATTRS = frozenset(["num_hidden", "num_filter", "hidden_size"])


def _stage_structure_signature(symbol):
    """Hashable (op, non-width attrs, wiring) sequence of a stage graph."""
    nodes = list(symbol._topo())
    index = {id(n): i for i, n in enumerate(nodes)}
    sig = []
    for n in nodes:
        if n.is_variable:
            sig.append(("var", n.name))
            continue
        attrs = {k: v for k, v in sorted(n.parsed_attrs().items())
                 if k not in _WIDTH_ATTRS}
        wiring = tuple((index[id(s)], i) for s, i in n.inputs)
        sig.append((n.op.name, tuple(attrs.items()), wiring))
    return tuple(sig)


# elementwise ops with f(0) = 0 and finite (two-input forms: f(0, 0) = 0),
# unconditionally safe on padded lanes
_ZERO_PRESERVING_ELEMWISE = frozenset({
    "abs", "sign", "rint", "ceil", "floor", "trunc", "fix", "round",
    "square", "sqrt", "cbrt", "expm1", "log1p", "sin", "tan", "arcsin",
    "arctan", "sinh", "tanh", "arcsinh", "arctanh", "degrees", "radians",
    "erf", "negative", "relu", "softsign", "smooth_l1",
    "_copy", "Cast", "Dropout", "LeakyReLU", "BlockGrad",
    "_mul_scalar", "_div_scalar", "_mod_scalar",
    "_plus", "_minus", "_mul", "_maximum", "_minimum", "_hypot",
    "broadcast_add", "broadcast_sub", "broadcast_mul",
    "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
    "broadcast_not_equal", "broadcast_greater", "broadcast_lesser",
    "add_n", "_grad_add",
})

# Activation act_types with f(0) = 0
_ZERO_PRESERVING_ACT_TYPES = ("relu", "tanh", "softsign")

_ELEMWISE_FAMILY = None


def _elementwise_family():
    """Every registered elementwise-family op name: the unary table, the
    two-tensor / broadcast / scalar binary and logic forms and the
    activation wrappers (so a new elementwise op is caught fail-closed)."""
    global _ELEMWISE_FAMILY
    if _ELEMWISE_FAMILY is not None:
        return _ELEMWISE_FAMILY
    from ..ops.elemwise import _UNARY

    names = set(_UNARY)
    binary = ("plus", "minus", "mul", "div", "mod", "power", "maximum",
              "minimum", "hypot")
    logic = ("equal", "not_equal", "greater", "greater_equal", "lesser",
             "lesser_equal")
    canon = {"plus": "add", "minus": "sub"}
    names.update("_%s" % n for n in binary)
    names.update("broadcast_%s" % canon.get(n, n) for n in binary)
    names.update("_%s_scalar" % n for n in binary + logic)
    names.update("_r%s_scalar" % n for n in ("minus", "div", "power", "mod"))
    names.update("broadcast_%s" % n for n in logic)
    names.update({"Activation", "LeakyReLU", "SoftmaxActivation", "clip",
                  "smooth_l1", "Cast", "_copy", "Dropout", "BlockGrad",
                  "add_n", "_grad_add"})
    _ELEMWISE_FAMILY = frozenset(names)
    return _ELEMWISE_FAMILY


def _zero_preservation_violation(node):
    """Why this node breaks f(0)=0 on padded lanes, or None when safe
    (non-elementwise ops too: the lane-locality contract covers them)."""
    name = node.op.name
    attrs = node.parsed_attrs()
    if name == "Activation":
        act = attrs.get("act_type", "relu")
        if act in _ZERO_PRESERVING_ACT_TYPES:
            return None
        return "Activation act_type=%r" % act
    if name == "clip":
        lo, hi = attrs.get("a_min", 0.0), attrs.get("a_max", 0.0)
        return None if lo <= 0.0 <= hi else \
            "clip bounds [%s, %s] excluding 0" % (lo, hi)
    if name == "_power_scalar":
        c = attrs.get("scalar", 0.0)
        return None if c > 0 else "_power_scalar exponent %s" % c
    if name == "_maximum_scalar":
        c = attrs.get("scalar", 0.0)
        return None if c <= 0 else "_maximum_scalar with scalar %s" % c
    if name == "_minimum_scalar":
        c = attrs.get("scalar", 0.0)
        return None if c >= 0 else "_minimum_scalar with scalar %s" % c
    if name in _ZERO_PRESERVING_ELEMWISE:
        return None
    if name in _elementwise_family():
        return "%r (f(0) != 0)" % name
    return None


def _seed(*parts):
    """A 63-bit seed from integers (a splitmix64 chain)."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9
        h &= 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & 0x7FFFFFFFFFFFFFFF


class PipelineModule(BaseModule):
    def __init__(self, stage_symbol, head_symbol, num_stages,
                 num_microbatches, embed_symbol=None, context=None,
                 remat=False, logger=logging):
        """``remat=True`` checkpoints each stage call: backward
        recomputes the stage instead of keeping its internals for every
        microbatch."""
        super().__init__(logger=logger)
        self._remat = bool(remat)
        if isinstance(stage_symbol, (list, tuple)):
            if len(stage_symbol) != int(num_stages):
                raise MXNetError(
                    "heterogeneous pipeline: %d stage symbols for "
                    "num_stages=%d" % (len(stage_symbol), num_stages))
            self._stage_syms = list(stage_symbol)
            stage_symbol = self._stage_syms[0]
        else:
            self._stage_syms = None      # homogeneous: one symbol stacked
        self._stage_sym = stage_symbol
        self._head_sym = head_symbol
        self._embed_sym = embed_symbol
        self._num_stages = int(num_stages)
        self._num_micro = int(num_microbatches)
        if context is None:
            context = gpu(0)
        self._contexts = [c if isinstance(c, Context) else Context(c)
                          for c in (context if isinstance(context,
                                                          (list, tuple))
                                    else [context])]
        if len(self._contexts) > 1 \
                and len(self._contexts) % self._num_stages:
            raise MXNetError("need a multiple of num_stages devices "
                             "(%d given for %d stages)"
                             % (len(self._contexts), self._num_stages))
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._outputs = None
        self._outputs_full = None
        self._outputs_from_step = False
        self._pending_metric = None
        self._metric_acc = None
        self._num_steps = 0
        self._arrays = {}
        self._grads = {}
        self._slab = None
        self.last_step_s = None

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return ["data"]

    @property
    def output_names(self):
        return self._head_sym.list_outputs()

    @property
    def symbol(self):
        return self._head_sym

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    @property
    def stage(self):
        """This rank's stage (its index in the pipe group)."""
        return self._stage

    # ------------------------------------------------------------------
    def _layout(self):
        """Resolve the (pipe, data) layout against the process group:
        the groups, this rank's stage and data index, and its device."""
        import torch.distributed as dist

        world = C.world_size()
        s = self._num_stages
        if world % s:
            raise MXNetError(
                "a PipelineModule of %d stages does not cover the %d "
                "rank(s) of the process group: start num_stages x data "
                "processes under parallel.launch.init()" % (s, world))
        self._data_par = world // s
        if len(self._contexts) > 1 and len(self._contexts) != world:
            raise MXNetError("%d contexts for a process group of %d: give "
                             "this rank's context, or one a rank"
                             % (len(self._contexts), world))
        ctx = self._contexts[C.rank() % len(self._contexts)]
        self._context = ctx
        self._device = resolve_device(ctx)
        self._pipe_group = self._data_group = None
        self._stage = self._data_rank = 0
        self._pipe_ranks = [C.rank()]
        if world > 1:
            from torch.distributed.device_mesh import DeviceMesh

            kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
            mesh = DeviceMesh(kind, torch.arange(world).reshape(
                s, self._data_par), mesh_dim_names=("pipe", "data"))
            self._pipe_group = mesh.get_group("pipe")
            self._data_group = mesh.get_group("data")
            self._stage = mesh.get_local_rank("pipe")
            self._data_rank = mesh.get_local_rank("data")
            self._pipe_ranks = dist.get_process_group_ranks(
                self._pipe_group)
        self._is_first = self._stage == 0
        self._is_last = self._stage == s - 1

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        if inputs_need_grad:
            raise MXNetError("inputs_need_grad is not supported by "
                             "PipelineModule")
        self._data_shapes = [d if isinstance(d, DataDesc) else
                             DataDesc(d[0], d[1]) for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc) else
                              DataDesc(d[0], d[1])
                              for d in (label_shapes or [])]
        batch = self._data_shapes[0].shape[0]
        if batch % self._num_micro:
            raise MXNetError("batch %d not divisible by num_microbatches %d"
                             % (batch, self._num_micro))
        mb = batch // self._num_micro
        self._batch = batch
        self._mb = mb

        in_shape = self._data_shapes[0].shape
        if self._embed_sym is not None:
            eargs, eout, _ = self._embed_sym.infer_shape(
                data=(mb,) + in_shape[1:])
            act_shape = eout[0]
            self._embed_shapes = dict(zip(self._embed_sym.list_arguments(),
                                          eargs))
            self._embed_shapes.pop("data")
        else:
            act_shape = (mb,) + in_shape[1:]
            self._embed_shapes = {}
        self._act_shape = tuple(act_shape)
        if self._stage_syms is None:
            sargs, souts, _ = self._stage_sym.infer_shape(data=act_shape)
            if tuple(souts[0]) != tuple(act_shape):
                raise MXNetError("stage must preserve the activation shape "
                                 "(got %s from %s)" % (souts[0], act_shape))
            self._stage_shapes = dict(zip(self._stage_sym.list_arguments(),
                                          sargs))
            self._stage_shapes.pop("data")
            self._stage_true_shapes = None
        else:
            self._bind_heterogeneous(act_shape)

        head_kwargs = {"data": (batch,) + tuple(act_shape[1:])}
        for d in self._label_shapes:
            head_kwargs[d.name] = d.shape
        hargs, houts, _ = self._head_sym.infer_shape(**head_kwargs)
        self._head_shapes = dict(zip(self._head_sym.list_arguments(), hargs))
        self._head_shapes.pop("data")
        head_args = set(self._head_sym.list_arguments())
        self._label_names = [d.name for d in self._label_shapes
                             if d.name in head_args]
        for n in self._label_names:
            self._head_shapes.pop(n, None)
        self._extra_head_vars = {
            n: tuple(s) for n, s in zip(self._head_sym.list_arguments(),
                                        hargs)
            if n not in self._head_shapes and n != "data"}
        self._output_shapes = list(zip(self._head_sym.list_outputs(),
                                       [tuple(s) for s in houts]))

        self._stage_fn = _symbol_fn(self._stage_sym)
        self._head_fn = _symbol_fn(self._head_sym)
        self._embed_fn = (_symbol_fn(self._embed_sym)
                          if self._embed_sym is not None else None)
        # the symbols' guards above raise in any process; the layout
        # needs the process group
        self._layout()
        if mb % self._data_par:
            raise MXNetError("microbatch %d not divisible by data-parallel "
                             "degree %d" % (mb, self._data_par))
        self._mb_local = mb // self._data_par
        self._head_tp = None
        if self._data_par > 1:
            # the loss head's 'batch' / 'valid' normalization over the
            # whole batch, not this rank's slice
            from ..parallel.tp_exec import TensorParallel

            self._head_tp = TensorParallel(
                self._head_sym, {}, 1, 0, None, data=self._data_par,
                data_group=self._data_group)
        # one seed for the run's random ops, the same on every rank
        seed = torch.tensor([int(torch.initial_seed()) & 0x7FFFFFFF],
                            dtype=torch.int64, device=self._device)
        C.broadcast(seed, 0)
        self._base_seed = int(seed.item())
        self._gen = torch.Generator(device=self._device)
        self.for_training = for_training
        self._detach_metric()
        self.binded = True

    def _bind_heterogeneous(self, act_shape):
        """Same structure and names required; parameters pad to the
        per-name largest shape across stages; padded stages must be
        zero-preserving."""
        names0 = self._stage_syms[0].list_arguments()
        sig0 = _stage_structure_signature(self._stage_syms[0])
        per_stage = []
        for k, s in enumerate(self._stage_syms):
            if s.list_arguments() != names0:
                raise MXNetError(
                    "heterogeneous pipeline stages must share parameter"
                    " structure: stage %d has args %s, stage 0 has %s"
                    % (k, s.list_arguments(), names0))
            sig = _stage_structure_signature(s)
            if sig != sig0:
                raise MXNetError(
                    "heterogeneous pipeline stages must share graph "
                    "STRUCTURE (ops, attrs, wiring) — only widths may "
                    "differ; stage %d diverges from stage 0:\n  %s\n"
                    "  vs\n  %s" % (k, sig, sig0))
            sargs, souts, _ = s.infer_shape(data=act_shape)
            if tuple(souts[0]) != tuple(act_shape):
                raise MXNetError(
                    "stage %d must preserve the activation shape "
                    "(got %s from %s)" % (k, souts[0], act_shape))
            shapes = dict(zip(names0, sargs))
            shapes.pop("data")
            per_stage.append(shapes)
        self._stage_true_shapes = per_stage
        self._stage_shapes = {}
        for name in per_stage[0]:
            dims = {len(sh[name]) for sh in per_stage}
            if len(dims) != 1:
                raise MXNetError(
                    "stage param %r rank differs across stages" % name)
            self._stage_shapes[name] = tuple(
                max(sh[name][i] for sh in per_stage)
                for i in range(dims.pop()))
        for k, s in enumerate(self._stage_syms):
            padded = any(tuple(per_stage[k][n]) != self._stage_shapes[n]
                         for n in per_stage[k])
            if not padded:
                continue
            for node in s._topo():
                if node.is_variable:
                    continue
                why = _zero_preservation_violation(node)
                if why is not None:
                    raise MXNetError(
                        "heterogeneous pipeline stage %d is width-"
                        "padded and needs zero-preserving elementwise"
                        " ops (f(0)=0, e.g. relu/tanh/softsign); %s "
                        "would turn the zero padding into live lanes"
                        % (k, why))

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def _names(self):
        return sorted(list(self._stage_shapes) + list(self._embed_shapes)
                      + list(self._head_shapes))

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        if self.params_initialized and not force_init:
            return
        from ..initializer import InitDesc, Uniform

        initializer = initializer or Uniform(0.01)

        def make(name, shape):
            arr = nd.zeros(shape, ctx=Context("cpu"))
            initializer(InitDesc(name), arr)
            return arr.asnumpy()

        host, drawn = {}, set()
        for name, shape in self._stage_shapes.items():
            if arg_params and name in arg_params:
                stacked = _numpy(arg_params[name])
                self._check_padding_invariant(name, stacked)
            elif self._stage_true_shapes is None:
                stacked = np.stack([make(name, shape)
                                    for _ in range(self._num_stages)])
                drawn.add(name)
            else:
                # each stage at its true shape inside a zero block: the
                # zero padding makes the stacking exact
                stacked = np.zeros((self._num_stages,) + tuple(shape),
                                   np.float32)
                for k, true in enumerate(self._stage_true_shapes):
                    block = make(name, true[name])
                    stacked[(k,) + tuple(slice(0, d)
                                         for d in true[name])] = block
                drawn.add(name)
            host[name] = stacked
        for shapes in (self._embed_shapes, self._head_shapes):
            for name, shape in shapes.items():
                if arg_params and name in arg_params:
                    host[name] = _numpy(arg_params[name])
                else:
                    host[name] = make(name, shape)
                    drawn.add(name)
        self._arrays, self._grads = {}, {}
        for name in self._names():
            t = torch.as_tensor(np.asarray(host[name], np.float32)).to(
                self._device)
            if name in drawn:
                # one draw for the whole mesh: rank 0's
                C.broadcast(t, 0)
            if name in self._stage_shapes:
                t = t[self._stage].clone()
            self._arrays[name] = nd.NDArray(t)
            self._grads[name] = nd.NDArray(torch.zeros_like(t))
        self.params_initialized = True
        self._slab = None
        if self.optimizer_initialized:
            self._arm_update()

    def _check_padding_invariant(self, name, stacked):
        """Heterogeneous stacking is exact ONLY with zero padding; reject
        caller-supplied stage params (init_params AND set_params /
        checkpoint loads) that violate it."""
        if self._stage_true_shapes is None or \
                name not in self._stage_shapes:
            return
        for k, true in enumerate(self._stage_true_shapes):
            block = np.array(stacked[k], copy=True)
            block[tuple(slice(0, d) for d in true[name])] = 0
            if np.any(block):
                raise MXNetError(
                    "heterogeneous pipeline param %r stage %d has nonzero "
                    "values outside its true shape %s — the zero-padding "
                    "invariant would be violated" % (name, k, true[name]))

    def get_params(self):
        """The reference's parameters: the stage parameters stacked over
        the stages (gathered over the pipe group: every rank calls it),
        the embed and head ones as they are; host NDArrays."""
        out = {}
        for name in self._names():
            t = self._arrays[name].data
            if name in self._stage_shapes:
                t = C.all_gather(t.unsqueeze(0).contiguous(), 0,
                                 self._pipe_group)
            out[name] = nd.NDArray(t.detach().cpu().clone())
        return out, {}

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        for n, v in (arg_params or {}).items():
            if n not in self._arrays:
                if not allow_extra:
                    raise MXNetError("unknown param %r" % n)
                continue
            host = _numpy(v).astype(np.float32)
            self._check_padding_invariant(n, host)
            if n in self._stage_shapes:
                host = host[self._stage]
            with torch.no_grad():
                self._arrays[n].data.copy_(torch.as_tensor(host))
        self.params_initialized = True

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", 1.0 / self._batch)
            idx2name = dict(enumerate(self._names()))
            optimizer = opt_mod.create(optimizer, param_idx2name=idx2name,
                                       **optimizer_params)
        self._optimizer = optimizer
        if optimizer.fused_kernel() is None:
            raise MXNetError("PipelineModule needs an optimizer with a "
                             "fused kernel (got %s)"
                             % type(optimizer).__name__)
        self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        self._arm_update()

    def _arm_update(self):
        """B1 over the rank's slab where the plan arms, else None (the
        optimizer's per-parameter ``apply`` through the updater)."""
        from ..train_step import SlabUpdate

        self._slab = SlabUpdate.over_arrays(
            self._arrays, self._grads, self._names(), self._optimizer,
            self._updater, self._device)

    def _update(self):
        if self._slab is not None:
            self._slab()
            return
        names = self._names()
        self._updater.update_multi(list(range(len(names))),
                                   [self._grads[n] for n in names],
                                   [self._arrays[n] for n in names])

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _local_batch(self, data_batch):
        """This rank's (M, mb / data, ...) slice of the batch and its
        label rows (each microbatch's data-axis slice)."""
        m, mb, ml = self._num_micro, self._mb, self._mb_local
        r0 = self._data_rank * ml

        def rows(arr):
            t = arr.data if isinstance(arr, nd.NDArray) else \
                torch.as_tensor(np.asarray(arr))
            t = t.to(self._device)
            return t.reshape((m, mb) + tuple(t.shape[1:]))[:, r0:r0 + ml]

        x = rows(data_batch.data[0])
        labels = {}
        for d, arr in zip(self._label_shapes, data_batch.label or []):
            if d.name in self._label_names:
                lab = rows(arr)
                labels[d.name] = lab.reshape((m * ml,) + tuple(
                    lab.shape[2:])).float()
        return x, labels

    def _run(self, data_batch, is_train, train):
        """One pass: the embed (first stage), the schedule, the head (last
        stage) and, with ``train``, the gradients.  Returns the head's
        outputs on the last stage (None elsewhere)."""
        m, ml = self._num_micro, self._mb_local
        x, labels = self._local_batch(data_batch)
        step_seed = _seed(self._base_seed, self._num_steps, int(train))
        gen = self._gen
        names = self._names()
        leaves = {n: self._arrays[n].data.detach().requires_grad_(train)
                  for n in names}
        stage_p = {n: leaves[n] for n in self._stage_shapes}
        act_tail = self._act_shape[1:]
        act_shape = (ml,) + tuple(act_tail)
        stage_fn = self._stage_fn
        stage = self._stage

        def run_stage(params, act, mb_id):
            gen.manual_seed(_seed(step_seed, stage, mb_id))
            env = dict(params)
            env["data"] = act
            return stage_fn(env, is_train, gen)[0]

        with torch.set_grad_enabled(train):
            first = None
            if self._is_first:
                a = x.reshape((m * ml,) + tuple(x.shape[2:]))
                if self._embed_fn is not None:
                    env = {n: leaves[n] for n in self._embed_shapes}
                    env["data"] = a
                    gen.manual_seed(_seed(step_seed, -1))
                    a = self._embed_fn(env, is_train, gen)[0]
                first = a.float().reshape((m,) + act_shape)
            sched = Schedule(self._pipe_group)
            outs = sched.run(run_stage, stage_p,
                             (lambda j: first[j]) if first is not None
                             else None, m, act_shape, torch.float32,
                             self._device, remat=self._remat and train)
            head_outs = None
            if self._is_last:
                h = torch.cat(outs)
                env = {n: leaves[n] for n in self._head_shapes}
                env["data"] = h
                for nme, shape in self._extra_head_vars.items():
                    env[nme] = torch.zeros(
                        (shape[0] // self._data_par,) + tuple(shape[1:]),
                        device=self._device)
                env.update(labels)
                gen.manual_seed(_seed(step_seed, -2))
                head_outs = self._head_fn(env, is_train, gen,
                                          tp=self._head_tp)
            if train:
                wanted = [leaves[n] for n in names] + sched.anchors
                if self._is_last:
                    roots = list(head_outs)
                    seeds = [torch.ones_like(o) for o in roots]
                else:
                    roots, seeds = [sched.sink], [torch.ones(
                        (), device=self._device)]
                grads = torch.autograd.grad(roots, wanted, seeds,
                                            allow_unused=True)
                C.wait_sends()
                with torch.no_grad():
                    for n, g in zip(names, grads):
                        if g is None:
                            self._grads[n].data.zero_()
                        else:
                            self._grads[n].data.copy_(g)
        if head_outs is not None:
            head_outs = [o.detach() for o in head_outs]
        return head_outs, labels

    def _share_grads(self):
        """Stage gradients and the embed / head ones summed over the data
        group (one all-reduce); the embed's broadcast from the first
        stage, the head's from the last, over the pipe group."""
        names = self._names()
        if self._data_par > 1:
            flat = torch.cat([self._grads[n].data.reshape(-1)
                              for n in names])
            C.all_reduce(flat, self._data_group)
            _unflatten(flat, [self._grads[n].data for n in names])
        if self._num_stages > 1:
            ranks = self._pipe_ranks
            for shapes, src in ((self._embed_shapes, ranks[0]),
                                (self._head_shapes, ranks[-1])):
                grads = [self._grads[n].data for n in sorted(shapes)]
                if grads:
                    flat = torch.cat([g.reshape(-1) for g in grads])
                    C.broadcast(flat, src, self._pipe_group)
                    _unflatten(flat, grads)

    def forward_backward(self, data_batch):
        """One train step: forward, the reverse pipeline, the update."""
        import time

        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        if self._pending_metric is not None and self._metric_acc is None:
            self._try_attach_metric(data_batch)
        t0 = time.perf_counter()
        outs, labels = self._run(data_batch, True, True)
        self._share_grads()
        self._update()
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.last_step_s = time.perf_counter() - t0
        self._num_steps += 1
        self._set_outputs(outs)
        self._outputs_from_step = True
        if self._metric_acc is not None:
            self._accumulate_metric(outs, labels)

    def update(self):
        pass  # the optimizer update runs inside forward_backward

    def backward(self, out_grads=None):
        raise MXNetError("PipelineModule fuses forward/backward/update; "
                         "use forward_backward()")

    def forward(self, data_batch, is_train=None):
        """Forward only — never updates parameters."""
        if is_train is None:
            is_train = self.for_training
        with torch.no_grad():
            outs, _ = self._run(data_batch, bool(is_train), False)
        self._set_outputs(outs)
        self._outputs_from_step = False

    def _set_outputs(self, outs):
        self._outputs = outs
        self._outputs_full = None

    def get_outputs(self, merge_multi_context=True):
        """The head's outputs over the whole batch on every rank: the
        last stage's, gathered over the data group and broadcast over the
        pipe group (collectives: every rank calls it)."""
        if self._outputs_full is None:
            full = []
            last = self._pipe_ranks[-1]
            for i, (_, shape) in enumerate(self._output_shapes):
                if self._is_last:
                    o = self._gather_rows(self._outputs[i])
                else:
                    o = torch.empty(shape, dtype=torch.float32,
                                    device=self._device)
                if self._num_stages > 1:
                    o = o.contiguous()
                    C.broadcast(o, last, self._pipe_group)
                full.append(nd.NDArray(o))
            self._outputs_full = full
        return list(self._outputs_full)

    def _gather_rows(self, out):
        """A head output over this rank's rows -> over the batch, rows in
        the batch's order (each microbatch's data slices in turn)."""
        if self._data_par == 1:
            return out
        m = self._num_micro
        blocks = out.reshape((m, -1) + tuple(out.shape[1:]))
        full = C.all_gather(blocks.contiguous(), 1, self._data_group)
        return full.reshape((-1,) + tuple(out.shape[1:]))

    def get_input_grads(self, merge_multi_context=True):
        raise MXNetError("inputs_need_grad is not supported by "
                         "PipelineModule")

    # ------------------------------------------------------------------
    # device-side metrics: the last stage folds its rows into the sums,
    # one small all-reduce / broadcast shares the step's increments
    # ------------------------------------------------------------------
    def _bind_metric(self, eval_metric):
        self._pending_metric = None
        if not config.get("MXNET_DEVICE_METRICS"):
            self._detach_metric()
            return
        if self._metric_acc is not None \
                and self._metric_acc.metric is not eval_metric:
            self._detach_metric()
        self._pending_metric = eval_metric

    def _try_attach_metric(self, data_batch):
        metric = self._pending_metric
        self._pending_metric = None
        if not metric_mod.DeviceMetricAccumulator.supported(metric):
            return
        if len(data_batch.label or []) != len(self._label_names) or \
                [d.name for d in self._label_shapes] != self._label_names:
            return
        acc = metric_mod.DeviceMetricAccumulator(metric)
        acc.install(self._device)
        self._metric_acc = acc

    def _detach_metric(self):
        if self._metric_acc is not None:
            self._metric_acc.uninstall()
            self._metric_acc = None

    def _accumulate_metric(self, outs, labels):
        acc = self._metric_acc
        tensors = acc._tensors()
        with torch.no_grad():
            if self._is_last:
                before = [t.clone() for t in tensors]
                acc.update(acc.state, [labels[n] for n in self._label_names],
                           outs)
                delta = torch.stack([(t - b).double() for t, b in
                                     zip(tensors, before)])
                for t, b in zip(tensors, before):
                    t.copy_(b)
            else:
                delta = torch.zeros(len(tensors), dtype=torch.float64,
                                    device=self._device)
            if self._data_par > 1:
                C.all_reduce(delta, self._data_group)
            if self._num_stages > 1:
                C.broadcast(delta, self._pipe_ranks[-1], self._pipe_group)
            for t, d in zip(tensors, delta):
                t.add_(d.to(t.dtype))
        acc.commit()

    def update_metric(self, eval_metric, labels):
        acc = self._metric_acc
        if acc is not None and acc.metric is eval_metric \
                and self._outputs_from_step:
            acc.maybe_drain(self._num_steps)
            return
        eval_metric.update(labels, metric_mod.select_outputs(
            eval_metric, self.get_outputs()))

    def install_monitor(self, mon):
        raise MXNetError("per-op monitoring is not available inside the "
                         "pipelined step; use a Module on the unrolled "
                         "net to inspect values")


def _numpy(v):
    if isinstance(v, nd.NDArray):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _unflatten(flat, tensors):
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n

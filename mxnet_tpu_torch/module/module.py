"""Module — the standard symbol-backed module (the counterpart of
``mxnet_tpu/module/module.py``, single device).

Training runs through :class:`~mxnet_tpu_torch.train_step.
CompiledTrainStep` where the JAX package's rule allows it
(``_fused_eligible``: ``MXNET_FUSED_TRAIN_STEP``, training without
``inputs_need_grad``, the local store, an optimizer with a
``fused_kernel``): ``forward_backward`` then runs the whole step
(forward, backward, the optimizer update and, after ``fit`` binds one,
the metric's accumulation) as one captured program — one CUDA-graph
replay a step on the card — and the following ``update()`` is a no-op.
``forward``/``backward``/``update`` remain the eager path; both paths
update the same arrays through the same
:class:`~mxnet_tpu_torch.optimizer.Updater` states, so they mix freely.
The step arms its slab plan wherever the optimizer and the masters
allow it: the executor's trainables and the updater's states become
views of the plan's slabs, so the eager update, ``get_params`` and
``set_params`` read and write the storage the multi-tensor kernel
updates.  ``get_outputs`` after a compiled step returns copies (a
replay overwrites the program's outputs).

``score`` accumulates a device-capable metric through a
:class:`~mxnet_tpu_torch.train_step.CompiledEvalStep`
(``_bind_eval_metric``).  ``save_checkpoint`` / ``Module.load`` /
``save_optimizer_states`` / ``load_optimizer_states`` read and write the
JAX package's files (``.params``, ``-symbol.json``, the fused
``.states`` payload).

Inference (``forward(is_train=False)``, ``predict``, ``score``'s host
path) replays the executor's captured forward
(:class:`~mxnet_tpu_torch.train_step.CompiledForward`) over the same
arrays the train step updates, so it sees the step's parameters.
``reshape`` rebinds for new input shapes, sharing the parameters.
``install_monitor`` puts a :class:`~mxnet_tpu_torch.monitor.Monitor`'s
tap on the executor; as in the JAX package a monitored module drops its
train step (the optimizer's slots handed to the eager updater through
``export_updater_states``) and trains eagerly, and scores on the host
path.

``bind(..., shared_module=)`` takes the shared module's parameter and
aux arrays (the same NDArrays) wherever name and shape match, and its
host parameter dicts; ``borrow_optimizer`` takes its optimizer, updater
and train step, which then runs this module's graph over the one store
(``BucketingModule``).

The module runs on the card (``gpu(0)``) unless ``context=cpu()``; with
no card and no CPU context it raises, as ``DecodePredictor`` does.
``plain=True`` runs every op that owns a hand-written kernel through its
plain PyTorch version — the reference the kernels are held to.
"""
from __future__ import annotations

import logging

from .. import config
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..context import Context, cpu, gpu, resolve_device
from ..initializer import InitDesc
from ..io import as_desc_list
from ..metric import DeviceMetricAccumulator, select_outputs
from ..model import load_checkpoint
from ..ndarray import NDArray, array, zeros
from ..train_step import CompiledEvalStep, CompiledTrainStep
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None, compute_dtype=None,
                 plain=False):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("Module runs on one device; got %d "
                                 "contexts" % len(context))
            context = context[0]
        self._context = context if isinstance(context, Context) else gpu(0)
        self._device = resolve_device(self._context)
        self._compute_dtype = compute_dtype
        self._plain = plain
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        inputs = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._updater = None
        self._exec_group = None
        self._train_step = None
        self._step_update_done = False
        self._fused_outputs = None
        self._pending_metric = None
        self._preload_opt_states = None
        self._eval_step_cache = None
        self._monitor = None
        self._output_names = symbol.list_outputs()
        self.inputs_need_grad = False

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from a checkpoint (``prefix-symbol.json``,
        ``prefix-%04d.params`` and, with ``load_optimizer_states``,
        ``prefix-%04d.states``, loaded at ``init_optimizer``)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write ``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states``."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info("Saved optimizer state to \"%s\"", state_name)

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        if not self.binded:
            raise MXNetError("call bind first")
        return self._exec_group.data_shapes

    @property
    def label_shapes(self):
        if not self.binded:
            raise MXNetError("call bind first")
        return self._exec_group.label_shapes or None

    @property
    def output_shapes(self):
        """``(name, shape)`` of each output of the last forward ([]
        before one)."""
        if not self.binded:
            raise MXNetError("call bind first")
        if self._exec_group.exec_._outputs is None:
            return []
        return [(n, o.shape) for n, o in
                zip(self._output_names, self._exec_group.get_outputs())]

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            if self._train_step is not None:
                self._train_step.detach_metric()
            self.binded = False
            self._exec_group = None
            self._train_step = None
            self._fused_outputs = None
            self._pending_metric = None
            self._eval_step_cache = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise MXNetError("inputs_need_grad needs for_training")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        shared_group = None
        if shared_module is not None:
            if not (shared_module.binded
                    and shared_module.params_initialized):
                raise MXNetError("bind and initialize the shared module "
                                 "first")
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._device, data_shapes, label_shapes,
            self._param_names, for_training,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            plain=self._plain, shared_group=shared_group,
            inputs_need_grad=inputs_need_grad)
        self.binded = True
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Initialize host copies of the parameters (from ``arg_params``
        / ``aux_params`` where given — NDArrays, tensors or numpy — else
        from ``initializer``) and load them into the executor."""
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before initializing the parameters")
        exe = self._exec_group.exec_
        if self._arg_params is None:
            self._arg_params = {n: zeros(exe.arg_dict[n].shape, cpu(),
                                         exe.arg_dict[n].data.dtype)
                                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {n: zeros(exe.aux_dict[n].shape, cpu(),
                                         exe.aux_dict[n].data.dtype)
                                for n in self._aux_names}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                src = array(cache[name], cpu())
                if src.shape != arr.shape:
                    raise MXNetError(
                        "Parameter %s cannot be initialized from loading. "
                        "Shape mismatch: %s vs %s"
                        % (name, src.shape, arr.shape))
                arr[:] = src
            elif cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name), initializer),
                            arr)

        for name, arr in sorted(self._arg_params.items()):
            _impl(name, arr, arg_params)
        for name, arr in sorted(self._aux_params.items()):
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._exec_group.set_params(self._arg_params, self._aux_params)
        if self._train_step is not None:
            self._train_step.load_from_executor()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        """Load ``arg_params`` / ``aux_params`` into the executor.  With
        ``allow_missing`` on an initialized module only the given names
        are written (the rest keep their current values), as in the JAX
        package."""
        if not (allow_missing and self.params_initialized):
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        if not force_init:
            return
        self._exec_group.set_params(arg_params, aux_params)
        if self._train_step is not None:
            self._train_step.load_from_executor()

    def get_params(self):
        """Host copies ``(arg_params, aux_params)`` of the current
        parameters."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self._exec_group.get_params(self._arg_params, self._aux_params)
        return self._arg_params, self._aux_params

    # ------------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Create the optimizer (``rescale_grad`` defaults to 1 /
        batch size) and its updater; a training module whose
        configuration is eligible also gets its
        :class:`CompiledTrainStep` (with the slab plan armed where the
        optimizer and the masters allow it).  Only the local
        single-device store exists: ``kvstore`` must be "local" or
        None."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring")
            return
        if kvstore not in ("local", None):
            raise MXNetError("kvstore %r is not ported (single device)"
                             % (kvstore,))
        rescale_grad = 1.0 / self._exec_group.batch_size
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._exec_group.param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt_mod.create(optimizer, sym=self._symbol,
                                       param_idx2name=idx2name,
                                       **optimizer_params)
        elif optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created outside Module but rescale_grad is not "
                "1.0/batch_size (%s vs. %s). Is this intended?",
                optimizer.rescale_grad, rescale_grad)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        self._maybe_build_fused_step()
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def _fused_eligible(self, optimizer):
        """Whether the compiled train step can own the update (the JAX
        package's rule, decided before anything runs): the switch on,
        training without input gradients, and an optimizer with a fused
        kernel.  The store is always local here."""
        if not config.get("MXNET_FUSED_TRAIN_STEP"):
            return False
        if not self.for_training or self.inputs_need_grad:
            return False
        if optimizer.fused_kernel() is None:
            self.logger.info(
                "optimizer %s has no fused kernel; using eager update path",
                type(optimizer).__name__)
            return False
        return True

    def _maybe_build_fused_step(self):
        """Build the compiled train step when the configuration allows
        it (dropping an earlier one and its metric)."""
        if self._train_step is not None:
            self._train_step.detach_metric()
        self._train_step = None
        self._step_update_done = False
        self._fused_outputs = None
        if self._monitor is None and self._fused_eligible(self._optimizer):
            try:
                self._train_step = CompiledTrainStep(
                    self._exec_group, self._optimizer, self._updater,
                    compute_dtype=self._compute_dtype)
            except MXNetError as exc:
                # the JAX package's rule: a step the compiled program
                # refuses (grad_req "add") trains on the eager path
                self.logger.warning("compiled train step unavailable (%s); "
                                    "using the eager update path", exc)

    def borrow_optimizer(self, shared_module):
        """Share ``shared_module``'s optimizer, updater and train step
        (bucketing): this module's steps update the same store, through
        a program of its own graph."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("the shared module has no optimizer yet")
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self._train_step = shared_module._train_step
        self._step_update_done = False
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        """One training forward + backward.  With a train step this runs
        the whole compiled step, the optimizer update included; the
        following ``update()`` is then a no-op."""
        if self._train_step is not None:
            self._run_fused(data_batch)
        else:
            self.forward(data_batch, is_train=True)
            self.backward()

    def _run_fused(self, data_batch):
        if self._pending_metric is not None:
            # arm device-side accumulation once; a metric the step cannot
            # host stays on the host update_metric path
            self._train_step.attach_metric(self._pending_metric)
            self._pending_metric = None
        self._fused_outputs = self._train_step.run(data_batch,
                                                   group=self._exec_group)
        self._step_update_done = True

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self._step_update_done = False
        self._fused_outputs = None
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        """The gradients of the last training forward, seeded with
        ``out_grads`` (one an output) when given, else with ones."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """The optimizer step over the gradients of the last backward; a
        no-op right after a compiled step's ``forward_backward``."""
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        if self._step_update_done:
            self._step_update_done = False
            return
        group = self._exec_group
        idxs, grads, weights = [], [], []
        for idx, (w, g) in enumerate(zip(group.param_arrays,
                                         group.grad_arrays)):
            if g is not None:
                idxs.append(idx)
                grads.append(g)
                weights.append(w)
        self._updater.update_multi(idxs, grads, weights)
        if self._train_step is not None:
            self._train_step.load_from_executor()

    def get_outputs(self, merge_multi_context=True):
        """The outputs of the last forward or step (copies after a
        compiled step: the next replay overwrites its outputs)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        if self._fused_outputs is not None:
            return [NDArray(o.clone()) for o in self._fused_outputs]
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not (self.binded and self.params_initialized
                and self.inputs_need_grad):
            raise MXNetError("bind with inputs_need_grad first")
        return self._exec_group.get_input_grads(merge_multi_context)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes (a new batch size), sharing the
        parameters, their gradients and the aux states by identity."""
        if not self.binded:
            raise MXNetError("call bind first")
        self._fused_outputs = None
        self._exec_group.reshape(as_desc_list(data_shapes),
                                 as_desc_list(label_shapes))

    def install_monitor(self, mon):
        """Tap every node's outputs into ``mon``.  A monitored module
        drops its compiled train step (its optimizer slots go to the
        eager updater, so nothing is lost) and runs eagerly."""
        if not self.binded:
            raise MXNetError("call bind first")
        self._monitor = mon
        if self._train_step is not None:
            self._train_step.detach_metric()
            if self._updater is not None:
                self._train_step.export_updater_states(
                    self._updater, self._exec_group.param_names)
            self._train_step = None
            self._step_update_done = False
            self._fused_outputs = None
            self._pending_metric = None
        self._exec_group.install_monitor(mon)

    def update_metric(self, eval_metric, labels):
        if self._fused_outputs is None:
            self._exec_group.update_metric(eval_metric, labels)
            return
        acc = self._train_step._metric_acc \
            if self._train_step is not None else None
        if acc is not None and acc.metric is eval_metric:
            # accumulated inside the step; the periodic drain's policy
            acc.maybe_drain(self._train_step.num_steps)
            return
        eval_metric.update(labels, [NDArray(o) for o in select_outputs(
            eval_metric, self._fused_outputs)])

    # ------------------------------------------------------------------
    # the async loop's hooks
    # ------------------------------------------------------------------
    def _bind_metric(self, eval_metric):
        self._pending_metric = None
        if self._train_step is None:
            return
        if not config.get("MXNET_DEVICE_METRICS"):
            self._train_step.detach_metric()
            return
        acc = self._train_step._metric_acc
        if acc is not None and acc.metric is not eval_metric:
            self._train_step.detach_metric()
        self._pending_metric = eval_metric

    def _bind_eval_metric(self, eval_metric):
        """A :class:`CompiledEvalStep` accumulating ``eval_metric`` on the
        device for ``score``, or None for the host path."""
        if not config.get("MXNET_DEVICE_METRICS"):
            return None
        if self._monitor is not None:
            return None  # the taps need the eager forward
        if not (self.binded and self.params_initialized):
            return None
        if not DeviceMetricAccumulator.supported(eval_metric):
            return None
        # a metric whose hooks the train step owns (fit's default
        # validation metric is the train metric) scores on the host
        if any(getattr(m, "_device_sync", None) is not None
               for m in DeviceMetricAccumulator._flatten(eval_metric)):
            return None
        cached = self._eval_step_cache
        if cached is not None and cached[0] is self._exec_group.exec_ \
                and cached[1] is eval_metric:
            return cached[2].rearm()
        try:
            step = CompiledEvalStep(self._exec_group, eval_metric)
        except MXNetError as exc:
            self.logger.info("device-side eval metrics unavailable (%s); "
                             "using the host path", exc)
            return None
        self._eval_step_cache = (self._exec_group.exec_, eval_metric, step)
        return step

    def _wrap_train_data(self, train_data):
        from ..io import DevicePrefetchIter

        if self._train_step is None or self._device.type != "cuda" \
                or not config.get("MXNET_DEVICE_PREFETCH") \
                or isinstance(train_data, DevicePrefetchIter):
            return train_data
        return DevicePrefetchIter(train_data, self._device)

    def _dispatch_fence(self):
        """The CUDA event recorded after the last compiled step (None on
        the CPU or after an eager step)."""
        if self._fused_outputs is None or self._train_step is None:
            return None
        return self._train_step.last_event

    # ------------------------------------------------------------------
    # optimizer states
    # ------------------------------------------------------------------
    def save_optimizer_states(self, fname):
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        source = self._train_step if self._train_step is not None \
            else self._updater
        with open(fname, "wb") as fout:
            fout.write(source.get_states())

    def load_optimizer_states(self, fname):
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer first")
        target = self._train_step if self._train_step is not None \
            else self._updater
        with open(fname, "rb") as fin:
            target.set_states(fin.read())

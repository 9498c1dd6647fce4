"""Module — the standard symbol-backed module (the counterpart of
``mxnet_tpu/module/module.py``, single device).

``forward_backward`` runs one whole :class:`~mxnet_tpu_torch.train_step.
TrainStep` (forward, backward and the optimizer update) when the module
trains its parameters, and the following ``update()`` is then a no-op,
as in the JAX package.  ``forward``/``backward``/``update`` remain the
eager path; both paths update the same parameter tensors through the
same :class:`~mxnet_tpu_torch.optimizer.Updater`, so they mix freely.

The module runs on the card (``gpu(0)``) unless ``context=cpu()``; with
no card and no CPU context it raises, as ``DecodePredictor`` does.
``plain=True`` runs every op that owns a hand-written kernel through its
plain PyTorch version — the reference the kernels are held to.
"""
from __future__ import annotations

import logging

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..context import Context, gpu, resolve_device
from ..initializer import InitDesc
from ..ndarray import array, zeros
from ..train_step import TrainStep
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

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        if force_rebind:
            self.binded = False
            self._exec_group = None
            self._train_step = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad:
            raise NotImplementedError("inputs_need_grad is not ported")
        self.for_training = for_training
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._device, data_shapes, label_shapes,
            self._param_names, for_training,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            plain=self._plain)
        self.binded = True
        if self.params_initialized:
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
            self._arg_params = {n: zeros(exe.arg_dict[n].shape,
                                         dtype=exe.arg_dict[n].data.dtype)
                                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {n: zeros(exe.aux_dict[n].shape,
                                         dtype=exe.aux_dict[n].data.dtype)
                                for n in self._aux_names}
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                src = array(cache[name])
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

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

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
        batch size) and its updater; a training module also gets its
        :class:`TrainStep`.  Only the local single-device store exists:
        ``kvstore`` must be "local" or None."""
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
        self._train_step = None
        if self.for_training:
            self._train_step = TrainStep(self._exec_group, self._updater,
                                         compute_dtype=self._compute_dtype)
        self._step_update_done = False
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        """One training forward + backward.  With a train step this runs
        the whole step, the optimizer update included; the following
        ``update()`` is then a no-op."""
        if self._train_step is not None:
            self._train_step.run(data_batch)
            self._step_update_done = True
        else:
            self.forward(data_batch, is_train=True)
            self.backward()

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self._step_update_done = False
        self._exec_group.forward(data_batch, is_train)

    def backward(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        self._exec_group.backward()

    def update(self):
        """The optimizer step over the gradients of the last backward; a
        no-op right after a train step's ``forward_backward``."""
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

    def get_outputs(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("bind and initialize the module first")
        return self._exec_group.get_outputs()

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

"""BaseModule — the high-level train / evaluate interface (the parts of
``mxnet_tpu/module/base_module.py`` the training loop calls: ``fit``,
``score``, ``forward_backward`` and the abstract surface)."""
from __future__ import annotations

import logging
import time
from collections import namedtuple

from .. import metric as metric_mod

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _fire(cbs, *args):
    if cbs is None:
        return
    for cb in (cbs if isinstance(cbs, (list, tuple)) else (cbs,)):
        cb(*args)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """An evaluation pass; returns the metric's (name, value) list."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialize the module first")
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            _fire(batch_end_callback,
                  BatchEndParam(epoch, nbatch, eval_metric, locals()))
        return eval_metric.get_name_value()

    def prepare_fit(self, train_data, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_rebind=False, force_init=False, kvstore="local",
                    optimizer="sgd",
                    optimizer_params=(("learning_rate", 0.01),)):
        """Bind, initialize the parameters and the optimizer for
        ``train_data``'s shapes."""
        from ..initializer import Uniform

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        self.init_params(initializer=initializer or Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_batch_end_callback=None, initializer=None, arg_params=None,
            aux_params=None, allow_missing=False, force_rebind=False,
            force_init=False, begin_epoch=0, num_epoch=None,
            validation_metric=None):
        """Train for ``num_epoch`` epochs: one forward_backward + update
        per batch, an optional validation pass per epoch."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        self.prepare_fit(train_data, initializer=initializer,
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing,
                         force_rebind=force_rebind, force_init=force_init,
                         kvstore=kvstore, optimizer=optimizer,
                         optimizer_params=optimizer_params)
        eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        try:
            for epoch in range(begin_epoch, num_epoch):
                if epoch > begin_epoch:
                    train_data.reset()
                start = time.time()
                eval_metric.reset()
                for nbatch, batch in enumerate(train_data):
                    self.forward_backward(batch)
                    self.update()
                    self.update_metric(eval_metric, batch.label)
                    _fire(batch_end_callback,
                          BatchEndParam(epoch, nbatch, eval_metric, locals()))
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - start)
                arg_snap, aux_snap = self.get_params()
                _fire(epoch_end_callback, epoch, self.symbol, arg_snap,
                      aux_snap)
                if eval_data:
                    for name, val in self.score(
                            eval_data, validation_metric,
                            batch_end_callback=eval_batch_end_callback,
                            epoch=epoch):
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
        finally:
            # leave the caller's iterator fresh for a second fit()
            train_data.reset()

    # the abstract surface
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

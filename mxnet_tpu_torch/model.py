"""``mxnet_tpu/model.py``'s checkpoint helpers (``save_checkpoint`` /
``load_checkpoint``: ``prefix-symbol.json`` plus ``prefix-%04d.params``
in the JAX package's formats, so either package loads what the other
wrote), the KVStore policy (``_create_kvstore``) and the legacy
``FeedForward`` estimator over ``Module``."""
from __future__ import annotations

import logging

import numpy as np

from . import io as io_mod
from . import kvstore as kvs_mod
from . import ndarray as nd
from . import symbol as sym_mod
from .context import cpu, gpu

__all__ = ["save_checkpoint", "load_checkpoint", "FeedForward"]


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore, update_on_kvstore)`` by the reference's policy: no
    store for one device unless the type is dist; no update on a local
    store whose largest parameter holds more than 16 Mi values."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs_mod.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs_mod.create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(param.shape)
                               for param in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params`` (``arg:`` / ``aux:`` keys)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
    save_dict.update({"aux:%s" % k: v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` from a checkpoint; the
    parameters are host NDArrays."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    save_dict = nd._load("%s-%04d.params" % (prefix, epoch), cpu())
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy estimator: ``fit`` / ``predict`` / ``score`` through a
    :class:`~mxnet_tpu_torch.module.Module` bound to the data's shapes.
    Numpy inputs are wrapped in an ``NDArrayIter`` (batch
    ``numpy_batch_size``, ``roll_over``; shuffled for training).  The
    device is the card unless ``ctx`` is ``cpu()``; optimizer settings
    ride in ``kwargs``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform

        self.symbol = symbol
        if ctx is None:
            ctx = [gpu(0)]
        elif not isinstance(ctx, list):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    def _label_name(self):
        names = [n for n in self.symbol.list_arguments()
                 if n.endswith("label")]
        return names[0] if names else "softmax_label"

    def _build_module(self, data):
        from .module import Module

        data_names = [d[0] for d in data.provide_data]
        label_names = [d[0] for d in data.provide_label] \
            or [self._label_name()]
        self._module = Module(self.symbol, data_names=data_names,
                              label_names=label_names, context=self.ctx)
        return self._module

    def _bound_module(self, data):
        """The module for inference, bound and loaded on first use."""
        if self._module is None or not self._module.binded:
            mod = self._build_module(data)
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label or None,
                     for_training=False)
            mod.init_params(initializer=self.initializer,
                            arg_params=self.arg_params,
                            aux_params=self.aux_params, allow_missing=True)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train for ``num_epoch`` epochs; keeps the trained parameters."""
        data = self._init_iter(X, y, is_train=True)
        if eval_data is not None \
                and not isinstance(eval_data, io_mod.DataIter):
            if isinstance(eval_data, tuple):
                eval_data = io_mod.NDArrayIter(eval_data[0], eval_data[1],
                                               self.numpy_batch_size)
            else:
                eval_data = self._init_iter(eval_data, None, is_train=False)
        mod = self._build_module(data)
        optimizer_params = dict(self.kwargs)
        if isinstance(self.optimizer, str):
            optimizer_params.setdefault("learning_rate", 0.01)
        mod.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=optimizer_params,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, allow_missing=True,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy (a list for several outputs).
        ``return_data`` is taken, and ignored, as in the JAX package."""
        data = self._init_iter(X, None, is_train=False)
        outputs = self._bound_module(data).predict(data, num_batch=num_batch,
                                                   reset=reset)
        if isinstance(outputs, list):
            return [o.asnumpy() for o in outputs]
        return outputs.asnumpy()

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """The metric's value over ``X``."""
        data = self._init_iter(X, None, is_train=False)
        res = self._bound_module(data).score(
            data, eval_metric, num_batch=num_batch,
            batch_end_callback=batch_end_callback, reset=reset)
        return res[0][1]

    def _init_iter(self, X, y, is_train):
        if isinstance(X, io_mod.DataIter):
            return X
        if isinstance(X, (np.ndarray, nd.NDArray)):
            if isinstance(X, nd.NDArray):
                X = X.asnumpy()
            if y is None:
                y = np.zeros(len(X))
            return io_mod.NDArrayIter(X, y, min(self.numpy_batch_size,
                                                len(X)),
                                      shuffle=is_train,
                                      last_batch_handle="roll_over")
        raise TypeError("X must be DataIter or numpy array")

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        if epoch is None:
            raise ValueError("save needs an epoch")
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Make a FeedForward and ``fit`` it."""
        from .initializer import Uniform

        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer or Uniform(0.01),
                            **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model

"""Checkpoint helpers of ``mxnet_tpu/model.py`` (``save_checkpoint`` /
``load_checkpoint``): ``prefix-symbol.json`` plus ``prefix-%04d.params``
in the JAX package's formats, so either package loads what the other
wrote.  The legacy ``FeedForward`` estimator is not ported."""
from __future__ import annotations

import logging

from . import ndarray as nd
from . import symbol as sym_mod

__all__ = ["save_checkpoint", "load_checkpoint"]


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
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params

"""RNN-aware checkpointing (the port of ``mxnet_tpu/rnn/rnn.py``).

Fused RNN cells keep their parameters as one packed blob; on disk the
checkpoint holds what ``cell.pack_weights`` / ``unpack_weights`` make of
them, as the JAX package's helpers write it, so either package loads the
other's files.  The helpers wrap ``model.save_checkpoint`` /
``load_checkpoint``.
"""
from __future__ import annotations

from .. import model as model_mod

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _through_cells(cells, method, params):
    """Thread ``params`` through ``cell.<method>`` for every cell."""
    if not isinstance(cells, (list, tuple)):
        cells = (cells,)
    for cell in cells:
        params = getattr(cell, method)(params)
    return params


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """``model.save_checkpoint`` with fused-cell weights packed first."""
    model_mod.save_checkpoint(
        prefix, epoch, symbol,
        _through_cells(cells, "pack_weights", arg_params), aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """``model.load_checkpoint`` + unpack of fused-cell weights."""
    symbol, arg_params, aux_params = model_mod.load_checkpoint(prefix, epoch)
    return symbol, _through_cells(cells, "unpack_weights", arg_params), \
        aux_params


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback variant of ``save_rnn_checkpoint`` (drop-in for
    ``callback.do_checkpoint`` when the net contains fused cells)."""
    period = max(1, int(period))

    def on_epoch_end(epoch, symbol=None, arg_params=None, aux_params=None):
        if (epoch + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, epoch + 1, symbol,
                                arg_params, aux_params)

    return on_epoch_end

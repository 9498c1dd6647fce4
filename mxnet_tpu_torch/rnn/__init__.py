"""The RNN package: cells (``rnn_cell``), the bucketing sentence
iterator (``io``) and the checkpoint helpers (``rnn``), after
``mxnet_tpu/rnn/``."""
from . import rnn_cell
from .io import BucketSentenceIter
from .rnn import do_rnn_checkpoint, load_rnn_checkpoint, save_rnn_checkpoint
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams, SequentialRNNCell,
                       ZoneoutCell)

__all__ = ["BaseRNNCell", "BidirectionalCell", "BucketSentenceIter",
           "DropoutCell", "FusedRNNCell", "GRUCell", "LSTMCell",
           "ModifierCell", "ResidualCell", "RNNCell", "RNNParams",
           "SequentialRNNCell", "ZoneoutCell", "do_rnn_checkpoint",
           "load_rnn_checkpoint", "rnn_cell", "save_rnn_checkpoint"]

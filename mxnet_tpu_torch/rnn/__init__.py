"""The RNN package: cells (``rnn_cell``) and the bucketing sentence
iterator (``io``), after ``mxnet_tpu/rnn/``.  The checkpoint helpers of
``rnn/rnn.py`` wait for ``.params`` file I/O."""
from . import rnn_cell
from .io import BucketSentenceIter
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams, SequentialRNNCell,
                       ZoneoutCell)

__all__ = ["BaseRNNCell", "BidirectionalCell", "BucketSentenceIter",
           "DropoutCell", "FusedRNNCell", "GRUCell", "LSTMCell",
           "ModifierCell", "ResidualCell", "RNNCell", "RNNParams",
           "SequentialRNNCell", "ZoneoutCell", "rnn_cell"]

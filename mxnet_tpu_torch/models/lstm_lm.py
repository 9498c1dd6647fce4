"""LSTM language model for bucketed training — the port of
``mxnet_tpu/models/lstm_lm.py`` (the reference MXNet's
``example/rnn/lstm_bucketing.py`` PTB workload): embedding -> stacked
LSTM (fused by default) -> FC over the vocabulary -> SoftmaxOutput,
returned as a ``sym_gen`` for ``BucketingModule``.

``ignore_label`` (an addition of the port; None by default, which builds
the reference's graph exactly) makes the head skip padded positions:
``SoftmaxOutput(use_ignore=True, ignore_label=...)``, for
``BucketSentenceIter``'s padding.
"""
from __future__ import annotations

from .. import rnn
from .. import symbol as sym


def sym_gen_factory(num_hidden=200, num_layers=2, num_embed=200,
                    vocab_size=10000, fused=True, dropout=0.0,
                    ignore_label=None):
    """Returns ``(sym_gen, stack)``: ``sym_gen(seq_len)`` for
    BucketingModule (layout NT) and the cell stack it unrolls."""
    if fused:
        stack = rnn.FusedRNNCell(num_hidden, num_layers=num_layers,
                                 mode="lstm", prefix="lstm_", dropout=dropout)
    else:
        stack = rnn.SequentialRNNCell()
        for i in range(num_layers):
            stack.add(rnn.LSTMCell(num_hidden, prefix="lstm_l%d_" % i))
    head = {} if ignore_label is None else {"use_ignore": True,
                                            "ignore_label": ignore_label}

    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data, input_dim=vocab_size,
                              output_dim=num_embed, name="embed")
        stack.reset()
        outputs, states = stack.unroll(seq_len, inputs=embed, layout="NTC",
                                       merge_outputs=True)
        pred = sym.Reshape(outputs, shape=(-1, num_hidden))
        pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
        lab = sym.Reshape(label, shape=(-1,))
        pred = sym.SoftmaxOutput(pred, lab, name="softmax", **head)
        return pred, ("data",), ("softmax_label",)

    return sym_gen, stack

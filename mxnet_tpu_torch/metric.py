"""Evaluation metrics: :class:`EvalMetric`, :class:`Accuracy`,
:class:`Perplexity`, :class:`CrossEntropy` and :func:`create` (the
counterparts of ``mxnet_tpu/metric.py``'s).  Each metric reduces one
(label, pred) pair on the host to a ``(statistic_sum, count)`` tuple;
there is no device-side accumulator."""
from __future__ import annotations

import numpy as np

__all__ = ["EvalMetric", "Accuracy", "Perplexity", "CrossEntropy",
           "create"]


def _host(x):
    return x if isinstance(x, np.ndarray) else x.asnumpy()


def check_label_shapes(labels, preds, shape=0):
    la = len(labels) if shape == 0 else labels.shape
    pr = len(preds) if shape == 0 else preds.shape
    if la != pr:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (la, pr))


class EvalMetric:
    """Accumulating metric base; subclasses implement ``_batch(label,
    pred) -> (sum, count)`` over host arrays."""

    def __init__(self, name):
        self.name = name
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0

    def _batch(self, label, pred):
        raise NotImplementedError()

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            s, n = self._batch(_host(label), _host(pred))
            self._sum += s
            self._count += n

    def get(self):
        return (self.name, self._sum / self._count if self._count
                else float("nan"))

    def get_name_value(self):
        return [self.get()]

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class Accuracy(EvalMetric):
    """Fraction of correctly classified instances."""

    def __init__(self, axis=1):
        super().__init__("accuracy")
        self.axis = axis

    def _batch(self, label, pred):
        hard = pred if pred.shape == label.shape \
            else np.argmax(pred, axis=self.axis)
        check_label_shapes(label, hard, shape=1)
        eq = hard.astype("int64").ravel() == label.astype("int64").ravel()
        return int(eq.sum()), eq.size


class Perplexity(EvalMetric):
    """exp(mean negative log-prob of the target tokens), per batch."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def _batch(self, label, pred):
        flat = pred.reshape(-1, pred.shape[self.axis])
        ids = label.astype("int64").ravel()
        if ids.size != flat.shape[0]:
            raise ValueError("shape mismatch: %s vs. %s"
                             % (label.shape, pred.shape))
        keep = np.ones(ids.shape, dtype=bool) if self.ignore_label is None \
            else ids != self.ignore_label
        p = np.take_along_axis(flat, np.where(keep, ids, 0)[:, None],
                               axis=1)[:, 0]
        nll = -np.log(np.maximum(p[keep], 1e-10)).sum()
        count = int(keep.sum())
        return float(np.exp(nll / count)) if count else float("nan"), 1


class CrossEntropy(EvalMetric):
    """Mean negative log predicted probability of the true class."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def _batch(self, label, pred):
        ids = label.astype("int64").ravel()
        if ids.size != pred.shape[0]:
            raise ValueError("shape mismatch: %s vs. %s"
                             % (label.shape, pred.shape))
        p = np.take_along_axis(pred, ids[:, None], axis=1)[:, 0]
        return float(-np.log(p + self.eps).sum()), ids.size


_BY_NAME = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
            "cross-entropy": CrossEntropy, "perplexity": Perplexity}


def create(metric, **kwargs):
    """A metric from a name or an instance."""
    if isinstance(metric, EvalMetric):
        return metric
    klass = _BY_NAME.get(str(metric).lower())
    if klass is None:
        raise ValueError("Metric must be one of %s or an EvalMetric"
                         % sorted(_BY_NAME))
    return klass(**kwargs)

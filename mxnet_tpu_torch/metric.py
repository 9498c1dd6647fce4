"""Evaluation metrics (the counterparts of ``mxnet_tpu/metric.py``'s):
:class:`EvalMetric`, :class:`Accuracy`, :class:`TopKAccuracy`,
:class:`F1`, :class:`Perplexity`, :class:`MAE`, :class:`MSE`,
:class:`RMSE`, :class:`CrossEntropy`, :class:`Loss`, :class:`Torch`,
:class:`Caffe`, :class:`CustomMetric`, :class:`CompositeEvalMetric`,
:func:`np_metric`, :func:`create` and :class:`DeviceMetricAccumulator`.

Each metric reduces one (label, pred) pair on the host to a
``(statistic_sum, count)`` tuple (``_batch``).  A metric that also has
``device_batch`` — the same reduction in torch ops over device tensors —
can accumulate inside the compiled train step (and ``score``'s compiled
eval step): :class:`DeviceMetricAccumulator` keeps one f32 sum and one
int64 count a slot as device scalars, which the step adds to in place
(a captured graph binds them by pointer), and installs drain / reset
hooks on the metric, so reading it (``get``, ``get_name_value``) folds
the device sums into the host ones first: reading the metric is the
only sync point.  The device-capable metrics are the JAX package's:
F1 and CustomMetric stay on the host, Torch and Caffe accumulate like
Loss.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "Perplexity",
           "MAE", "MSE", "RMSE", "CrossEntropy", "Loss", "Torch", "Caffe",
           "CustomMetric", "CompositeEvalMetric", "DeviceMetricAccumulator",
           "np_metric", "create", "select_outputs"]


def select_outputs(metric, outputs):
    """The output heads ``metric`` consumes: ``metric.output_indices``
    when set, else all of them."""
    idxs = getattr(metric, "output_indices", None)
    if idxs is None:
        return outputs
    return [outputs[i] for i in idxs]


def _host(x):
    """``x`` on the host; every call on a non-numpy input is a
    device-to-host copy, counted for the profiler's
    ``host_syncs_per_step``."""
    if isinstance(x, np.ndarray):
        return x
    from . import profiler as _prof

    _prof.bump_metric_d2h()
    return x.asnumpy()


def check_label_shapes(labels, preds, shape=0):
    la = len(labels) if shape == 0 else labels.shape
    pr = len(preds) if shape == 0 else preds.shape
    if la != pr:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (la, pr))


class EvalMetric:
    """Accumulating metric base; subclasses implement ``_batch(label,
    pred) -> (sum, count)`` over host arrays, and may implement
    ``device_batch`` (the same over device tensors, returning tensors or
    numbers) to accumulate on the device."""

    # the torch mirror of _batch; None = a host-only metric
    device_batch = None
    # which output heads the metric consumes (None = all)
    output_indices = None

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self._device_sync = None    # drain pending device sums -> host
        self._device_reset = None   # zero device sums without draining
        self.reset()

    def reset(self):
        hook = getattr(self, "_device_reset", None)
        if hook is not None:
            hook()
        n = 1 if self.num is None else self.num
        self._sums = [0.0] * n
        self._counts = [0] * n

    def _drain_device(self):
        hook = getattr(self, "_device_sync", None)
        if hook is not None:
            hook()

    # -- the device protocol (DeviceMetricAccumulator drives it) -------
    def device_supported(self):
        """Whether this metric can accumulate inside a compiled step."""
        return self.device_batch is not None

    def device_update(self, sums, counts, labels, preds):
        """Fold one batch of device tensors into the slots' accumulator
        tensors, in place (``update``'s pairing: labels zipped with
        preds)."""
        if self.device_batch is None:
            raise NotImplementedError("%s has no device_batch"
                                      % type(self).__name__)
        check_label_shapes(labels, preds)
        for slot, (label, pred) in enumerate(zip(labels, preds)):
            s, n = self.device_batch(label, pred)
            idx = 0 if self.num is None else slot
            sums[idx].add_(s)
            counts[idx].add_(n)

    def _batch(self, label, pred):
        raise NotImplementedError()

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for slot, (label, pred) in enumerate(zip(labels, preds)):
            s, n = self._batch(_host(label), _host(pred))
            idx = 0 if self.num is None else slot
            self._sums[idx] += s
            self._counts[idx] += n

    def get(self):
        self._drain_device()

        def ratio(s, n):
            return s / n if n != 0 else float("nan")

        if self.num is None:
            return (self.name, ratio(self._sums[0], self._counts[0]))
        return (["%s_%d" % (self.name, i) for i in range(self.num)],
                [ratio(s, n) for s, n in zip(self._sums, self._counts)])

    def get_name_value(self):
        names, values = self.get()
        if not isinstance(names, list):
            names, values = [names], [values]
        return list(zip(names, values))

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

    def device_batch(self, label, pred):
        hard = pred if pred.shape == label.shape \
            else torch.argmax(pred, dim=self.axis)
        check_label_shapes(label, hard, shape=1)
        eq = hard.long().reshape(-1) == label.long().reshape(-1)
        return eq.sum(), eq.numel()


class TopKAccuracy(EvalMetric):
    """Label-in-top-k accuracy."""

    def __init__(self, top_k=1):
        if top_k <= 1:
            raise ValueError("use Accuracy for top_k <= 1")
        super().__init__("top_k_accuracy_%d" % top_k)
        self.top_k = top_k

    def _batch(self, label, pred):
        if pred.ndim > 2:
            raise ValueError("predictions must be at most (batch, classes)")
        if pred.ndim == 1:  # already-hard class ids
            eq = pred.astype("int64") == label.astype("int64").ravel()
            return int(eq.sum()), eq.size
        k = min(self.top_k, pred.shape[1])
        topk = np.argpartition(pred, -k, axis=1)[:, -k:]
        hits = (topk == label.astype("int64")[:, None]).any(axis=1)
        return int(hits.sum()), hits.size

    def device_batch(self, label, pred):
        if pred.dim() > 2:
            raise ValueError("predictions must be at most (batch, classes)")
        if pred.dim() == 1:
            eq = pred.long() == label.long().reshape(-1)
            return eq.sum(), eq.numel()
        k = min(self.top_k, pred.shape[1])
        topk = torch.topk(pred, k, dim=1).indices
        hits = (topk == label.long()[:, None]).any(dim=1)
        return hits.sum(), hits.numel()


class F1(EvalMetric):
    """Binary F1 of each batch (the batch's confusion counts), averaged
    over batches."""

    def __init__(self):
        super().__init__("f1")

    def _batch(self, label, pred):
        y = label.astype("int64").ravel()
        if np.unique(y).size > 2:
            raise ValueError("F1 currently only supports binary "
                             "classification.")
        yhat = np.argmax(pred, axis=1).ravel()
        tp = int(np.sum((yhat == 1) & (y == 1)))
        fp = int(np.sum((yhat == 1) & (y == 0)))
        fn = int(np.sum((yhat == 0) & (y == 1)))
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if precision + recall else 0.0
        return f1, 1


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

    def device_batch(self, label, pred):
        flat = pred.reshape(-1, pred.shape[self.axis])
        ids = label.long().reshape(-1)
        keep = torch.ones_like(ids, dtype=torch.bool) \
            if self.ignore_label is None else ids != int(self.ignore_label)
        p = flat.gather(1, torch.where(keep, ids, 0)[:, None])[:, 0]
        nll = -(torch.log(torch.clamp_min(p, 1e-10)) * keep).sum()
        count = keep.sum()
        stat = torch.where(count > 0,
                           torch.exp(nll / torch.clamp_min(count, 1)),
                           torch.full_like(nll, float("nan")))
        return stat, 1


class _Regression(EvalMetric):
    """Shared shape handling for element-wise regression errors."""

    def _batch(self, label, pred):
        if label.ndim == 1:
            label = label[:, None]
        return float(self._error(np, label, pred)), 1

    def device_batch(self, label, pred):
        if label.dim() == 1:
            label = label[:, None]
        return self._error(torch, label, pred), 1


class MAE(_Regression):
    def __init__(self):
        super().__init__("mae")

    @staticmethod
    def _error(xp, label, pred):
        return xp.mean(xp.abs(label - pred))


class MSE(_Regression):
    def __init__(self):
        super().__init__("mse")

    @staticmethod
    def _error(xp, label, pred):
        return xp.mean(xp.square(label - pred))


class RMSE(_Regression):
    def __init__(self):
        super().__init__("rmse")

    @staticmethod
    def _error(xp, label, pred):
        return xp.sqrt(xp.mean(xp.square(label - pred)))


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

    def device_batch(self, label, pred):
        ids = label.long().reshape(-1)
        if ids.numel() != pred.shape[0]:
            raise ValueError("shape mismatch: %s vs. %s"
                             % (tuple(label.shape), tuple(pred.shape)))
        # a negative id indexes from the end, as numpy's does on the host
        ids = torch.where(ids < 0, ids + pred.shape[1], ids)
        p = pred.gather(1, ids[:, None])[:, 0]
        return -torch.log(p + self.eps).sum(), ids.numel()


class Loss(EvalMetric):
    """Mean of raw outputs (MakeLoss-style nets); ignores labels."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for pred in preds:
            arr = _host(pred)
            self._sums[0] += float(arr.sum())
            self._counts[0] += arr.size

    def device_supported(self):
        return True

    def device_update(self, sums, counts, labels, preds):
        # update()'s pairing: every output head, labels ignored
        for pred in preds:
            sums[0].add_(pred.sum())
            counts[0].add_(pred.numel())


class Torch(Loss):
    """The mean of the outputs, named "torch" (a Loss)."""

    def __init__(self, name="torch"):
        EvalMetric.__init__(self, name)


class Caffe(Loss):
    """The mean of the outputs, named "caffe" (a Loss)."""

    def __init__(self, name="caffe"):
        EvalMetric.__init__(self, name)


class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` over numpy arrays, which
    returns a value (one instance) or a ``(sum, count)`` pair."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            result = self._feval(_host(label), _host(pred))
            s, n = result if isinstance(result, tuple) else (result, 1)
            self._sums[0] += s
            self._counts[0] += n


def np_metric(name=None, allow_extra_outputs=False):
    """Decorator making a :class:`CustomMetric` of a numpy ``feval``."""

    def wrap(numpy_feval):
        return CustomMetric(numpy_feval, name or numpy_feval.__name__,
                            allow_extra_outputs)

    return wrap


class CompositeEvalMetric(EvalMetric):
    """Fan one update out to several child metrics."""

    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite", **kwargs)
        self.metrics = []
        for m in metrics or []:
            self.add(m)

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def get_metric(self, index):
        if not 0 <= index < len(self.metrics):
            raise ValueError("Metric index {} is out of range 0 and {}"
                             .format(index, len(self.metrics)))
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, select_outputs(m, preds))

    def device_supported(self):
        # a composite-level output_indices has no flattened counterpart
        return bool(self.metrics) and self.output_indices is None and \
            all(m.device_supported() for m in self.metrics)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        pairs = [m.get() for m in self.metrics]
        return [p[0] for p in pairs], [p[1] for p in pairs]


class DeviceMetricAccumulator:
    """An :class:`EvalMetric`'s ``(sum, count)`` slots as device scalars
    that a compiled step adds to in place (the counterpart of the JAX
    package's donated accumulator state).

    :meth:`install` zeroes the state on a device and binds the metric's
    drain / reset hooks; :meth:`update` is called inside the step body;
    :meth:`drain` folds the device sums into the host metric with one
    transfer and zeroes them in place (the tensors keep their storage, so
    a captured step that binds them stays valid); :meth:`uninstall`
    drains and detaches the hooks.
    """

    def __init__(self, metric):
        self.metric = metric
        self._leaves = self._flatten(metric)
        bad = [type(m).__name__ for m in self._leaves
               if not m.device_supported()]
        if bad or not self._leaves:
            raise ValueError("metric(s) %s cannot accumulate on device"
                             % (bad or metric))
        self.state = None
        self._buffers = None
        self.dirty = False  # anything accumulated since the last drain?

    @staticmethod
    def _flatten(metric):
        if isinstance(metric, CompositeEvalMetric):
            out = []
            for m in metric.metrics:
                out.extend(DeviceMetricAccumulator._flatten(m))
            return out
        return [metric]

    @staticmethod
    def supported(metric):
        """Whether every leaf of ``metric`` implements the device
        protocol."""
        try:
            return bool(metric.device_supported())
        except Exception:
            return False

    def _tensors(self):
        return [t for sums, counts in self.state for t in sums + counts]

    # ------------------------------------------------------------------
    def update(self, state, labels, preds):
        """Fold one batch (device tensors) into ``state`` in place; called
        inside the step body."""
        for (sums, counts), m in zip(state, self._leaves):
            m.device_update(list(sums), list(counts), labels,
                            select_outputs(m, preds))

    def install(self, device):
        """Zeroed state on ``device`` (the last one's tensors when they
        live there) and the metric's hooks."""
        if self._buffers is None or self._buffers[0] != device:
            state = []
            for m in self._leaves:
                n = 1 if m.num is None else m.num
                state.append((
                    tuple(torch.zeros((), dtype=torch.float32, device=device)
                          for _ in range(n)),
                    tuple(torch.zeros((), dtype=torch.int64, device=device)
                          for _ in range(n))))
            self._buffers = (device, tuple(state))
        self.state = self._buffers[1]
        self.reset_device()
        for m in self._leaves:
            m._device_sync = self.drain
            m._device_reset = self.reset_device

    def uninstall(self):
        """Drain what is pending and detach the hooks."""
        self.drain()
        for m in self._leaves:
            m._device_sync = None
            m._device_reset = None
        self.state = None

    def commit(self):
        """The step has added to the state."""
        self.dirty = True

    def maybe_drain(self, num_steps):
        """The periodic drain: fold the sums into the host metric every
        ``MXNET_METRIC_SYNC_PERIOD`` steps (0: only when the metric is
        read).  The Module drivers call it from ``update_metric`` once a
        step."""
        from . import config

        period = config.get("MXNET_METRIC_SYNC_PERIOD")
        if period and num_steps % int(period) == 0:
            self.drain()

    def drain(self):
        """Fold the device sums into the host metric (one transfer) and
        zero them in place; nothing to do when clean."""
        if self.state is None or not self.dirty:
            return
        self.dirty = False
        tensors = self._tensors()
        host = torch.stack([t.double() for t in tensors]).cpu().tolist()
        from . import profiler as _prof

        _prof.bump_metric_d2h(len(host))
        _prof.bump_metric_sync()
        it = iter(host)
        for (sums, counts), m in zip(self.state, self._leaves):
            vals = [next(it) for _ in sums]
            cnts = [next(it) for _ in counts]
            for idx, (s, c) in enumerate(zip(vals, cnts)):
                m._sums[idx] += s
                m._counts[idx] += int(c)
        with torch.no_grad():
            for t in tensors:
                t.zero_()

    def reset_device(self):
        """Zero the device sums WITHOUT folding them (metric.reset)."""
        if self.state is not None:
            with torch.no_grad():
                for t in self._tensors():
                    t.zero_()
        self.dirty = False


_BY_NAME = {"acc": Accuracy, "accuracy": Accuracy, "ce": CrossEntropy,
            "cross-entropy": CrossEntropy, "f1": F1,
            "perplexity": Perplexity, "mae": MAE, "mse": MSE, "rmse": RMSE,
            "top_k_accuracy": TopKAccuracy, "topkaccuracy": TopKAccuracy,
            "loss": Loss, "torch": Torch, "caffe": Caffe}


def create(metric, **kwargs):
    """A metric from a name, a callable (a :class:`CustomMetric`), a list
    of them (a composite) or an instance."""
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, list):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m, **kwargs))
        return out
    klass = _BY_NAME.get(str(metric).lower())
    if klass is None:
        raise ValueError("Metric must be one of %s or an EvalMetric"
                         % sorted(_BY_NAME))
    return klass(**kwargs)

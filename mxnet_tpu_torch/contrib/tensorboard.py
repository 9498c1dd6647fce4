"""TensorBoard logging bridge — the port of
``mxnet_tpu/contrib/tensorboard.py`` (reference:
python/mxnet/contrib/tensorboard.py)."""
from __future__ import annotations


class LogMetricsCallback(object):
    """Log metrics to a TensorBoard event file each batch (through
    ``torch.utils.tensorboard.SummaryWriter``): one scalar a metric name
    a call, at step 1, 2, ..., named ``<prefix>-<name>`` with a
    ``prefix``."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.summary_writer = SummaryWriter(logging_dir)
        except ImportError:
            raise ImportError("LogMetricsCallback requires a SummaryWriter "
                              "backend (torch.utils.tensorboard)")
        self.step = 0

    def __call__(self, param):
        if param.eval_metric is None:
            return
        self.step += 1
        name_value = param.eval_metric.get_name_value()
        for name, value in name_value:
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)

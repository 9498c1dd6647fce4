"""BaseModule — the high-level train / evaluate / predict interface (the
counterpart of ``mxnet_tpu/module/base_module.py``: ``fit`` with its
async loop, ``score``, ``iter_predict`` / ``predict``,
``forward_backward``, ``save_params`` / ``load_params`` /
``set_params`` and the abstract surface).

``predict`` and ``iter_predict`` run ``forward(is_train=False)`` a
batch (a driver's captured inference forward), strip the iterator's
tail padding from each output and, with ``merge_batches``, join the
batches with ``ndarray.concatenate``.  ``fit`` takes a
:class:`~mxnet_tpu_torch.monitor.Monitor` (installed before the
parameters, ``tic`` / ``toc_print`` around every batch) and an
``eval_end_callback`` for the validation pass.

``fit`` runs ``_fit_epoch``'s async loop: with a compiled step and
device-side metric accumulation the loop body does not wait on the
card, so up to ``MXNET_MAX_STEPS_IN_FLIGHT`` steps stay outstanding and
the host prepares batch n + K while the card runs step n; the loop
blocks on the CUDA event of the step K behind (``_dispatch_fence``),
never the newest.  Each epoch is one ``fit_epoch`` timeline span;
input waits, host waits on the fences and steps go to
``profiler.step_stats``.

``fit(..., elastic=)`` takes an
:class:`~mxnet_tpu_torch.elastic.ElasticController` (one is made from
``MXNET_CKPT_DIR`` / ``MXNET_CKPT_PERIOD`` when none is passed): async
fenced checkpoints of the training store, auto-resume from the last
committed fence (``attach`` before the first epoch, ``on_epoch_start``
fast-forwards the resumed epoch, ``on_step`` after each batch's
callback) and, with a failure monitor, a drained stop on a liveness
transition.  Without a controller the loop is unchanged."""
from __future__ import annotations

import logging
import time
from collections import deque, namedtuple

from .. import config
from .. import metric as metric_mod
from .. import ndarray as nd
from ..context import cpu

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
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._elastic = None

    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def _eval_batches(self, eval_data, num_batch, reset):
        """``(nbatch, batch)`` pairs up to the batch limit, after a reset
        when asked."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialize the module first")
        if reset:
            eval_data.reset()

        def batches():
            for nbatch, batch in enumerate(eval_data):
                if num_batch is not None and nbatch >= num_batch:
                    return
                yield nbatch, batch

        return batches()

    @staticmethod
    def _unpadded(batch, outputs):
        """A batch's outputs without the iterator's tail padding, each
        sliced by its own leading dimension (a scalar output stays)."""
        return [out[:out.shape[0] - batch.pad] if out.ndim > 0 else out
                for out in outputs]

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """An evaluation pass; returns the metric's (name, value) list.
        A driver with a compiled forward accumulates a device-capable
        metric on the card (``_bind_eval_metric``): the pass then reads
        no output back.  ``score_end_callback`` gets a
        ``BatchEndParam`` with the number of batches after the pass."""
        batches = self._eval_batches(eval_data, num_batch, reset)
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        eval_step = self._bind_eval_metric(eval_metric)
        nbatch = -1
        try:
            for nbatch, batch in batches:
                if eval_step is not None:
                    eval_step.run(batch)
                else:
                    self.forward(batch, is_train=False)
                    self.update_metric(eval_metric, batch.label)
                _fire(batch_end_callback,
                      BatchEndParam(epoch, nbatch, eval_metric, locals()))
        finally:
            if eval_step is not None:
                eval_step.finish()
        _fire(score_end_callback,
              BatchEndParam(epoch, nbatch + 1, eval_metric, locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """``(outputs, nbatch, batch)`` a batch, the padding stripped."""
        for nbatch, batch in self._eval_batches(eval_data, num_batch,
                                                reset):
            self.forward(batch, is_train=False)
            yield self._unpadded(batch, self.get_outputs()), nbatch, batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data``: with ``merge_batches`` one
        NDArray an output, the batches joined along axis 0 (a single
        output bare unless ``always_output_list``), else a list of each
        batch's output list."""
        collected = [list(outs) for outs, _, _
                     in self.iter_predict(eval_data, num_batch, reset)]
        if not collected or not merge_batches:
            return collected
        widths = {len(outs) for outs in collected}
        if len(widths) != 1:
            raise ValueError("Cannot merge batches: mismatched number of "
                             "outputs")
        merged = [nd.concatenate([outs[i] for outs in collected])
                  for i in range(widths.pop())]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def prepare_fit(self, train_data, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_rebind=False, force_init=False, kvstore="local",
                    optimizer="sgd",
                    optimizer_params=(("learning_rate", 0.01),),
                    monitor=None):
        """Bind, install ``monitor``, initialize the parameters and the
        optimizer for ``train_data``'s shapes."""
        from ..initializer import Uniform

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer or Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

    # ------------------------------------------------------------------
    # async-loop hooks (drivers with compiled steps override them)
    # ------------------------------------------------------------------
    def _bind_metric(self, eval_metric):
        """Let the driver fold ``eval_metric`` into its compiled step.
        Default: the host path."""

    def _bind_eval_metric(self, eval_metric):
        """A ``CompiledEvalStep``-like object (``run`` / ``finish``) for
        ``score``, or None for the host path (the default)."""
        return None

    def _wrap_train_data(self, train_data):
        """Optionally wrap the training iterator (device prefetch)."""
        return train_data

    def _dispatch_fence(self):
        """A CUDA event that completes with the last dispatched step, or
        None when the driver runs synchronously."""
        return None

    def _fit_epoch(self, epoch, train_data, eval_metric, batch_end_callback,
                   monitor=None):
        """One pass over ``train_data``; returns the wall-clock cost."""
        from .. import obs as _obs
        from .. import profiler as _prof

        start = time.time()
        eval_metric.reset()
        limit = max(1, int(config.get("MXNET_MAX_STEPS_IN_FLIGHT")))
        fences = deque()
        nbatch = 0
        if self._elastic is not None:
            # resuming into this epoch: metric sums back to the fence's,
            # the iterator past the batches already done
            nbatch = self._elastic.on_epoch_start(self, epoch, train_data,
                                                  eval_metric)
        it = iter(train_data)
        # one timeline span an epoch: the loop spans nest under it
        with _obs.span("fit_epoch", cat="loop", args={"epoch": int(epoch)}):
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                _prof.record_input_wait(time.perf_counter() - t0)
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                fence = self._dispatch_fence()
                if fence is not None:
                    fences.append(fence)
                    # at most `limit` dispatched-but-unfinished steps
                    if len(fences) >= limit:
                        t0 = time.perf_counter()
                        fences.popleft().synchronize()
                        _prof.record_host_wait(time.perf_counter() - t0)
                if monitor is not None:
                    monitor.toc_print()
                _prof.record_step()
                _fire(batch_end_callback,
                      BatchEndParam(epoch, nbatch, eval_metric, locals()))
                if self._elastic is not None:
                    # fault injection, the periodic fence and the liveness
                    # poll (which drains `fences` and raises
                    # ReconfigureSignal); after the callback, so callbacks
                    # see every batch once across a resume
                    self._elastic.on_step(self, epoch, nbatch, fences)
                nbatch += 1
        if fences:
            # the steps run in order on one stream: the newest covers all
            t0 = time.perf_counter()
            fences[-1].synchronize()
            _prof.record_host_wait(time.perf_counter() - t0)
        return time.time() - start

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, elastic=None):
        """Train for ``num_epoch`` epochs through ``_fit_epoch``, an
        optional validation pass per epoch (``eval_end_callback`` after
        each).  ``elastic``: an
        :class:`~mxnet_tpu_torch.elastic.ElasticController` (made from
        ``MXNET_CKPT_DIR`` / ``MXNET_CKPT_PERIOD`` when None)."""
        from .. import elastic as elastic_mod

        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        self.prepare_fit(train_data, initializer=initializer,
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing,
                         force_rebind=force_rebind, force_init=force_init,
                         kvstore=kvstore, optimizer=optimizer,
                         optimizer_params=optimizer_params, monitor=monitor)
        eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        self._bind_metric(eval_metric)
        fit_data = self._wrap_train_data(train_data)
        if elastic is None:
            elastic = elastic_mod.from_env()
            if elastic is not None and \
                    getattr(self, "_exec_group", None) is None:
                # the env knobs are ambient: a module without executor-
                # group state to fence trains without checkpoints (an
                # explicitly passed controller still fails loudly)
                self.logger.warning(
                    "MXNET_CKPT_DIR is set but %s has no executor-group "
                    "state to fence; training without elastic "
                    "checkpoints", type(self).__name__)
                elastic = None
        self._elastic = elastic
        failed = False
        try:
            if elastic is not None:
                # auto-resume: a committed fence restores the store, the
                # generators and the counts and advances the first epoch
                begin_epoch = elastic.attach(self, eval_metric, begin_epoch)
            epoch, first_epoch = begin_epoch, True
            while epoch < num_epoch:
                if not first_epoch:
                    fit_data.reset()
                first_epoch = False
                signal = fault = None
                try:
                    cost = self._fit_epoch(epoch, fit_data, eval_metric,
                                           batch_end_callback, monitor)
                except elastic_mod.ReconfigureSignal as sig:
                    # a liveness transition, the steps drained (its frames
                    # let go: they may hold the group's autograd graph)
                    signal = sig.with_traceback(None)
                except RuntimeError as exc:
                    # a collective whose peer died raises here: under a
                    # controller with a monitor it becomes a poll, once
                    # the exception (and its frames) are gone
                    if elastic is None or not elastic.is_liveness_fault(exc):
                        raise
                    fault = "%s: %s" % (type(exc).__name__, exc)
                if fault is not None:
                    signal = elastic.signal_after_fault(self, fault)
                if signal is not None:
                    # re-form the mesh on the survivors, restore the last
                    # fence and continue from its epoch (None: this rank
                    # left the mesh)
                    epoch = elastic.handle_reconfigure(self, signal,
                                                       eval_metric)
                    if epoch is None:
                        break
                    continue
                # reading the metric drains the device accumulation
                for name, val in eval_metric.get_name_value():
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch, cost)
                arg_snap, aux_snap = self.get_params()
                _fire(epoch_end_callback, epoch, self.symbol, arg_snap,
                      aux_snap)
                if eval_data:
                    for name, val in self.score(
                            eval_data, validation_metric,
                            score_end_callback=eval_end_callback,
                            batch_end_callback=eval_batch_end_callback,
                            epoch=epoch):
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                epoch += 1
        except BaseException:
            failed = True
            raise
        finally:
            if elastic is not None:
                # a failed write does not replace the exception unwinding
                elastic.finish(raise_error=not failed)
            self._elastic = None
            # leave the caller's iterator fresh for a second fit()
            train_data.reset()

    # ------------------------------------------------------------------
    # parameter files
    # ------------------------------------------------------------------
    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        blob = {"arg:%s" % k: v for k, v in arg_params.items()}
        blob.update({"aux:%s" % k: v for k, v in aux_params.items()})
        nd.save(fname, blob)

    def load_params(self, fname):
        arg_params, aux_params = {}, {}
        for key, value in nd._load(fname, cpu()).items():
            kind, _, name = key.partition(":")
            if kind == "arg":
                arg_params[name] = value
            elif kind == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # the abstract surface
    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()
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

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()

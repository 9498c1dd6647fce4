"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

It imports ``torch`` and never ``jax`` or ``mxnet_tpu``.  Ported so far:

* paged, KV-cached serving of ``models.attention_lm``: the symbol layer,
  the ops the model uses, :mod:`~mxnet_tpu_torch.decode`
  (``DecodePredictor`` / ``DecodeServer``) with speculative decoding
  (``NGramProposer`` / ``DraftProposer``, the verify step), its serving
  programs captured as CUDA graphs (:mod:`~mxnet_tpu_torch.programs`);
* training through ``Module`` (:mod:`~mxnet_tpu_torch.module`,
  ``executor``, ``train_step``, ``optimizer``, ``lr_scheduler``,
  ``initializer``, ``metric``, ``io``, ``ndarray``) of
  ``models.attention_lm`` and ``models.resnet``: each step one captured
  program (``train_step.CompiledTrainStep``) with the metric accumulated
  on the card, ``fit``'s async loop, checkpoints in the JAX package's
  files (``model``, ``callback``, ``ndarray.save`` / ``load``);
* inference: ``Module.predict`` / ``iter_predict``, :class:`Predictor`
  and ``model.FeedForward``, each executor's inference forward one
  captured program (``train_step.CompiledForward``), the rest of the
  Module / Executor / Symbol API (``reshape``, ``backward(out_grads)``,
  ``bind`` / ``simple_bind`` / ``eval``, ``get_internals``,
  ``infer_type``) and :mod:`~mxnet_tpu_torch.monitor`;
* bucketed recurrent training: the ``RNN`` op, the cells and
  ``BucketSentenceIter`` (:mod:`~mxnet_tpu_torch.rnn`) and
  ``BucketingModule``, whose buckets share one slab plan, over
  ``models.lstm_lm``;
* image classification: the model zoo (``models.get_mlp`` ...
  ``get_resnext``, with ``LRN``), the optimizers, initializers, metrics
  and iterators (``MNISTIter``, ``CSVIter``, ``ResizeIter``,
  ``PrefetchingIter``) the reference's image-classification scripts
  reach, and the optimizer update ops;
* the imperative front end: ``nd`` arrays with their operators and an
  op function for every registered op (the reference's elemwise,
  tensor, nn and sample ops), :mod:`~mxnet_tpu_torch.autograd` on
  torch's autograd, :mod:`~mxnet_tpu_torch.random`,
  :mod:`~mxnet_tpu_torch.test_utils`, ``current_context`` and the
  ``with ctx:`` scope (the default context is the card);
* detection and the rest of the op library: the contrib ops (the SSD
  MultiBox ops, ``Proposal``, ``CTCLoss``, ``fft``, quantization,
  ``count_sketch``), the spatial ops, user ops
  (:mod:`~mxnet_tpu_torch.operator`, ``Custom``),
  :mod:`~mxnet_tpu_torch.recordio` and
  :mod:`~mxnet_tpu_torch.image` (the image and detection iterators),
  ``PythonModule`` / ``PythonLossModule`` / ``SequentialModule`` and
  ``models.ssd``.

The hand-written Hopper kernels (``csrc/``): the fused LN->linear
forward and backward (:mod:`~mxnet_tpu_torch.ops.fused_kernel`), flash
attention forward, dQ and dK/dV
(:mod:`~mxnet_tpu_torch.ops.flash_kernel`), paged split-K flash
decoding (:mod:`~mxnet_tpu_torch.ops.decode_kernel`) and the
multi-tensor optimizer update (:mod:`~mxnet_tpu_torch.ops.update_kernel`).  Entry points run
on the card unless given the CPU (``device="cpu"``, ``context=cpu()``).
"""
from . import base, config, context, ops, registry
from . import operator  # registers Custom
from . import symbol
from .base import AttrScope, MXNetError, NameManager
from .context import Context, cpu, current_context, gpu

symbol._init_symbol_module()
sym = symbol

from . import decode, models, programs, serve, weights  # noqa: E402
from . import (autograd, callback, executor, initializer,  # noqa: E402
               image, io, lr_scheduler, metric, model, module, monitor,
               ndarray, optimizer, predictor, random, recordio, rnn,
               test_utils, train_step)
from .decode import DecodePredictor, DecodeServer  # noqa: E402
from .model import FeedForward  # noqa: E402
from .predictor import Predictor  # noqa: E402

ndarray._init_ndarray_module()
mod = module
nd = ndarray

__all__ = ["AttrScope", "Context", "DecodePredictor", "DecodeServer",
           "FeedForward", "MXNetError", "NameManager", "Predictor",
           "autograd", "base", "callback", "config", "context", "cpu",
           "current_context", "decode", "executor", "gpu", "image",
           "initializer", "io", "lr_scheduler", "metric", "mod", "model",
           "models", "module", "monitor", "nd", "ndarray", "operator",
           "ops", "optimizer", "predictor", "programs", "random",
           "recordio", "registry", "rnn", "serve", "sym", "symbol",
           "test_utils", "train_step", "weights"]

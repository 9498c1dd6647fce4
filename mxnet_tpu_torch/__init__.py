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
  ``models.ssd``;
* serving as a fleet and its telemetry: ``DecodeServer``'s session
  (``serve_tick``, ``inject``, priorities, preemption by page swap),
  :mod:`~mxnet_tpu_torch.serve.swap` and :mod:`~mxnet_tpu_torch.serve.
  fleet` (``Router``, ``FleetHost``, ``PrefillWorker``), and
  :mod:`~mxnet_tpu_torch.obs` (metrics registry, trace timeline,
  Prometheus endpoint, per-program roofline) under
  :mod:`~mxnet_tpu_torch.profiler`;
* deployment export on ``torch.export``: ``Predictor.export`` /
  ``artifact`` and ``predictor.load_exported``, the decode programs'
  artifacts (``DecodePredictor.*_artifact``, ``ProgramSpec.artifact``)
  and :mod:`~mxnet_tpu_torch.analysis` (``ProgramArtifact``,
  ``kernel_ops``); kernels A, B and C are torch operators
  (``mxnet_tpu_torch::fused_fwd``, ``::paged_decode``, ``::flash_fwd``),
  registered when this package is imported;
* persistence and resume: :mod:`~mxnet_tpu_torch.checkpoint` (step
  directories on ``torch.distributed.checkpoint``), :mod:`~mxnet_tpu_torch.
  elastic` (async fenced checkpoints, the controller ``fit(...,
  elastic=)`` drives, the fault injector), the iterators' resume surface
  and :mod:`~mxnet_tpu_torch.parallel.health` (heartbeats and the
  failure monitor);
* data parallelism: :mod:`~mxnet_tpu_torch.kvstore` (every store type;
  the ``dist_*`` ones all-reduce over ``torch.distributed``),
  :mod:`~mxnet_tpu_torch.parallel` (``launch``: one process a card,
  ``collectives``, ``mesh``) and ``Module`` over several contexts of
  one device;
* kernel tuning and tooling: :mod:`~mxnet_tpu_torch.ops.tuning` (the
  kernels' tunable plans, swept on the card under ``MXNET_PALLAS_TUNE``
  and read back from a content-addressed cache),
  :mod:`~mxnet_tpu_torch.rtc` (user CUDA kernels built with nvcc and
  registered as ops), :mod:`~mxnet_tpu_torch.visualization` (``viz``)
  and :mod:`~mxnet_tpu_torch.contrib` (``tensorboard``).

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
from .context import Context, cpu, current_context, gpu, num_devices

symbol._init_symbol_module()
sym = symbol

from . import decode, models, programs, serve, weights  # noqa: E402
from . import (autograd, callback, executor, initializer,  # noqa: E402
               image, io, lr_scheduler, metric, model, module, monitor,
               ndarray, obs, optimizer, predictor, profiler, random,
               recordio, rnn, test_utils, train_step)
from . import analysis  # noqa: E402
from . import checkpoint, parallel  # noqa: E402
from . import kvstore, kvstore_server  # noqa: E402
from . import rtc  # noqa: E402
from . import visualization  # noqa: E402
from . import visualization as viz  # noqa: E402
from . import contrib  # noqa: E402
from .decode import DecodePredictor, DecodeServer  # noqa: E402
from .executor import Executor  # noqa: E402
from .initializer import init_registry  # noqa: E402
from .model import FeedForward  # noqa: E402
from .optimizer import Optimizer  # noqa: E402
from .predictor import Predictor  # noqa: E402
from .symbol import Group, Variable  # noqa: E402

ndarray._init_ndarray_module()
mod = module
nd = ndarray

__all__ = ["AttrScope", "Context", "DecodePredictor", "DecodeServer",
           "Executor", "FeedForward", "Group", "MXNetError", "NameManager",
           "Optimizer", "Predictor", "Variable", "analysis", "autograd",
           "base", "callback", "checkpoint", "config", "context",
           "contrib", "cpu",
           "current_context", "decode", "executor", "gpu", "image",
           "init_registry", "initializer", "io", "kvstore",
           "kvstore_server", "lr_scheduler", "metric",
           "mod", "model", "models", "module", "monitor", "nd", "ndarray",
           "num_devices", "obs", "operator", "ops", "optimizer",
           "parallel",
           "predictor", "profiler", "programs", "random",
           "recordio", "registry", "rnn", "rtc", "serve", "sym", "symbol",
           "test_utils", "train_step", "visualization", "viz", "weights"]

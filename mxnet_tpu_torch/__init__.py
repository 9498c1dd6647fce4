"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

It imports ``torch`` and never ``jax`` or ``mxnet_tpu``.  Ported so far:

* paged, KV-cached serving of ``models.attention_lm``: the symbol layer,
  the ops the model uses, :mod:`~mxnet_tpu_torch.decode`
  (``DecodePredictor`` / ``DecodeServer``);
* training through ``Module`` (:mod:`~mxnet_tpu_torch.module`,
  ``executor``, ``train_step``, ``optimizer``, ``initializer``,
  ``metric``, ``io``, ``ndarray``).

The hand-written Hopper kernels (``csrc/``): the fused LN->linear
forward and backward (:mod:`~mxnet_tpu_torch.ops.fused_kernel`), flash
attention forward, dQ and dK/dV
(:mod:`~mxnet_tpu_torch.ops.flash_kernel`) and paged split-K flash
decoding (:mod:`~mxnet_tpu_torch.ops.decode_kernel`).  Entry points run
on the card unless given the CPU (``device="cpu"``, ``context=cpu()``).
"""
from . import base, config, context, ops, registry
from . import symbol
from .base import AttrScope, MXNetError, NameManager
from .context import Context, cpu, gpu

symbol._init_symbol_module()
sym = symbol

from . import decode, models, serve, weights  # noqa: E402
from . import (executor, initializer, io, metric, module,  # noqa: E402
               ndarray, optimizer, train_step)

mod = module
nd = ndarray

__all__ = ["AttrScope", "Context", "MXNetError", "NameManager", "base",
           "config", "context", "cpu", "decode", "executor", "gpu",
           "initializer", "io", "metric", "mod", "models", "module", "nd",
           "ndarray", "ops", "optimizer", "registry", "serve", "sym",
           "symbol", "train_step", "weights"]

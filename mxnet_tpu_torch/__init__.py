"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

It imports ``torch`` and never ``jax`` or ``mxnet_tpu``.  This slice
covers paged, KV-cached serving of ``models.attention_lm``: the symbol
layer, the ops the model uses, :mod:`~mxnet_tpu_torch.decode`
(``DecodePredictor`` / ``DecodeServer``) and two hand-written Hopper
kernels (``csrc/``): the fused LN->linear forward
(:mod:`~mxnet_tpu_torch.ops.fused_kernel`) and paged split-K flash
decoding (:mod:`~mxnet_tpu_torch.ops.decode_kernel`).  Entry points run
on the card unless given ``device="cpu"``.
"""
from . import base, config, context, ops, registry
from . import symbol
from .base import AttrScope, MXNetError, NameManager
from .context import Context, cpu, gpu

symbol._init_symbol_module()
sym = symbol

from . import decode, models, serve, weights  # noqa: E402

__all__ = ["AttrScope", "Context", "MXNetError", "NameManager", "base",
           "config", "context", "cpu", "decode", "gpu", "models", "ops",
           "registry", "serve", "sym", "symbol", "weights"]

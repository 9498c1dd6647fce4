"""Model builders of the port: the JAX package's zoo, each symbol's JSON
byte for byte the reference's (``mxnet_tpu/models/__init__.py``)."""
from . import (alexnet, attention_lm, googlenet, inception_bn, inception_v3,
               lenet, lstm_lm, mlp, resnet, resnext, ssd, vgg)

get_lenet = lenet.get_symbol
get_mlp = mlp.get_symbol
get_resnet = resnet.get_symbol
get_alexnet = alexnet.get_symbol
get_vgg = vgg.get_symbol
get_inception_bn = inception_bn.get_symbol
get_inception_v3 = inception_v3.get_symbol
get_googlenet = googlenet.get_symbol
get_resnext = resnext.get_symbol
get_attention_lm = attention_lm.get_symbol
get_ssd = ssd.get_symbol

__all__ = ["alexnet", "attention_lm", "googlenet", "inception_bn",
           "inception_v3", "lenet", "lstm_lm", "mlp", "resnet", "resnext",
           "ssd", "vgg", "get_alexnet", "get_attention_lm", "get_googlenet",
           "get_inception_bn", "get_inception_v3", "get_lenet", "get_mlp",
           "get_resnet", "get_resnext", "get_ssd", "get_vgg"]

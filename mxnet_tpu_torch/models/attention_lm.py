"""Decoder-only attention language model (a copy of
``mxnet_tpu/models/attention_lm.py`` without the MoE option).

Pre-norm blocks: LayerNorm statistics as graph ops, the LN affine tail
plus each projection as one ``FusedLNLinear``, causal
``dot_product_attention`` (grouped-query when ``num_kv_heads`` <
``heads``), and an FFN whose ReLU and residual ride the second
projection.  For the same arguments the symbol JSON is byte-identical to
the JAX package's.
"""
from __future__ import annotations

from .. import symbol as sym


def _normalize(data):
    """(x - mean) / sqrt(var + eps) over the last axis, no affine."""
    mean = sym.mean(data, axis=-1, keepdims=True)
    centered = sym.broadcast_sub(data, mean)
    var = sym.mean(sym.square(centered), axis=-1, keepdims=True)
    inv = sym.rsqrt(var + 1e-5)
    return sym.broadcast_mul(centered, inv)


def _ln_affine(name, embed):
    gamma = sym.Variable(name + "_ln_gamma", shape=(1, 1, embed))
    beta = sym.Variable(name + "_ln_beta", shape=(1, 1, embed))
    return gamma, beta


def layer_norm(data, embed, name):
    """LayerNorm over the last axis from registry ops."""
    normed = _normalize(data)
    gamma, beta = _ln_affine(name, embed)
    return sym.broadcast_add(sym.broadcast_mul(normed, gamma), beta)


def block(data, embed, heads, ffn_hidden, name, num_kv_heads=0):
    """One pre-norm decoder block (parameter names as in the JAX
    package: ``*_ln_gamma``/``*_ln_beta``, FullyConnected-layout
    ``*_weight``/``*_bias``)."""
    kv_heads = int(num_kv_heads) or heads
    if heads % kv_heads:
        raise ValueError(
            "attention_lm.block: num_heads=%d not divisible by "
            "num_kv_heads=%d" % (heads, kv_heads))
    kv_hidden = kv_heads * (embed // heads)
    normed = _normalize(data)
    gamma, beta = _ln_affine(name + "_att", embed)
    q = sym.FusedLNLinear(normed, gamma, beta, num_hidden=embed,
                          name=name + "_q")
    k = sym.FusedLNLinear(normed, gamma, beta, num_hidden=kv_hidden,
                          name=name + "_k")
    v = sym.FusedLNLinear(normed, gamma, beta, num_hidden=kv_hidden,
                          name=name + "_v")
    if kv_heads != heads:
        att = sym.dot_product_attention(q, k, v, num_heads=heads,
                                        num_kv_heads=kv_heads, causal=True)
    else:
        att = sym.dot_product_attention(q, k, v, num_heads=heads,
                                        causal=True)
    att = sym.FullyConnected(att, num_hidden=embed, flatten=False,
                             name=name + "_attout")
    data = data + att

    ffn_normed = _normalize(data)
    fgamma, fbeta = _ln_affine(name + "_ffn", embed)
    h = sym.FusedLNLinear(ffn_normed, fgamma, fbeta,
                          num_hidden=ffn_hidden, name=name + "_ffn1")
    # ffn2 consumes the PRE-activation h: its ReLU is the fused op's
    # prologue and the block's residual rides its epilogue
    return sym.FusedLNLinear(h, residual=data, num_hidden=embed,
                             relu=True, no_affine=True, has_residual=True,
                             name=name + "_ffn2")


def get_symbol(vocab_size, seq_len, num_layers=2, embed=128, heads=4,
               ffn_hidden=512, num_kv_heads=0, **kwargs):
    """Decoder-only LM: data (B, T) tokens, softmax over the vocabulary at
    every position; labels (B, T) next tokens (pad = -1 ignored)."""
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    net = sym.Embedding(data, input_dim=vocab_size, output_dim=embed,
                        name="embed")
    # learned positional embedding, broadcast over the batch
    pos = sym.Variable("pos_embed_weight", shape=(1, seq_len, embed))
    net = sym.broadcast_add(net, pos)
    for i in range(num_layers):
        net = block(net, embed, heads, ffn_hidden, "layer%d" % i,
                    num_kv_heads=num_kv_heads)
    net = layer_norm(net, embed, "final")
    logits = sym.FullyConnected(sym.Reshape(net, shape=(-1, embed)),
                                num_hidden=vocab_size, name="head")
    flat_label = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(logits, flat_label, use_ignore=True,
                             ignore_label=-1, name="softmax")


def imperative_lm(nd, p, data, label, layers, embed, heads, ffn, vocab):
    """:func:`get_symbol`'s graph (all heads for keys and values) as
    imperative calls of ``nd``, the ndarray module (this package's, or
    another with the same op functions), on the parameters ``p``
    (``{name: NDArray}``, :func:`get_symbol`'s argument names): the
    SoftmaxOutput probabilities (B * T, vocab).  Under
    ``autograd.record()`` it is a training step's forward.
    FusedLNLinear takes every array by name (positional and keyword
    arrays bind in argument order otherwise)."""
    def normalize(x):
        mean = nd.mean(x, axis=-1, keepdims=True)
        centered = nd.broadcast_sub(x, mean)
        var = nd.mean(nd.square(centered), axis=-1, keepdims=True)
        return nd.broadcast_mul(centered, nd.rsqrt(var + 1e-5))

    def segment(name, x, gamma, beta, n):
        return nd.FusedLNLinear(data=x, gamma=gamma, beta=beta,
                                weight=p[name + "_weight"],
                                bias=p[name + "_bias"], num_hidden=n)

    net = nd.Embedding(data, p["embed_weight"], input_dim=vocab,
                       output_dim=embed)
    net = nd.broadcast_add(net, p["pos_embed_weight"])
    for i in range(layers):
        n = "layer%d" % i
        normed = normalize(net)
        g, b = p[n + "_att_ln_gamma"], p[n + "_att_ln_beta"]
        q = segment(n + "_q", normed, g, b, embed)
        k = segment(n + "_k", normed, g, b, embed)
        v = segment(n + "_v", normed, g, b, embed)
        att = nd.dot_product_attention(q, k, v, num_heads=heads, causal=True)
        att = nd.FullyConnected(att, p[n + "_attout_weight"],
                                p[n + "_attout_bias"], num_hidden=embed,
                                flatten=False)
        net = net + att
        h = segment(n + "_ffn1", normalize(net), p[n + "_ffn_ln_gamma"],
                    p[n + "_ffn_ln_beta"], ffn)
        net = nd.FusedLNLinear(data=h, residual=net,
                               weight=p[n + "_ffn2_weight"],
                               bias=p[n + "_ffn2_bias"], num_hidden=embed,
                               relu=True, no_affine=True, has_residual=True)
    net = nd.broadcast_add(nd.broadcast_mul(normalize(net),
                                            p["final_ln_gamma"]),
                           p["final_ln_beta"])
    logits = nd.FullyConnected(nd.Reshape(net, shape=(-1, embed)),
                               p["head_weight"], p["head_bias"],
                               num_hidden=vocab)
    return nd.SoftmaxOutput(logits, nd.Reshape(label, shape=(-1,)),
                            use_ignore=True, ignore_label=-1)

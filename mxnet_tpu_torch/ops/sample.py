"""Random sampling (counterpart of ``mxnet_tpu/ops/sample.py``): token
sampling for the decode loop, the speculative acceptance rule, and the
sampler ops — ``uniform`` / ``normal`` (aliased ``random_*``),
``random_gamma`` / ``random_exponential`` / ``random_poisson`` /
``random_negative_binomial`` / ``random_generalized_negative_binomial``
(an output of ``shape`` on ``OpContext.device``) and the multisample
family ``_sample_*`` (one draw of ``shape`` for each element of the
parameter arrays: output shape = param shape + ``shape``).

Random draws come from an explicit ``torch.Generator``
(``OpContext.generator``: the device's generator of
:mod:`~mxnet_tpu_torch.random` on the imperative path); it gives other
numbers than ``jax.random`` from the same seed, so cross-package parity
is token identity under greedy decoding, and the samplers' moments.
The negative binomials are Poisson draws over Gamma rates, as in the
reference.  The decode-loop functions are plain torch with fixed shapes
and no host read, so they run inside a captured program (the paged
verify step)."""
from __future__ import annotations

import torch

from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op
from .tensor import attr_dtype

__all__ = ["is_greedy_policy", "policy_logits", "sample_tokens",
           "residual_probs", "speculative_accept", "register_all"]


def is_greedy_policy(temperature, top_k):
    """``temperature == 0`` and ``top_k == 1`` are both a deterministic
    argmax."""
    return temperature == 0 or top_k == 1


def policy_logits(logits, temperature=1.0, top_k=0):
    """Temperature-scaled, top-k-truncated logits the sampler draws
    from."""
    scaled = logits.float() / float(temperature)
    if top_k and 0 < top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    return scaled


def sample_tokens(logits, temperature=1.0, top_k=0, generator=None):
    """Token ids (int32, the leading dims of ``logits``) drawn from
    ``(..., V)`` logits: argmax under the greedy policy, else a
    categorical draw over :func:`policy_logits` from ``generator``."""
    if is_greedy_policy(temperature, top_k):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(policy_logits(logits, temperature, top_k), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


# ---------------------------------------------------------------------------
# Speculative sampling (Leviathan et al., "Fast Inference from Transformers
# via Speculative Decoding"): a proposer drafts k tokens, the target scores
# all k+1 positions in one verify pass, and the acceptance-rejection rule
# below keeps the output distribution exactly the target's.
# ---------------------------------------------------------------------------

def residual_probs(p, q):
    """The rejection-resample distribution ``norm(max(p - q, 0))`` over
    (..., V) probability vectors; where ``p <= q`` everywhere (the
    branch is never taken) it is ``p``, so nothing turns NaN."""
    res = torch.clamp_min(p.float() - q.float(), 0.0)
    tot = res.sum(dim=-1, keepdim=True)
    return torch.where(tot > 0, res / torch.where(tot > 0, tot, 1.0),
                       p.float())


def speculative_accept(target_probs, draft_toks, draft_probs=None,
                       greedy=False, generator=None):
    """Accept a prefix of k drafted tokens against k+1 target
    distributions and draw one more token at the first mismatch.

    ``target_probs`` (B, k+1, V): row i is the target's sampling
    distribution after the committed prefix and drafts d_1..d_i.
    ``draft_toks`` (B, k): the drafts.  ``draft_probs`` (B, k, V): the
    distributions they were drawn from; None for a deterministic
    proposer (n-gram lookup, a greedy draft: q is a delta at each
    draft).  ``greedy``: accept d_i iff it is the argmax of row i and
    take the next token by argmax too (no draw).  Otherwise uniforms and
    the residual's categorical come from ``generator``.

    Returns ``(counts, out_toks)``: counts (B,) int32 in [1, k+1], the
    accepted drafts plus the one drawn token; out_toks (B, k+1) int32,
    valid through counts (later columns are the caller's to mask)."""
    b, kp1, v = target_probs.shape
    k = kp1 - 1
    p = target_probs.float()
    toks = draft_toks.to(device=p.device, dtype=torch.int64)
    if greedy:
        tgt = torch.argmax(p, dim=-1)                         # (B, k+1)
        accept = toks == tgt[:, :k]
    else:
        p_at_d = torch.gather(p[:, :k], 2, toks[..., None])[..., 0]
        if draft_probs is None:
            ratio = p_at_d                                    # q = delta
        else:
            q_at_d = torch.gather(draft_probs.float(), 2,
                                  toks[..., None])[..., 0]
            ratio = p_at_d / torch.clamp_min(q_at_d, 1e-30)
        u = torch.rand((b, k), generator=generator, device=p.device)
        accept = u < ratio                                    # min(1, .)
    # accepted prefix length a in [0, k]: the drafts before the first
    # rejection
    a = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
    # the next token's distribution is row a (the bonus row at a == k),
    # with the rejected draft's proposal mass taken out when a < k
    p_next = torch.gather(p, 1, a[:, None, None].expand(b, 1, v))[:, 0]
    if greedy:
        next_tok = torch.argmax(p_next, dim=-1)
    else:
        j = torch.clamp_max(a, k - 1)
        if draft_probs is None:
            d_rej = torch.gather(toks, 1, j[:, None])
            q_row = torch.zeros_like(p_next).scatter_(1, d_rej, 1.0)
        else:
            q_row = torch.gather(draft_probs.float(), 1,
                                 j[:, None, None].expand(b, 1, v))[:, 0]
        dist = torch.where((a == k)[:, None], p_next,
                           residual_probs(p_next, q_row))
        next_tok = torch.multinomial(dist, 1, generator=generator)[:, 0]
    out = torch.cat([toks, torch.zeros((b, 1), dtype=torch.int64,
                                       device=p.device)], dim=1)
    out.scatter_(1, a[:, None], next_tok[:, None])
    return (a + 1).to(torch.int32), out.to(torch.int32)


# ---------------------------------------------------------------------------
# The sampler ops.  Each draw is f32 (the reference's jax.random draws),
# then cast to the op's dtype.
# ---------------------------------------------------------------------------

def _uniform(sh, dev, gen):
    return torch.rand(sh, generator=gen, device=dev)


def _normal(sh, dev, gen):
    return torch.randn(sh, generator=gen, device=dev)


def _exponential(sh, dev, gen):
    return torch.empty(sh, device=dev).exponential_(1.0, generator=gen)


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws of ``alpha``'s shape."""
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam, generator=gen)


def _full(sh, dev, value):
    return torch.full(sh, float(value), device=dev)


# {op name: (its parameters, draw(attrs, shape, device, generator))}
_SAMPLERS = {
    "uniform": (
        (Param("low", float, default=0.0), Param("high", float, default=1.0)),
        lambda a, sh, dev, gen: a.get("low", 0.0) + _uniform(sh, dev, gen)
        * (a.get("high", 1.0) - a.get("low", 0.0))),
    "normal": (
        (Param("loc", float, default=0.0),
         Param("scale", float, default=1.0)),
        lambda a, sh, dev, gen: _normal(sh, dev, gen) * a.get("scale", 1.0)
        + a.get("loc", 0.0)),
    "random_gamma": (
        (Param("alpha", float, default=1.0),
         Param("beta", float, default=1.0)),
        lambda a, sh, dev, gen: _gamma(_full(sh, dev, a.get("alpha", 1.0)),
                                       gen) * a.get("beta", 1.0)),
    "random_exponential": (
        (Param("lam", float, default=1.0),),
        lambda a, sh, dev, gen: _exponential(sh, dev, gen)
        / a.get("lam", 1.0)),
    "random_poisson": (
        (Param("lam", float, default=1.0),),
        lambda a, sh, dev, gen: _poisson(_full(sh, dev, a.get("lam", 1.0)),
                                         gen)),
    "random_negative_binomial": (
        (Param("k", int, default=1), Param("p", float, default=1.0)),
        lambda a, sh, dev, gen: _poisson(
            _gamma(_full(sh, dev, a.get("k", 1)), gen)
            * (1 - a.get("p", 1.0)) / a.get("p", 1.0), gen)),
    "random_generalized_negative_binomial": (
        (Param("mu", float, default=1.0),
         Param("alpha", float, default=1.0)),
        lambda a, sh, dev, gen: _poisson(
            _gamma(_full(sh, dev, 1.0 / a.get("alpha", 1.0)), gen)
            * (a.get("mu", 1.0) * a.get("alpha", 1.0)), gen)),
}

# {op name: (number of parameter arrays, draw(shape, generator, *params))}
# with the parameters broadcast against the output shape
_MULTI_SAMPLERS = {
    "_sample_uniform": (2, lambda sh, gen, lo, hi:
                        lo + _uniform(sh, lo.device, gen) * (hi - lo)),
    "_sample_normal": (2, lambda sh, gen, mu, sigma:
                       mu + _normal(sh, mu.device, gen) * sigma),
    "_sample_gamma": (2, lambda sh, gen, alpha, beta:
                      _gamma(alpha.expand(sh).contiguous(), gen) * beta),
    "_sample_exponential": (1, lambda sh, gen, lam:
                            _exponential(sh, lam.device, gen) / lam),
    "_sample_poisson": (1, lambda sh, gen, lam:
                        _poisson(lam.expand(sh).contiguous(), gen)),
    "_sample_negative_binomial": (2, lambda sh, gen, k, p: _poisson(
        _gamma(k.expand(sh).contiguous(), gen) * (1 - p) / p, gen)),
    "_sample_generalized_negative_binomial": (
        2, lambda sh, gen, mu, alpha: _poisson(
            _gamma((1.0 / alpha).expand(sh).contiguous(), gen)
            * (mu * alpha), gen)),
}


def register_all():
    def _sample_shape(attrs, in_shapes, aux_shapes):
        return [], [tuple(attrs.get("shape", ()) or ())], []

    for name, (extra, draw) in _SAMPLERS.items():
        def fcompute(attrs, inputs, aux, octx, draw=draw):
            sh = tuple(attrs.get("shape", ()) or ())
            out = draw(attrs, sh, octx.device or "cpu", octx.generator)
            return [out.to(attr_dtype(attrs))], []

        schema = ParamSchema(*extra, Param("shape", "shape", default=()),
                             Param("ctx", str, default=""),
                             Param("dtype", str, default="float32"))
        aliases = ["random_" + name] if name in ("uniform", "normal") else []
        register_op(OpDef(name, fcompute, schema=schema, num_inputs=0,
                          infer_shape=_sample_shape, hint=name),
                    aliases=aliases)

    ms_schema = ParamSchema(Param("shape", "shape", default=()),
                            Param("dtype", str, default="float32"))
    for name, (n_params, draw) in _MULTI_SAMPLERS.items():
        def _ms_shape(attrs, in_shapes, aux_shapes, n=n_params):
            s = tuple(attrs.get("shape", ()) or ())
            base = tuple(in_shapes[0]) if in_shapes[0] is not None else ()
            return [base] * n, [base + s], []

        def fcompute(attrs, inputs, aux, octx, draw=draw):
            s = tuple(attrs.get("shape", ()) or ())
            base = tuple(inputs[0].shape)
            ps = [p.reshape(base + (1,) * len(s)).float() for p in inputs]
            out = draw(base + s, octx.generator, *ps)
            return [out.to(attr_dtype(attrs))], []

        register_op(OpDef(name, fcompute, schema=ms_schema,
                          num_inputs=n_params, infer_shape=_ms_shape,
                          hint=name.lstrip("_")))

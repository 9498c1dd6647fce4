"""Token sampling for the decode loop (counterpart of the sampling half of
``mxnet_tpu/ops/sample.py``).  Random draws come from an explicit
``torch.Generator``; it gives other numbers than ``jax.random`` from the
same seed, so cross-package parity is token identity under greedy
decoding only."""
from __future__ import annotations

import torch

__all__ = ["is_greedy_policy", "policy_logits", "sample_tokens"]


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

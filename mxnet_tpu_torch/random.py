"""The global random state (counterpart of ``mxnet_tpu/random.py``).

The JAX package keeps one ``jax.random`` key chain and splits a subkey
for every random op.  The port keeps one ``torch.Generator`` a device:
imperative random ops (the samplers, ``Dropout``) draw from the
generator of the device they run on (:func:`generator`), and
:func:`seed` reseeds them all.  Draws from the same seed repeat, but
they are not the JAX package's numbers (the two generators differ), so
random ops are held to the reference by their moments only.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "generator"]

_state = threading.local()


def _table():
    if not hasattr(_state, "gens"):
        _state.gens = {}
        _state.seed = 0
    return _state


def seed(seed_state):
    """Seed every random source: each device's generator, torch's default
    generators (the initializers draw from them) and numpy's (the JAX
    package's ``seed`` seeds numpy too)."""
    st = _table()
    st.seed = int(seed_state)
    for gen in st.gens.values():
        gen.manual_seed(st.seed)
    torch.manual_seed(st.seed)
    np.random.seed(st.seed % (2 ** 32))


def generator(device):
    """The generator of ``device`` (a ``torch.device`` or its name),
    created seeded with the last :func:`seed` (0 before any)."""
    st = _table()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = st.gens.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(st.seed)
        st.gens[dev] = gen
    return gen

"""``shard_map`` over a ``torch.distributed`` mesh (the counterpart of
``mxnet_tpu/parallel/compat.py``, which maps the call onto whichever
``jax.shard_map`` the installed jax has).

The port runs one process a rank, and every rank holds the global
arrays (as a mesh ``Module`` feeds them): :func:`shard_map` slices each
input to this rank's block by its spec, calls the function inside a
context where each mesh axis name resolves to its process group, size
and this rank's index on it (:func:`axis`: what ``lax.psum(1, name)`` and
``lax.axis_index(name)`` read in the reference), and gathers each output
by its spec, so the caller gets the global array, as jax's
``shard_map`` gives.  Both steps are differentiable: an input's block is
sliced with ``collectives.scatter_to`` (its gradient all-gathered) and
an output gathered with ``collectives.gather_from`` (its gradient this
rank's slice), so the gradient of a global input is the global gradient
on every rank.

A spec is a tuple with one entry a dim: a mesh axis name (the dim is
split over that axis in rank order), a tuple of names (split over their
product, the first the major one, as ``P(("data", "expert"))``) or None
(whole); a spec of None leaves the array whole.  ``in_specs`` has one
spec an argument; ``out_specs`` is one spec for a function that returns
one tensor, else one a returned tensor.  The mesh may also be a ``{name:
MeshAxis}`` dict (groups a caller already holds).

Stated differences: ``check_vma`` is accepted and means nothing (there
is no varying-axes typing to relax), and :func:`pvary` is the identity,
as the reference's is where jax has no such typing.  An input that a
spec leaves whole over an axis keeps this rank's own gradient (jax sums
a varying use's over that axis).
"""
from __future__ import annotations

import threading

from ..base import MXNetError
from . import collectives as C

__all__ = ["shard_map", "pvary", "axis", "MeshAxis"]

_LOCAL = threading.local()


class MeshAxis:
    """One mesh axis as a rank sees it: its process ``group`` (None for an
    axis of one), ``size`` and this rank's ``index`` on it."""

    __slots__ = ("name", "group", "size", "index")

    def __init__(self, name, group, size, index):
        self.name, self.group = name, group
        self.size, self.index = int(size), int(index)

    def __repr__(self):
        return "MeshAxis(%r, size=%d, index=%d)" % (self.name, self.size,
                                                    self.index)


def _stack():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def axis(name):
    """The :class:`MeshAxis` called ``name`` in the innermost
    :func:`shard_map` call; MXNetError naming it when no enclosing call
    binds it."""
    for env in reversed(_stack()):
        if name in env:
            return env[name]
    raise MXNetError(
        "mesh axis %r is not bound here: call inside compat.shard_map over "
        "a mesh with that axis, or pass its ProcessGroup" % (name,))


def _mesh_axes(mesh):
    """``{name: MeshAxis}`` of a ``DeviceMesh`` (or a ``MeshConfig``,
    built over the process group; or such a dict itself)."""
    from .mesh import MeshConfig, build_mesh

    if isinstance(mesh, dict):
        return dict(mesh)
    if isinstance(mesh, MeshConfig):
        mesh = build_mesh(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise MXNetError("shard_map needs a DeviceMesh with named dims "
                         "(parallel.build_mesh), not %r" % (mesh,))
    out = {}
    for i, name in enumerate(names):
        size = int(mesh.mesh.shape[i])
        group = mesh.get_group(name) if size > 1 else None
        index = mesh.get_local_rank(name) if size > 1 else 0
        out[name] = MeshAxis(name, group, size, index)
    return out


def _specs(specs, n, what):
    if specs is None:
        return [None] * n
    specs = list(specs)
    if len(specs) != n or any(isinstance(s, str) for s in specs):
        raise MXNetError("shard_map: %s must hold one spec (a tuple of axis "
                         "names or None a dim, or None) for each of the %d "
                         "arrays, not %r" % (what, n, specs))
    return specs


def _split_dims(x, spec, axes, what):
    """``[(dim, MeshAxis)]`` of ``spec`` for ``x``, checked."""
    if spec is None:
        return []
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise MXNetError("shard_map: %s spec %r has more dims than its "
                         "array's %s" % (what, spec, tuple(x.shape)))
    out, seen = [], set()
    for dim, names in enumerate(spec):
        for name in (names if isinstance(names, tuple) else (names,)):
            if name is None:
                continue
            if name not in axes:
                raise MXNetError("shard_map: %s spec names %r, which the "
                                 "mesh (%s) lacks" % (what, name,
                                                      sorted(axes)))
            if name in seen:
                raise MXNetError("shard_map: %s spec names %r twice"
                                 % (what, name))
            seen.add(name)
            if axes[name].size > 1:
                out.append((dim, axes[name]))
    return out


def shard_map(f, mesh, in_specs, out_specs, check_vma=None):
    """``f`` mapped over ``mesh`` (a ``DeviceMesh`` from
    ``parallel.build_mesh``, or a ``MeshConfig``): the returned function
    takes and returns global arrays; ``f`` sees this rank's blocks.
    The mesh's axes (and a ``MeshConfig``'s groups) are resolved here,
    once, not at every call.  ``check_vma`` means nothing here (see the
    module's docstring)."""
    del check_vma
    axes = _mesh_axes(mesh)

    def mapped(*args):
        local = []
        for i, (x, spec) in enumerate(zip(args, _specs(in_specs, len(args),
                                                       "in_specs"))):
            for dim, ax in _split_dims(x, spec, axes, "input %d" % i):
                if x.shape[dim] % ax.size:
                    raise MXNetError(
                        "shard_map: input %d's dim %d (%d) does not split "
                        "over the %r axis of %d" % (i, dim, x.shape[dim],
                                                    ax.name, ax.size))
                x = C.scatter_to(x, dim, ax.group)
            local.append(x)
        stack = _stack()
        stack.append(axes)
        try:
            out = f(*local)
        finally:
            stack.pop()
        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        ospecs = [out_specs] if single else _specs(out_specs, len(outs),
                                                   "out_specs")
        res = []
        for i, (y, spec) in enumerate(zip(outs, ospecs)):
            for dim, ax in reversed(_split_dims(y, spec, axes,
                                                "output %d" % i)):
                y = C.gather_from(y, dim, ax.group)
            res.append(y)
        return res[0] if single else type(out)(res)

    return mapped


def pvary(x, axis_names):
    """The identity: the port has no varying-mesh-axes typing (the
    reference's own answer where jax has none)."""
    del axis_names
    return x

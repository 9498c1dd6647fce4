"""Regex partition rules over named parameter trees (the counterpart of
``mxnet_tpu/programs/partition.py``).

A sharding plan is a list of ``(regex, axes)`` rules matched against
parameter NAMES (the fmengine ``match_partition_rules`` idiom);
:func:`rules_from_plan` turns the Megatron graph walk's plan
(:func:`~mxnet_tpu_torch.parallel.tp_rules.plan_tensor_parallel`) into
exact-name rules, so graph-derived and hand-written rules share one
matcher.  Axes are tuples of mesh axis names (or None) a tensor dim,
where the reference uses ``PartitionSpec``.

:func:`build_shardings` returns, for each name, torch's placements
(``Shard(dim)`` / ``Replicate()`` from ``torch.distributed.tensor``) over
the mesh's dims, where the reference returns ``NamedSharding``s.  The
degrade rule is the reference's: a rule whose rank differs from the
leaf's, or whose sharded dims do not divide by the mesh axis,
REPLICATES the leaf, and the coverage record says so.
"""
from __future__ import annotations

import re

import numpy as np

__all__ = ["match_partition_rules", "build_shardings", "rules_from_plan"]


def _as_spec(spec):
    return tuple(spec)


def _exact_table(rules):
    """``{literal_name: spec}`` when EVERY rule is an exact-name anchor
    (``^<re.escape(name)>$``, what :func:`rules_from_plan` emits), else
    None: exact plans then match by one dict lookup a leaf.  First rule
    wins, like the scan."""
    table = {}
    for patt, spec in rules or ():
        if not (isinstance(patt, str) and patt.startswith("^")
                and patt.endswith("$")):
            return None
        body = patt[1:-1]
        literal = re.sub(r"\\(.)", r"\1", body)
        if re.escape(literal) != body:
            return None
        table.setdefault(literal, spec)
    return table


def match_partition_rules(rules, named_leaves, default=(), coverage=None):
    """``{name: axes tuple}`` by the first matching regex a name
    (``re.search``; anchor with ``^...$`` for exact names).

    ``named_leaves`` maps names to shape-bearing leaves (tensors, arrays,
    or anything with ``shape``).  Scalars and single-element leaves
    always replicate; an unmatched name takes ``default``.
    ``coverage``, when a dict, receives one record a leaf: ``{"shape",
    "spec", "source": "scalar|rule|default"}``.
    """
    def note(name, shape, spec, source):
        if coverage is not None:
            coverage[name] = {"shape": [int(d) for d in shape],
                              "spec": [str(a) if a is not None else None
                                       for a in spec],
                              "source": source}

    exact = _exact_table(rules)
    out = {}
    for name, leaf in named_leaves.items():
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            out[name] = ()
            note(name, shape, (), "scalar")
            continue
        if exact is not None:
            hit = exact.get(name)
            out[name] = _as_spec(hit if hit is not None else default)
            note(name, shape, out[name],
                 "rule" if hit is not None else "default")
            continue
        for patt, spec in rules or ():
            if re.search(patt, name) is not None:
                out[name] = _as_spec(spec)
                note(name, shape, out[name], "rule")
                break
        else:
            out[name] = _as_spec(default)
            note(name, shape, out[name], "default")
    return out


def mesh_sizes(mesh):
    """``{axis: size}`` of a ``DeviceMesh`` (its dim names) or of a
    mapping of axis sizes (kept in its order)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    return {str(k): int(v) for k, v in dict(mesh).items()}


def build_shardings(mesh, rules, named_leaves, default=(), coverage=None):
    """``{name: placements}`` for a named parameter tree on ``mesh`` (a
    ``DeviceMesh``, or a mapping of axis sizes in mesh-dim order):
    placements is a tuple with one entry a mesh dim, ``Shard(d)`` where
    tensor dim ``d`` is split on that axis, else ``Replicate()``.

    Applies :func:`match_partition_rules`, then the divisibility guard:
    a matched spec holds only when its rank equals the leaf's and every
    sharded dim divides by its axis size; otherwise the leaf replicates
    and ``coverage`` (when a dict) gets ``"degrade"``
    (``"rank-mismatch"`` or ``"indivisible"``) on its record."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_sizes(mesh)
    specs = match_partition_rules(rules, named_leaves, default,
                                  coverage=coverage)
    out = {}
    for name, leaf in named_leaves.items():
        spec = specs[name]
        shape = tuple(getattr(leaf, "shape", ()) or ())
        ok = len(spec) == len(shape) and all(
            ax is None or shape[d] % sizes.get(ax, 1) == 0
            for d, ax in enumerate(spec))
        if not ok and coverage is not None and len(spec) \
                and coverage.get(name, {}).get("source") != "default":
            coverage[name]["degrade"] = ("rank-mismatch"
                                         if len(spec) != len(shape)
                                         else "indivisible")
        if not ok:
            spec = ()
        out[name] = tuple(
            next((Shard(d) for d, ax in enumerate(spec) if ax == axis),
                 Replicate()) for axis in sizes)
    return out


def rules_from_plan(plan):
    """Exact-name regex rules from a ``{name: axes tuple}`` plan: the
    Megatron graph walk through the one regex matcher."""
    return [("^" + re.escape(name) + "$", tuple(spec))
            for name, spec in (plan or {}).items()]

"""Mixture-of-experts feed-forward (counterpart of
``mxnet_tpu/ops/moe.py``).

``MoEFFN`` is a routed expert feed-forward layer::

    gate   = softmax(x @ Wg)                      # (N, E) router
    choice = top-k(gate)                          # k = num_experts_per_tok
    y      = sum_k gate_k * FFN_{choice_k}(x)     # gated expert mixture

Top-1 (the default) is switch routing with the raw chosen probability as
the gate; k > 1 renormalizes the chosen gates to sum to one.

Three dispatch shapes, one routing rule:

* **dense** (``capacity_factor == 0``): every expert sees every token
  through one-hot dispatch and combine products: E times the FFN work.
  The oracle the sparse path is held to.
* **sparse** (``capacity_factor > 0`` or dropless): capacity-slot
  dispatch.  Each expert owns ``C = ceil(cf*k*N_g/E)`` slots per token
  group; choices past capacity drop (Switch semantics) unless
  ``dropless`` stretches C to the group's worst case.  ``num_groups``
  splits the tokens into contiguous groups with their own quotas (group
  g of the reference is device g of its sharded path).
* **sharded** (a capacity under a mesh whose ``expert`` axis is above 1,
  the experts and the tokens dividing it: :func:`_sharded_ok`):
  :func:`_moe_forward_sparse_sharded`, one rank a process.  Each rank
  routes its n_loc tokens (split over data x expert, and over seq too
  where a mesh Module's rows arrive split over it), packs them into
  (E, C_loc, d) slots, exchanges them with
  ``collectives.all_to_all`` over the expert group, runs its own experts
  (their hidden dim split over ``model`` with one sum when it divides),
  exchanges the outputs back and combines them.  ``MoEFn``'s backward
  recomputes through the same two exchanges, and their gradients are the
  reversed exchanges: six a training step.  Token-identical to
  ``_moe_forward_sparse(num_groups=data*expert)``.

On a mesh (:class:`MoEMesh`, from the mesh ``Module``'s and the mesh
``DecodePredictor``'s graph walk) a config the sharded path does not take
keeps the reference's global semantics, never per-rank ones: the sparse
path counts slot positions over every data (and seq) rank's choices in
the global row order (one quota, ``num_groups`` 1) with the expert
stacks gathered (the degrade is
recorded in :data:`MOE_DEGRADE`), and the dense oracle runs each rank's
experts over every token with one sum over the expert group.  On every
path the Switch balance term averages f and P over the whole token group
(data x seq x expert) before their product, and each gradient is counted once
across the ranks.  The expert products are batched matrix products
(``torch.bmm``), as they are einsums outside any kernel in the JAX
package.  Without a mesh everything is capturable in a CUDA graph: no
value is read back to the host, no boolean indexing, no ``bincount``
(whose output size is read from the card).

Load balancing: the Switch auxiliary loss (E * sum_e f_e * P_e) is folded
into the op's own gradient (:class:`MoEFn`): the backward recomputes the
forward and returns the vector-Jacobian product of ``y + coeff * aux``,
the coefficient in aux's dtype (``aux_loss_coeff=0`` disables it).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config as _config
from ..attrs import Param, ParamSchema
from ..registry import OpDef, register_op

# which dispatch shape the last MoEFFN call used ("dense" | "sparse" |
# "sparse_a2a")
MOE_PATH = {"last": None}

# why the last sparse call under an expert axis did not take the sharded
# path (None: it did, or no expert axis)
MOE_DEGRADE = {"last": None}

# which capacity-slot assignment algorithm the last sparse call used
# ("sort" | "onehot"); None until a capacity path runs
MOE_DISPATCH = {"last": None}


def _moe_shape(attrs, in_shapes, aux_shapes):
    x = in_shapes[0]
    e = attrs["num_experts"]
    h = attrs["hidden_size"]
    d = x[-1]
    want = [tuple(x), (d, e), (e, d, h), (e, h), (e, h, d), (e, d)]
    return want, [tuple(x)], []


def _one_hot(choice, e, dtype):
    """(..., E) one-hot of integer ``choice`` as a comparison (no range
    check read back from the card)."""
    return (choice[..., None]
            == torch.arange(e, device=choice.device)).to(dtype)


# ---------------------------------------------------------------------------
# routing + slot assignment
# ---------------------------------------------------------------------------

def _route(probs, k):
    """Top-k routing: ``(choice, gate)`` both (n, k).

    k = 1 is switch routing (argmax, the first index among equal
    values; gate = the raw chosen probability).  k > 1 takes the k
    highest-probability experts per token, the lower index first among
    equal values (``jax.lax.top_k``'s order: a stable descending sort),
    and renormalizes the chosen gates to sum to one.
    """
    if k == 1:
        choice = torch.argmax(probs, dim=-1)[:, None]
        gate = torch.gather(probs, -1, choice)
        return choice, gate
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, choice = vals[:, :k], idx[:, :k]
    gate = gate / gate.sum(-1, keepdim=True)
    return choice, gate


def _positions_onehot(choice, e):
    """Capacity positions via the one-hot cumsum pack: a (k*n, E)
    integer one-hot and its running sum (integers, never the activation
    dtype, which loses exact counts past 256 in bf16)."""
    n, k = choice.shape
    oh = _one_hot(choice, e, torch.int64)                 # (n, k, E)
    oh_rank_major = oh.transpose(0, 1).reshape(k * n, e)
    return ((torch.cumsum(oh_rank_major, dim=0) - 1) * oh_rank_major) \
        .sum(-1).reshape(k, n).t()                         # (n, k)


def _positions_sort(choice, e):
    """Capacity positions via sort-based dispatch: a STABLE sort of the
    rank-major flattened choices orders the entries by (expert,
    priority), so each entry's position within its expert is its sorted
    index minus the expert's start (an exclusive sum of the length-E
    histogram, built by a scatter-add)."""
    n, k = choice.shape
    flat = choice.t().reshape(-1)                          # rank-major
    _, order = torch.sort(flat, stable=True)
    counts = torch.zeros((e,), dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=0) - counts          # exclusive
    pos_sorted = torch.arange(k * n, dtype=torch.int64,
                              device=flat.device) - starts[flat[order]]
    pos = torch.zeros((k * n,), dtype=torch.int64, device=flat.device)
    return pos.scatter_(0, order, pos_sorted).reshape(k, n).t()


def _slot_assign(choice, e, cap):
    """Capacity-slot assignment for one token group.

    Positions are PRIORITY-MAJOR: every token's rank-0 choice is counted
    before any rank-1 choice.  Returns ``(pos, keep, slot)``, all (n,
    k); ``slot = choice*cap + pos`` clipped into [0, e*cap).
    ``MXNET_MOE_DISPATCH`` selects the position algorithm ('sort' or
    'onehot'); both give the same tables bit for bit.
    """
    algo = (str(_config.get("MXNET_MOE_DISPATCH")) or "sort").lower()
    if algo not in ("sort", "onehot"):
        raise ValueError("MXNET_MOE_DISPATCH must be 'sort' or 'onehot'; "
                         "got %r" % algo)
    MOE_DISPATCH["last"] = algo
    pos = (_positions_sort if algo == "sort"
           else _positions_onehot)(choice, e)
    keep = pos < cap
    slot = choice * cap + torch.clamp(pos, max=cap - 1)
    return pos, keep, slot


def _pack_slots(xt, slot, keep, e, cap):
    """Scatter kept tokens into the (E, cap, d) dispatch table: a token
    index per slot (dropped choices go to a sentinel entry e*cap, sliced
    off), unfilled slots reading a zero pad row."""
    n, d = xt.shape
    k = slot.shape[1]
    tok = torch.arange(n, dtype=torch.int64, device=xt.device)[:, None] \
        .expand(n, k).reshape(-1)
    scatter_idx = torch.where(keep.reshape(-1), slot.reshape(-1),
                              torch.full_like(tok, e * cap))
    slot_tok = torch.full((e * cap + 1,), n, dtype=torch.int64,
                          device=xt.device).scatter_(0, scatter_idx, tok)
    xpad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    return xpad.index_select(0, slot_tok[:e * cap]).reshape(e, cap, d)


def _combine_slots(flat_out, slot, keep, gate):
    """Gather each kept (token, rank) choice's slot output, weighted by
    its gate; dropped choices contribute zero."""
    total = flat_out.shape[0]
    idx = torch.clamp(slot, max=total - 1)                 # (n, k)
    picked = flat_out.index_select(0, idx.reshape(-1)) \
        .reshape(idx.shape + (flat_out.shape[-1],))        # (n, k, d)
    w = keep.to(flat_out.dtype) * gate.to(flat_out.dtype)
    return (picked * w[..., None]).sum(dim=1)


def _expert_ffn(xd, w1, b1, w2, b2):
    """The relu expert FFN over an (E, C, d) slot table."""
    h = torch.relu(torch.bmm(xd, w1) + b1[:, None, :])
    return torch.bmm(h, w2) + b2[:, None, :]


def _aux_terms(probs, choice, e):
    """(frac, imp) means for the Switch balance loss: f_e = mean routed
    fraction per choice rank, P_e = mean router probability."""
    k = choice.shape[1]
    oh = _one_hot(choice, e, probs.dtype).sum(1)           # (n, E)
    return oh.mean(0) / k, probs.mean(0)


def _capacity(capacity_factor, k, group_tokens, e, dropless):
    if dropless:
        return group_tokens * k
    return max(1, int(np.ceil(capacity_factor * k * group_tokens / e)))


# ---------------------------------------------------------------------------
# the two dispatch shapes
# ---------------------------------------------------------------------------

def _moe_forward(x, wg, w1, b1, w2, b2, num_experts, num_experts_per_tok=1):
    """Dense one-hot dispatch -> (y, aux_loss): every expert sees the
    masked token batch (the E-times-the-work oracle)."""
    e = num_experts
    k = min(num_experts_per_tok, e)
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)                       # (N, d) tokens

    probs = torch.softmax(xt @ wg, dim=-1)      # (N, E) router
    choice, gate = _route(probs, k)             # (N, k) each
    onehot_k = _one_hot(choice, e, xt.dtype)    # (N, k, E)
    dispatch = onehot_k.sum(1)                  # (N, E) 0/1 mask
    combine = (onehot_k * gate[..., None].to(xt.dtype)).sum(1)

    xe = dispatch.t()[:, :, None] * xt[None]    # (E, N, d)
    ye = _expert_ffn(xe, w1, b1, w2, b2)        # (E, N, d)
    y = torch.einsum("end,ne->nd", ye, combine)  # gated combine

    # Switch load-balance loss: E * sum_e f_e * P_e
    frac, imp = _aux_terms(probs, choice, e)
    aux_loss = (frac * imp).sum() * e
    return y.reshape(orig_shape), aux_loss


def _route_groups(x, wg, num_experts, capacity_factor, num_experts_per_tok,
                  num_groups, dropless):
    """The sparse path's routing: ``(xt, probs, choice, gate, cap,
    tables)`` with ``tables`` one ``(pos, keep, slot)`` per group."""
    e = num_experts
    k = min(num_experts_per_tok, e)
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    g = num_groups
    assert n % g == 0, "token count %d not divisible into %d groups" % (n, g)
    ng = n // g
    cap = _capacity(capacity_factor, k, ng, e, dropless)
    probs = torch.softmax(xt @ wg, dim=-1)
    choice, gate = _route(probs, k)
    tables = [_slot_assign(choice[i * ng:(i + 1) * ng], e, cap)
              for i in range(g)]
    return xt, probs, choice, gate, cap, tables


def _moe_forward_sparse(x, wg, w1, b1, w2, b2, num_experts,
                        capacity_factor, num_experts_per_tok=1,
                        num_groups=1, dropless=False):
    """Capacity-based sparse dispatch: per-step FLOPs flat in num_experts.

    Tokens split into ``num_groups`` contiguous groups; within each group
    every (token, rank-k choice) takes the next capacity slot of its
    chosen expert (C = ceil(cf*k*N_g/E) slots per group and expert), and
    choices past capacity drop unless ``dropless`` stretches C to the
    group's worst case.  Dispatch and combine are gathers over the slot
    tables; the experts run once over every group's slots, (E, g*C, d).
    """
    e = num_experts
    orig_shape = x.shape
    d = x.shape[-1]
    xt, probs, choice, gate, cap, tables = _route_groups(
        x, wg, e, capacity_factor, num_experts_per_tok, num_groups,
        dropless)
    n = xt.shape[0]
    g = num_groups
    ng = n // g
    xd = torch.stack([
        _pack_slots(xt[i * ng:(i + 1) * ng], slot, keep, e, cap)
        for i, (_, keep, slot) in enumerate(tables)], dim=1)  # (E, g, C, d)
    ye = _expert_ffn(xd.reshape(e, g * cap, d), w1, b1, w2, b2)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1)             # (g, E, C, d)
    yt = torch.cat([
        _combine_slots(ye[i].reshape(e * cap, d), slot, keep,
                       gate[i * ng:(i + 1) * ng])
        for i, (_, keep, slot) in enumerate(tables)], dim=0)

    frac, imp = _aux_terms(probs, choice, e)
    aux_loss = (frac * imp).sum() * e
    return yt.reshape(orig_shape), aux_loss


# ---------------------------------------------------------------------------
# the mesh: the sharded all-to-all path and the global semantics
# ---------------------------------------------------------------------------

class MoEMesh:
    """Where an MoEFFN call runs on a mesh of processes: ``axes``
    ``{name: parallel.compat.MeshAxis}`` (``data``, ``model``, ``seq``,
    ``expert``), ``split`` the axes the data input's rows already arrive
    split over (a mesh Module's ``data`` rows, and under a ``seq`` axis
    its blocks of the sequence: then ``seq_t`` is the block's length,
    the rows being (outer, seq_t) with the block inner), ``local``
    whether the expert stacks given are this rank's block of the expert
    axis (a mesh Module's sharded stacks) or whole."""

    __slots__ = ("axes", "split", "local", "seq_t")

    def __init__(self, axes, split=(), local=False, seq_t=None):
        self.axes = dict(axes)
        self.split = tuple(a for a in split if self.size(a) > 1)
        self.local = bool(local) and self.size("expert") > 1
        self.seq_t = seq_t
        if "seq" in self.split and not seq_t:
            raise ValueError("rows split over a seq axis need the block's "
                             "length (seq_t)")

    @classmethod
    def of(cls, mesh):
        """A ``MoEMesh`` of a ``DeviceMesh`` / ``MeshConfig`` / ``{name:
        MeshAxis}`` whose arrays are global (nothing split, stacks
        whole); a ``MoEMesh`` itself."""
        if isinstance(mesh, cls):
            return mesh
        from ..parallel.compat import _mesh_axes

        return cls(_mesh_axes(mesh))

    def size(self, name):
        ax = self.axes.get(name)
        return ax.size if ax is not None else 1

    def token_axes(self):
        """The axes the tokens are split over on the sharded path, major
        first (those of size above 1): data, the seq axis where the rows
        arrive split over it, expert."""
        return tuple(a for a in ("data", "seq", "expert")
                     if self.size(a) > 1
                     and (a != "seq" or a in self.split))


def _token_mean(value, axes):
    """The mean over a token group of a per-rank mean ``value`` (equal
    token counts a rank): summed over each axis, the gradient passed
    through (``collectives.reduce_from``: every rank's local term counts
    once), divided by the group's size."""
    from ..parallel import collectives as C

    n = 1
    for ax in axes:
        value = C.reduce_from(value, ax.group)
        n *= ax.size
    return value / n if n > 1 else value


def _balance_loss(probs, choice, e, axes):
    """The Switch loss E * sum_e f_e * P_e with f and P averaged over the
    token group ``axes`` before their product."""
    frac, imp = _aux_terms(probs, choice, e)
    return (_token_mean(frac, axes) * _token_mean(imp, axes)).sum() * e


def _sharded_ok(x, num_experts, mesh):
    """The sharded path's divisibility guards (the reference's): an
    ``expert`` axis above 1, the experts dividing it, and the global
    token count (over every axis that splits the rows) dividing the token
    axes (data x expert, and seq where the rows arrive split over it).
    Returns None when they hold, else the reason (the call then keeps the
    global semantics)."""
    ep = mesh.size("expert")
    if ep <= 1:
        return "no expert axis"
    if num_experts % ep:
        return "%d experts do not divide the expert axis of %d" % (
            num_experts, ep)
    n = int(np.prod(x.shape[:-1])) * int(np.prod(
        [mesh.size(a) for a in mesh.split]))
    axes = mesh.token_axes()
    groups = int(np.prod([mesh.size(a) for a in axes]))
    if n % groups:
        return "%d tokens do not divide %s = %d" % (
            n, " x ".join(axes if "data" in axes else ("data",) + axes),
            groups)
    return None


def _sharded_local(xt, wg, w1, b1, w2, b2, e, k, cap, model_split,
                   tok_axes):
    """One rank of the sharded path, inside ``compat.shard_map``: its
    tokens ``xt`` (n_loc, d), the router whole, its experts' stacks (the
    hidden dim this rank's block over ``model`` when ``model_split``).
    Returns ``(yt, aux)``."""
    from ..parallel import collectives as C
    from ..parallel import compat

    ex = compat.axis("expert")
    d = xt.shape[-1]
    # each expert rank routes other tokens: the router's gradient is
    # summed over the group
    wg = C.copy_to(wg, ex.group)
    probs = torch.softmax(xt @ wg, dim=-1)
    choice, gate = _route(probs, k)
    _, keep, slot = _slot_assign(choice, e, cap)
    xd = _pack_slots(xt, slot, keep, e, cap)              # (E, C_loc, d)
    # dispatch: the expert dim splits over the group, the capacity dims
    # concatenate source-rank-major -> (E / ep, ep * C_loc, d)
    xs = C.all_to_all(xd, 0, 1, ex.group)
    if model_split:
        # the Megatron pair over the hidden dim: f before, g after
        xs = C.copy_to(xs, compat.axis("model").group)
    h = torch.relu(torch.bmm(xs, w1) + b1[:, None, :])
    ye = torch.bmm(h, w2)
    if model_split:
        ye = C.reduce_from(ye, compat.axis("model").group)
    ye = ye + b2[:, None, :]
    # combine exchange: the capacity dim splits back to the source ranks,
    # the expert dim concatenates home -> (E, C_loc, d)
    ys = C.all_to_all(ye, 1, 0, ex.group)
    yt = _combine_slots(ys.reshape(e * cap, d), slot, keep, gate)
    return yt, _balance_loss(probs, choice, e,
                             [compat.axis(a) for a in tok_axes])


def _moe_forward_sparse_sharded(x, wg, w1, b1, w2, b2, num_experts,
                                capacity_factor, mesh,
                                num_experts_per_tok=1, dropless=False):
    """Explicit expert-parallel dispatch over a mesh of processes
    (``mesh``: a :class:`MoEMesh`, or a ``DeviceMesh`` / ``MeshConfig``
    over which every rank holds the global arrays): a
    ``compat.shard_map`` of :func:`_sharded_local`, tokens split over
    (data, expert), the expert stacks over ``expert`` with the hidden dim
    over ``model`` when it divides.  Returns ``(y, aux)`` as the caller
    holds x: whole, or its own rows where ``mesh.split`` says so.

    The gradients are the reference's: every rank gets its tokens' x
    gradient, gathered as x is; the router's is summed over the expert
    group inside; an axis the call itself splits the tokens over (data,
    when x arrives whole) sums every weight's gradient over it, which a
    mesh Module's executor does for the rows it splits.
    Token-identical to ``_moe_forward_sparse(...,
    num_groups=data*expert)``."""
    from ..parallel import collectives as C
    from ..parallel.compat import shard_map

    mesh = MoEMesh.of(mesh)
    e = num_experts
    k = min(num_experts_per_tok, e)
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    tok_axes = mesh.token_axes()
    n_loc = xt.shape[0] * int(np.prod([mesh.size(a) for a in mesh.split])) \
        // int(np.prod([mesh.size(a) for a in tok_axes]))
    cap = _capacity(capacity_factor, k, n_loc, e, dropless)
    mp = mesh.size("model")
    model_ax = "model" if mp > 1 and w1.shape[-1] % mp == 0 else None
    x_axes = tuple(a for a in tok_axes if a not in mesh.split)
    weights = [wg, w1, b1, w2, b2]
    for a in x_axes:
        if a != "expert":
            weights = [C.copy_to(w, mesh.axes[a].group) for w in weights]
    ex = None if mesh.local else "expert"
    fn = shard_map(
        lambda *a: _sharded_local(*a, e, k, cap, model_ax is not None,
                                  tok_axes),
        mesh.axes,
        ((x_axes or None, None), None, (ex, None, model_ax),
         (ex, model_ax), (ex, model_ax, None), (ex, None)),
        ((x_axes or None, None), None))
    yt, aux = fn(xt, *weights)
    return yt.reshape(orig_shape), aux


def _whole_stacks(mesh, stacks):
    """The four expert stacks whole: a rank's block gathered over the
    expert group (its gradient this rank's block)."""
    if not mesh.local:
        return stacks
    from ..parallel import collectives as C

    group = mesh.axes["expert"].group
    return [C.gather_from(w, 0, group) for w in stacks]


def _global_choices(choice, mesh):
    """``(every, mine)``: the (n_all, k) choices of every rank of the
    split axes in the global row order (gathered: over the seq group
    within each outer row first, the blocks inner, then over the data
    group along the rows) and the indices of this rank's rows in it."""
    from ..parallel import collectives as C

    n, k = choice.shape
    every = choice.contiguous()
    mine = torch.arange(n, device=choice.device)
    if "seq" in mesh.split:
        ax, t = mesh.axes["seq"], mesh.seq_t
        outer = n // t
        every = C.all_gather(every.reshape(outer, t, k), 1, ax.group) \
            .reshape(-1, k)
        mine = (mine // t) * (t * ax.size) + ax.index * t + mine % t
    if "data" in mesh.split:
        ax = mesh.axes["data"]
        mine = mine + ax.index * every.shape[0]
        every = C.all_gather(every, 0, ax.group)
    return every, mine


def _moe_forward_sparse_global(x, wg, w1, b1, w2, b2, num_experts,
                               capacity_factor, mesh,
                               num_experts_per_tok=1, dropless=False):
    """The sparse path on a mesh where the sharded one does not apply:
    the reference's ``_moe_forward_sparse`` over the global batch, one
    capacity quota (``num_groups`` 1).  Each rank routes the rows it
    holds; when they are its block of a data (and seq) split, every
    rank's choices are gathered in the global row order (integers, no
    gradient: :func:`_global_choices`) so the slot positions are the
    global ones, and the rank packs and combines its own tokens.  f and
    P are averaged over the split axes, so the balance term's gradient
    counts once across them."""
    from ..parallel import collectives as C

    e = num_experts
    k = min(num_experts_per_tok, e)
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    n = xt.shape[0]
    w1, b1, w2, b2 = _whole_stacks(mesh, [w1, b1, w2, b2])
    axes = [mesh.axes[a] for a in mesh.split]
    n_all = n * int(np.prod([ax.size for ax in axes]))
    cap = _capacity(capacity_factor, k, n_all, e, dropless)
    probs = torch.softmax(xt @ wg, dim=-1)
    choice, gate = _route(probs, k)
    every, mine = _global_choices(choice, mesh)
    _, keep, slot = _slot_assign(every, e, cap)
    keep, slot = keep[mine], slot[mine]
    xd = _pack_slots(xt, slot, keep, e, cap)
    ye = _expert_ffn(xd, w1, b1, w2, b2)
    yt = _combine_slots(ye.reshape(e * cap, d), slot, keep, gate)
    return yt.reshape(orig_shape), _balance_loss(probs, choice, e, axes)


def _moe_forward_dense_mesh(x, wg, w1, b1, w2, b2, num_experts, mesh,
                            num_experts_per_tok=1):
    """The dense oracle on a mesh: with an expert axis the experts divide,
    each rank runs its own experts over every token it holds and one sum
    over the expert group adds their outputs (x and the router go in
    through *f*, so their gradients sum the ranks' experts; the balance
    term, alike on every expert rank, counts on the first alone); f and P
    are averaged over the data rows a rank holds a block of."""
    from ..parallel import collectives as C

    e = num_experts
    k = min(num_experts_per_tok, e)
    orig_shape = x.shape
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    ex = mesh.axes.get("expert")
    split = ex is not None and ex.size > 1 and e % ex.size == 0
    stacks = [w1, b1, w2, b2]
    if split:
        if not mesh.local:
            stacks = [C.scatter_to(w, 0, ex.group) for w in stacks]
        xt = C.copy_to(xt, ex.group)
        wg = C.copy_to(wg, ex.group)
    probs = torch.softmax(xt @ wg, dim=-1)
    choice, gate = _route(probs, k)
    onehot_k = _one_hot(choice, e, xt.dtype)
    dispatch = onehot_k.sum(1)
    combine = (onehot_k * gate[..., None].to(xt.dtype)).sum(1)
    if split:
        e_loc = e // ex.size
        cols = slice(ex.index * e_loc, (ex.index + 1) * e_loc)
        dispatch, combine = dispatch[:, cols], combine[:, cols]
    xe = dispatch.t()[:, :, None] * xt[None]
    ye = _expert_ffn(xe, *stacks)
    y = torch.einsum("end,ne->nd", ye, combine)
    aux = _balance_loss(probs, choice, e, [mesh.axes[a] for a in mesh.split])
    if split:
        y = C.reduce_from(y, ex.group)
        aux = C.share_grad(aux, 1.0 if ex.index == 0 else 0.0)
    return y.reshape(orig_shape), aux


def moe_settings(attrs):
    """``(k, capacity_factor, dropless)`` of a MoEFFN node: the runtime
    knobs override the symbol's attributes when they are set, read when
    the op runs (so a captured program keeps what its capture read)."""
    k = int(_config.get("MXNET_MOE_TOPK")) \
        or int(attrs.get("num_experts_per_tok", 1))
    cf = float(_config.get("MXNET_MOE_CAPACITY")) \
        or float(attrs.get("capacity_factor", 0.0))
    dropless = bool(_config.get("MXNET_MOE_DROPLESS")) \
        or attrs.get("overflow", "drop") == "dropless"
    return k, cf, dropless


def moe_flops(attrs, n_tokens, d):
    """FLOPs of one MoEFFN forward over ``n_tokens`` tokens of width
    ``d``: the router's 2*N*d*E, plus the expert products, E * 4*N*d*h
    on the dense path or 4*(E*cap)*d*h on the sparse one (one group)."""
    e = int(attrs["num_experts"])
    h = int(attrs["hidden_size"])
    k, cf, dropless = moe_settings(attrs)
    k = min(k, e)
    flops = 2 * n_tokens * d * e
    if cf > 0 or dropless:
        cap = _capacity(cf, k, n_tokens, e, dropless)
        return flops + 4 * e * cap * d * h
    return flops + e * 4 * n_tokens * d * h


def _forward_impl(num_experts, capacity_factor, num_experts_per_tok,
                  dropless, mesh=None):
    """The op's forward ``(x, wg, w1, b1, w2, b2) -> (y, aux)`` for its
    settings: the sparse path when a capacity or dropless is set, else
    the dense oracle; on a ``mesh`` (:class:`MoEMesh`) the sharded path
    when :func:`_sharded_ok` holds, else the global semantics."""
    if mesh is not None:
        return _mesh_forward_impl(num_experts, capacity_factor,
                                  num_experts_per_tok, dropless, mesh)

    def fwd(x, wg, w1, b1, w2, b2):
        if capacity_factor > 0 or dropless:
            MOE_PATH["last"] = "sparse"
            return _moe_forward_sparse(
                x, wg, w1, b1, w2, b2, num_experts, capacity_factor,
                num_experts_per_tok=num_experts_per_tok, dropless=dropless)
        MOE_PATH["last"] = "dense"
        return _moe_forward(x, wg, w1, b1, w2, b2, num_experts,
                            num_experts_per_tok=num_experts_per_tok)
    return fwd


def _mesh_forward_impl(num_experts, capacity_factor, num_experts_per_tok,
                       dropless, mesh):
    """:func:`_forward_impl` on a mesh, the path recorded in
    :data:`MOE_PATH` (and why not the sharded one in
    :data:`MOE_DEGRADE`)."""
    kw = dict(num_experts_per_tok=num_experts_per_tok)

    def fwd(x, wg, w1, b1, w2, b2):
        if capacity_factor > 0 or dropless:
            why = _sharded_ok(x, num_experts, mesh)
            if why is None:
                MOE_PATH["last"] = "sparse_a2a"
                MOE_DEGRADE["last"] = None
                return _moe_forward_sparse_sharded(
                    x, wg, w1, b1, w2, b2, num_experts, capacity_factor,
                    mesh, dropless=dropless, **kw)
            MOE_PATH["last"] = "sparse"
            MOE_DEGRADE["last"] = why if mesh.size("expert") > 1 else None
            return _moe_forward_sparse_global(
                x, wg, w1, b1, w2, b2, num_experts, capacity_factor, mesh,
                dropless=dropless, **kw)
        MOE_PATH["last"] = "dense"
        return _moe_forward_dense_mesh(x, wg, w1, b1, w2, b2, num_experts,
                                       mesh, **kw)
    return fwd


class MoEFn(torch.autograd.Function):
    """y = MoE(x, ...) whose backward is the vector-Jacobian product of
    ``y + coeff * aux_loss``: training minimizes task loss + coeff *
    balance loss with exact gradients.  The backward recomputes the
    forward under autograd (the reference's ``custom_vjp`` recomputes it
    too), so the forward keeps only its inputs.  The routing tables are
    integers and carry no gradient."""

    @staticmethod
    def forward(ctx, fwd, coeff, x, wg, w1, b1, w2, b2):
        ctx.fwd = fwd
        ctx.coeff = coeff
        ctx.save_for_backward(x, wg, w1, b1, w2, b2)
        y, _ = fwd(x, wg, w1, b1, w2, b2)
        return y

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(True)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, aux = ctx.fwd(*inputs)
        # a fill on the card, not a host-to-device copy (capturable)
        daux = torch.full((), ctx.coeff, dtype=aux.dtype, device=aux.device)
        grads = torch.autograd.grad((y, aux), inputs, (dy, daux))
        return (None, None) + tuple(grads)


def moe_ffn(attrs, x, wg, w1, b1, w2, b2, mesh=None):
    """MoEFFN on tensors with its attributes (the knobs applied); on a
    ``mesh`` (:class:`MoEMesh`) as one rank of it."""
    k, cf, dropless = moe_settings(attrs)
    fwd = _forward_impl(attrs["num_experts"], cf, k, dropless, mesh)
    inputs = (x, wg, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return MoEFn.apply(fwd, float(attrs["aux_loss_coeff"]), *inputs)
    y, _ = fwd(*inputs)
    return y


def register_all():
    def fcompute(attrs, inputs, aux, octx):
        return [moe_ffn(attrs, *inputs)], []

    register_op(OpDef(
        "MoEFFN", fcompute,
        schema=ParamSchema(
            Param("num_experts", int, required=True),
            Param("hidden_size", int, required=True),
            Param("aux_loss_coeff", float, default=0.01,
                  doc="weight of the Switch load-balancing loss folded "
                      "into the backward pass; 0 disables"),
            Param("capacity_factor", float, default=0.0,
                  doc="> 0 enables SPARSE capacity-based dispatch: each "
                      "expert processes at most ceil(cf*k*N_g/E) tokens "
                      "per token group (overflow drops, Switch "
                      "semantics, unless overflow='dropless') and the "
                      "per-step FLOPs are flat in num_experts; under an "
                      "'expert' mesh the dispatch is an explicit "
                      "all-to-all shard_map program (docs/moe.md); 0 "
                      "keeps the dense all-expert oracle"),
            Param("num_experts_per_tok", int, default=1,
                  doc="top-k routing: experts per token (gates "
                      "renormalized over the chosen k when k > 1; 1 = "
                      "classic switch top-1 with the raw probability "
                      "gate).  MXNET_MOE_TOPK overrides at trace time"),
            Param("overflow", str, default="drop",
                  doc="sparse-path overflow policy: 'drop' (Switch "
                      "semantics — past-capacity tokens emit zero and "
                      "ride the residual) or 'dropless' (capacity "
                      "stretches to the per-device worst case with a "
                      "padding mask, no drops ever).  "
                      "MXNET_MOE_DROPLESS=1 forces 'dropless'"),
        ),
        num_inputs=6,
        arguments=["data", "gate_weight", "expert1_weight",
                   "expert1_bias", "expert2_weight", "expert2_bias"],
        infer_shape=_moe_shape,
        mesh_axes={"expert1_weight": "expert", "expert1_bias": "expert",
                   "expert2_weight": "expert", "expert2_bias": "expert"},
        capturable=True,
        doc="Top-k-routed mixture-of-experts feed-forward.  "
            "Leapfrog op (SURVEY §2.5: expert parallelism 'not present'): "
            "expert-stacked weights (E, ...) shard on the 'expert' mesh "
            "axis; capacity_factor > 0 under an 'expert' mesh dispatches "
            "through the explicit all-to-all shard_map program; the "
            "Switch balance loss rides the backward pass "
            "(aux_loss_coeff)."),
        aliases=("_contrib_MoEFFN",))

"""TrainStep — one whole training step: forward, backward, optimizer
update (the counterpart of ``mxnet_tpu/train_step.py``'s
``CompiledTrainStep``: its per-parameter step body ``:707-748`` and its
slab-plan step ``:662-705``).

The JAX package compiles the step into one donated XLA program with its
own master-weight store.  PyTorch runs eagerly, so the port's step reads
the executor group's parameter tensors as the masters and updates them
in place; the module's :class:`~mxnet_tpu_torch.optimizer.Updater` holds
the optimizer state, which is therefore the same whether a step ran here
or through ``Module.update``: there is no store to hand off or flush.
No jit and no donation; CUDA graphs are later work.

**Buckets** (``BucketingModule``): one step serves every executor group
bound against the primary's (``run(batch, group=...)``, after the JAX
package's ``compatible`` / ``_entry_for`` / ``run`` ``:550-590``,
``:758``).  A bucket's group shares the primary's parameter and gradient
NDArrays by identity, so after arming they show the slab views, whether
the bucket was bound before arming or after; its graph forwards through
the views, its gradients land in the one grad slab, and one update runs
over the shared slabs.  A group whose parameters are not all shared is
not ``compatible`` and is refused.

**The slab plan** (``ops/update_kernel.py``), armed whenever ``plan_for``
accepts the optimizer and the masters; the per-parameter update remains
only where it declines (NAG, masters that are not f32 / bf16).  Arming
packs the trainable masters and the optimizer's slots into slabs once,
then rebinds every trainable's NDArray in the executor and each
``Updater.states`` entry to **views** of those slabs, so the eager
``Module.update()``, ``get_params`` / ``set_params`` (in-place copies)
and the kernel all see one storage.  Each step the forward reads views
of the compute-dtype slab (or of the master slab in f32), autograd's
gradients are copied into the f32 grad slab (one pass, the pack the JAX
package fuses into the backward), the per-block lr / wd upload only when
they change (without waiting on the card), and one multi-tensor update
runs per slab.  A master written outside the step (an eager update,
``set_params``) marks the compute slab stale, and the next step recasts
it first.

The compute-dtype rule is the JAX package's (``:640-650``): with a
``compute_dtype``, floating parameters and DATA inputs are cast to it
(labels keep their dtype), uint8 data is cast to it (or f32), gradients
return in the masters' dtype.  That rule casts an LM's float token ids
too, and bf16 holds integers exactly only up to 256: train such models
in f32 (``ROADMAP.md`` lists the fault).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .executor import forward_backward
from .ndarray import torch_dtype
from .ops import update_kernel

__all__ = ["TrainStep"]


class TrainStep:
    """Forward + backward (autograd) + the optimizer update over one
    executor group, in place; through the slab plan when it is armed."""

    def __init__(self, exec_group, updater, compute_dtype=None):
        self._group = exec_group
        self._updater = updater
        exe = exec_group.exec_
        self._grad_names = [n for n in exec_group.param_names
                            if exe.grad_req.get(n, "null") == "write"]
        # optimizer bookkeeping is keyed by the param's index in the group,
        # as on the eager path
        self._grad_indices = [exec_group.param_names.index(n)
                              for n in self._grad_names]
        self._cdtype = (None if compute_dtype in (None, "", "float32")
                        else torch_dtype(compute_dtype))
        self.plan = None
        self._wc_stale = False
        self._hyper_cache = None
        plan = update_kernel.plan_for(
            updater.optimizer,
            {n: exe.arg_dict[n].data for n in self._grad_names},
            self._grad_names, self._cdtype)
        if plan is not None:
            self._arm(plan)

    def _arm(self, plan):
        """Pack masters, gradients and slots into the plan's slabs and
        rebind the executor's arrays and the updater's states to views of
        them."""
        exe = self._group.exec_
        updater = self._updater
        opt = updater.optimizer
        dev = exe.arg_dict[self._grad_names[0]].data.device
        slots = {}
        for n, idx in zip(self._grad_names, self._grad_indices):
            st = updater.states.get(idx)
            if st is None:
                st = opt.create_state(idx, exe.arg_dict[n])
            slots[n] = () if st is None else \
                (st,) if isinstance(st, torch.Tensor) else tuple(st)
        self._w = plan.pack({n: exe.arg_dict[n].data
                             for n in self._grad_names}, dev)
        self._g = plan.pack({n: exe.grad_dict[n].data
                             for n in self._grad_names}, dev,
                            dtype=torch.float32)
        self._slots = plan.pack_slots(slots, dev)
        self._wc = plan.cast_slabs(self._w)
        for n, v in plan.unpack_all(self._w).items():
            exe.arg_dict[n]._set_data(v)
        self._grad_views = plan.unpack_all(self._g)
        self._bind_grad_views()
        slot_views = plan.unpack_slots(self._slots)
        for n, idx in zip(self._grad_names, self._grad_indices):
            views = slot_views[n]
            updater.states[idx] = None if not views else \
                views[0] if plan.kind == "sgd" else views
        # what the forward reads: the compute copy, else the masters
        self._views = {}
        for bk in plan.buckets:
            src = self._wc[bk] if plan.has_wc(bk) else self._w[bk]
            self._views.update(plan.unpack(bk, src))
        self.plan = plan

    def _bind_grad_views(self):
        # grad_dict shows the grad slab (an eager backward rebinds it)
        grad_dict = self._group.exec_.grad_dict
        for n, v in self._grad_views.items():
            grad_dict[n]._set_data(v)

    def compatible(self, group):
        """Whether a (bucket) executor group can train through this
        step: every parameter and aux array the primary's NDArray itself
        (shared binding shares them where the shapes match), and no
        trainable parameter of its own."""
        exe, prim = group.exec_, self._group.exec_
        params = self._group.param_names
        if any(exe.arg_dict.get(n) is not prim.arg_dict[n] for n in params):
            return False
        if any(exe.aux_dict.get(n) is not a
               for n, a in prim.aux_dict.items()):
            return False
        inputs = set(group.data_names) | set(group.label_names)
        return all(n in inputs or n in params for n in exe.arg_dict)

    def masters_changed(self):
        """The masters were written outside the step (an eager update,
        ``set_params``): recast the compute slab before the next
        forward."""
        self._wc_stale = bool(self._wc) if self.plan is not None else False

    def _cast(self, v):
        if self._cdtype is not None and v.is_floating_point():
            return v.to(self._cdtype)
        if v.dtype == torch.uint8:
            return v.to(self._cdtype or torch.float32)
        return v

    def _lr_wd(self, lrs, wds, device):
        """Per-block lr / wd tensors on ``device``, rebuilt (and uploaded
        without a synchronize) only when the per-parameter values
        change."""
        cached = self._hyper_cache
        if cached is not None and np.array_equal(cached[0], lrs) \
                and np.array_equal(cached[1], wds):
            return cached[2], cached[3]
        names = self._grad_names
        lrb, wdb = self.plan.lr_wd_blocks(dict(zip(names, lrs)),
                                          dict(zip(names, wds)))

        def upload(arrays):
            out = {}
            for bk, a in arrays.items():
                t = torch.from_numpy(a)
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                out[bk] = t
            return out

        lrb, wdb = upload(lrb), upload(wdb)
        self._hyper_cache = (lrs, wds, lrb, wdb)
        return lrb, wdb

    def run(self, data_batch, group=None):
        """One step on ``data_batch`` through ``group``'s graph (the
        primary's by default); returns the outputs (tensors)."""
        if group is None:
            group = self._group
        elif group is not self._group and not self.compatible(group):
            raise MXNetError(
                "the bucket's parameters are not all shared with the "
                "train step's; demote every bucket to the eager update")
        group.load_data_batch(data_batch)
        exe = group.exec_
        plan = self.plan
        if plan is not None and self._wc_stale:
            with torch.no_grad():
                for bk, wc in self._wc.items():
                    wc.copy_(self._w[bk])
            self._wc_stale = False
        data_names = set(group.data_names)
        label_names = set(group.label_names)
        env = {}
        for n, arr in exe.arg_dict.items():
            if plan is not None and n in self._views:
                env[n] = self._views[n]
                continue
            v = arr.data
            if n not in label_names and (n in data_names
                                         or n in group.param_names):
                v = self._cast(v)
            env[n] = v
        aux = {n: a.data for n, a in exe.aux_dict.items()}
        outs, new_aux, grads = forward_backward(
            exe._symbol, env, aux, self._grad_names, exe.op_context(True))
        exe._set_aux(new_aux)
        if plan is None:
            exe.set_grads(grads)
        else:
            # the pack into the f32 gradient slab
            with torch.no_grad():
                for n, g in zip(self._grad_names, grads):
                    self._grad_views[n].copy_(g)
            self._bind_grad_views()
        del grads
        if plan is None:
            self._updater.update_multi(
                self._grad_indices,
                [exe.grad_dict[n] for n in self._grad_names],
                [exe.arg_dict[n] for n in self._grad_names])
            update_kernel.UPDATE_PATH["last"] = "per_param"
        else:
            opt = self._updater.optimizer
            lrs, wds, rescale, clip = opt.fused_hyper(self._grad_indices)
            hyp = [rescale, clip] + list(opt.fused_extra())
            lrb, wdb = self._lr_wd(lrs, wds,
                                   next(iter(self._w.values())).device)
            update_kernel.UPDATE_PATH["last"] = plan.apply(
                self._w, self._g, self._slots, self._wc, lrb, wdb, hyp,
                plain=exe.plain)
        exe.set_outputs(outs)
        return outs

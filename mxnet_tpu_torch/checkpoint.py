"""Step-directory checkpoints of a module's training store (the
counterpart of ``mxnet_tpu/checkpoint.py``).

The JAX package writes orbax directories, each host its own shards.
The port writes ``torch.distributed.checkpoint`` (DCP) directories: a
``.metadata`` file and ``__<rank>_0.distcp`` payloads.  One process
without a process group writes one payload.  A mesh ``Module`` (one rank
a process, ``mesh_config``) writes ONE step directory over its group:
each parameter, aux state or slot that the rank holds a block of (the
tensor-parallel shards, the expert stacks) goes in as a ``DTensor`` over
the module's ``DeviceMesh`` with ``programs.partition``'s placements, so
every rank writes its own blocks; a replicated one is a plain tensor,
which DCP writes once.  The first rank renames the directory and writes
the commit marker (and a fence's sidecar) last, after every rank's
payload is in.  A restore reads the blocks of the CURRENT layout,
whatever layout wrote them: a fence of one mesh restores into another,
into one process with no group, and one process's into a mesh.  The
files are not the JAX package's: a checkpoint crosses packages through
``.params`` (``Module.save_checkpoint``), not through these.

    from mxnet_tpu_torch import checkpoint
    checkpoint.save_sharded(directory, step, module)
    checkpoint.load_sharded(directory, step, module)

The state is the module's live store: its parameters and aux states
(the executor's arrays) and, with a compiled train step, under
``update_on_kvstore`` (the store's updater) or on a mesh (its updater,
whose states are views of the B1 slabs), the optimizer slots, keyed
``params/<name>``, ``aux/<name>`` and ``slots/<name>/<i>``.

Commit protocol (the JAX package's): a step directory counts only once
it is *committed*.  The payload is written into a temporary sibling,
``<step>`` + :data:`TMP_SUFFIX`, renamed to ``<dir>/<step>`` when
complete, and :data:`COMMIT_MARKER` is written into it last.
:func:`latest_step` and :func:`is_committed` accept the marker only, so
a crash anywhere before it leaves the previous checkpoint as the resume
point; adopt a directory written by other tooling with
:func:`commit_step`.  The elastic subsystem (``mxnet_tpu_torch.
elastic``) builds its fence checkpoints on these primitives.

**Restores write in place.**  The captured programs bind the store's
tensors by address, so :func:`load_sharded` copies into the live
tensors and never rebinds them; the train step then recasts its compute
copy before its next replay (``CompiledTrainStep.load_from_executor``).
"""
from __future__ import annotations

import logging
import os
import shutil
import warnings

import torch

from .base import MXNetError
from .optimizer import _state_tensors

__all__ = ["save_sharded", "load_sharded", "latest_step", "save_state_tree",
           "commit_step", "is_committed", "layout_of", "Layout",
           "COMMIT_MARKER"]

# written LAST, inside the renamed step directory (the name orbax uses on
# filesystems without an atomic rename, kept so tooling recognizes it)
COMMIT_MARKER = "commit_success.txt"
TMP_SUFFIX = ".dcp-tmp"
_SEP = "/"

log = logging.getLogger(__name__)


def _dcp():
    """``torch.distributed.checkpoint``, its single-process warning
    silenced (one process without a process group is the intent)."""
    import torch.distributed.checkpoint as dcp

    warnings.filterwarnings(
        "ignore", message="torch.distributed is disabled, unavailable or "
        "uninitialized", category=UserWarning)
    return dcp


def _flatten(state):
    """``{section: {name: tensor or sequence of tensors}}`` as DCP's flat
    ``{"section/name[/i]": tensor}``."""
    flat = {}
    _map_state(lambda key, t: flat.__setitem__(key, t), state)
    return flat


def _map_state(fn, state):
    """``state`` with ``fn(key, tensor)`` in place of each tensor (``key``
    the tensor's flat DCP key)."""
    out = {}
    for section, entries in state.items():
        out[section] = sec = {}
        for name, value in entries.items():
            key = section + _SEP + name
            sec[name] = fn(key, value) if isinstance(value, torch.Tensor) \
                else [fn(key + _SEP + str(i), t) for i, t in enumerate(value)]
    return out


def _mesh_of(module):
    """The module's ``MeshRuntime`` when it spans a process group, else
    None."""
    mesh = getattr(module, "_mesh", None)
    return mesh if mesh is not None and mesh.mesh is not None else None


def _state_of(module):
    """The module's live store, ``{section: {name: tensor(s)}}``: the
    executor's parameter and aux tensors and the optimizer slots of a
    compiled train step, under ``update_on_kvstore`` of the store's
    updater, or on a mesh of the module's updater.  The tensors
    themselves, not copies: restores write into them.  Needs a bound
    ``Module``."""
    group = module._exec_group
    exe = group.exec_
    state = {"params": {n: exe.arg_dict[n].data for n in group.param_names},
             "aux": {n: exe.aux_dict[n].data for n in group.aux_names}}
    step = getattr(module, "_train_step", None)
    if step is not None:
        slots = {n: list(s) for n, s in step.slots.items() if len(s)}
    elif getattr(module, "_update_on_kvstore", False):
        slots = _store_slots(module._kvstore._updater, group)
    elif _mesh_of(module) is not None and module._updater is not None:
        slots = _store_slots(module._updater, group)
    else:
        slots = None
    if slots:
        state["slots"] = slots
    return state


def _store_slots(updater, group):
    """The store updater's states, ``{name: [tensors]}``, made now for a
    parameter no push has reached yet (a restore writes into them)."""
    slots = {}
    for idx, (name, w, g) in enumerate(zip(
            group.param_names, group.param_arrays, group.grad_arrays)):
        if g is None:
            continue
        if idx not in updater.states:
            updater.states[idx] = updater.optimizer.create_state(idx, w)
        tensors = [t for t in _state_tensors(updater.states[idx])
                   if t is not None]
        if tensors:
            slots[name] = tensors
    return slots


class Layout:
    """How a mesh module's store lies over its process group: the
    ``DeviceMesh``, and for each parameter or aux state the rank holds a
    block of, its global shape, local shape and placements
    (``programs.partition.build_shardings`` over the plan's specs: the
    tensor-parallel shards on ``model``, the expert stacks on
    ``expert``).  Keys of other tensors (and slots whose shape is not
    their parameter's block) are replicated."""

    def __init__(self, module):
        from types import SimpleNamespace

        from .programs.partition import build_shardings, rules_from_plan

        group = module._exec_group
        tp = group.tp
        self.mesh = module._mesh.mesh
        names = sorted(set(tp.sharded) | set(tp.expert_sharded))
        specs = {n: tuple(tp.coverage[n]["spec"]) for n in names}
        self.shapes = {n: tuple(group.global_shapes[n]) for n in names}
        self.local = {n: tp.local_shape(n, self.shapes[n]) for n in names}
        self.placements = build_shardings(
            self.mesh, rules_from_plan(specs),
            {n: SimpleNamespace(shape=self.shapes[n]) for n in names})

    @staticmethod
    def name_of(key):
        return key.split(_SEP)[1]

    def sharded(self, key, local_shape):
        """Whether ``key`` (of a tensor of ``local_shape``) is a block."""
        name = self.name_of(key)
        return name in self.local \
            and tuple(local_shape) == tuple(self.local[name])

    def global_shape(self, key, local_shape):
        return self.shapes[self.name_of(key)] \
            if self.sharded(key, local_shape) else tuple(local_shape)

    def wrap(self, key, local):
        """``local`` as DCP takes it: a ``DTensor`` over the mesh for a
        block (on the mesh's device type), else the tensor."""
        if not self.sharded(key, local.shape):
            return local
        from torch.distributed.tensor import DTensor

        shape = self.shapes[self.name_of(key)]
        if local.device.type != self.mesh.device_type:
            local = local.to(self.mesh.device_type)
        stride, acc = [], 1
        for d in reversed(shape):
            stride.append(acc)
            acc *= d
        return DTensor.from_local(
            local.contiguous(), self.mesh,
            self.placements[self.name_of(key)], run_check=False,
            shape=torch.Size(shape), stride=tuple(reversed(stride)))


def _first_rank():
    from .parallel import collectives

    return collectives.rank() == 0


def _barrier(layout):
    if layout is not None:
        from .parallel import collectives

        collectives.barrier()


def save_state_tree(directory, step, state, layout=None):
    """Write ``state`` (``{section: {name: host tensor(s)}}``) as the
    step's DCP directory: into a temporary sibling, renamed to
    ``directory/step`` when complete (an older directory of that step is
    replaced).  Returns the path; the caller commits it.  Without a
    ``layout`` safe to call from a background writer thread; with one
    (a mesh module's, :class:`Layout`) a collective over the process
    group: every rank writes its blocks, DCP writes a replicated tensor
    once, and the first rank renames the directory after every rank's
    payload is in (DCP's finish gathers them)."""
    dcp = _dcp()
    root = os.path.abspath(directory)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, str(step))
    tmp = path + TMP_SUFFIX
    first = layout is None or _first_rank()
    if first:
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier(layout)
    flat = _flatten(state)
    if layout is not None:
        flat = {k: layout.wrap(k, t) for k, t in flat.items()}
    # host tensors, written without DCP's copy-ahead stream: a writer
    # thread must make no CUDA call while the loop thread captures
    dcp.save(flat, no_dist=layout is None,
             storage_writer=dcp.FileSystemWriter(
                 tmp, per_thread_copy_ahead=0))
    if first:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    return path


def commit_step(path, layout=None):
    """Drop the commit marker into a finished step directory: the LAST
    write of a checkpoint (under a ``layout`` by the first rank, the
    others waiting for it)."""
    if layout is None or _first_rank():
        with open(os.path.join(path, COMMIT_MARKER), "w") as f:
            f.write("committed\n")
    _barrier(layout)
    return path


def is_committed(directory, step):
    """Whether ``directory/step`` is a committed checkpoint: the marker
    file is the only accepted evidence (a renamed directory that never
    got its marker is the debris of a crash)."""
    path = os.path.join(os.path.abspath(directory), str(step))
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, COMMIT_MARKER))


def layout_of(module):
    """The module's :class:`Layout` on a mesh of processes, else None."""
    return Layout(module) if _mesh_of(module) is not None else None


def save_sharded(directory, step, module):
    """Write the module's store (parameters, aux states, the optimizer
    slots) at ``directory/step`` and commit it (on a mesh, a collective:
    every rank calls it).  The copies to the host wait for the card."""
    if not (module.binded and module.params_initialized):
        raise MXNetError("bind and initialize the module first")
    host = _map_state(lambda key, t: t.detach().cpu(), _state_of(module))
    layout = layout_of(module)
    return commit_step(save_state_tree(directory, step, host, layout),
                       layout)


def _disk_tree(path):
    """The saved checkpoint's ``{key: TensorStorageMetadata}`` (shape in
    ``.size``, dtype in ``.properties.dtype``), read from its
    ``.metadata`` without loading the payload."""
    from torch.distributed.checkpoint import FileSystemReader

    return FileSystemReader(path).read_metadata().state_dict_metadata


def load_sharded(directory, step, module):
    """Restore the module's store from ``directory/step``, in place.

    Structure differences are tolerated as in the JAX package: a
    section on disk the module does not carry (slots into an inference
    module) is not read; a section the module carries and the disk does
    not keeps the module's state, except a training module's slots: a
    checkpoint without them gives the restored parameters FRESH (zeroed)
    slots, not the moments of the weights they replaced.  A name missing
    inside a section both have, or a shape that differs, raises.  On a
    mesh (a collective: every rank calls it) each rank reads the blocks
    it holds, whatever layout wrote them."""
    if not (module.binded and module.params_initialized):
        raise MXNetError("bind and initialize the module first")
    if step is None:
        raise MXNetError("no checkpoint step to load from %s (is the "
                         "directory empty?)" % directory)
    path = os.path.join(os.path.abspath(directory), str(step))
    if not os.path.isdir(path):
        raise MXNetError("no sharded checkpoint at %s" % path)
    live = _state_of(module)
    layout = layout_of(module)
    disk = _disk_tree(path)
    disk_sections = {k.split(_SEP, 1)[0] for k in disk}
    targets, dests = {}, {}
    for key, dst in _flatten(live).items():
        section = key.split(_SEP, 1)[0]
        if section not in disk_sections:
            continue
        md = disk.get(key)
        if md is None:
            raise MXNetError("checkpoint %s has no %s" % (path, key))
        shape = tuple(dst.shape) if layout is None \
            else layout.global_shape(key, dst.shape)
        if tuple(md.size) != shape:
            raise MXNetError("checkpoint %s: %s has shape %s, the module "
                             "%s" % (path, key, tuple(md.size), shape))
        target = torch.empty(tuple(dst.shape), dtype=md.properties.dtype)
        targets[key] = target if layout is None \
            else layout.wrap(key, target)
        dests[key] = dst
    for section in live:
        if section not in disk_sections:
            log.info("checkpoint %s has no %r section; leaving the "
                     "module's live state", path, section)
    _dcp().load(targets, checkpoint_id=path, no_dist=layout is None)
    with torch.no_grad():
        for key, src in targets.items():
            dests[key].copy_(src.to_local() if hasattr(src, "to_local")
                             else src)
    step_obj = getattr(module, "_train_step", None)
    fresh = "slots" in live and "slots" not in disk_sections
    if step_obj is not None:
        # the masters changed under the step: recast its compute copy
        step_obj.load_from_executor()
        if fresh:
            step_obj.reset_slots()
    elif fresh and getattr(module, "_update_on_kvstore", False):
        # the store's updater makes its states anew at the next push
        module._kvstore._updater.states.clear()
    elif fresh:
        # a mesh module's states are views of its B1 slabs: zeroed in
        # place
        with torch.no_grad():
            for tensors in live["slots"].values():
                for t in tensors:
                    t.zero_()
    return module


def latest_step(directory):
    """Highest COMMITTED step number under ``directory``, or None.  Torn
    directories (a crash mid-save, a write in flight, a temporary
    sibling) are skipped."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory)
             if d.isdigit() and is_committed(directory, d)]
    return max(steps) if steps else None

"""Step-directory checkpoints of a module's training store (the
counterpart of ``mxnet_tpu/checkpoint.py``).

The JAX package writes orbax directories, each host its own shards.
The port runs one process on one device and writes
``torch.distributed.checkpoint`` (DCP) directories without a process
group: a ``.metadata`` file and one ``__0_0.distcp`` payload per step.
The files are not the JAX package's: a checkpoint crosses packages
through ``.params`` (``Module.save_checkpoint``), not through these.

    from mxnet_tpu_torch import checkpoint
    checkpoint.save_sharded(directory, step, module)
    checkpoint.load_sharded(directory, step, module)

The state is the module's live store: its parameters and aux states
(the executor's arrays) and, with a compiled train step, the optimizer
slots, keyed ``params/<name>``, ``aux/<name>`` and
``slots/<name>/<i>``.

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

__all__ = ["save_sharded", "load_sharded", "latest_step", "save_state_tree",
           "commit_step", "is_committed", "COMMIT_MARKER"]

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


def _state_of(module):
    """The module's live store, ``{section: {name: tensor(s)}}``: the
    executor's parameter and aux tensors and, with a compiled train step
    that has them, its optimizer slots.  The tensors themselves, not
    copies: restores write into them.  Needs a bound ``Module``."""
    group = module._exec_group
    exe = group.exec_
    state = {"params": {n: exe.arg_dict[n].data for n in group.param_names},
             "aux": {n: exe.aux_dict[n].data for n in group.aux_names}}
    step = getattr(module, "_train_step", None)
    if step is not None:
        slots = {n: list(s) for n, s in step.slots.items() if len(s)}
        if slots:
            state["slots"] = slots
    return state


def save_state_tree(directory, step, state):
    """Write ``state`` (``{section: {name: host tensor(s)}}``) as the
    step's DCP directory: into a temporary sibling, renamed to
    ``directory/step`` when complete (an older directory of that step is
    replaced).  Returns the path; the caller commits it.  Safe to call
    from a background writer thread."""
    dcp = _dcp()
    root = os.path.abspath(directory)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, str(step))
    tmp = path + TMP_SUFFIX
    shutil.rmtree(tmp, ignore_errors=True)
    # host tensors, written without DCP's copy-ahead stream: a writer
    # thread must make no CUDA call while the loop thread captures
    dcp.save(_flatten(state), no_dist=True,
             storage_writer=dcp.FileSystemWriter(
                 tmp, per_thread_copy_ahead=0))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def commit_step(path):
    """Drop the commit marker into a finished step directory: the LAST
    write of a checkpoint."""
    with open(os.path.join(path, COMMIT_MARKER), "w") as f:
        f.write("committed\n")
    return path


def is_committed(directory, step):
    """Whether ``directory/step`` is a committed checkpoint: the marker
    file is the only accepted evidence (a renamed directory that never
    got its marker is the debris of a crash)."""
    path = os.path.join(os.path.abspath(directory), str(step))
    return os.path.isdir(path) and \
        os.path.exists(os.path.join(path, COMMIT_MARKER))


def save_sharded(directory, step, module):
    """Write the module's store (parameters, aux states, the train
    step's optimizer slots) at ``directory/step`` and commit it.  The
    copies to the host wait for the card."""
    if not (module.binded and module.params_initialized):
        raise MXNetError("bind and initialize the module first")
    host = _map_state(lambda key, t: t.detach().cpu(), _state_of(module))
    return commit_step(save_state_tree(directory, step, host))


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
    inside a section both have, or a shape that differs, raises."""
    if not (module.binded and module.params_initialized):
        raise MXNetError("bind and initialize the module first")
    if step is None:
        raise MXNetError("no checkpoint step to load from %s (is the "
                         "directory empty?)" % directory)
    path = os.path.join(os.path.abspath(directory), str(step))
    if not os.path.isdir(path):
        raise MXNetError("no sharded checkpoint at %s" % path)
    live = _state_of(module)
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
        if tuple(md.size) != tuple(dst.shape):
            raise MXNetError("checkpoint %s: %s has shape %s, the module "
                             "%s" % (path, key, tuple(md.size),
                                     tuple(dst.shape)))
        targets[key] = torch.empty(tuple(md.size), dtype=md.properties.dtype)
        dests[key] = dst
    for section in live:
        if section not in disk_sections:
            log.info("checkpoint %s has no %r section; leaving the "
                     "module's live state", path, section)
    _dcp().load(targets, checkpoint_id=path, no_dist=True)
    with torch.no_grad():
        for key, src in targets.items():
            dests[key].copy_(src)
    step_obj = getattr(module, "_train_step", None)
    if step_obj is not None:
        # the masters changed under the step: recast its compute copy
        step_obj.load_from_executor()
        if "slots" in live and "slots" not in disk_sections:
            step_obj.reset_slots()
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

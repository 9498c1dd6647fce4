"""Multi-process launcher (the counterpart of
``mxnet_tpu/parallel/launch.py``) on ``torch.distributed``.

Every process is a worker; :func:`init` forms the process group.  The
reference's environment contract carries over unchanged:
``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` (default 9091) give the
coordinator's address, ``DMLC_NUM_WORKER`` the world size and
``DMLC_WORKER_ID`` (or ``DMLC_RANK``) the rank.  Without them,
torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
take the place of the reference's pod-metadata path; failing those the
process stays a single process with no group, as the reference's does.

The backend follows the device: NCCL for a rank that owns a card (rank
``r`` takes card ``LOCAL_RANK``, else ``r`` modulo the cards), gloo on
the CPU.  Ranks that share one card pass ``backend="gloo"`` (NCCL takes
one card a rank); gloo's ``all_reduce`` and ``broadcast`` take CUDA
tensors.  A backend that cannot start raises: there is no fallback.

An elastic mesh re-forms its group without the old one
(:func:`abandon`, then :func:`reform`): a dead rank can never take part
in another collective, so the survivors neither make a subgroup of the
old group nor destroy it collectively.  Each destroys its own handles
(``destroy_process_group`` returns at once when a peer is gone, and
dropping the last reference closes this rank's connections, which fails
the collectives its live peers are blocked in: the error reaches every
survivor in about a collective's latency), then joins a new rendezvous
generation: a ``FileStore`` keyed by the generation and the member set
in a directory every rank sees (the heartbeat directory).  Each
generation's members and mesh are recorded there first
(:func:`write_record`).  A process started in a dead worker's place
comes in by :func:`rejoin` (or :func:`init` from the environment with
``MXNET_IS_RECOVERY=1`` and ``MXNET_HEARTBEAT_DIR``): it stamps the
worker's heartbeat, waits for the survivors' next generation that
names its rank and forms it.
"""
from __future__ import annotations

import datetime
import os

import torch

from ..base import MXNetError

__all__ = ["init", "shutdown", "backend_for", "abandon", "reform",
           "rejoin", "rejoined", "write_record", "read_record",
           "DEFAULT_TIMEOUT"]

DEFAULT_TIMEOUT = 300.0     # seconds a collective waits for a dead peer

_initialized = False
# the backend and timeout of the group this process formed: a re-formed
# group takes the same
_formed = {"backend": None, "timeout": DEFAULT_TIMEOUT}
# the generation a replacement process joined (rejoin), until the elastic
# controller takes it
_rejoin = {"record": None}


def _env_contract():
    """``(address, world, rank)`` from the DMLC_* variables, else from
    torchrun's, else None."""
    env = os.environ
    if "DMLC_PS_ROOT_URI" in env:
        return ("%s:%s" % (env["DMLC_PS_ROOT_URI"],
                           env.get("DMLC_PS_ROOT_PORT", "9091")),
                int(env.get("DMLC_NUM_WORKER", "1")),
                int(env.get("DMLC_WORKER_ID", env.get("DMLC_RANK", "0"))))
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env and "RANK" in env:
        return ("%s:%s" % (env["MASTER_ADDR"],
                           env.get("MASTER_PORT", "29500")),
                int(env["WORLD_SIZE"]), int(env["RANK"]))
    return None


def backend_for(backend=None):
    """The backend a rank of this process takes: ``backend`` when given,
    else NCCL where there is a card and gloo where there is none."""
    if backend is not None:
        return backend
    return "nccl" if torch.cuda.is_available() else "gloo"


def init(coordinator_address=None, num_processes=None, process_id=None,
         backend=None, timeout=DEFAULT_TIMEOUT):
    """Form the process group (idempotent once a group has formed).
    ``coordinator_address`` is ``host:port``; with none given the
    environment decides (see the module's docstring), and without one
    the process stays single: a later call with arguments still forms
    its group."""
    global _initialized
    import torch.distributed as dist

    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return
    if coordinator_address is None:
        contract = _env_contract()
        if contract is None:
            return                      # a single process, no group
        coordinator_address, num_processes, process_id = contract
        from .health import is_recovery

        hb = os.environ.get("MXNET_HEARTBEAT_DIR")
        if hb and is_recovery():
            # a replacement: the coordinator's group is gone
            rejoin(hb, process_id, num_processes, backend=backend,
                   timeout=timeout)
            return
    world = int(num_processes if num_processes is not None else 1)
    rank = int(process_id if process_id is not None else 0)
    backend = backend_for(backend)
    if not dist.is_available():
        raise MXNetError("torch.distributed is not available in this "
                         "build of PyTorch")
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise MXNetError("the NCCL backend needs a CUDA card and an "
                             "NCCL build of PyTorch; pass backend='gloo' "
                             "to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    _import_dynamo_first()
    try:
        dist.init_process_group(
            backend, init_method="tcp://" + coordinator_address,
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
    except Exception as exc:
        raise MXNetError("process group (%s, rank %d of %d at %s) did not "
                         "start: %s" % (backend, rank, world,
                                        coordinator_address, exc)) from exc
    _formed.update(backend=backend, timeout=float(timeout))
    _initialized = True


def _import_dynamo_first():
    """Import ``torch._dynamo`` before a group forms: its import keeps a
    reference to the default group it finds (the port's tracing imports
    it later), which would keep an abandoned group's connections open and
    its live peers blocked until the group's timeout."""
    import torch._dynamo  # noqa: F401


def shutdown():
    """Destroy the process group (a rank whose peer died leaves with
    ``os._exit`` instead: destroying would wait on the dead rank)."""
    global _initialized
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def abandon():
    """Drop this process's process groups without a collective: every
    group destroyed locally (it returns at once when a peer is gone) and
    the handles collected, so this rank's connections close.  The caller
    holds no group (no module, mesh or autograd graph that keeps one).
    Returns the seconds it took."""
    import gc
    import time

    import torch.distributed as dist

    from . import collectives

    global _initialized
    t0 = time.perf_counter()
    collectives._PENDING.clear()
    if dist.is_available() and dist.is_initialized():
        if _formed["backend"] is None:
            _formed["backend"] = dist.get_backend()
        dist.destroy_process_group()
    gc.collect()
    _initialized = False
    return time.perf_counter() - t0


def reform(directory, generation, members, rank, backend=None,
           timeout=None):
    """Form the process group of rendezvous ``generation`` over
    ``members`` (the member list every joiner computes alike; this
    process is ``members[rank]``) through a ``FileStore`` under
    ``directory``.  A group of one forms nothing (the process goes on
    alone).  Returns the world size."""
    import torch.distributed as dist

    global _initialized
    world = len(members)
    if dist.is_available() and dist.is_initialized():
        raise MXNetError("reform needs the old group abandoned first "
                         "(parallel.launch.abandon)")
    if world <= 1:
        return world
    backend = backend or _formed["backend"] or backend_for()
    timeout = float(timeout or _formed["timeout"])
    _import_dynamo_first()
    root = os.path.join(directory, "rendezvous")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "gen-%d-%s" % (
        int(generation), "_".join(str(m) for m in members)))
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(path, world), world_size=world,
            rank=int(rank), timeout=datetime.timedelta(seconds=timeout))
    except Exception as exc:
        raise MXNetError("rendezvous generation %d (%s, rank %d of %d at "
                         "%s) did not form: %s" % (generation, backend,
                                                   rank, world, path, exc)) \
            from exc
    _formed.update(backend=backend, timeout=timeout)
    _initialized = True
    return world


def _rendezvous_dir(directory):
    path = os.path.join(directory, "rendezvous")
    os.makedirs(path, exist_ok=True)
    return path


def write_record(directory, kind, generation, **body):
    """Write ``<directory>/rendezvous/<kind>-<generation>.json`` (a
    generation's ``gen`` record: members and mesh; the survivors'
    ``done``) atomically."""
    import json

    path = os.path.join(_rendezvous_dir(directory),
                        "%s-%d.json" % (kind, generation))
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(dict(body, generation=generation), f)
    os.replace(tmp, path)


def read_record(directory, kind, generation):
    """The record :func:`write_record` wrote, or None."""
    import json

    path = os.path.join(_rendezvous_dir(directory),
                        "%s-%d.json" % (kind, generation))
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def rejoin(directory, rank, world, num_workers=None, backend=None,
           timeout=None):
    """Come back into an elastic mesh as ``rank`` of the ``world`` ranks
    it started with (a process started in a dead worker's place): note
    the newest generation, stamp the worker's heartbeat (its first rank;
    ``num_workers`` workers of whole data rows, default one a rank),
    wait for a newer generation whose members name ``rank`` and form it
    (within the group's timeout).  Returns the record; the elastic
    controller of the next ``fit`` takes it (:func:`rejoined`) and
    restores the fence the survivors restore."""
    import time

    from .health import ensure_heartbeat

    rank, world = int(rank), int(world)
    per = world // int(num_workers or world)
    root = _rendezvous_dir(directory)
    gens = [int(n[4:-5]) for n in os.listdir(root)
            if n.startswith("gen-") and n.endswith(".json")]
    gen = max(gens) if gens else 0
    if rank % per == 0:
        ensure_heartbeat(directory, rank // per)
    limit = float(timeout or _formed["timeout"])
    deadline = time.perf_counter() + limit
    while True:
        rec = read_record(directory, "gen", gen + 1)
        if rec is not None:
            gen += 1
            if rank in rec["members"]:
                break
            continue
        if time.perf_counter() > deadline:
            raise MXNetError("rank %d found no generation of the mesh in %s "
                             "taking it back within %.0f s"
                             % (rank, directory, limit))
        time.sleep(0.05)
    reform(directory, gen, rec["members"], rec["members"].index(rank),
           backend=backend, timeout=timeout)
    _rejoin["record"] = dict(rec, generation=gen, world=world, rank=rank)
    return _rejoin["record"]


def rejoined(take=False):
    """The generation record of this process's :func:`rejoin` (None when
    it did not rejoin, or after it was taken with ``take``)."""
    rec = _rejoin["record"]
    if take:
        _rejoin["record"] = None
    return rec

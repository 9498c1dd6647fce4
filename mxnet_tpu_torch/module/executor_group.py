"""DataParallelExecutorGroup on one device (the counterpart of
``mxnet_tpu/module/executor_group.py``): binds the executor, loads
batches into it and runs forward / backward (with head gradients,
``backward(out_grads)``).  A group bound with a ``shared_group`` takes
that group's parameter, gradient and aux arrays by identity wherever
name and shape match (bucketing); ``reshape`` rebinds for new input
shapes that way against itself.  With ``inputs_need_grad`` the data
inputs get gradients too (``get_input_grads``).  ``install_monitor``
hooks a :class:`~mxnet_tpu_torch.monitor.Monitor` to the executor.

Several contexts bind ONE executor over the whole batch when they name
one device (every ``cpu(i)``, or ``gpu(0)`` twice): the reference's own
fallback for contexts that share hardware.  The batch must still divide
by the number of contexts, as the reference requires.  Contexts that
name distinct cards are refused (:func:`one_device`): the port's data
parallelism is one process a card under ``parallel.launch`` with a
``dist_sync`` store, where the reference shards in-process over a mesh.
So ``merge_multi_context`` has one device's arrays to return either
way.

With a ``mesh`` (:class:`MeshRuntime`, from a Module's ``mesh_config``)
the group is one rank of a (data x model x seq x expert) mesh of
processes (an expert axis holds this rank's block of each MoE expert
stack; see :class:`MeshRuntime`):
every rank is fed the same global batch and binds its data-axis rows
and, for every input whose ``DataDesc.layout`` holds ``N`` and ``T``, its
seq-axis block of the sequence (the reference's input shardings); the
executor walks the graph tensor- and sequence-parallel
(:class:`~mxnet_tpu_torch.parallel.tp_exec.TensorParallel`) over this
rank's parameter shards; ``set_params`` slices the full arrays and
``get_params`` gathers them; ``backward`` sums the parameter gradients
over the data x seq ranks that share this rank's model coordinate (one
all-reduce of the packed gradients), so they arrive at ``update()``
globally summed, as the reference's do; and ``get_outputs`` (and
``get_input_grads``) gather over the seq group along T, then over the
data group along the rows: the reference's row order."""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..base import MXNetError
from ..executor import simple_bind
from ..io import as_desc_list
from ..parallel import collectives
from ..parallel.tp_exec import TensorParallel, gather_seq, slice_seq, SeqSplit


class MeshRuntime:
    """A ``MeshConfig`` (or a ``DeviceMesh`` from ``parallel.build_mesh``)
    resolved against the process group (one rank a process, where the
    reference resolves it against its contexts): the axis sizes, the
    ``DeviceMesh``, this rank's model, data and seq groups, and the
    group its parameter gradients are summed over (data x seq).  A
    config that does not cover the group raises.  Axes named in
    ``replicate`` are realized as replicas (their ranks compute the same
    values: a ``DecodePredictor`` leaves ``seq`` and ``pipe`` so, as the
    reference's specs do); a ``pipe`` axis above 1 raises (a
    ``PipelineModule`` runs one).  An ``expert`` axis shards the MoE
    expert stacks and splits the MoEFFN tokens over its group
    (``ops.moe``'s sharded path); every other value is computed alike on
    its ranks, so no gradient sum spans it (the router's is summed inside
    the op).  It does not combine with a ``seq`` axis."""

    def __init__(self, mesh_config, replicate=()):
        from ..parallel.mesh import MeshConfig
        from ..programs.partition import mesh_sizes

        world = collectives.world_size()
        if isinstance(mesh_config, MeshConfig):
            try:
                sizes = mesh_config.resolve(world)
            except AssertionError as exc:
                raise MXNetError(
                    "mesh_config %s does not cover the %d rank(s) of the "
                    "process group (%s): start one process a rank under "
                    "parallel.launch.init()" % (mesh_config, world, exc)) \
                    from exc
            self.sizes = dict(zip(mesh_config.names,
                                  (int(s) for s in sizes)))
            device_mesh = None
        else:
            device_mesh = mesh_config
            self.sizes = mesh_sizes(device_mesh)
            n = int(np.prod(list(self.sizes.values())))
            if n != world:
                raise MXNetError(
                    "the device mesh %s covers %d rank(s), the process "
                    "group has %d" % (self.sizes, n, world))
        if self.sizes.get("pipe", 1) > 1 and "pipe" not in replicate:
            raise MXNetError(
                "a 'pipe' mesh axis of %d is not realized here "
                "(mxnet_tpu_torch.mod.PipelineModule, which runs the stages "
                "of a pipe axis); the port shards the 'data', 'model', "
                "'seq' and 'expert' axes" % self.sizes["pipe"])
        self.config = mesh_config
        self.data = self.sizes.get("data", 1)
        self.model = self.sizes.get("model", 1)
        self.seq = 1 if "seq" in replicate else self.sizes.get("seq", 1)
        self.expert = self.sizes.get("expert", 1)
        if self.expert > 1 and self.seq > 1:
            raise MXNetError(
                "an 'expert' axis of %d with a 'seq' axis of %d is not "
                "realized: the MoE tokens split over data x expert, the seq "
                "axis splits the sequence" % (self.expert, self.seq))
        self.mesh = None
        self.model_group = self.data_group = self.seq_group = None
        self.expert_group = self.grad_group = None
        self.model_rank = self.data_rank = self.seq_rank = 0
        self.expert_rank = 0
        if world > 1:
            from ..parallel.mesh import build_mesh

            self.mesh = device_mesh if device_mesh is not None \
                else build_mesh(mesh_config)
            names = self.mesh.mesh_dim_names
            if "model" in names:
                self.model_group = self.mesh.get_group("model")
                self.model_rank = self.mesh.get_local_rank("model")
            if "data" in names:
                self.data_group = self.mesh.get_group("data")
                self.data_rank = self.mesh.get_local_rank("data")
            if self.seq > 1:
                self.seq_group = self.mesh.get_group("seq")
                self.seq_rank = self.mesh.get_local_rank("seq")
            if self.expert > 1:
                self.expert_group = self.mesh.get_group("expert")
                self.expert_rank = self.mesh.get_local_rank("expert")
            self.grad_group = self._grad_group()

    def _grad_group(self):
        """This rank's group of the ranks that share its coordinates but
        on the data and seq axes (None when both are 1): one
        ``new_group`` a coordinate, every rank creating all of them in
        one order, as ``torch.distributed`` requires."""
        import torch.distributed as dist

        if self.seq <= 1:
            return self.data_group if self.data > 1 else None
        if self.data <= 1:
            return self.seq_group
        names = list(self.mesh.mesh_dim_names)
        ranks = self.mesh.mesh
        ranks = ranks.movedim((names.index("data"), names.index("seq")),
                              (-2, -1)).reshape(-1, self.data * self.seq)
        me, mine = collectives.rank(), None
        for row in ranks.tolist():
            group = dist.new_group(row)
            if me in row:
                mine = group
        return mine

    @property
    def ranks(self):
        return self.data * self.model * self.seq * self.expert

    def tensor_parallel(self, symbol, shapes, seq_inputs=None):
        shape = {"data": self.data, "model": self.model}
        shape.update({a: getattr(self, a) for a in ("seq", "expert")
                      if getattr(self, a) > 1})
        return TensorParallel(
            symbol, shapes, self.model, self.model_rank, self.model_group,
            data=self.data, data_group=self.data_group,
            mode=config.get("MXNET_TP_MODE"), mesh_shape=shape,
            seq=self.seq, seq_rank=self.seq_rank, seq_group=self.seq_group,
            grad_group=self.grad_group, seq_inputs=seq_inputs,
            expert=self.expert, expert_rank=self.expert_rank,
            expert_group=self.expert_group, data_rank=self.data_rank)

    def data_rows(self, n):
        """This rank's rows of a batch of ``n`` split over the data group
        (a slice), or None when the data axis is 1."""
        if self.data <= 1:
            return None
        if n % self.data:
            raise MXNetError("a batch of %d rows does not split over a "
                             "data axis of %d" % (n, self.data))
        k = n // self.data
        return slice(self.data_rank * k, (self.data_rank + 1) * k)


def one_device(contexts):
    """The one torch device that ``contexts`` (a list of Contexts) name,
    or MXNetError for contexts on distinct devices."""
    devices = {c.torch_device for c in contexts}
    if len(devices) != 1:
        raise MXNetError(
            "contexts %s name %d distinct devices; a Module binds one "
            "device.  Data parallelism across cards is one process a card: "
            "start each under mxnet_tpu_torch.parallel.launch.init() and "
            "train with kvstore='dist_sync'" % (list(contexts), len(devices)))
    return devices.pop()


class _Shared:
    """A shared group's face: its executor."""

    def __init__(self, exec_):
        self.exec_ = exec_


class DataParallelExecutorGroup:
    def __init__(self, symbol, device, data_shapes, label_shapes,
                 param_names, for_training, fixed_param_names=None,
                 grad_req="write", plain=False, shared_group=None,
                 inputs_need_grad=False, num_contexts=1, mesh=None):
        self._bind_args = dict(device=device, grad_req=grad_req,
                               plain=plain,
                               fixed_param_names=fixed_param_names,
                               inputs_need_grad=inputs_need_grad,
                               num_contexts=num_contexts, mesh=mesh)
        self.mesh = mesh
        self.symbol = symbol
        self.param_names = list(param_names)
        self.for_training = for_training
        self.fixed_param_names = set(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.data_shapes = as_desc_list(data_shapes)
        self.label_shapes = as_desc_list(label_shapes)
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[0]
        degree = mesh.data if mesh is not None else num_contexts
        if self.batch_size % max(1, degree) != 0:
            raise MXNetError("batch size %d must be divisible by the data-"
                             "parallel degree %d" % (self.batch_size,
                                                     degree))

        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                req = grad_req if isinstance(grad_req, str) \
                    else grad_req.get(name, "write")
                if not for_training or name in self.fixed_param_names:
                    req = "null"
            elif inputs_need_grad and name in self.data_names:
                req = "write"
            else:
                req = "null"
            self.grad_req[name] = req

        shapes = {d.name: d.shape for d in self.data_shapes
                  + self.label_shapes}
        types = {d.name: d.dtype for d in self.data_shapes
                 + self.label_shapes}
        self.tp = None
        self._outputs = None
        self._input_grads = None
        # {input name: T dim} of the inputs split over the seq group: a
        # layout with N and T, T dividing the axis (else the input stays
        # whole, every seq rank computing the same)
        self._seq_inputs = {}
        if mesh is not None:
            if mesh.seq > 1:
                for d in self.data_shapes + self.label_shapes:
                    layout = getattr(d, "layout", None) or ""
                    if "N" in layout and "T" in layout \
                            and d.shape[layout.index("T")] % mesh.seq == 0:
                        self._seq_inputs[d.name] = layout.index("T")
            # this rank's slice of the batch; the parameters' GLOBAL
            # shapes for the plan (set_params / get_params use them); the
            # executor binds the seq inputs' blocks (tp.local_shape)
            self._slice = self.batch_size // mesh.data
            shapes = {n: (self._slice,) + tuple(s[1:])
                      for n, s in shapes.items()}
            arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
            self.global_shapes = {
                n: tuple(s) for n, s in zip(self.arg_names, arg_shapes)
                if n in set(self.param_names)}
            self.global_shapes.update(
                (n, tuple(s)) for n, s in zip(self.aux_names, aux_shapes))
            # the expert stacks (OpDef.mesh_axes) shard on the expert axis
            self.tp = mesh.tensor_parallel(symbol, self.global_shapes,
                                           self._seq_inputs)
        self.exec_ = simple_bind(
            symbol, device, grad_req=self.grad_req, type_dict=types,
            plain=plain, shared_exec=(shared_group.exec_ if shared_group
                                      is not None else None), tp=self.tp,
            **shapes)
        exe = self.exec_
        self.param_arrays = [exe.arg_dict[n] for n in self.param_names]
        self.grad_arrays = [exe.grad_dict.get(n) for n in self.param_names]

    def reshape(self, data_shapes, label_shapes):
        """Rebind for new input shapes against the current executor: every
        array whose name and shape are unchanged (the parameters) is
        shared by identity, the rest are allocated."""
        if as_desc_list(data_shapes) == self.data_shapes and \
                as_desc_list(label_shapes) == self.label_shapes:
            return
        args = dict(self._bind_args)
        self.__init__(self.symbol, args.pop("device"), data_shapes,
                      label_shapes, self.param_names, self.for_training,
                      shared_group=_Shared(self.exec_), **args)

    def _full(self, arr):
        from ..ndarray import NDArray

        if isinstance(arr, NDArray):
            return arr.data
        return torch.as_tensor(arr)

    def set_params(self, arg_params, aux_params):
        """Copy the (full) parameters into the executor: under a mesh,
        this rank's block of each sharded one."""
        for table, params in ((self.exec_.arg_dict, arg_params),
                              (self.exec_.aux_dict, aux_params or {})):
            for name, arr in params.items():
                if name not in table:
                    continue
                if self.tp is not None:
                    arr = self.tp.shard(name, self._full(arr))
                table[name][:] = arr

    def get_params(self, arg_params, aux_params):
        """Copy the executor's parameters into the host arrays: under a
        mesh, gathered over the model group (every rank calls it)."""
        for table, names, out in ((self.exec_.arg_dict, self.param_names,
                                   arg_params),
                                  (self.exec_.aux_dict, self.aux_names,
                                   aux_params)):
            for name in names:
                value = table[name].data
                if self.tp is not None:
                    value = self.tp.unshard(name, value)
                out[name][:] = value

    def load_data_batch(self, data_batch):
        """Copy the batch's arrays into the bound inputs (onto the device,
        in their dtype)."""
        if len(data_batch.data) != len(self.data_names):
            raise MXNetError("batch has %d data arrays, the module binds %s"
                             % (len(data_batch.data), self.data_names))
        for name, arr in zip(self.data_names, data_batch.data):
            self.exec_.arg_dict[name][:] = self._my_cols(
                name, self._my_rows(arr))
        if self.label_names and data_batch.label:
            for name, arr in zip(self.label_names, data_batch.label):
                if name in self.exec_.arg_dict:
                    self.exec_.arg_dict[name][:] = self._my_cols(
                        name, self._my_rows(arr))
        self._outputs = self._input_grads = None

    def _my_rows(self, arr):
        """Under a mesh, this rank's data-axis slice of a global batch
        array (its leading dim in data blocks: a batch's rows, or an
        output's (B, T) rows); else the array."""
        if self.mesh is None or self.mesh.data == 1:
            return arr
        full = self._full(arr)
        k = full.shape[0] // self.mesh.data
        return full[self.mesh.data_rank * k:(self.mesh.data_rank + 1) * k]

    def _my_cols(self, name, arr):
        """This rank's seq-axis block of input ``name`` along its T dim,
        when the input is split over the seq group; else ``arr``."""
        tdim = self._seq_inputs.get(name)
        if tdim is None:
            return arr
        full = self._full(arr)
        return slice_seq(full, SeqSplit(tdim, full.shape[tdim]
                                        // self.mesh.seq),
                         self.mesh.seq, self.mesh.seq_rank)

    def _whole(self, value, st):
        """A value of this rank (split over the seq group as ``st``, None:
        whole) gathered over seq along T, then over data along its rows:
        the reference's row order."""
        if st is not None:
            value = gather_seq(value, st, self.mesh.seq_group)
        if self.mesh.data > 1:
            value = collectives.all_gather(value, 0, self.mesh.data_group)
        return value

    def forward(self, data_batch, is_train=None):
        self.load_data_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        self.exec_.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        mesh = self.mesh
        if out_grads is not None and mesh is not None \
                and mesh.data * mesh.seq > 1:
            out_grads = [self._my_out(g, st) for g, st in zip(
                out_grads if isinstance(out_grads, (list, tuple))
                else [out_grads], self.tp.out_seq)]
        self.exec_.backward(out_grads)
        self._input_grads = None
        if mesh is not None and mesh.data * mesh.seq > 1:
            self._sum_grads()

    def _my_out(self, grad, st):
        """This rank's block of a global head gradient of an output split
        as ``st`` (its data rows, then its seq block)."""
        grad = self._full(self._my_rows(grad))
        if st is None:
            return grad
        return slice_seq(grad, st, self.mesh.seq, self.mesh.seq_rank)

    def _sum_grads(self):
        """The parameter gradients summed over the data x seq ranks that
        share this rank's model coordinate: packed into one buffer, one
        all-reduce, unpacked in place."""
        grads = [g.data for g in self.grad_arrays if g is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        collectives.all_reduce(flat, self.mesh.grad_group)
        off = 0
        with torch.no_grad():
            for g in grads:
                n = g.numel()
                g.copy_(flat[off:off + n].view_as(g))
                off += n

    def get_outputs(self, merge_multi_context=True):
        """The outputs of the last forward; under a mesh with a data or
        seq axis above 1 every rank's blocks gathered in the reference's
        row order (once a forward)."""
        mesh = self.mesh
        if mesh is None or mesh.data * mesh.seq == 1:
            return list(self.exec_.outputs)
        if self._outputs is None:
            from ..ndarray import NDArray

            self._outputs = [NDArray(self._whole(o.data, st)) for o, st in
                             zip(self.exec_.outputs, self.tp.out_seq)]
        return list(self._outputs)

    def get_input_grads(self, merge_multi_context=True):
        """The data inputs' gradients; under a mesh every rank's blocks
        gathered as the outputs are."""
        mesh = self.mesh
        grads = [self.exec_.grad_dict[n] for n in self.data_names]
        if mesh is None or mesh.data * mesh.seq == 1:
            return grads
        if self._input_grads is None:
            from ..ndarray import NDArray

            self._input_grads = []
            for n, g in zip(self.data_names, grads):
                tdim = self._seq_inputs.get(n)
                st = None if tdim is None else SeqSplit(
                    tdim, g.data.shape[tdim])
                self._input_grads.append(NDArray(self._whole(g.data, st)))
        return list(self._input_grads)

    def install_monitor(self, mon):
        mon.install(self.exec_)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

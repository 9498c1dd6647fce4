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
way."""
from __future__ import annotations

from ..base import MXNetError
from ..executor import simple_bind
from ..io import as_desc_list


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
                 inputs_need_grad=False, num_contexts=1):
        self._bind_args = dict(device=device, grad_req=grad_req,
                               plain=plain,
                               fixed_param_names=fixed_param_names,
                               inputs_need_grad=inputs_need_grad,
                               num_contexts=num_contexts)
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
        if self.batch_size % max(1, num_contexts) != 0:
            raise MXNetError("batch size %d must be divisible by the data-"
                             "parallel degree %d" % (self.batch_size,
                                                     num_contexts))

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
        self.exec_ = simple_bind(
            symbol, device, grad_req=self.grad_req, type_dict=types,
            plain=plain, shared_exec=(shared_group.exec_ if shared_group
                                      is not None else None), **shapes)
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

    def set_params(self, arg_params, aux_params):
        for name, arr in arg_params.items():
            if name in self.exec_.arg_dict:
                self.exec_.arg_dict[name][:] = arr
        for name, arr in (aux_params or {}).items():
            if name in self.exec_.aux_dict:
                self.exec_.aux_dict[name][:] = arr

    def get_params(self, arg_params, aux_params):
        for name in self.param_names:
            arg_params[name][:] = self.exec_.arg_dict[name]
        for name in self.aux_names:
            aux_params[name][:] = self.exec_.aux_dict[name]

    def load_data_batch(self, data_batch):
        """Copy the batch's arrays into the bound inputs (onto the device,
        in their dtype)."""
        if len(data_batch.data) != len(self.data_names):
            raise MXNetError("batch has %d data arrays, the module binds %s"
                             % (len(data_batch.data), self.data_names))
        for name, arr in zip(self.data_names, data_batch.data):
            self.exec_.arg_dict[name][:] = arr
        if self.label_names and data_batch.label:
            for name, arr in zip(self.label_names, data_batch.label):
                if name in self.exec_.arg_dict:
                    self.exec_.arg_dict[name][:] = arr

    def forward(self, data_batch, is_train=None):
        self.load_data_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        self.exec_.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        self.exec_.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        return list(self.exec_.outputs)

    def get_input_grads(self, merge_multi_context=True):
        return [self.exec_.grad_dict[n] for n in self.data_names]

    def install_monitor(self, mon):
        mon.install(self.exec_)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.exec_.outputs)

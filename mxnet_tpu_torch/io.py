"""Data iterators: :class:`DataDesc`, :class:`DataBatch`, :class:`DataIter`
and :class:`NDArrayIter` (the counterparts of ``mxnet_tpu/io.py``'s
classes of the same names).  Batches are host NDArrays; ``Module`` copies
them onto its device."""
from __future__ import annotations

import numpy as np

from .ndarray import NDArray, array

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter"]


class DataDesc:
    """Named shape/dtype descriptor; unpacks like a (name, shape) pair."""

    def __init__(self, name, shape, dtype=np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __iter__(self):
        yield self.name
        yield self.shape

    def __getitem__(self, i):
        return (self.name, self.shape)[i]

    def __len__(self):
        return 2

    def __eq__(self, other):
        if isinstance(other, (tuple, list)):
            return (self.name, self.shape) == tuple(other)
        return (self.name, self.shape) == (other.name, other.shape)

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)


def as_desc_list(shapes):
    """DataDesc objects from descriptors or (name, shape) pairs."""
    return [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1])
            for s in shapes or []]


class DataBatch:
    """One mini-batch."""

    def __init__(self, data, label=None, pad=0, index=None, bucket_key=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()


def _init_data(data, allow_empty, default_name):
    """Normalize input data to a list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise ValueError("NDArrayIter: data is required")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and not data:
            raise ValueError("NDArrayIter: data is empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in batches; ``last_batch_handle`` is
    'pad' (wrap to the front and report the pad), 'discard' or
    'roll_over'."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size")
        if shuffle:
            idx = np.arange(self.num_data)
            np.random.shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" \
                and self.cursor > self.num_data:
            self.cursor = -self.batch_size \
                + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        if self.cursor + self.batch_size <= self.num_data:
            return [array(x[1][self.cursor:self.cursor + self.batch_size])
                    for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [array(np.concatenate((x[1][self.cursor:], x[1][:pad]),
                                     axis=0)) for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" \
                and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

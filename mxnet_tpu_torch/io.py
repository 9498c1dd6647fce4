"""Data iterators: :class:`DataDesc`, :class:`DataBatch`, :class:`DataIter`,
:class:`NDArrayIter`, :class:`MNISTIter`, :class:`CSVIter`,
:class:`ResizeIter`, :class:`PrefetchingIter`,
:class:`DevicePrefetchIter` and :func:`ImageRecordIter` (the counterparts
of ``mxnet_tpu/io.py``'s names).  Batches are host NDArrays; ``Module``
copies them onto its device, or :class:`DevicePrefetchIter` does ahead
of time.  :class:`PrefetchingIter` reads the next batches of its
iterators on a worker thread (``_BackgroundIter``: a bounded queue, a
stop flag the worker checks while it waits, the worker's exception
raised in the consumer); ``reset`` and ``close`` stop and join it."""
from __future__ import annotations

import gzip
import logging
import os
import queue as _queue
import struct
import threading
from collections import deque

import numpy as np
import torch

from . import config
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter", "MNISTIter",
           "CSVIter", "ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
           "ImageRecordIter"]


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
            return [array(x[1][self.cursor:self.cursor + self.batch_size],
                          ctx=cpu()) for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [array(np.concatenate((x[1][self.cursor:], x[1][:pad]),
                                     axis=0), ctx=cpu())
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" \
                and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class MNISTIter(NDArrayIter):
    """MNIST from its idx files (``image`` / ``label``, or ``.gz``), scaled
    to [0, 1]: (n, 1, 28, 28), flat (n, 784) with ``flat``, or
    ``input_shape``; ``num_parts`` / ``part_index`` take one contiguous
    part, ``shuffle`` permutes with ``RandomState(seed)``; the last
    partial batch is dropped.  Without the files it serves the JAX
    package's synthetic set of 6,000 class-conditional digits, the same
    arrays for the same ``seed`` (with a warning unless ``silent``)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, num_parts=1, part_index=0, **kwargs):
        if os.path.exists(image) or os.path.exists(image + ".gz"):
            images = _read_idx(image)
            labels = _read_idx(label)
        else:
            if not silent:
                logging.warning(
                    "MNISTIter: idx files %r not found; substituting a "
                    "deterministic SYNTHETIC dataset (accuracy numbers will "
                    "not be comparable to real MNIST). Pass silent=True to "
                    "suppress.", image)
            images, labels = _synthetic_mnist(seed=seed)
        images = images.astype(np.float32) / 255.0
        if num_parts > 1:
            part = len(images) // num_parts
            images = images[part_index * part:(part_index + 1) * part]
            labels = labels[part_index * part:(part_index + 1) * part]
        if input_shape is not None:
            images = images.reshape((len(images),) + tuple(input_shape))
        elif flat:
            images = images.reshape(len(images), -1)
        elif images.ndim == 3:
            # the file's own (H, W) with a channel axis
            images = images.reshape(len(images), 1, *images.shape[1:])
        else:
            images = images.reshape(len(images), 1, 28, 28)
        if shuffle:
            idx = np.random.RandomState(seed).permutation(len(images))
            images, labels = images[idx], labels[idx]
        super().__init__(images, labels.astype(np.float32),
                         batch_size=batch_size, last_batch_handle="discard")


def _read_idx(path):
    """An idx file (big-endian magic, dims, uint8 payload) as an array;
    ``path + ".gz"`` where ``path`` itself is missing."""
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        f = gzip.open(path + ".gz", "rb")
    else:
        f = open(path, "rb")
    with f:
        magic = struct.unpack(">i", f.read(4))[0]
        ndim = magic % 256
        shape = tuple(struct.unpack(">i", f.read(4))[0]
                      for _ in range(ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _synthetic_mnist(n=6000, seed=0):
    """The JAX package's synthetic digits: ten fixed 28 x 28 prototypes
    from ``RandomState(42)``, samples 0.7 x prototype + N(0, 16) noise
    clipped to uint8, labels and noise from ``RandomState(seed)``."""
    protos = np.random.RandomState(42).uniform(
        0, 255, size=(10, 28, 28)).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.uint8)
    noise = rng.normal(0, 16.0, size=(n, 28, 28)).astype(np.float32)
    images = np.clip(protos[labels] * 0.7 + noise, 0, 255).astype(np.uint8)
    return images, labels


class CSVIter(NDArrayIter):
    """Rows of a CSV file reshaped to ``data_shape`` (labels from
    ``label_csv``, else zeros), batched as :class:`NDArrayIter` does:
    padded from the front with ``round_batch``, else the last partial
    batch dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((len(data),), dtype=np.float32)
        super().__init__(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label")


class ResizeIter(DataIter):
    """``size`` batches an epoch from ``data_iter``, restarting it when it
    runs out; ``reset_internal`` resets it with each reset."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _BackgroundIter(DataIter):
    """A worker thread filling a bounded queue.  Its puts give up when the
    consumer has set the stop flag (a worker blocked on a full queue does
    not hold ``close`` / ``reset`` up), and an exception in the worker is
    raised in the consumer at its next ``next()``.  Subclasses implement
    ``_produce()`` (the next payload, or StopIteration) and
    ``_reset_source()``, and call ``_restart()`` once built."""

    def __init__(self, batch_size, capacity):
        super().__init__(batch_size)
        self._capacity = max(1, int(capacity))
        self._queue = None
        self._stop = threading.Event()
        self._thread = None
        self._done = False

    # -- the worker ------------------------------------------------------
    def _produce(self):
        raise NotImplementedError()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _worker(self):
        while not self._stop.is_set():
            try:
                payload = self._produce()
            except StopIteration:
                self._put(("end", None))
                return
            except BaseException as exc:
                self._put(("error", exc))
                return
            if not self._put(("batch", payload)):
                return

    # -- the consumer ----------------------------------------------------
    def _restart(self):
        self._stop = threading.Event()
        self._queue = _queue.Queue(maxsize=self._capacity)
        self._done = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def close(self):
        """Stop the worker and join it (again is a no-op); a closed
        iterator raises StopIteration."""
        self._stop.set()
        self._done = True
        while self._thread is not None and self._thread.is_alive():
            try:  # a worker blocked in put() sees the flag
                self._queue.get_nowait()
            except _queue.Empty:
                pass
            self._thread.join(timeout=0.01)
        self._thread = None

    def _reset_source(self):
        raise NotImplementedError()

    def reset(self):
        self.close()
        self._reset_source()
        self._restart()

    def __del__(self):
        self._stop.set()

    def next(self):
        if self._done:
            raise StopIteration
        kind, payload = self._queue.get()
        if kind == "batch":
            return payload
        self._done = True
        if kind == "error":
            raise payload
        raise StopIteration


class PrefetchingIter(_BackgroundIter):
    """The next ``capacity`` batches of one iterator (or of several,
    joined: their data and labels concatenated, the first one's pad) read
    on a worker thread; ``rename_data`` / ``rename_label`` (one
    ``{old: new}`` dict an iterator) rename the descriptors."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 capacity=2):
        if not isinstance(iters, list):
            iters = [iters]
        if not iters:
            raise ValueError("PrefetchingIter needs at least one iterator")
        super().__init__(iters[0].batch_size, capacity)
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._restart()

    @staticmethod
    def _renamed(descs_by_iter, renames):
        if renames is None:
            return sum(descs_by_iter, [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r[x.name], str) else r[x.name]
                     for x in descs]
                    for r, descs in zip(renames, descs_by_iter)], [])

    @property
    def provide_data(self):
        return self._renamed([i.provide_data for i in self.iters],
                             self.rename_data)

    @property
    def provide_label(self):
        return self._renamed([i.provide_label for i in self.iters],
                             self.rename_label)

    def _produce(self):
        batches = [i.next() for i in self.iters]
        if self.n_iter == 1:
            return batches[0]
        return DataBatch(data=sum([b.data for b in batches], []),
                         label=sum([b.label for b in batches], []),
                         pad=batches[0].pad)

    def _reset_source(self):
        for i in self.iters:
            i.reset()


class DevicePrefetchIter(DataIter):
    """Copy the next ``depth`` batches onto a CUDA device ahead of the
    consumer (``mxnet_tpu/io.py:596``'s counterpart): each batch's host
    arrays are pinned and copied on a side stream, and the consumer's
    stream waits on the copy's event when it takes the batch, so the
    host-to-device copy of step n + 1 overlaps step n instead of
    stalling the host in front of it.  The copies are issued from the
    consumer's thread (no worker thread touches the card).  Depth
    defaults to ``MXNET_PREFETCH_DEPTH``."""

    def __init__(self, data_iter, device, depth=None):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self._device = torch.device(device)
        self._depth = max(1, int(depth if depth is not None
                                 else config.get("MXNET_PREFETCH_DEPTH")))
        self._stream = torch.cuda.Stream(device=self._device)
        self._queue = deque()
        self._done = False

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self._queue.clear()
        self._done = False
        self.data_iter.reset()

    def _put(self, arr):
        t = arr.data if isinstance(arr, NDArray) else torch.as_tensor(arr)
        if t.device.type == "cpu":
            t = t.pin_memory().to(self._device, non_blocking=True)
        return t

    def _fill(self):
        while not self._done and len(self._queue) < self._depth:
            try:
                batch = self.data_iter.next()
            except StopIteration:
                self._done = True
                break
            with torch.cuda.stream(self._stream):
                data = [self._put(a) for a in batch.data or []]
                label = [self._put(a) for a in batch.label or []]
                event = torch.cuda.Event()
                event.record(self._stream)
            self._queue.append((batch, data, label, event))

    def next(self):
        self._fill()
        if not self._queue:
            raise StopIteration
        batch, data, label, event = self._queue.popleft()
        cur = torch.cuda.current_stream(self._device)
        cur.wait_event(event)
        for t in data + label:
            t.record_stream(cur)
        self._fill()
        return DataBatch(data=[NDArray(t) for t in data],
                         label=[NDArray(t) for t in label], pad=batch.pad,
                         index=batch.index, bucket_key=batch.bucket_key,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label)


def ImageRecordIter(**kwargs):
    """The RecordIO image pipeline, :func:`image.ImageRecordIter` under
    the reference's ``io`` name."""
    from . import image

    return image.ImageRecordIter(**kwargs)

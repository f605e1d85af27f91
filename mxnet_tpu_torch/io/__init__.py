"""``mx.io`` — the data-iterator core (counterpart of
``mxnet_tpu/io/__init__.py:26-222``; ref python/mxnet/io/io.py).

``DataDesc``, ``DataBatch``, the ``DataIter`` protocol that
``Module.fit`` consumes, and ``NDArrayIter`` over in-memory arrays with
``last_batch_handle`` "pad", "discard" or "roll_over", shuffling (numpy's
global generator, as in the JAX package) and ``num_parts`` /
``part_index`` read sharding. Batches are NDArrays on the current
context (``cuda:0`` unless the caller sets ``with mx.cpu():``).

The other iterators (``ResizeIter``, ``PrefetchingIter``, ``CSVIter``,
``MNISTIter``, the record iterators and ``LibSVMIter``) are ROADMAP
Queue 1 item 11: constructing one raises.
"""
from __future__ import annotations

import os
from collections import OrderedDict, namedtuple

import numpy as np

from .. import ndarray as nd
from ..base import MXNetError

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter",
           "ImageDetRecordIter", "LibSVMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """ref: io.py DataDesc — name, shape, dtype and layout of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """ref: io.py DataBatch."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """ref: io.py DataIter — the iterator protocol every trainer reads."""

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
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """ref: io.py _init_data — an array, a list or a dict of arrays as
    ``[(name, numpy array)]``."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, nd.NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict([(f"_{i}_{default_name}", d)
                                for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise MXNetError("data must be array, list of arrays, or dict")
    return [(k, v if isinstance(v, np.ndarray) else v.asnumpy())
            for k, v in data.items()]


def _resolve_part(num_parts, part_index):
    """Read sharding (ref: ``num_parts``/``part_index`` of the record
    iterators): None reads the launcher's ``MXTPU_NUM_PROC`` /
    ``MXTPU_PROC_ID``, (1, 0) in one process."""
    if num_parts is None:
        num_parts = int(os.environ.get("MXTPU_NUM_PROC", "1") or 1)
    if part_index is None:
        part_index = int(os.environ.get("MXTPU_PROC_ID", "0") or 0)
    num_parts, part_index = int(num_parts), int(part_index)
    if num_parts < 1 or not 0 <= part_index < num_parts:
        raise MXNetError(f"part_index {part_index} out of range for "
                         f"num_parts {num_parts}")
    return num_parts, part_index


def _part_bounds(n, num_parts, part_index):
    """Contiguous split [start, stop): parts differ in size by at most
    one, the remainder on the first parts (dmlc InputSplit)."""
    base, rem = divmod(n, num_parts)
    start = part_index * base + min(part_index, rem)
    return start, start + base + (1 if part_index < rem else 0)


class NDArrayIter(DataIter):
    """Batches over in-memory arrays (ref: io.py NDArrayIter): shuffle,
    ``last_batch_handle`` pad / discard / roll_over; ``num_parts`` /
    ``part_index`` restrict it to a contiguous shard."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", num_parts=None,
                 part_index=None):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        for k, v in self.data + self.label:
            if v.shape[0] != self.num_data:
                raise MXNetError(f"{k}: all arrays must share dim 0")
        num_parts, part_index = _resolve_part(num_parts, part_index)
        if num_parts > 1:
            lo, hi = _part_bounds(self.num_data, num_parts, part_index)
            self.data = [(k, v[lo:hi]) for k, v in self.data]
            self.label = [(k, v[lo:hi]) for k, v in self.label]
            self.num_data = hi - lo
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size
        self._order = np.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self._order)
        # roll_over: the leftover rows lead the next epoch
        if self.last_batch_handle == "roll_over" and \
                getattr(self, "_leftover", None) is not None:
            self._order = np.concatenate([self._leftover, self._order])
            self._leftover = None
        self._cursor = 0

    def iter_next(self):
        return self._cursor < self.num_batches * self.batch_size and \
            self._cursor < self.num_data

    def next(self):
        if not self.iter_next():
            if self.last_batch_handle == "roll_over":
                start = (self.num_data // self.batch_size) * self.batch_size
                if start < self.num_data:
                    self._leftover = self._order[start:]
            raise StopIteration
        start = self._cursor
        stop = min(start + self.batch_size, self.num_data)
        idx = self._order[start:stop]
        pad = 0
        if stop - start < self.batch_size:    # pad from the beginning
            pad = self.batch_size - (stop - start)
            idx = np.concatenate([idx, self._order[:pad]])
        self._cursor += self.batch_size
        data = [nd.array(v[idx]) for _, v in self.data]
        label = [nd.array(v[idx]) for _, v in self.label]
        return DataBatch(data=data, label=label, pad=pad, index=idx,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def getpad(self):
        return 0


def _deferred_iter(name):
    def __init__(self, *args, **kwargs):
        raise MXNetError(f"io.{name} is not ported yet: ROADMAP Queue 1 "
                         "item 11 (data and interchange); use "
                         "io.NDArrayIter")
    return type(name, (DataIter,), {"__init__": __init__,
                                    "__doc__": f"ref: io.py {name} (item "
                                               "11): raises."})


ResizeIter = _deferred_iter("ResizeIter")
PrefetchingIter = _deferred_iter("PrefetchingIter")
CSVIter = _deferred_iter("CSVIter")
MNISTIter = _deferred_iter("MNISTIter")
ImageRecordIter = _deferred_iter("ImageRecordIter")
ImageDetRecordIter = _deferred_iter("ImageDetRecordIter")
LibSVMIter = _deferred_iter("LibSVMIter")

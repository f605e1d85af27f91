"""NDArray and the ``.params`` container (counterpart of
``mxnet_tpu/ndarray/ndarray.py``, ref ``include/mxnet/ndarray.h``,
``src/ndarray/ndarray.cc``).

:class:`NDArray` is a thin class over one ``torch.Tensor`` (``_data``),
as the JAX package's is over one ``jax.Array``. It is a wrapper, not a
``torch.Tensor`` subclass, so that the Gluon, serving and
``ShardedTrainer`` paths and their CUDA graphs keep seeing plain tensors
(no ``__torch_function__`` cost reaches a graphed step) and the kernels'
outputs need no re-wrapping. Its operators go through ``mx.nd`` (the
registry and :func:`~.._dispatch.invoke`); PyTorch's autograd records
them inside ``autograd.record()``.

Mutation writes into the tensor, as MXNet writes into the buffer:
``x[:] = v``, ``x += 1`` (outside ``record()``) and ``out=`` change the
storage in place, so an NDArray over a Gluon Parameter updates it.
Inside ``record()`` ``x += 1`` rebinds ``x`` to the recorded result (the
graph goes on). Basic indexing returns a view that writes through, as
the reference's does (the JAX package copies). Differences from the
reference that the JAX package has too: 64-bit sources become 32-bit
(``array`` of an int64 array is int32), and ``asnumpy`` of a bfloat16
array gives float32 (numpy has no bfloat16 here).

The ``.params`` container (``save``, ``load``): the layout,
little-endian, byte for byte the JAX package's::

    <Q 0x112> <Q flag>  <Q count>
    count x entry:  <I 0xF993FAC9> <I rank> rank x <q dim>
                    <i device type> <i device id> <i dtype code>
                    raw bytes  [<I crc32 of the entry>   (flag 1)]
    <Q names> names x (<Q length> utf-8 bytes)
    (flag 1) footer: <Q body length> <I crc32 of the name table>
                     <I 0> <Q "MXTP CRC3">

Flag 1 is what :func:`save` writes: every entry is followed by its
CRC32 and the footer proves the file whole up front. Files of flag 0
(the reference's) still load, without the checksum proof. Every read
is bounds-checked: truncation or corruption raises an ``MXNetError``
naming the defect, never ``struct.error`` or silent garbage.

bfloat16 (dtype code 12) goes through torch: its bytes are written and
read as 16-bit integers and viewed as ``torch.bfloat16``.
"""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import _dispatch, engine
from ..base import MXNetError, dtype_name, jax_dtype
from ..context import Context, current_context
from ..resilience import commit as _commit
from ..resilience.atomic import atomic_write

__all__ = ["NDArray", "arange", "array", "concat", "empty", "eye", "full",
           "imdecode", "linspace", "load", "moveaxis", "onehot_encode", "ones",
           "save", "stack", "waitall", "zeros"]


def _context_of(device) -> Context:
    return Context("gpu", device.index or 0) if device.type == "cuda" \
        else Context("cpu", 0)


def _np_dtype(dtype):
    """The numpy dtype of a torch dtype; bfloat16 has none here and stays
    a torch dtype."""
    if dtype == torch.bfloat16:
        return dtype
    return np.dtype(dtype_name(dtype))


class NDArray:
    """An array on a device (ref: mx.nd.NDArray): one ``torch.Tensor``.
    ``NDArray(tensor)`` wraps the tensor itself; ``ctx`` or ``dtype``
    move or cast it (a copy only when they change it). A numpy array or a
    list becomes a tensor on ``ctx``, the current context when None
    (``cuda:0``, which raises without a card)."""

    __slots__ = ("_data", "__weakref__")

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _dispatch.to_tensor(
                data, _dispatch.as_device(ctx if ctx is not None
                                          else current_context()))
        elif ctx is not None:
            data = data.to(_dispatch.as_device(ctx))
        if dtype is not None:
            data = data.to(jax_dtype(dtype))
        self._data = data

    # -- properties ---------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (``torch.bfloat16`` for bfloat16)."""
        return _np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def ctx(self) -> Context:
        return _context_of(self._data.device)

    context = ctx

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        """The gradient buffer after :meth:`attach_grad` (None before); a
        row-sparse deposit (``Embedding(sparse_grad=True)``'s backward) as
        a :class:`~.sparse.RowSparseNDArray` of the touched rows."""
        g = self._data.grad
        if g is None:
            return None
        if g.is_sparse:
            from .sparse import RowSparseNDArray
            return RowSparseNDArray._from_coo(g)
        return NDArray(g)

    @property
    def T(self):
        return _invoke1("transpose", self)

    @property
    def handle(self):
        return self._data

    # -- sync and host transfer ---------------------------------------------
    def wait_to_read(self):
        """ref: NDArray::WaitToRead — wait for the card to finish the
        array's producers."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a if dtype is None else a.astype(dtype)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def astype(self, dtype, copy=True):
        return _invoke1("Cast", self, dtype=dtype_name(
            jax_dtype(dtype)))

    def copy(self):
        return NDArray(self._data.clone())

    def copyto(self, other):
        """ref: NDArray.copyto — into an NDArray (in place, its dtype), or
        to a Context (a new array)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().clone(), ctx=other)
        with torch.no_grad():
            other._data.copy_(self._data)
        return other

    def as_in_context(self, ctx):
        if ctx == self.ctx:
            return self
        return NDArray(self._data, ctx=ctx)

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        """ref: NDArray.tostype — "default", "csr" or "row_sparse"."""
        from . import sparse
        if stype == "default":
            return self
        if stype == "csr":
            return sparse.csr_matrix(self)
        if stype == "row_sparse":
            return sparse.row_sparse_array(self)
        raise MXNetError(f"unknown storage type {stype!r}")

    # -- autograd -------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """ref: NDArray.attach_grad — make this array a differentiation
        leaf (detached from any recorded graph) with a zero gradient
        buffer; ``grad_req`` "write" replaces the gradient at each
        backward, "add" adds to it, "null" records none."""
        if stype not in (None, "default", "row_sparse"):
            raise MXNetError(f"attach_grad: stype {stype!r} must be "
                             "'default' or 'row_sparse'")
        t = self._data.detach()
        if grad_req != "null":
            t.requires_grad_(True)
            t.grad = torch.zeros_like(t)
        t.grad_req = grad_req
        self._data = t

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """ref: NDArray.backward — gradients of this array into the
        ``grad`` of every leaf it was recorded from (``train_mode`` is
        accepted; the recorded ops already ran in their mode)."""
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph)

    # -- shape methods --------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return _invoke1("Reshape", self, shape=shape,
                        reverse=kwargs.get("reverse", False))

    def reshape_like(self, other):
        return _invoke1("Reshape", self, shape=other.shape)

    def broadcast_to(self, shape):
        return _invoke1("broadcast_to", self, shape=shape)

    def broadcast_like(self, other):
        return _dispatch.invoke("broadcast_like", [self, other], {})

    def expand_dims(self, axis):
        return _invoke1("expand_dims", self, axis=axis)

    def flatten(self):
        return _invoke1("Flatten", self)

    def squeeze(self, axis=None):
        return _invoke1("squeeze", self, axis=axis)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke1("transpose", self, axes=axes or None)

    def swapaxes(self, dim1, dim2):
        return _invoke1("SwapAxis", self, dim1=dim1, dim2=dim2)

    def flip(self, axis):
        return _invoke1("reverse", self, axis=axis)

    def slice(self, begin, end, step=None):
        return _invoke1("slice", self, begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return _invoke1("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _dispatch.invoke("take", [self, indices],
                                dict(axis=axis, mode=mode))

    def one_hot(self, depth, **kw):
        return _invoke1("one_hot", self, depth=depth, **kw)

    def pad(self, mode="constant", pad_width=None, constant_value=0.0):
        return _invoke1("Pad", self, mode=mode, pad_width=pad_width,
                        constant_value=constant_value)

    def clip(self, a_min=None, a_max=None):
        return _invoke1("clip", self, a_min=a_min, a_max=a_max)

    def tile(self, reps):
        return _invoke1("tile", self, reps=reps)

    def repeat(self, repeats, axis=None):
        return _invoke1("repeat", self, repeats=repeats, axis=axis)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke1("SliceChannel", self, num_outputs=num_outputs,
                        axis=axis, squeeze_axis=squeeze_axis)

    # -- Python protocol ------------------------------------------------------
    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray {self.shape} @{self.ctx}>"

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, key):
        """Basic indexing gives a view (it writes through), advanced
        indexing a copy; recorded inside ``record()``."""
        with torch.set_grad_enabled(_recording()):
            return NDArray(self._data[_index(key)])

    def __setitem__(self, key, value):
        """In place. Inside ``record()`` on a tensor autograd saved, the
        backward raises PyTorch's version-counter error."""
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value),
                                    device=self._data.device)
        with torch.set_grad_enabled(_recording()):
            self._data[_index(key)] = value.to(self._data.dtype)

    # arithmetic ---------------------------------------------------------------
    def __add__(self, other):
        return _binary(self, other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _binary(self, other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return _rbinary(self, other, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, other):
        return _binary(self, other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary(self, other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _rbinary(self, other, "broadcast_div", "_rdiv_scalar")

    def __mod__(self, other):
        return _binary(self, other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return _rbinary(self, other, "broadcast_mod", "_rmod_scalar")

    def __pow__(self, other):
        return _binary(self, other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return _rbinary(self, other, "broadcast_power", "_rpower_scalar")

    def __neg__(self):
        return _invoke1("negative", self)

    def __abs__(self):
        return _invoke1("abs", self)

    def __eq__(self, other):
        return _binary(self, other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return _binary(self, other, "broadcast_not_equal",
                       "_not_equal_scalar")

    def __gt__(self, other):
        return _binary(self, other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return _binary(self, other, "broadcast_greater_equal",
                       "_greater_equal_scalar")

    def __lt__(self, other):
        return _binary(self, other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return _binary(self, other, "broadcast_lesser_equal",
                       "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # in place: into the storage, or rebound to the recorded result
    def _inplace(self, res):
        t = self._data
        if _recording() or res._data.shape != t.shape \
                or res._data.dtype != t.dtype:
            self._data = res._data
        else:
            with torch.no_grad():
                t.copy_(res._data)
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))

    # pickling: the values and the context
    def __getstate__(self):
        return {"data": self.asnumpy(), "ctx": str(self.ctx)}

    def __setstate__(self, state):
        kind, _, idx = state["ctx"].partition("(")
        self._data = torch.from_numpy(np.array(state["data"])).to(
            _dispatch.as_device(Context(kind, int(idx.rstrip(")")))))


def _recording():
    from .. import autograd
    return autograd.is_recording()


def _invoke1(op, x, **kwargs):
    return _dispatch.invoke(op, [x], kwargs)


def _is_array(x):
    return isinstance(x, (NDArray, torch.Tensor)) or \
        (isinstance(x, np.ndarray) and x.ndim > 0)


def _binary(lhs, rhs, broadcast_op, scalar_op):
    if _is_array(rhs):
        return _dispatch.invoke(broadcast_op, [lhs, rhs], {})
    return _dispatch.invoke(scalar_op, [lhs], {"scalar": float(rhs)})


def _rbinary(rhs, lhs, broadcast_op, rscalar_op):
    """``lhs (op) rhs`` with ``rhs`` the NDArray."""
    if _is_array(lhs):
        return _dispatch.invoke(broadcast_op, [lhs, rhs], {})
    return _dispatch.invoke(rscalar_op, [rhs], {"scalar": float(lhs)})


def _index(key):
    """An index with NDArrays unwrapped; float index arrays (MXNet's
    default dtype) index as integers."""
    def one(k):
        if isinstance(k, NDArray):
            k = k._data
        if isinstance(k, torch.Tensor) and k.is_floating_point():
            k = k.long()
        return k
    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


# ---------------------------------------------------------------------------
# creation functions (ref: python/mxnet/ndarray/ndarray.py)
# ---------------------------------------------------------------------------
def _device(ctx):
    return _dispatch.as_device(ctx if ctx is not None else current_context())


def _creation_dtype(dtype):
    return torch.float32 if dtype is None else jax_dtype(dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """ref: mx.nd.array — a copy on ``ctx`` (default ``cuda:0``). An
    ndarray or tensor source keeps its dtype (64-bit becomes 32-bit, as
    in the JAX package); a list or a scalar becomes float32."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if isinstance(source_array, torch.Tensor):
        src = source_array.detach()
    else:
        src = np.asarray(source_array)
        if dtype is None and not isinstance(source_array, np.ndarray):
            dtype = "float32"
        src = _dispatch.to_tensor(src, "cpu")
    dt = jax_dtype(dtype if dtype is not None else src.dtype)
    return NDArray(src.to(device=_device(ctx), dtype=dt, copy=True))


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=_creation_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=_creation_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.full(_shape(shape), val,
                              dtype=_creation_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """Zeros, as in the JAX package."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    """ref: mx.nd.arange — each value ``repeat`` times; float32 unless
    ``dtype`` says otherwise."""
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=_creation_dtype(dtype),
                       device=_device(ctx))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return NDArray(out)


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    m = M or N
    rows = torch.arange(N, device=_device(ctx))[:, None]
    cols = torch.arange(m, device=_device(ctx))[None, :]
    return NDArray((cols - rows == k).to(_creation_dtype(dtype)))


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype=None) -> NDArray:
    dt = _creation_dtype(dtype)
    if endpoint:
        out = torch.linspace(start, stop, num, device=_device(ctx))
    else:
        out = torch.linspace(start, stop, num + 1, device=_device(ctx))[:-1]
    return NDArray(out.to(dt))


def moveaxis(tensor, source, destination):
    return _dispatch.invoke("moveaxis", [tensor],
                            {"source": source, "destination": destination})


def concat(*args, dim=1):
    return _dispatch.invoke("Concat", list(args), {"dim": dim})


def stack(*args, axis=0):
    return _dispatch.invoke("stack", list(args), {"axis": axis})


def onehot_encode(indices, out):
    """ref: mx.nd.onehot_encode — into ``out`` (N, depth), in place."""
    res = _invoke1("one_hot", indices, depth=out.shape[1])
    with torch.no_grad():
        out._data.copy_(res._data)
    return out


def imdecode(buf, **kwargs):
    raise MXNetError("nd.imdecode needs the image module: ROADMAP Queue 1 "
                     "item 11")


def waitall():
    """ref: mx.nd.waitall."""
    engine.waitall()



_LIST_MAGIC = 0x112          # kMXAPINDArrayListMagic
_ND_MAGIC = 0xF993FAC9       # NDArray binary magic (v2)
_FOOTER_MAGIC = 0x4D585450_43524333   # "MXTP CRC3"
_FMT_LEGACY, _FMT_CRC = 0, 1
_FOOTER_BYTES = 24           # <Q body_len> <I names_crc> <I 0> <Q magic>

_DTYPE_CODE = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
               "int32": 4, "int8": 5, "int64": 6, "bool": 7, "bfloat16": 12}
_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}
_DEV_CPU, _DEV_GPU = 1, 2    # Context.devstr2type of "cpu" and "gpu"


def _host(arr):
    """(numpy array of the bytes to write, dtype name, device type, device
    id) of an NDArray, a tensor or a numpy array. A bfloat16 array's bytes
    come as 16-bit integers."""
    if isinstance(arr, NDArray):
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        dev = arr.device
        typ, idx = ((_DEV_GPU, dev.index or 0) if dev.type == "cuda"
                    else (_DEV_CPU, 0))
        t = arr.detach().cpu().contiguous()
        name = dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), name, typ, idx
        return t.numpy(), name, typ, idx
    a = np.asarray(arr, order="C")
    name = a.dtype.name
    if name == "bfloat16":                  # an ml_dtypes array
        a = a.view(np.uint16)
    return a, name, _DEV_CPU, 0


def save(fname, data):
    """Save NDArrays, tensors or numpy arrays (a list, or a str -> array
    dict) to a ``.params`` file, atomically: a crash leaves the previous
    file or the new one, never a torn mix."""
    if isinstance(data, (NDArray, torch.Tensor, np.ndarray)):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    with atomic_write(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, _FMT_CRC))
        f.write(struct.pack("<Q", len(arrays)))
        for arr in arrays:
            crc = _write_entry(f, arr)
            f.write(struct.pack("<I", crc))
        tail = [struct.pack("<Q", len(names))]
        for n in names:
            b = n.encode("utf-8")
            tail.append(struct.pack("<Q", len(b)))
            tail.append(b)
        tail_bytes = b"".join(tail)
        f.write(tail_bytes)
        # f.nbytes: the atomic handle's running byte count = body length
        f.write(struct.pack("<QIIQ", f.nbytes,
                            zlib.crc32(tail_bytes) & 0xFFFFFFFF, 0,
                            _FOOTER_MAGIC))


def _write_entry(f, arr) -> int:
    """Serialize one array; returns the CRC32 of the entry's bytes."""
    host, name, dev_type, dev_id = _host(arr)
    if name not in _DTYPE_CODE:
        raise MXNetError(f"nd.save: dtype {name!r} has no .params dtype "
                         f"code (supported: {sorted(_DTYPE_CODE)})")
    pieces = [struct.pack("<I", _ND_MAGIC),
              struct.pack("<I", host.ndim)]
    for s in host.shape:
        pieces.append(struct.pack("<q", s))
    pieces.append(struct.pack("<ii", dev_type, dev_id))
    pieces.append(struct.pack("<i", _DTYPE_CODE[name]))
    pieces.append(host.reshape(-1).view(np.uint8))   # the bytes, no copy
    crc = 0
    for piece in pieces:
        f.write(piece)
        crc = zlib.crc32(piece, crc)
    return crc & 0xFFFFFFFF


class _BoundedReader:
    """Bounds-checked reads over the container body: a short or
    out-of-bounds read is a truncation error, never struct.error. Can
    accumulate a CRC over what it reads."""

    def __init__(self, f, fname, limit, pool):
        self._f = f
        self._fname = fname
        self._limit = limit
        self._pool = pool
        self._crc = None

    def _check(self, n, what):
        if n < 0 or self._f.tell() + n > self._limit:
            raise MXNetError(
                f"{self._fname}: truncated or corrupt .params file — "
                f"{what} wants {n} bytes but only "
                f"{max(self._limit - self._f.tell(), 0)} remain (was the "
                "save interrupted?)")

    def read(self, n, what):
        self._check(n, what)
        data = self._f.read(n)
        if len(data) != n:
            raise MXNetError(
                f"{self._fname}: truncated .params file — short read "
                f"({len(data)}/{n} bytes) for {what}")
        if self._crc is not None:
            self._crc = zlib.crc32(data, self._crc)
        return data

    def read_into(self, buf, what):
        """Fill the writable byte buffer ``buf`` from the file: the bytes
        land where they are kept, read and checksummed in slices on the
        reader's threads."""
        n = len(buf)
        self._check(n, what)
        start = self._f.tell()
        crc, got = _commit.read_into_crc(self._pool, self._f.fileno(),
                                         start, buf)
        self._f.seek(start + got)
        if got != n:
            raise MXNetError(
                f"{self._fname}: truncated .params file — short read "
                f"({got}/{n} bytes) for {what}")
        if self._crc is not None:
            self._crc = _commit.crc32_combine(self._crc, crc, got)

    def unpack(self, fmt, what):
        return struct.unpack(fmt, self.read(struct.calcsize(fmt), what))

    def begin_crc(self):
        self._crc = 0

    def end_crc(self) -> int:
        crc, self._crc = self._crc, None
        return crc & 0xFFFFFFFF

    def tell(self):
        return self._f.tell()


def load(fname):
    """ref: mx.nd.load — a ``.params`` file as a list of NDArrays on the
    CPU, or a dict when the file names them (see :func:`_load_tensors`)."""
    loaded = _load_tensors(fname)
    if isinstance(loaded, dict):
        return {k: NDArray(v) for k, v in loaded.items()}
    return [NDArray(v) for v in loaded]


def _load_tensors(fname):
    """A ``.params`` file as a list of CPU tensors, or a dict when the
    file names them: what the port's own readers take. Integrity is
    proven up front for flag-1 files (footer, per-entry CRC32); a defect
    raises ``MXNetError`` naming it."""
    with open(fname, "rb") as f, \
            ThreadPoolExecutor(_commit.CRC_THREADS) as pool:
        size = os.fstat(f.fileno()).st_size
        if size < 24:
            raise MXNetError(f"{fname}: truncated .params file — "
                             f"{size} bytes is smaller than any header")
        magic, fmt = struct.unpack("<QQ", f.read(16))
        if magic != _LIST_MAGIC:
            raise MXNetError(f"{fname}: bad magic {magic:#x} — not an "
                             "NDArray save file")
        names_crc = None
        if fmt == _FMT_CRC:
            if size < 16 + _FOOTER_BYTES:
                raise MXNetError(f"{fname}: truncated .params file — "
                                 "no room for the integrity footer")
            limit = size - _FOOTER_BYTES
            f.seek(limit)
            body_len, names_crc, _resv, fmagic = struct.unpack(
                "<QIIQ", f.read(_FOOTER_BYTES))
            if fmagic != _FOOTER_MAGIC or body_len != limit:
                raise MXNetError(
                    f"{fname}: truncated or corrupt .params file — "
                    "footer missing or inconsistent (the save was "
                    "interrupted before commit)")
            f.seek(16)
        elif fmt == _FMT_LEGACY:
            limit = size
        else:
            raise MXNetError(f"{fname}: unsupported .params format flag "
                             f"{fmt} — written by a newer version?")
        verify = fmt == _FMT_CRC
        r = _BoundedReader(f, fname, limit, pool)
        (count,) = r.unpack("<Q", "array count")
        if count > limit:
            raise MXNetError(f"{fname}: corrupt .params file — implausible "
                             f"array count {count}")
        arrays = [_read_entry(r, verify, fname, i) for i in range(count)]
        if verify:
            r.begin_crc()
        (n_names,) = r.unpack("<Q", "name count")
        if n_names > limit:
            raise MXNetError(f"{fname}: corrupt .params file — implausible "
                             f"name count {n_names}")
        names = []
        for i in range(n_names):
            (ln,) = r.unpack("<Q", f"name {i} length")
            try:
                names.append(r.read(ln, f"name {i}").decode("utf-8"))
            except UnicodeDecodeError as e:
                raise MXNetError(f"{fname}: corrupt .params file — "
                                 f"name {i} is not valid UTF-8") from e
        if verify:
            if r.end_crc() != names_crc:
                raise MXNetError(f"{fname}: checksum mismatch in the name "
                                 "table — the file is corrupt")
            if r.tell() != limit:
                raise MXNetError(
                    f"{fname}: corrupt .params file — "
                    f"{limit - r.tell()} unexpected trailing bytes")
    if names:
        return dict(zip(names, arrays))
    return arrays


def _read_entry(r, verify, fname, index) -> torch.Tensor:
    what = f"array entry {index}"
    r.begin_crc()
    (magic,) = r.unpack("<I", what)
    if magic != _ND_MAGIC:
        raise MXNetError(f"{fname}: corrupt NDArray entry {index} "
                         f"(bad entry magic {magic:#x})")
    (ndim,) = r.unpack("<I", what)
    if ndim > 64:
        raise MXNetError(f"{fname}: corrupt NDArray entry {index} — "
                         f"implausible rank {ndim}")
    shape = tuple(r.unpack("<q", what)[0] for _ in range(ndim))
    if any(s < 0 for s in shape):
        raise MXNetError(f"{fname}: corrupt NDArray entry {index} — "
                         f"negative dimension in shape {shape}")
    r.unpack("<ii", what)                    # device type and id
    (dtype_code,) = r.unpack("<i", what)
    dt = _CODE_DTYPE.get(dtype_code)
    if dt is None:
        raise MXNetError(
            f"{fname}: unknown dtype code {dtype_code} in entry {index} "
            "— file from a newer format or corrupt (refusing to guess "
            "a dtype)")
    count = int(np.prod(shape)) if ndim else 1
    npdt = np.dtype(np.int16 if dt == "bfloat16" else dt)
    raw = np.empty(shape, dtype=npdt)
    r.read_into(memoryview(raw.reshape(-1).view(np.uint8)), what + " data")
    crc = r.end_crc()
    if verify:
        (want,) = r.unpack("<I", what + " checksum")
        if crc != want:
            raise MXNetError(
                f"{fname}: checksum mismatch in entry {index} "
                f"(stored {want:#010x}, computed {crc:#010x}) — the "
                "file is corrupt")
    out = torch.from_numpy(raw)
    return out.view(torch.bfloat16) if dt == "bfloat16" else out

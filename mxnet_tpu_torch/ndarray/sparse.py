"""Sparse storage types (counterpart of ``mxnet_tpu/ndarray/sparse.py``,
ref ``python/mxnet/ndarray/sparse.py``, ``include/mxnet/ndarray.h``
kCSRStorage / kRowSparseStorage).

:class:`CSRNDArray` and :class:`RowSparseNDArray` hold their parts as
tensors on one device (``data``, ``indices`` and, for CSR, ``indptr``;
the JAX package holds numpy arrays), so on the card the rows of a
gradient and their values never visit the host. Conversions are
explicit (``tostype('default')``); ``CSRNDArray.dot`` is the one sparse
product, ``torch.sparse`` (cuSPARSE on the card).

Row-sparse is the gradient format of embedding tables: under
``autograd.record()``, ``nn.Embedding(sparse_grad=True)`` (or
``nd.Embedding(..., sparse_grad=True)``) gives its weight a coalesced
sparse COO gradient holding only the rows the batch touched
(:func:`sparse_embedding`), ``NDArray.grad`` shows it as a
:class:`RowSparseNDArray`, and the Trainer applies the optimizer to
those rows alone (``Optimizer.update_row_sparse``: untouched rows see no
weight decay and no state decay, the reference's lazy update). A
hybridized block keeps dense gradients, as in the JAX package. The win
grows with the table against the batch's rows (the JAX package's
docstring names a vocabulary of 500k at width 64 with Adam).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _dispatch
from ..base import MXNetError, as_torch_dtype, dtype_name
from ..context import current_context

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "sparse_embedding"]


def _device(ctx, *parts):
    for p in parts:
        if isinstance(p, torch.Tensor):
            return p.device
        if hasattr(p, "_data"):
            return p._data.device
    return _dispatch.as_device(ctx if ctx is not None else current_context())


def _tensor(x, device, dtype=None):
    """A part (NDArray, tensor, numpy array or list) as a tensor on
    ``device``."""
    if hasattr(x, "_data"):
        x = x._data
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if dtype is None and a.dtype == np.float64:
            a = a.astype(np.float32)
        x = torch.as_tensor(a)
    x = x.to(device)
    return x if dtype is None else x.to(dtype)


def _dense_tensor(arg, device):
    if hasattr(arg, "_data"):
        return arg._data.detach()
    if isinstance(arg, torch.Tensor):
        return arg.detach()
    return _dispatch.to_tensor(np.asarray(arg), device)


class BaseSparseNDArray:
    """What both storage types share (ref: BaseSparseNDArray)."""

    @property
    def stype(self):
        raise NotImplementedError

    @property
    def dtype(self):
        from .ndarray import _np_dtype
        return _np_dtype(self.data.dtype)

    @property
    def ctx(self):
        from .ndarray import _context_of
        return _context_of(self.data.device)

    context = ctx

    @property
    def size(self):
        return int(np.prod(self.shape))

    def _dense(self) -> torch.Tensor:
        raise NotImplementedError

    def asnumpy(self):
        t = self._dense()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            from .ndarray import NDArray
            return NDArray(self._dense())
        raise MXNetError(f"cannot convert {self.stype} to {stype}")

    def copyto(self, other):
        raise MXNetError("copyto on sparse arrays: use tostype('default')")

    def __repr__(self):
        return (f"<{self.__class__.__name__} {self.shape} "
                f"stype={self.stype}>")


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (ref: CSRNDArray): ``data`` and
    ``indices`` (column of each stored value, int64) and ``indptr``
    (rows + 1 offsets, int64)."""

    def __init__(self, data, indices, indptr, shape, dtype=None, ctx=None):
        device = _device(ctx, data, indices, indptr)
        self.data = _tensor(data, device,
                            as_torch_dtype(dtype or "float32"))
        self.indices = _tensor(indices, device, torch.int64)
        self.indptr = _tensor(indptr, device, torch.int64)
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != 2:
            raise MXNetError("CSR arrays are 2-D")
        if self.indptr.numel() != self.shape[0] + 1:
            raise MXNetError("indptr length must be rows+1")

    @property
    def stype(self):
        return "csr"

    def _csr(self):
        return torch.sparse_csr_tensor(self.indptr, self.indices, self.data,
                                       self.shape, check_invariants=False)

    def _dense(self):
        return self._csr().to_dense()

    def dot(self, rhs):
        """CSR @ dense with ``torch.sparse`` (ref: the csr path of
        src/operator/tensor/dot.cc); returns an NDArray."""
        from .ndarray import NDArray
        r = _tensor(rhs, self.data.device)
        return NDArray(torch.sparse.mm(self._csr(), r.to(self.data.dtype)))


class RowSparseNDArray(BaseSparseNDArray):
    """A subset of rows stored (ref: RowSparseNDArray, the gradient format
    of Embedding): ``data`` (rows, ...) and their row ``indices``
    (int64)."""

    def __init__(self, data, indices, shape, dtype=None, ctx=None):
        device = _device(ctx, data, indices)
        if dtype is None and not isinstance(data, torch.Tensor):
            dtype = "float32"       # the JAX package's default
        self.data = _tensor(data, device,
                            None if dtype is None else as_torch_dtype(dtype))
        self.indices = _tensor(indices, device, torch.int64)
        self.shape = tuple(int(s) for s in shape)
        if self.data.shape[0] != self.indices.numel():
            raise MXNetError("data rows must match indices length")

    @property
    def stype(self):
        return "row_sparse"

    @classmethod
    def _from_coo(cls, grad):
        """A sparse COO gradient (one sparse dimension) as a row-sparse
        array, its duplicate rows summed."""
        grad = grad.coalesce()
        return cls(grad.values(), grad.indices()[0], tuple(grad.shape))

    def _dense(self):
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        out[self.indices] = self.data
        return out

    def retain(self, row_ids):
        """ref: sparse.retain — keep only the given rows."""
        ids = _tensor(row_ids, self.indices.device, torch.int64)
        mask = torch.isin(self.indices, ids)
        return RowSparseNDArray(self.data[mask], self.indices[mask],
                                self.shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """ref: nd.sparse.csr_matrix — from ``(data, indices, indptr)`` and
    ``shape``, or from a dense 2-D array."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(data, indices, indptr, shape, dtype=dtype, ctx=ctx)
    dense = _dense_tensor(arg1, _device(ctx, arg1))
    if dense.ndim != 2:
        raise MXNetError("csr_matrix needs a 2-D input")
    csr = dense.to_sparse_csr()
    return CSRNDArray(csr.values(), csr.col_indices(), csr.crow_indices(),
                      dense.shape, dtype=dtype or dtype_name(dense.dtype))


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """ref: nd.sparse.row_sparse_array — from ``(data, indices)`` and
    ``shape``, or from a dense array (its rows that hold a non-zero)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        return RowSparseNDArray(data, indices, shape, dtype=dtype, ctx=ctx)
    dense = _dense_tensor(arg1, _device(ctx, arg1))
    nz = (dense != 0).reshape(dense.shape[0], -1).any(dim=1)
    rows = torch.nonzero(nz).reshape(-1)
    return RowSparseNDArray(dense[rows], rows, dense.shape,
                            dtype=dtype or dtype_name(dense.dtype))


class _SparseEmbedding(torch.autograd.Function):
    """Embedding whose weight gradient is a coalesced sparse COO tensor
    of the touched rows (ref: indexing_op.cc
    SparseEmbeddingOpBackwardRspImpl; the JAX package's ``_RowSparseCT``).
    The forward is the dense op's (an out-of-range id gives a NaN row);
    an id in [-V, -1] counts from the end, and an out-of-range id adds
    nothing, as the dense gradient gives it nothing."""

    @staticmethod
    def forward(ctx, ids, weight):
        from ..ops.nn import embedding
        ctx.save_for_backward(ids)
        ctx.table = tuple(weight.shape)
        return embedding(ids, weight)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        v, width = ctx.table
        rows = ids.to(torch.int32).long().reshape(-1)
        rows = torch.where(rows < 0, rows + v, rows)
        vals = g.reshape(rows.numel(), width)
        inside = (rows >= 0) & (rows < v)
        grad = torch.sparse_coo_tensor(rows[inside].unsqueeze(0),
                                       vals[inside], (v, width),
                                       dtype=g.dtype, device=g.device,
                                       check_invariants=False)
        return None, grad.coalesce()


def sparse_embedding(ids, weight):
    """``embedding(ids, weight)`` with a row-sparse weight gradient when
    autograd records it here: outside a hybridized block's program and a
    CUDA-graph capture (there the gradient stays dense, as under the JAX
    package's trace)."""
    from ..ops.control_flow import program_path
    from ..ops.nn import embedding
    if torch.is_grad_enabled() and weight.requires_grad \
            and not program_path():
        return _SparseEmbedding.apply(ids, weight)
    return embedding(ids, weight)

"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``)."""
from __future__ import annotations

import hashlib
import math
import warnings

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..guardrails import fused
from ..ops import tensor as _tensor

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split one batch along ``batch_axis`` into ``num_slice`` pieces, the
    last taking the remainder (ref: gluon/utils.py split_data)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"batch size {size} not divisible by {num_slice} slices; pass "
            f"even_split=False")
    step = size // num_slice
    return [_tensor.slice_axis(data, axis=batch_axis, begin=i * step,
                               end=(i + 1) * step if i < num_slice - 1
                               else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split a batch (a tensor or an array) and put each slice on one
    context of ``ctx_list`` (ref: gluon/utils.py split_and_load)."""
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data))
    if len(ctx_list) == 1:
        return [data.to(resolve_device(ctx_list[0]))]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [piece.to(resolve_device(ctx))
            for piece, ctx in zip(slices, ctx_list)]


def _stored(arr):
    """The tensor whose values an array stores: a row-sparse array's rows,
    a sparse COO tensor's values (a view), an NDArray's tensor."""
    from ..ndarray.sparse import RowSparseNDArray
    if isinstance(arr, RowSparseNDArray):
        return arr.data
    if hasattr(arr, "_data"):
        return arr._data
    if arr.is_sparse:
        if not arr.is_coalesced():
            raise MXNetError("clip_global_norm: coalesce the sparse "
                             "gradient first (duplicate rows)")
        return arr._values()
    if arr.layout != torch.strided:
        raise MXNetError(f"clip_global_norm: layout {arr.layout} is not "
                         "taken")
    return arr


def clip_global_norm(arrays, max_norm, check_isfinite=True,
                     global_norm=None):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm`` (ref: gluon/utils.py clip_global_norm).

    The norm is one fused reduction on the device (each array's fp32 norm
    by ``torch._foreach_norm``, then the norm of those), or
    ``global_norm`` where the caller has it (e.g. a guard's). With
    ``check_isfinite`` (the default) it makes one host read of the norm,
    returns it as a float, warns and leaves the arrays alone when it is
    not finite, and scales only when the factor is below 1. Without, it
    makes no host read: the factor ``min(1, max_norm / (norm + 1e-8))``,
    1 for a non-finite norm, scales every array on the device, and the
    norm comes back as a 0-d fp32 tensor. Row-sparse arrays (a
    :class:`~..ndarray.sparse.RowSparseNDArray` or a sparse COO tensor,
    coalesced) take part through their stored rows alone, scaled in
    place (ref: gluon/utils.py clips row_sparse gradients)."""
    if not arrays:
        raise MXNetError("clip_global_norm: empty array list")
    arrays = [_stored(a) for a in arrays]
    if global_norm is not None:
        norm_dev = torch.as_tensor(global_norm, device=arrays[0].device) \
            .detach().float()
    else:
        with torch.no_grad():
            norms = torch._foreach_norm(arrays, 2, dtype=torch.float32)
            norm_dev = torch.linalg.vector_norm(torch.stack(norms))
    if not check_isfinite:
        scale = fused.clip_scale(norm_dev, float(max_norm))
        with torch.no_grad():
            for arr in arrays:
                arr.mul_(scale.to(arr.dtype))
        return norm_dev
    norm = fused.host_fetch(norm_dev)[0]
    if not math.isfinite(norm):
        warnings.warn("clip_global_norm: non-finite gradient norm — "
                      "arrays left unclipped (enable guardrails to "
                      "skip-step instead)")
        return norm
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for arr in arrays:
                arr.mul_(scale)
    return norm


def check_sha1(filename, sha1_hash):
    """Whether the SHA-1 of ``filename``'s bytes is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Raises, as the JAX package's ``download`` does: nothing is
    fetched."""
    raise MXNetError("download() requires network access, which this "
                     "environment does not provide; place files locally and "
                     "load them directly")

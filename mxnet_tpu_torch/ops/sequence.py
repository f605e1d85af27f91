"""Sequence operators (counterpart of ``mxnet_tpu/ops/sequence.py``, ref
``src/operator/sequence_mask.cc``, ``sequence_last.cc``,
``sequence_reverse.cc``): variable-length handling, time-major (T, N,
...) by default, ``axis`` the time axis."""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import OpParam, register


def _len_mask(x, seq_len, axis):
    """(T, N, 1, ...) (or (N, T, ...) for ``axis=1``) bool mask of the
    steps within each sequence's length."""
    steps = torch.arange(x.shape[axis], device=x.device)
    mask = steps[:, None] < seq_len.to(torch.int32)[None, :]       # (T, N)
    if axis == 1:
        mask = mask.t()
    return mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - 2))


@register("SequenceMask", num_inputs=-1,
          params=[OpParam("use_sequence_length", bool, False),
                  OpParam("value", float, 0.0), OpParam("axis", int, 0)],
          doc="Fill the steps beyond each sequence's length with ``value``")
def sequence_mask(data, *rest, use_sequence_length=False, value=0.0, axis=0):
    if not use_sequence_length:
        return data
    mask = _len_mask(data, rest[0], axis)
    return torch.where(mask, data, torch.full_like(data, value))


@register("SequenceLast", num_inputs=-1,
          params=[OpParam("use_sequence_length", bool, False),
                  OpParam("axis", int, 0)],
          doc="The last valid step of each sequence")
def sequence_last(data, *rest, use_sequence_length=False, axis=0):
    if not use_sequence_length:
        return data.select(axis, -1)
    last = rest[0].to(torch.int32).long() - 1
    if axis == 0:
        idx = last.reshape((1, -1) + (1,) * (data.ndim - 2))
    else:
        idx = last.reshape((-1, 1) + (1,) * (data.ndim - 2))
    idx = idx.expand(tuple(1 if i == axis else s
                           for i, s in enumerate(data.shape)))
    return torch.gather(data, axis, idx).squeeze(axis)


@register("SequenceReverse", num_inputs=-1,
          params=[OpParam("use_sequence_length", bool, False),
                  OpParam("axis", int, 0)],
          doc="Reverse each sequence up to its length (time-major only, as "
              "the JAX op)")
def sequence_reverse(data, *rest, use_sequence_length=False, axis=0):
    if axis != 0:
        raise MXNetError("SequenceReverse supports time-major (axis=0) only")
    if not use_sequence_length:
        return torch.flip(data, (0,))
    seq_len = rest[0].to(torch.int32).long()
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    src = torch.where(steps < seq_len[None, :], seq_len[None, :] - 1 - steps,
                      steps)
    src = src.reshape(tuple(src.shape) + (1,) * (data.ndim - 2))
    return torch.gather(data, 0, src.expand(data.shape))

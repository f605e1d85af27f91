"""K2, the matmul epilogue: ``dropout(act(y + bias))`` over a matrix
product's output.

Counterpart of ``mxnet_tpu/pallas/kernels.py`` (``keep_threshold``,
``_matmul_epilogue_ref``, ``_matmul_epilogue_call`` and the N-D wrapper
``fused_matmul_epilogue``). The math runs in fp32 and the result is cast
back to ``y``'s dtype (the bias is read at its own dtype); ``act`` is one
of identity, relu, exact-erf gelu, tanh, sigmoid. Dropout keeps an element where its uint8 ``bits`` are at
least :func:`keep_threshold` of ``p`` and scales it by ``1 / (1 - p)``.

- :func:`matmul_epilogue_plain` is the plain PyTorch version: the CPU
  path, and the yardstick the CUDA kernel is held against on the card.
- :func:`matmul_epilogue_2d` is the 2-D entry, ``y`` (R, C) with a
  (1, C) or (R, 1) bias, like the JAX package's
  ``_matmul_epilogue_pallas``.
- :func:`fused_matmul_epilogue` is the N-D entry with the bias along the
  last axis, what ``Dense`` calls.

A CPU tensor goes to the plain version; a CUDA tensor goes to the
hand-written kernel in ``csrc/matmul_epilogue.cu`` or the call raises.
There is no fallback. The dropout bits are always explicit here
(``ops.contrib.matmul_epilogue`` draws them in training).

Both entries are differentiable: a ``torch.autograd.Function`` whose
forward is the kernel (the plain version on the CPU) and whose backward
is the counterpart of ``_me_drop_bwd`` / ``_me_nodrop_bwd``: the VJP of
the plain version with the same bits, ``dy = g * keep / (1 - p) *
act'(y + bias)`` and ``dbias`` its fp32 sum over the broadcast rows,
cast back. Like the JAX package, which leaves that VJP to XLA, the port
computes it with PyTorch ops.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..base import MXNetError
from . import _build
from ._common import (ACT_CODE, DTYPE_CODE, EPILOGUE_ACTS, LaunchCount,
                      act_fn, check_cuda_inputs, note_route)

__all__ = ["EPILOGUE_ACTS", "fused_matmul_epilogue", "keep_threshold",
           "launch_count", "matmul_epilogue_2d", "matmul_epilogue_plain"]

MODE_COL, MODE_ROW = 1, 2
launch_count = LaunchCount()


def keep_threshold(p):
    """uint8 keep threshold: keep where ``bits >= keep_threshold(p)``.
    Python's ``round`` (half to even), as in the JAX package."""
    return min(255, int(round(float(p) * 256)))


def matmul_epilogue_plain(y, bias, bits=None, act_type="gelu", p=0.0):
    """The plain version (``_matmul_epilogue_ref``): fp32 math, dropout
    as ``where(bits >= keep_threshold(p), out / (1 - p), 0)``, cast back
    to ``y.dtype``. ``bias`` broadcasts against ``y``."""
    out = act_fn("matmul epilogue", act_type)(y.float() + bias.float())
    if bits is not None and p > 0:
        keep = bits >= keep_threshold(p)
        out = torch.where(keep, out / (1.0 - p), 0.0)
    return out.to(y.dtype)


@functools.cache
def _lib():
    """The built kernel library, its C signatures declared."""
    lib = _build.load("matmul_epilogue")
    fn = lib.matmul_epilogue_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.matmul_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.matmul_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def _check(y, bias, bits, act_type, p):
    """Validate a 2-D call; returns the bias mode."""
    act_fn("matmul epilogue", act_type)
    if y.ndim != 2:
        raise MXNetError(f"matmul epilogue: y must be 2-D, got "
                         f"{tuple(y.shape)}")
    r, c = y.shape
    if tuple(bias.shape) == (1, c):
        mode = MODE_COL
    elif tuple(bias.shape) == (r, 1):
        mode = MODE_ROW
    else:
        raise MXNetError(f"matmul epilogue: bias {tuple(bias.shape)} must "
                         f"be (1, {c}) or ({r}, 1) for y {tuple(y.shape)}")
    if bits is not None:
        if tuple(bits.shape) != tuple(y.shape):
            raise MXNetError(f"matmul epilogue: bits {tuple(bits.shape)} vs "
                             f"y {tuple(y.shape)}")
        if bits.dtype != torch.uint8:
            raise MXNetError(f"matmul epilogue: bits are {bits.dtype}, "
                             "want torch.uint8")
    if not 0.0 <= float(p) < 1.0:
        raise MXNetError(f"matmul epilogue: dropout p={p} outside [0, 1)")
    return mode


def _launch(y, bias, bits, act_type, p, mode):
    if bits is None or p <= 0:
        bits = None
    check_cuda_inputs("matmul epilogue kernel", y,
                      (("bias", bias, None), ("bits", bits, torch.uint8)))
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return out
    # the fp32 reciprocal PyTorch's CUDA division by a scalar multiplies
    # by, so the kernel equals the plain version on the card
    inv_keep = float(np.float32(1.0) / np.float32(1.0 - p))
    lib = _lib()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = lib.matmul_epilogue_launch(
        y.data_ptr(), bias.data_ptr(),
        None if bits is None else bits.data_ptr(), out.data_ptr(),
        y.numel(), y.shape[1], mode, ACT_CODE[act_type],
        DTYPE_CODE[y.dtype], DTYPE_CODE[bias.dtype], keep_threshold(p),
        inv_keep, stream)
    if err != 0:
        raise MXNetError("matmul epilogue kernel launch failed: "
                         + lib.matmul_epilogue_error_string(err).decode())
    launch_count.add()
    return out


class _MatmulEpilogue(torch.autograd.Function):
    """K2 under autograd: the kernel (plain version on the CPU) forward;
    the backward is the VJP of the plain version with the same bits."""

    @staticmethod
    def forward(ctx, y, bias, bits, act_type, p, mode):
        note_route("matmul_epilogue", y.device)
        # a meta tensor computes nothing: its shape comes from the plain
        # version
        if y.device.type in ("cpu", "meta"):
            out = matmul_epilogue_plain(y, bias, bits, act_type, p)
        elif y.device.type == "cuda":
            out = _launch(y, bias, bits, act_type, p, mode)
        else:
            raise MXNetError(f"matmul epilogue: unsupported device "
                             f"{y.device}")
        if any(ctx.needs_input_grad[:2]):
            ctx.save_for_backward(y, bias, bits)
            ctx.args = (act_type, p)
        return out

    @staticmethod
    def backward(ctx, g):
        y, bias, bits = ctx.saved_tensors
        act_type, p = ctx.args
        with torch.enable_grad():
            yy = y.detach().requires_grad_()
            bb = bias.detach().requires_grad_()
            out = matmul_epilogue_plain(yy, bb, bits, act_type, p)
            dy, dbias = torch.autograd.grad(out, (yy, bb), g)
        return dy, dbias, None, None, None, None


def matmul_epilogue_2d(y, bias, bits=None, act_type="gelu", p=0.0):
    """2-D entry: ``y`` (R, C), ``bias`` (1, C) (column mode) or (R, 1)
    (row mode), optional uint8 ``bits`` of ``y``'s shape, dropout rate
    ``p`` in [0, 1) (applied only with ``bits`` and ``p > 0``).
    Differentiable in ``y`` and ``bias``."""
    mode = _check(y, bias, bits, act_type, p)
    return _MatmulEpilogue.apply(y, bias, bits, act_type, float(p), mode)


def fused_matmul_epilogue(y, bias, act_type=None, p=0.0, bits=None):
    """N-D entry: ``dropout(act(y + bias))`` with ``bias`` (None means
    zeros) of ``y.shape[-1]`` elements along the last axis; ``bits``, when
    given, has ``y``'s shape."""
    c = y.shape[-1]
    if bias is None:
        bias = torch.zeros(c, dtype=y.dtype, device=y.device)
    if bias.numel() != c:
        raise MXNetError(f"matmul epilogue: bias {tuple(bias.shape)} must "
                         f"have {c} elements (last axis of "
                         f"{tuple(y.shape)})")
    if bits is not None and tuple(bits.shape) != tuple(y.shape):
        raise MXNetError(f"matmul epilogue: bits {tuple(bits.shape)} vs y "
                         f"{tuple(y.shape)}")
    y2 = y.reshape(-1, c)
    out = matmul_epilogue_2d(
        y2, bias.reshape(1, c), None if bits is None else bits.reshape(
            y2.shape), act_type=act_type or "identity", p=p)
    return out.reshape(y.shape)

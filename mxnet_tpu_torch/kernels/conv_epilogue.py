"""K1, the conv epilogue: ``act(scale * y + bias [+ res])``.

Counterpart of ``mxnet_tpu/pallas/kernels.py`` (``_conv_epilogue_ref``,
``_conv_epilogue_call`` and the N-D wrapper ``fused_conv_epilogue``).
The math runs in fp32 and the result is cast back to ``y``'s dtype
(``scale``, ``bias`` and ``res`` are each read at their own dtype);
``act`` is one of identity, relu, exact-erf gelu, tanh, sigmoid.

- :func:`conv_epilogue_plain` is the plain PyTorch version: the CPU
  path, and the yardstick the CUDA kernel is held against on the card.
- :func:`fused_conv_epilogue` is the N-D entry that BatchNorm with an
  activation and the ResNet residual epilogue call. A CPU tensor goes to
  the plain version; a CUDA tensor goes to the hand-written kernel in
  ``csrc/conv_epilogue.cu`` or the call raises. There is no fallback.

The per-channel vectors are indexed in place by the kernel (row mode for
NCHW, column mode for channel-last), so no layout is moved and no vector
is tiled; the residual-only form passes no vectors at all.

The N-D entry is differentiable: a ``torch.autograd.Function`` whose
forward is the kernel (the plain version on the CPU) and whose backward
is the counterpart of ``_ce_res_bwd`` / ``_ce_nores_bwd``, the VJP of
the plain version. The JAX package leaves that VJP to XLA; the port
computes it with PyTorch ops, so the backward launches no kernel of its
own and adds nothing to :data:`launch_count`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..base import MXNetError
from . import _build
from ._common import (ACT_CODE, DTYPE_CODE, EPILOGUE_ACTS, LaunchCount,
                      act_fn, check_cuda_inputs, note_route)

__all__ = ["EPILOGUE_ACTS", "conv_epilogue_plain", "fused_conv_epilogue",
           "fused_conv_epilogue_plain", "launch_count"]

MODE_NONE, MODE_COL, MODE_ROW = 0, 1, 2
launch_count = LaunchCount()     # forward launches; the backward has none


def conv_epilogue_plain(y, scale=None, bias=None, res=None,
                        act_type="relu"):
    """The plain version (``_conv_epilogue_ref``): fp32 math, cast back to
    ``y.dtype``. ``scale``/``bias`` broadcast against ``y`` (None skips
    them: the residual-only form)."""
    out = y.float()
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    if res is not None:
        out = out + res.float()
    return act_fn("conv epilogue", act_type)(out).to(y.dtype)


@functools.cache
def _lib():
    """The built kernel library, its C signatures declared."""
    lib = _build.load("conv_epilogue")
    fn = lib.conv_epilogue_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.conv_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.conv_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def _launch(y, scale, bias, res, act_type, mode, c, inner):
    check_cuda_inputs("conv epilogue kernel", y,
                      (("scale", scale, None), ("bias", bias, None),
                       ("res", res, None)))
    out = torch.empty_like(y, memory_format=torch.contiguous_format)
    n = y.numel()
    if n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = lib.conv_epilogue_launch(
        y.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(),
        n, c, inner, mode, ACT_CODE[act_type], DTYPE_CODE[y.dtype],
        *(DTYPE_CODE[(y if t is None else t).dtype]
          for t in (scale, bias, res)), stream)
    if err != 0:
        raise MXNetError("conv epilogue kernel launch failed: "
                         + lib.conv_epilogue_error_string(err).decode())
    launch_count.add()
    return out


def _layout(x, scale, bias, res, channel_axis, act_type):
    """Validate an N-D call; returns (scale, bias, mode, c, inner, axis)
    with missing vectors filled (ones / zeros) and flattened to (C,)."""
    act_fn("conv epilogue", act_type)
    if res is not None and tuple(res.shape) != tuple(x.shape):
        raise MXNetError(f"conv epilogue: res {tuple(res.shape)} vs x "
                         f"{tuple(x.shape)}")
    if scale is None and bias is None:
        return None, None, MODE_NONE, 1, 1, None
    ax = channel_axis % x.ndim if x.ndim else 0
    c = int(x.shape[ax]) if x.ndim else 1
    if scale is None:
        scale = torch.ones(c, dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros(c, dtype=x.dtype, device=x.device)
    if scale.numel() != c or bias.numel() != c:
        raise MXNetError(f"conv epilogue: scale {tuple(scale.shape)} / "
                         f"bias {tuple(bias.shape)} must have {c} elements "
                         f"(axis {channel_axis} of {tuple(x.shape)})")
    inner = math.prod(x.shape[ax + 1:]) if x.ndim else 1
    mode = MODE_COL if inner == 1 else MODE_ROW
    return scale.reshape(c), bias.reshape(c), mode, c, inner, ax


def fused_conv_epilogue_plain(x, scale=None, bias=None, res=None,
                              channel_axis=-1, act_type="relu"):
    """The plain version of :func:`fused_conv_epilogue`, on any device:
    the vectors broadcast along ``channel_axis``."""
    scale, bias, mode, c, _, ax = _layout(x, scale, bias, res, channel_axis,
                                          act_type)
    if mode != MODE_NONE:
        bshape = [1] * x.ndim
        if x.ndim:
            bshape[ax] = c
        scale, bias = scale.reshape(bshape), bias.reshape(bshape)
    return conv_epilogue_plain(x, scale, bias, res, act_type)


def _forward(y, scale, bias, res, act_type, channel_axis, mode, c, inner):
    note_route("conv_epilogue", y.device)
    # a meta tensor computes nothing: its shape comes from the plain version
    if y.device.type in ("cpu", "meta"):
        return fused_conv_epilogue_plain(y, scale, bias, res, channel_axis,
                                         act_type)
    if y.device.type == "cuda":
        return _launch(y, scale, bias, res, act_type, mode, c, inner)
    raise MXNetError(f"conv epilogue: unsupported device {y.device}")


class _ConvEpilogue(torch.autograd.Function):
    """K1 under autograd: the kernel (plain version on the CPU) forward;
    the backward is the VJP of the plain version. ``scale``/``bias``
    gradients reduce to their (C,) shape over every other axis, in row
    and column mode alike; the ones / zeros that ``_layout`` fills in
    get none."""

    @staticmethod
    def forward(ctx, y, scale, bias, res, act_type, channel_axis, mode, c,
                inner):
        ctx.save_for_backward(y, scale, bias, res)
        ctx.args = (act_type, channel_axis)
        return _forward(y, scale, bias, res, act_type, channel_axis, mode, c,
                        inner)

    @staticmethod
    def backward(ctx, g):
        act_type, channel_axis = ctx.args
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            args = [None if t is None else t.detach().requires_grad_(n)
                    for t, n in zip(ctx.saved_tensors, need)]
            out = fused_conv_epilogue_plain(*args, channel_axis, act_type)
            grads = iter(torch.autograd.grad(
                out, [a for a, n in zip(args, need) if n], g))
        return (*(next(grads) if n else None for n in need),
                None, None, None, None, None)


def fused_conv_epilogue(x, scale=None, bias=None, res=None, channel_axis=-1,
                        act_type="relu"):
    """N-D entry: ``act(scale * x + bias [+ res])``.

    ``scale``/``bias`` are per-channel vectors (``C`` elements) along
    ``channel_axis``, or both None for the residual-only form; one of
    them None means ones / zeros. ``res`` has ``x``'s shape. On a CUDA
    tensor the kernel runs in row mode (channel = (i / inner) % C, e.g.
    NCHW with inner = H*W) or column mode (channel last) over the
    contiguous ``x``; on a CPU tensor the plain version runs.
    Differentiable in ``x``, ``scale``, ``bias`` and ``res``: when
    autograd records and one of them requires grad, the call goes
    through :class:`_ConvEpilogue`; otherwise nothing is saved.
    """
    scale, bias, mode, c, inner, ax = _layout(x, scale, bias, res,
                                              channel_axis, act_type)
    args = (x, scale, bias, res, act_type,
            channel_axis if ax is None else ax, mode, c, inner)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, bias, res)):
        return _ConvEpilogue.apply(*args)
    return _forward(*args)

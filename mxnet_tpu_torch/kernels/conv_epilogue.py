"""K1, the conv epilogue: ``act(scale * y + bias [+ res])``.

Counterpart of ``mxnet_tpu/pallas/kernels.py`` (``_conv_epilogue_ref``,
``_conv_epilogue_call`` and the N-D wrapper ``fused_conv_epilogue``).
The math runs in fp32 and the result is cast back to ``y``'s dtype;
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
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from ..base import MXNetError
from . import _build

__all__ = ["EPILOGUE_ACTS", "conv_epilogue_plain", "fused_conv_epilogue",
           "fused_conv_epilogue_plain", "launch_count"]

EPILOGUE_ACTS = ("identity", "relu", "gelu", "tanh", "sigmoid")
_ACT_CODE = {None: 0, "identity": 0, "relu": 1, "gelu": 2, "tanh": 3,
             "sigmoid": 4}
MODE_NONE, MODE_COL, MODE_ROW = 0, 1, 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class LaunchCount:
    """How many times a wrapper launched its kernel. Only a successful
    launch adds one; the CPU path and the plain version add nothing."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self):
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self):
        with self._lock:
            self._n = 0


launch_count = LaunchCount()


def _act_fn(act_type):
    fns = {
        None: lambda x: x,
        "identity": lambda x: x,
        "relu": torch.relu,
        "gelu": lambda x: torch.nn.functional.gelu(x, approximate="none"),
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
    }
    try:
        return fns[act_type]
    except KeyError:
        raise MXNetError(f"conv epilogue: unknown act_type {act_type!r}; "
                         f"one of {list(EPILOGUE_ACTS)}") from None


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
    return _act_fn(act_type)(out).to(y.dtype)


@functools.cache
def _lib():
    """The built kernel library, its C signatures declared."""
    lib = _build.load("conv_epilogue")
    fn = lib.conv_epilogue_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.conv_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.conv_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(y, scale, bias, res):
    """Raise on anything the kernel does not take."""
    if y.dtype not in _DTYPE_CODE:
        raise MXNetError(f"conv epilogue kernel: dtype {y.dtype} not "
                         f"supported; one of {list(_DTYPE_CODE)}")
    if y.device.index != torch.cuda.current_device():
        raise MXNetError(f"conv epilogue kernel: input on {y.device} but "
                         f"the current device is cuda:"
                         f"{torch.cuda.current_device()}")
    named = (("y", y), ("scale", scale), ("bias", bias), ("res", res))
    for name, t in named:
        if t is None:
            continue
        if t.device != y.device:
            raise MXNetError(f"conv epilogue kernel: {name} on {t.device}, "
                             f"y on {y.device}")
        if t.dtype != y.dtype:
            raise MXNetError(f"conv epilogue kernel: {name} is {t.dtype}, "
                             f"y is {y.dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"conv epilogue kernel: {name} is not "
                             "contiguous")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for _, t in named):
        raise MXNetError("conv epilogue kernel: an input requires grad; the "
                         "kernel has no backward yet (run under "
                         "torch.inference_mode() or torch.no_grad())")


def _launch(y, scale, bias, res, act_type, mode, c, inner):
    _check_cuda_inputs(y, scale, bias, res)
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
        n, c, inner, mode, _ACT_CODE[act_type], _DTYPE_CODE[y.dtype], stream)
    if err != 0:
        raise MXNetError("conv epilogue kernel launch failed: "
                         + lib.conv_epilogue_error_string(err).decode())
    launch_count.add()
    return out


def _layout(x, scale, bias, res, channel_axis, act_type):
    """Validate an N-D call; returns (scale, bias, mode, c, inner, axis)
    with missing vectors filled (ones / zeros) and flattened to (C,)."""
    _act_fn(act_type)
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


def fused_conv_epilogue(x, scale=None, bias=None, res=None, channel_axis=-1,
                        act_type="relu"):
    """N-D entry: ``act(scale * x + bias [+ res])``.

    ``scale``/``bias`` are per-channel vectors (``C`` elements) along
    ``channel_axis``, or both None for the residual-only form; one of
    them None means ones / zeros. ``res`` has ``x``'s shape. On a CUDA
    tensor the kernel runs in row mode (channel = (i / inner) % C, e.g.
    NCHW with inner = H*W) or column mode (channel last) over the
    contiguous ``x``; on a CPU tensor the plain version runs.
    """
    if x.device.type == "cpu":
        return fused_conv_epilogue_plain(x, scale, bias, res, channel_axis,
                                         act_type)
    if x.device.type != "cuda":
        raise MXNetError(f"conv epilogue: unsupported device {x.device}")
    scale, bias, mode, c, inner, _ = _layout(x, scale, bias, res,
                                             channel_axis, act_type)
    return _launch(x, scale, bias, res, act_type, mode, c, inner)

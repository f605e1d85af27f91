"""What the kernels' wrappers share: the activation table of the
epilogues' plain versions, the codes passed to the CUDA sources
(``csrc/epilogue_common.cuh``), the checks before a launch, the launch
count and the route note on the active trace span."""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..observability import trace as _trace

__all__ = ["ACT_CODE", "DTYPE_CODE", "EPILOGUE_ACTS", "LaunchCount",
           "act_fn", "check_cuda_inputs", "note_route", "stream_capturing"]

EPILOGUE_ACTS = ("identity", "relu", "gelu", "tanh", "sigmoid")
ACT_CODE = {None: 0, "identity": 0, "relu": 1, "gelu": 2, "tanh": 3,
            "sigmoid": 4}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ACT_FNS = {
    None: lambda x: x,
    "identity": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def stream_capturing() -> bool:
    """Whether the current stream of this thread is capturing a CUDA
    graph (False without CUDA)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def note_route(name, device) -> None:
    """Annotate the active trace span with ``pallas.<name>``: "cuda" when
    the wrapper launches the hand-written kernel, "plain" when a CPU
    tensor takes the plain version (the counterpart of the reference
    registry's dispatch note). One host-side ``annotate`` call; like the
    reference's, it fires when the program is built, which on the card
    is the capture: a replayed graph runs no Python."""
    _trace.annotate(**{f"pallas.{name}":
                       "cuda" if device.type == "cuda" else "plain"})


class LaunchCount:
    """How many times a wrapper launched its kernel. Only a successful
    launch adds one; the CPU path and the plain version add nothing. A
    launch made while the current stream is capturing a CUDA graph runs
    nothing: it goes to :meth:`captured`, whatever thread made it (the
    capturing thread, or the autograd engine's thread running a captured
    backward on the capture's stream), and the graph adds it to the count
    once per replay (:meth:`add_replayed`). Launches of other threads
    during a capture (a replica serving beside a capturing one) stay in
    the count and out of the graph's."""

    def __init__(self):
        self._n = 0
        self._captured = 0
        self._lock = threading.Lock()

    def add(self, n=1):
        capturing = stream_capturing()
        with self._lock:
            if capturing:
                self._captured += n
            else:
                self._n += n

    def add_replayed(self, n):
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    @property
    def captured(self) -> int:
        return self._captured

    def reset(self):
        with self._lock:
            self._n = 0


def act_fn(what, act_type):
    """The plain version of one activation (exact-erf gelu); ``what``
    names the caller in the error for an unknown one."""
    try:
        return _ACT_FNS[act_type]
    except KeyError:
        raise MXNetError(f"{what}: unknown act_type {act_type!r}; one of "
                         f"{list(EPILOGUE_ACTS)}") from None


def check_cuda_inputs(what, y, named):
    """Raise on anything a kernel does not take. ``named`` lists
    ``(name, tensor or None, dtype)`` beside ``y``; a dtype of None means
    any floating dtype a kernel instantiates (:data:`DTYPE_CODE`): the
    epilogues read each operand at its own precision, as the JAX
    reference does."""
    if y.dtype not in DTYPE_CODE:
        raise MXNetError(f"{what}: dtype {y.dtype} not supported; one of "
                         f"{list(DTYPE_CODE)}")
    if y.device.index != torch.cuda.current_device():
        raise MXNetError(f"{what}: input on {y.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    for name, t, dtype in (("y", y, None), *named):
        if t is None:
            continue
        if t.device != y.device:
            raise MXNetError(f"{what}: {name} on {t.device}, y on "
                             f"{y.device}")
        if dtype is None and t.dtype not in DTYPE_CODE:
            raise MXNetError(f"{what}: {name} is {t.dtype}, want one of "
                             f"{list(DTYPE_CODE)}")
        if dtype is not None and t.dtype != dtype:
            raise MXNetError(f"{what}: {name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise MXNetError(f"{what}: {name} is not contiguous")

"""Device context model (counterpart of ``mxnet_tpu/context.py``).

A :class:`Context` names a logical device, ``cpu`` or ``gpu``, and
resolves to a ``torch.device``. The port's default context is
``gpu(0)``, i.e. ``cuda:0``: entry points run on the card unless the
caller asks for the CPU with ``ctx=cpu()``. Resolving a ``gpu`` context
on a machine without CUDA raises; nothing carries on on the CPU.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "resolve_device"]


class Context:
    """A logical device: ``Context("gpu", 0)``. Comparable, hashable and
    usable as a ``with`` scope that sets the default device (ref:
    python/mxnet/context.py Context.__enter__)."""

    _default = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r}; "
                             "one of 'cpu', 'gpu'")
        self.device_type = device_type
        self.device_id = int(device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __str__(self):
        return f"{self.device_type}({self.device_id})"

    __repr__ = __str__

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names. A ``gpu`` context
        raises when CUDA is unavailable or the index is out of range."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self} requested but no CUDA device is available; pass "
                "ctx=mx.cpu() to run on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(f"{self} out of range: "
                             f"{torch.cuda.device_count()} CUDA devices")
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        if not hasattr(Context._default, "stack"):
            Context._default.stack = []
        Context._default.stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default.stack.pop()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope, else ``gpu(0)``."""
    stack = getattr(Context._default, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)


def resolve_device(ctx=None) -> torch.device:
    """``None`` / :class:`Context` / ``"cpu"`` / ``"cuda:0"`` /
    ``torch.device`` → ``torch.device``. ``None`` means
    :func:`current_context`, which is ``cuda:0`` unless a scope says
    otherwise; a CUDA device on a machine without one raises."""
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context):
        return ctx.torch_device
    dev = torch.device(ctx)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError(f"unsupported device {dev}; use cpu or cuda")
    return Context("gpu", dev.index or 0).torch_device

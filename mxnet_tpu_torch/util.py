"""``mx.util`` — utilities (counterpart of ``mxnet_tpu/util.py``, ref
``python/mxnet/util.py``): the NumPy-semantics switches and decorators
(``np_array``, ``use_np``) and ``getenv``/``setenv``."""
from __future__ import annotations

import functools

from . import numpy_extension as _npx

__all__ = ["is_np_array", "set_np", "reset_np", "use_np", "np_array",
           "getenv", "setenv"]

is_np_array = _npx.is_np_array
set_np = _npx.set_np
reset_np = _npx.reset_np


class np_array:
    """Scoped numpy-semantics activation (ref: util.py np_array) —
    usable as context manager or decorator."""

    def __init__(self, active=True):
        self._active = active
        self._prev = None

    def __enter__(self):
        # save BOTH flags — restoring via set_np() defaults would
        # clobber a caller's set_np(shape=False, array=True) state
        self._prev = dict(_npx._np_mode)
        (_npx.set_np if self._active else _npx.reset_np)()
        return self

    def __exit__(self, *exc):
        _npx.set_np(shape=self._prev["shape"], array=self._prev["array"])

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with np_array(self._active):
                return fn(*args, **kwargs)
        return wrapper


def use_np(fn):
    """Decorator running ``fn`` under numpy semantics (ref: util.py
    use_np; the shape/array split collapses here — one flag). Applied
    to a CLASS, it wraps the methods the reference wraps (__init__,
    forward, hybrid_forward, __call__) and returns the same class, so
    isinstance/subclassing keep working."""
    if isinstance(fn, type):
        for name in ("__init__", "forward", "hybrid_forward",
                     "__call__"):
            meth = fn.__dict__.get(name)
            if callable(meth):
                setattr(fn, name, np_array(True)(meth))
        return fn
    return np_array(True)(fn)


def getenv(name):
    """ref: util.py getenv over MXGetEnv."""
    import os
    return os.environ.get(name)


def setenv(name, value):
    """ref: util.py setenv over MXSetEnv."""
    import os
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = str(value)

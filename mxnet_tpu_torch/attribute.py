"""``mx.AttrScope`` (counterpart of ``mxnet_tpu/attribute.py``, ref
``python/mxnet/attribute.py``): scoped attributes for what is created
inside the scope, nested scopes merged — the reference's mechanism
behind ``ctx_group`` placement hints and custom attributes. ``mx.sym``'s
operators read it: a node made inside the scope carries its attributes
as ``__key__``."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_state = threading.local()


class AttrScope:
    def __init__(self, **kwargs):
        self._attr = {k: str(v) for k, v in kwargs.items()}
        self._old = None

    def get(self, attr=None):
        """Compose current-scope attrs with the given ones."""
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        self._old = getattr(_state, "current", None)
        base = dict(self._old._attr) if self._old else {}
        base.update(self._attr)
        merged = AttrScope()
        merged._attr = base
        _state.current = merged
        return self

    def __exit__(self, *exc):
        _state.current = self._old


def current() -> AttrScope:
    cur = getattr(_state, "current", None)
    return cur if cur is not None else AttrScope()

"""``mx.name`` — the name manager (counterpart of ``mxnet_tpu/name.py``,
ref ``python/mxnet/name.py`` NameManager / Prefix): scoped control over
auto-generated names, used as a ``with`` scope."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]

_state = threading.local()


class NameManager:
    """Assigns unique names per op hint; usable as a with-scope."""

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    def __enter__(self):
        self._old = getattr(_state, "current", None)
        _state.current = self
        return self

    def __exit__(self, *exc):
        _state.current = self._old


class Prefix(NameManager):
    """ref: name.py Prefix — prepends a prefix to every auto name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


def current() -> NameManager:
    cur = getattr(_state, "current", None)
    if cur is None:
        cur = NameManager()
        _state.current = cur
    return cur

"""Crash-consistent file writes: tmp, flush, fsync, ``os.replace``
(counterpart of ``mxnet_tpu/resilience/atomic.py``).

The caller streams into a temp file in the target's directory, which is
fsynced and renamed over the target, so a reader only ever sees the
complete old bytes or the complete new bytes: a preemption in the middle
of ``nd.save`` cannot leave a torn ``.params`` file.

Fault-injection seam: :func:`set_fault_hook` installs a hook consulted
at every named phase (``open``, ``write`` with the bytes written so far,
``fsync``, ``replace``, ``after_replace``, ``dir_fsync``), and at the
points other modules name through :func:`trip` (the commit protocol's
``publish`` and ``gc``). The tests crash a writer at each phase and
check that the previous file or step is still whole.

Cleanup follows real crashes: an ordinary ``Exception`` unlinks the
temp file; a ``BaseException`` (a simulated crash, KeyboardInterrupt)
leaves the torn temp on disk as a dead process would, and
:func:`sweep_tmp` (run by the checkpoint GC) collects it later.

Stdlib only; transient fsync/replace failures go through
:mod:`.retry` (journaled, bounded).
"""
from __future__ import annotations

import contextlib
import itertools
import os

from ..diagnostics.journal import get_journal
from .retry import is_disk_full, note_disk_full, retry_call

__all__ = ["atomic_write", "fsync_dir", "set_fault_hook", "sweep_tmp",
           "trip"]

_TMP_MARK = ".tmp."
# per-call staging suffix <path>.tmp.<pid>.<n>: concurrent writers to
# one path stage into different files, and the last replace wins
_tmp_seq = itertools.count()

_fault_hook = None


def set_fault_hook(hook):
    """Install (or, with None, remove) the process-wide fault hook;
    returns the previous one."""
    global _fault_hook
    prev = _fault_hook
    _fault_hook = hook
    return prev


def trip(point: str, path: str, nbytes: int | None = None,
         size: int | None = None) -> None:
    """Consult the fault hook at a named phase (``nbytes``: bytes already
    written, ``size``: bytes about to be written, at ``write``); nothing
    unless a hook is installed."""
    if _fault_hook is not None:
        _fault_hook(point, path=path, nbytes=nbytes, size=size)


class _Handle:
    """File wrapper that counts the bytes written and trips ``write``."""

    def __init__(self, f, path):
        self._f = f
        self._path = path
        self.nbytes = 0

    def write(self, data):
        trip("write", self._path, nbytes=self.nbytes, size=len(data))
        n = self._f.write(data)
        self.nbytes += len(data)
        return n

    def __getattr__(self, name):
        return getattr(self._f, name)


def fsync_dir(path: str) -> None:
    """Record a rename durably: fsync the parent directory. A failure is
    journaled, not raised: the rename already happened."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return

    def _do_fsync():
        trip("dir_fsync", d)
        os.fsync(fd)

    try:
        retry_call(_do_fsync, what=f"fsync_dir:{d}")
    except OSError as exc:
        get_journal().event("fsync_dir_failed", dir=d,
                            error=type(exc).__name__,
                            detail=str(exc)[:200])
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(path, mode: str = "wb", encoding: str | None = None,
                 durable: bool = True):
    """Write ``path`` all or nothing: yield a handle over
    ``<path>.tmp.<pid>.<n>``; on a clean exit flush, fsync and
    ``os.replace`` it into place (and fsync the directory when
    ``durable``). ``mode`` is a write mode ('wb', 'w'); text mode takes
    ``encoding``."""
    path = os.fspath(path)
    tmp = f"{path}{_TMP_MARK}{os.getpid()}.{next(_tmp_seq)}"
    kwargs = {} if "b" in mode else {"encoding": encoding or "utf-8"}
    try:
        trip("open", tmp)
        f = open(tmp, mode, **kwargs)
    except Exception as exc:
        if is_disk_full(exc):
            note_disk_full(path, op="atomic_write")
        raise

    def _do_fsync():
        trip("fsync", tmp)
        os.fsync(f.fileno())

    def _do_replace():
        trip("replace", path)
        os.replace(tmp, path)

    try:
        try:
            yield _Handle(f, tmp)
            f.flush()
            if durable:
                retry_call(_do_fsync, what=f"fsync:{tmp}")
            else:
                trip("fsync", tmp)
        finally:
            f.close()
        retry_call(_do_replace, what=f"replace:{path}")
        trip("after_replace", path)
        if durable:
            fsync_dir(path)
    except Exception as exc:
        # a recoverable failure leaves no litter; a BaseException (a
        # crash) skips this and leaves the torn temp, as a dead process
        # would. On a full disk the unlink comes first: it frees space
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        if is_disk_full(exc):
            note_disk_full(path, op="atomic_write")
        raise


def sweep_tmp(dirpath: str, prefix: str | None = None) -> list[str]:
    """Remove the ``*.tmp.<pid>.<n>`` litter of crashed writers in
    ``dirpath`` (only names starting with ``prefix``, if given).
    Returns the removed names; a missing directory is a no-op."""
    removed = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return removed
    for name in names:
        if _TMP_MARK not in name:
            continue
        if prefix is not None and not name.startswith(prefix):
            continue
        with contextlib.suppress(OSError):
            os.unlink(os.path.join(dirpath, name))
            removed.append(name)
    return removed

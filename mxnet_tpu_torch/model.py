"""``mx.model`` — epoch checkpoints (counterpart of
``mxnet_tpu/model.py``; ref python/mxnet/model.py).

The reference's pair: ``prefix-symbol.json`` (the graph) and
``prefix-%04d.params`` (the port's ``nd.save`` container, ``arg:`` and
``aux:`` keys), which either package reads. Both files are written
through ``resilience.atomic`` (tmp, fsync, rename) and the container
carries CRCs, so :func:`load_latest_params` (``Module.fit(resume=True)``)
walks the epochs newest first, validating each, and journals a
``ckpt_fallback`` record for every torn or corrupt file it skips.
"""
from __future__ import annotations

import contextlib
import os
import re

from . import ndarray as nd
from .base import MXNetError
from .diagnostics.journal import get_journal

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "list_checkpoint_epochs", "load_latest_params",
           "gc_checkpoints"]

_EPOCH_RE_T = r"^%s-(\d{4,})\.params$"


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """ref: model.py save_checkpoint — atomic; the prefix's directory is
    created if missing."""
    from .observability import trace as _trace
    with _trace.span("ckpt_commit", prefix=prefix, epoch=int(epoch)):
        d = os.path.dirname(prefix)
        if d:
            os.makedirs(d, exist_ok=True)
        if symbol is not None:
            symbol.save(f"{prefix}-symbol.json")
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        nd.save(f"{prefix}-{epoch:04d}.params", save_dict)


def load_params(prefix, epoch):
    """ref: model.py load_params -> (arg_params, aux_params), NDArrays on
    the CPU."""
    loaded = nd.load(f"{prefix}-{epoch:04d}.params")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        kind, _, name = k.partition(":")
        if kind == "arg":
            arg_params[name] = v
        elif kind == "aux":
            aux_params[name] = v
        else:
            raise MXNetError(f"invalid param key {k!r} (want arg:/aux:)")
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """ref: model.py load_checkpoint -> (symbol, arg_params,
    aux_params)."""
    from . import symbol as sym_mod
    symbol = sym_mod.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


def list_checkpoint_epochs(prefix):
    """The epochs of every ``prefix-NNNN.params`` on disk, ascending."""
    d, base = os.path.split(prefix)
    pat = re.compile(_EPOCH_RE_T % re.escape(base))
    try:
        names = os.listdir(d or ".")
    except OSError:
        return []
    return sorted(int(m.group(1)) for n in names
                  for m in [pat.match(n)] if m)


def load_latest_params(prefix):
    """The newest epoch checkpoint that loads, as ``(arg_params,
    aux_params, epoch)``, or None. A torn or corrupt candidate is skipped
    with a journaled ``ckpt_fallback`` record."""
    for epoch in reversed(list_checkpoint_epochs(prefix)):
        try:
            arg_params, aux_params = load_params(prefix, epoch)
            return arg_params, aux_params, epoch
        except MXNetError as e:
            get_journal().event(
                "ckpt_fallback", prefix=prefix, epoch=epoch,
                file=f"{prefix}-{epoch:04d}.params",
                error=type(e).__name__, detail=str(e)[:300])
    return None


def gc_checkpoints(prefix, keep_last):
    """Keep the newest ``keep_last`` epochs (``.params`` and their
    ``.states``) and sweep crashed writers' tmp files beside the prefix;
    the symbol file is shared by the epochs and stays."""
    if not keep_last or keep_last < 1:
        return []
    removed = []
    for epoch in list_checkpoint_epochs(prefix)[:-keep_last]:
        for suffix in (".params", ".states"):
            path = f"{prefix}-{epoch:04d}{suffix}"
            with contextlib.suppress(OSError):
                os.remove(path)
                removed.append(path)
    from .resilience.atomic import sweep_tmp
    d, base = os.path.split(prefix)
    sweep_tmp(d or ".", prefix=base)
    return removed

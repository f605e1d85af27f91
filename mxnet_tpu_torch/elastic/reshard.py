"""Topology-free checkpoint reader: restore a checkpoint that any number
of processes wrote onto the port's one-device trainer (counterpart of
the readers of ``mxnet_tpu/elastic/reshard.py``).

1. **assemble** — read the meta file and every ``.shard0..N-1`` file
   the meta names (never a glob: stale files of an older save must not
   mix in), and paste each piece into a full host tensor per entry.
   Each piece's bytes are CRC-checked by the ``.params`` container, the
   file set by the commit manifest. Coverage is proven: a missing or
   overlapping piece raises naming the entry.
2. **place** — check each full tensor's shape and dtype against the
   live one; the trainer copies it in place.

The reference's placement onto a multi-device mesh (``place_named``)
and the resize loop are ROADMAP Queue 1 items 9 and 13.
"""
from __future__ import annotations

import os

import torch

from .. import ndarray as nd
from ..base import MXNetError, dtype_name
from ..diagnostics.journal import get_journal
from ..parallel import _ckpt

__all__ = ["assemble_entries", "journal_reshard", "place_global",
           "read_global_entries"]


def _parse_idx(ik):
    """``"a:b,c:d"`` -> ((a, b), (c, d)); a scalar's key is ``""``."""
    if not ik:
        return ()
    out = []
    for part in ik.split(","):
        a, b = part.split(":")
        out.append((int(a), int(b)))
    return tuple(out)


def assemble_entries(pieces):
    """``{name: {index key: tensor}}`` -> ``{name: tensor}`` full host
    tensors. Each dimension's extent is the largest piece stop; the
    pieces must cover every element exactly once."""
    out = {}
    for name, per in pieces.items():
        parsed = [(_parse_idx(ik), arr) for ik, arr in per.items()]
        ndim = len(parsed[0][0])
        if any(len(idx) != ndim for idx, _ in parsed):
            raise MXNetError(f"reshard: {name!r} pieces disagree on rank")
        if ndim == 0:
            out[name] = parsed[0][1].reshape(())
            continue
        shape = tuple(max(idx[d][1] for idx, _ in parsed)
                      for d in range(ndim))
        dtype = parsed[0][1].dtype
        full = torch.empty(shape, dtype=dtype)
        covered = 0
        for idx, arr in parsed:
            want = tuple(stop - lo for lo, stop in idx)
            if tuple(arr.shape) != want:
                raise MXNetError(
                    f"reshard: {name!r} piece {idx} is shaped "
                    f"{tuple(arr.shape)}, index says {want} — torn or "
                    "mislabeled shard file")
            if arr.dtype != dtype:
                raise MXNetError(
                    f"reshard: {name!r} pieces disagree on dtype "
                    f"({dtype_name(arr.dtype)} vs {dtype_name(dtype)})")
            full[tuple(slice(lo, stop) for lo, stop in idx)] = arr
            covered += arr.numel()
        if covered != full.numel():
            raise MXNetError(
                f"reshard: {name!r} pieces cover {covered} of "
                f"{full.numel()} elements — the shard set is incomplete "
                "(or overlapping); refusing a partial tensor")
        out[name] = full
    return out


def read_global_entries(fname):
    """(meta, {name: full host tensor}) of a sharded-trainer checkpoint
    file, full-file or per-shard, of any writer topology."""
    meta, loaded = _ckpt.read_meta(fname)
    if not meta["per_shard"]:
        return meta, {k: v for k, v in loaded.items() if k != "__meta__"}
    n_files = int(meta.get("shard_files", 1))
    pieces = {}
    for rank in range(n_files):
        path = f"{fname}.shard{rank}"
        if not os.path.exists(path):
            raise MXNetError(
                f"reshard: per-shard checkpoint incomplete: {path} "
                f"missing (meta says {n_files} shard files)")
        loaded = nd._load_tensors(path)
        if not isinstance(loaded, dict):
            continue             # an empty shard container loads as a list
        for key, arr in loaded.items():
            name, ik = key.rsplit("|", 1)
            pieces.setdefault(name, {}).setdefault(ik, arr)  # replicas
    return meta, assemble_entries(pieces)


def place_global(name, cur, host):
    """``host``, a full tensor for the live ``cur``, its shape and dtype
    checked."""
    if tuple(host.shape) != tuple(cur.shape) or host.dtype != cur.dtype:
        raise MXNetError(
            f"reshard: checkpoint entry {name!r} is "
            f"{dtype_name(host.dtype)}{tuple(host.shape)}, expected "
            f"{dtype_name(cur.dtype)}{tuple(cur.shape)} — architecture or "
            "master_dtype mismatch")
    return host


def journal_reshard(root, step, meta, n_new, entries, consumer):
    """One ``reshard_restore`` record per topology-changing restore."""
    n_old = int(meta.get("shard_files", 1)) if meta.get("per_shard") \
        else 1
    get_journal().event(
        "reshard_restore", root=root, step=int(step), n_old=n_old,
        n_new=int(n_new), entries=len(entries),
        bytes=int(sum(v.numel() * v.element_size()
                      for v in entries.values())),
        consumer=consumer)

"""Checkpoint file machinery of the one-device trainers (counterpart of
``mxnet_tpu/parallel/_ckpt.py``).

Layout: a ``.params`` container (readable by ``nd.load`` in either
package) with a JSON ``__meta__`` entry (uint8 bytes). One process
writes one file. A per-shard checkpoint of the JAX package (a
``<fname>.shard<rank>`` file per process, entries keyed
``<name>|<index>``) is read here; writing one is ROADMAP Queue 1
item 9.

Crash consistency: every file lands through ``nd.save``'s atomic path,
and the directory commit protocol (:func:`commit_checkpoint` /
:func:`restore_checkpoint`, on ``resilience.commit``) stages a step under
``step-N.tmp/``, publishes it behind a CRC manifest and one rename,
moves the ``latest`` pointer, keeps the last k steps, and restores from
the newest step that validates, journaling every step it skips.

A load checks every entry's shape and dtype before it copies anything,
and then copies each into the live tensor in place: a captured CUDA
graph reads its tensors by address, so a load never rebinds one.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import ndarray as nd
from .. import random as _random
from ..base import MXNetError, dtype_name
from ..diagnostics.journal import get_journal
from ..resilience import commit as _commit

CKPT_FORMAT = 1
CKPT_BASENAME = "ckpt"


class LocalGroup:
    """The one process: rank 0 of 1, barriers do nothing (the
    reference's ``JaxGroup`` of a single-process world)."""

    kind = "local"

    def index(self):
        return 0

    def count(self):
        return 1

    def barrier(self, tag):
        pass

    def meta(self):
        return {"world": 1}


_GROUP = LocalGroup()


def group():
    return _GROUP


def full_key(shape):
    """The shard-index key of a piece that covers all of ``shape``
    (the one piece of a one-device layout): ``"0:d0,0:d1"``."""
    return ",".join(f"0:{int(d)}" for d in shape)


def write_entries(fname, entries, meta):
    """Write ``entries`` (name -> tensor) and ``meta`` to one file, each
    tensor copied to the host once."""
    if meta["per_shard"]:
        raise MXNetError("per-shard checkpoint files are written by "
                         "multi-process runs, not ported yet (ROADMAP Queue "
                         "1 item 9); this one-process trainer writes one "
                         "file")
    full = {"__meta__": np.frombuffer(json.dumps(meta).encode("utf-8"),
                                      dtype=np.uint8).copy()}
    full.update(entries)
    nd.save(fname, full)


def read_meta(fname):
    loaded = nd._load_tensors(fname)
    if not isinstance(loaded, dict) or "__meta__" not in loaded:
        raise MXNetError(
            f"{fname}: not a sharded-trainer checkpoint (no __meta__ "
            "entry); eager gluon.Trainer states use Trainer.load_states")
    meta = json.loads(loaded["__meta__"].numpy().tobytes().decode())
    if meta.get("format") != CKPT_FORMAT:
        raise MXNetError(f"{fname}: unsupported checkpoint format "
                         f"{meta.get('format')!r}")
    return meta, loaded


def read_pieces(fname, n_files, needed):
    """Collect the per-shard pieces of the entries ``needed`` (names)
    from exactly the ``.shard0..N-1`` files the saving run wrote.
    Every piece of a needed entry is kept, so that :func:`place_like`
    can tell a changed layout from a missing entry."""
    pieces = {}
    for rank in range(n_files):
        path = f"{fname}.shard{rank}"
        if not os.path.exists(path):
            raise MXNetError(
                f"per-shard checkpoint incomplete: {path} missing "
                f"(meta says {n_files} shard files)")
        loaded = nd._load_tensors(path)
        if not isinstance(loaded, dict):
            continue             # an empty shard container loads as a list
        for key, arr in loaded.items():
            name, ik = key.rsplit("|", 1)
            if name in needed:
                pieces.setdefault(name, {})[ik] = arr
    return pieces


def place_like(name, cur, loaded, pieces):
    """The host tensor that goes into ``cur``, from the full-file
    entries or the per-shard pieces, its shape and dtype checked against
    ``cur``'s (the reference's messages)."""
    if pieces is None:
        if name not in loaded:
            raise MXNetError(f"checkpoint is missing entry {name!r}")
        host = loaded[name]
        if tuple(host.shape) != tuple(cur.shape) or host.dtype != cur.dtype:
            raise MXNetError(
                f"checkpoint entry {name!r} is "
                f"{dtype_name(host.dtype)}{tuple(host.shape)}, expected "
                f"{dtype_name(cur.dtype)}{tuple(cur.shape)} — architecture "
                "or master_dtype mismatch")
        return host
    per = pieces.get(name)
    if per is None:
        raise MXNetError(f"per-shard checkpoint is missing {name!r}")
    piece = per.get(full_key(cur.shape))
    if piece is None:
        raise MXNetError(
            f"{name!r}: no saved piece for shard {full_key(cur.shape)!r} — "
            "mesh or sharding layout changed since save")
    if piece.dtype != cur.dtype:
        raise MXNetError(
            f"checkpoint piece {name!r} is {dtype_name(piece.dtype)}, "
            f"expected {dtype_name(cur.dtype)} — master_dtype mismatch")
    return piece


def copy_into(pairs):
    """Copy each checked host tensor into its live tensor, in place."""
    with torch.no_grad():
        for cur, host in pairs:
            cur.copy_(host)


# -- the dropout generator's state -------------------------------------------
def _rng_impl(device):
    """The port's generator algorithm on ``device``: the meta's
    ``rng_impl`` (the JAX package writes its key implementation's)."""
    return "torch-philox" if torch.device(device).type == "cuda" \
        else "torch-mt19937"


def rng_meta(device):
    """The meta's RNG keys: the state of ``device``'s dropout generator
    (``random.device_generator``), as bytes."""
    state = _random.device_generator(device).get_state()
    return {"rng_impl": _rng_impl(device),
            "rng_data": [int(v) for v in state.tolist()],
            "rng_shape": list(state.shape)}


def restore_rng(meta, device, source):
    """Put ``device``'s dropout generator back to the meta's state. A
    state of another implementation (a JAX key, another device type)
    leaves the generator as it is and journals ``rng_not_restored``;
    weights, state and count resume all the same."""
    impl = meta.get("rng_impl")
    if impl != _rng_impl(device):
        get_journal().event("rng_not_restored", source=str(source),
                            rng_impl=impl, want=_rng_impl(device))
        return False
    state = torch.tensor(meta["rng_data"], dtype=torch.uint8).reshape(
        meta["rng_shape"])
    _random.device_generator(device).set_state(state)
    return True


# -- directory commit protocol -----------------------------------------------
_NO_VALID, _PINNED_BAD = -1, -2


def commit_checkpoint(root, step, save_cb, keep_last=None):
    """Commit-protocol save: ``save_cb(prefix)`` writes the step's files
    under ``<root>/step-N.tmp/``; then the CRC manifest, the one publish
    rename, the ``latest`` pointer and keep-last-k retention. A step
    that is already committed and valid is not written again."""
    g = group()
    step = int(step)
    try:
        _commit.validate_step(root, step)
        already = True          # e.g. restore -> immediate re-checkpoint
    except ValueError:
        already = False
    if already:
        get_journal().event("ckpt_skip_existing", root=root, step=step)
        return step
    _commit.prepare_stage(root, step)
    save_cb(os.path.join(_commit.stage_dir(root, step), CKPT_BASENAME))
    _commit.finalize(root, step, keep_last=keep_last, meta=g.meta())
    get_journal().event("ckpt_committed", root=root, step=step)
    return step


def restore_checkpoint(root, load_cb, step=None):
    """Resume from ``root``: a pinned ``step`` must validate; otherwise
    the newest valid committed step wins, and every corrupt or torn step
    skipped on the way is journaled as ``ckpt_fallback``."""
    def _skip(s, reason):
        get_journal().event("ckpt_fallback", root=root, step=s,
                            detail=reason[:300])

    found, pinned_err = _NO_VALID, ""
    if step is not None:
        try:
            _commit.validate_step(root, int(step))
            found = int(step)
        except ValueError as e:
            found, pinned_err = _PINNED_BAD, str(e)
    else:
        got = _commit.find_restorable(root, on_skip=_skip)
        if got is not None:
            found = got[0]
    if found == _PINNED_BAD:
        raise MXNetError(f"checkpoint step {step} under {root!r} failed "
                         f"validation: {pinned_err}")
    if found == _NO_VALID:
        raise MXNetError(
            f"no valid committed checkpoint under {root!r} — nothing "
            "to restore (uncommitted step-*.tmp staging dirs and "
            "corrupt steps are ignored)")
    load_cb(os.path.join(_commit.step_dir(root, found), CKPT_BASENAME))
    get_journal().event("ckpt_restored", root=root, step=found)
    return found

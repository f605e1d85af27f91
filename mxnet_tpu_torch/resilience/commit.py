"""Directory-granular commit protocol for multi-file checkpoints
(counterpart of ``mxnet_tpu/resilience/commit.py``).

Every multi-file save has one commit point, so a reader never picks up a
checkpoint that was not completely written.

Layout under a checkpoint root::

    <root>/step-00000042.tmp/   staging: readers ignore it
    <root>/step-00000042/       committed: holds MANIFEST.json
    <root>/latest               pointer file (a hint; re-validated)

Writer protocol (one writer per root):

1. ``prepare_stage`` (wipes a half-written stage of a crashed attempt
   at the same step);
2. the caller writes its files into the stage through ``atomic_write``;
3. ``finalize``: writes ``MANIFEST.json`` (file list, CRC32s, sizes,
   step, caller meta) atomically inside the stage, renames the stage to
   ``step-N/`` (the commit point: a visible step directory always holds
   a complete manifest), rewrites ``latest``, then collects garbage:
   keep-last-k committed steps, stale ``*.tmp`` stages and temp files.

Reader protocol: every committed step newest first; a directory whose
manifest is missing or corrupt, or whose files fail their CRC, is
skipped (reported to the caller) and the next newest tried.

``finalize`` and ``find_restorable`` run inside ``observability.trace``
spans (``ckpt_commit`` with root and step, ``ckpt_restore_scan`` with
root and the ``restored_step`` it found), as the reference's do. Stdlib
only.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor

from . import atomic

__all__ = ["MANIFEST", "committed_steps", "doctor_report", "file_crc",
           "finalize", "find_restorable", "gc_steps", "prepare_stage",
           "read_latest", "read_manifest", "stage_dir", "step_dir",
           "validate_step", "write_latest", "write_manifest"]

MANIFEST = "MANIFEST.json"
LATEST = "latest"
FORMAT = 1

_STEP_RE = re.compile(r"^step-(\d{8})$")


def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step-{int(step):08d}")


def stage_dir(root: str, step: int) -> str:
    return step_dir(root, step) + ".tmp"


def prepare_stage(root: str, step: int) -> str:
    """A fresh staging directory for ``step``; a half-written stage of a
    crashed attempt at the same step is wiped."""
    s = stage_dir(root, step)
    if os.path.isdir(s):
        shutil.rmtree(s)
    os.makedirs(s, exist_ok=True)
    return s


_CRC_SLICE = 32 << 20            # bytes one thread checksums at a time
CRC_THREADS = min(8, os.cpu_count() or 1)
_CRC_POLY = 0xEDB88320           # CRC-32's polynomial, bit-reflected


def _gf2_mul(a: int, b: int) -> int:
    """a * b modulo the CRC-32 polynomial, bit-reflected (zlib's
    ``multmodp``)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ _CRC_POLY if b & 1 else b >> 1


_X2N = [1 << 30]                 # x^(2^k) modulo the polynomial, k < 32
for _ in range(31):
    _X2N.append(_gf2_mul(_X2N[-1], _X2N[-1]))


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of A + B from crc32(A), crc32(B) and len(B) (zlib's
    ``crc32_combine``: crc1 times x^(8 len2), plus crc2)."""
    p, n, k = 1 << 31, len2, 3
    while n:
        if n & 1:
            p = _gf2_mul(_X2N[k & 31], p)
        n >>= 1
        k += 1
    return _gf2_mul(p, crc1) ^ crc2


def _range_crc(fd: int, start: int, n: int, chunksize: int = 1 << 22):
    """(crc32, bytes read) of ``n`` bytes of ``fd`` from ``start``."""
    buf = memoryview(bytearray(min(chunksize, max(n, 1))))
    crc, done = 0, 0
    while done < n:
        got = os.preadv(fd, [buf[:min(len(buf), n - done)]], start + done)
        if got <= 0:
            break
        crc = zlib.crc32(buf[:got], crc)
        done += got
    return crc, done


def _pread_crc(fd: int, start: int, buf):
    """(crc32, bytes read) of filling the byte buffer ``buf`` from ``fd``
    at ``start``."""
    crc, done = 0, 0
    while done < len(buf):
        got = os.preadv(fd, [buf[done:]], start + done)
        if got <= 0:
            break
        crc = zlib.crc32(buf[done:done + got], crc)
        done += got
    return crc, done


def read_into_crc(pool, fd: int, start: int, buf,
                  slice_bytes: int = 2 << 20):
    """Fill the writable byte buffer ``buf`` from ``fd`` at ``start``, its
    slices read and checksummed on ``pool``'s threads. Returns (crc32 of
    what was read, bytes read); the count stops at the first short
    slice."""
    n = len(buf)
    if n <= slice_bytes:
        crc, done = _pread_crc(fd, start, buf)
        return crc & 0xFFFFFFFF, done
    offs = range(0, n, slice_bytes)
    results = [f.result() for f in [
        pool.submit(_pread_crc, fd, start + off, buf[off:off + slice_bytes])
        for off in offs]]
    crc, done = 0, 0
    for off, (c, got) in zip(offs, results):
        crc, done = crc32_combine(crc, c, got), done + got
        if got < min(slice_bytes, n - off):
            break
    return crc & 0xFFFFFFFF, done


def _files_crc(paths) -> list[tuple[int, int]]:
    """(crc32, size) of each file's bytes. Slices of ``_CRC_SLICE`` bytes
    are checksummed on up to ``CRC_THREADS`` threads (``zlib.crc32``
    lets go of the GIL) and combined in order: a checkpoint of a few
    GB is read at several times one core's CRC rate."""
    fds = []
    try:
        for path in paths:
            fds.append(os.open(path, os.O_RDONLY))
        slices = [[(off, min(_CRC_SLICE, size - off))
                   for off in range(0, size, _CRC_SLICE)]
                  for size in (os.fstat(fd).st_size for fd in fds)]
        with ThreadPoolExecutor(max(1, min(CRC_THREADS,
                                           sum(map(len, slices))))) as ex:
            parts = [[ex.submit(_range_crc, fd, off, n) for off, n in sl]
                     for fd, sl in zip(fds, slices)]
            out = []
            for futures in parts:
                crc, size = 0, 0
                for fut in futures:
                    c, n = fut.result()
                    crc, size = crc32_combine(crc, c, n), size + n
                out.append((crc & 0xFFFFFFFF, size))
        return out
    finally:
        for fd in fds:
            os.close(fd)


def file_crc(path: str):
    """(crc32, size) of a file's bytes."""
    return _files_crc([path])[0]


def _payload_files(dirpath: str) -> list[str]:
    """The regular files of a step directory that belong to the
    checkpoint: not the manifest, not a crashed writer's temp file."""
    out = []
    for name in sorted(os.listdir(dirpath)):
        if name == MANIFEST or atomic._TMP_MARK in name:
            continue
        if os.path.isfile(os.path.join(dirpath, name)):
            out.append(name)
    return out


def write_manifest(dirpath: str, step: int, meta: dict | None = None):
    """Checksum every payload file of ``dirpath`` and write the manifest
    atomically. Returns the manifest."""
    names = _payload_files(dirpath)
    files = {name: {"crc32": crc, "size": size} for name, (crc, size) in
             zip(names, _files_crc([os.path.join(dirpath, n)
                                    for n in names]))}
    if not files:
        raise ValueError(f"{dirpath}: nothing staged — refusing to "
                         "commit an empty checkpoint")
    doc = {"format": FORMAT, "step": int(step), "files": files,
           "meta": meta or {}}
    with atomic.atomic_write(os.path.join(dirpath, MANIFEST), "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return doc


def read_manifest(dirpath: str) -> dict:
    """Parse and check a step directory's manifest; ValueError naming
    the defect for anything short of a well-formed one."""
    path = os.path.join(dirpath, MANIFEST)
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        raise ValueError(f"no manifest ({e.strerror or e})") from e
    except ValueError as e:
        raise ValueError(f"manifest not valid JSON ({e})") from e
    if not isinstance(doc, dict) or doc.get("format") != FORMAT \
            or not isinstance(doc.get("files"), dict) \
            or not isinstance(doc.get("step"), int):
        raise ValueError("manifest malformed or unsupported format")
    return doc


def validate_step(root: str, step: int) -> dict:
    """Prove a committed step intact: its manifest well-formed, every
    listed file present with the listed size and CRC32. Returns the
    manifest; ValueError naming the defect otherwise."""
    d = step_dir(root, step)
    doc = read_manifest(d)
    if doc["step"] != int(step):
        raise ValueError(f"manifest step {doc['step']} != dir step {step}")
    present = [name for name in doc["files"]
               if os.path.isfile(os.path.join(d, name))]
    crcs = dict(zip(present,
                    _files_crc([os.path.join(d, n) for n in present])))
    for name, want in doc["files"].items():
        if name not in crcs:
            raise ValueError(f"missing file {name!r}")
        crc, size = crcs[name]
        if size != want.get("size"):
            raise ValueError(f"{name!r}: size {size} != manifest "
                             f"{want.get('size')}")
        if crc != want.get("crc32"):
            raise ValueError(f"{name!r}: CRC mismatch (torn or corrupt)")
    return doc


def committed_steps(root: str) -> list[int]:
    """The steps of the committed directories, ascending (staging
    directories do not match)."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    steps = []
    for name in names:
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def write_latest(root: str, step: int) -> None:
    with atomic.atomic_write(os.path.join(root, LATEST), "w") as f:
        f.write(f"step-{int(step):08d}\n")


def read_latest(root: str) -> int | None:
    """The ``latest`` pointer's step, or None when it is absent or
    garbled (a hint: it never blocks a restore)."""
    try:
        with open(os.path.join(root, LATEST), encoding="utf-8") as f:
            m = _STEP_RE.match(f.read().strip())
            return int(m.group(1)) if m else None
    except OSError:
        return None


def gc_steps(root: str, keep_last: int | None) -> list[int]:
    """Drop the committed steps beyond the newest ``keep_last`` and sweep
    stale staging directories and temp files. Returns the removed steps.
    ``keep_last`` < 2 keeps no fallback behind the newest step."""
    atomic.trip("gc", root)
    removed = []
    steps = committed_steps(root)
    if keep_last is not None and keep_last >= 1:
        for step in steps[:-keep_last]:
            atomic.trip("gc", step_dir(root, step))
            shutil.rmtree(step_dir(root, step), ignore_errors=True)
            removed.append(step)
    newest = steps[-1] if steps else -1
    try:
        names = os.listdir(root)
    except OSError:
        return removed
    for name in names:
        # a stage not newer than the newest commit is a crashed attempt
        if name.endswith(".tmp") and _STEP_RE.match(name[:-4]):
            if int(_STEP_RE.match(name[:-4]).group(1)) <= newest:
                atomic.trip("gc", os.path.join(root, name))
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        elif name.startswith(".trash-"):
            # a recommit's moved-aside predecessor, redundant once a
            # newer commit exists
            atomic.trip("gc", os.path.join(root, name))
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    atomic.sweep_tmp(root)
    return removed


def finalize(root: str, step: int, meta: dict | None = None,
             keep_last: int | None = None) -> dict:
    """Commit a staged step: manifest, publish rename, ``latest``
    pointer, GC. The rename is the one commit point; every phase before
    it leaves the previous checkpoint untouched."""
    from ..observability import trace as _trace
    with _trace.span("ckpt_commit", root=root, step=int(step)):
        return _finalize(root, step, meta, keep_last)


def _finalize(root, step, meta, keep_last) -> dict:
    stage = stage_dir(root, step)
    doc = write_manifest(stage, step, meta)
    dst = step_dir(root, step)
    trash = None
    if os.path.isdir(dst):
        # a recommit of the same step: the committed copy moves aside
        # (intact across a crash) until the new one has landed
        trash = os.path.join(root, f".trash-{os.path.basename(dst)}"
                                   f"-{os.getpid()}")
        if os.path.isdir(trash):
            shutil.rmtree(trash)
        os.rename(dst, trash)
    atomic.trip("publish", dst)
    os.rename(stage, dst)
    atomic.fsync_dir(dst)
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)
    write_latest(root, step)
    gc_steps(root, keep_last)
    return doc


def find_restorable(root: str, on_skip=None):
    """The newest committed step that validates, as ``(step,
    manifest)``, or None. Each invalid candidate is reported through
    ``on_skip(step, reason)``.

    Not driven by the ``latest`` pointer: it is written after the
    publish rename, so a crash between the two leaves it one step
    stale."""
    from ..observability import trace as _trace
    with _trace.span("ckpt_restore_scan", root=root) as sp:
        for step in sorted(committed_steps(root), reverse=True):
            try:
                doc = validate_step(root, step)
                sp.set_attrs(restored_step=step)
                return step, doc
            except ValueError as e:
                if on_skip is not None:
                    on_skip(step, str(e))
        sp.set_attrs(restored_step=None)
    return None


def doctor_report(root: str) -> dict:
    """A health summary of a checkpoint root: pointer, committed steps,
    whether the newest is valid, and the step a restore would take."""
    steps = committed_steps(root)
    report = {"root": root, "exists": os.path.isdir(root),
              "committed_steps": len(steps),
              "latest_pointer": read_latest(root)}
    newest = steps[-1] if steps else None
    report["newest_step"] = newest
    if newest is not None:
        try:
            validate_step(root, newest)
            report["newest_valid"] = True
        except ValueError as e:
            report["newest_valid"] = False
            report["newest_error"] = str(e)
    skipped = []
    found = find_restorable(root, on_skip=lambda s, r: skipped.append(s))
    report["restorable_step"] = found[0] if found else None
    if skipped:
        report["skipped_steps"] = skipped
    return report

"""``nd.save`` / ``nd.load``: the ``.params`` container (counterpart of
``mxnet_tpu/ndarray/ndarray.py`` save/load, ref
``src/ndarray/ndarray.cc`` NDArray::Save/Load). The NDArray class itself
is ROADMAP Queue 1 item 6: here the arrays are ``torch.Tensor``s.

Layout, little-endian, byte for byte the JAX package's::

    <Q 0x112> <Q flag>  <Q count>
    count x entry:  <I 0xF993FAC9> <I rank> rank x <q dim>
                    <i device type> <i device id> <i dtype code>
                    raw bytes  [<I crc32 of the entry>   (flag 1)]
    <Q names> names x (<Q length> utf-8 bytes)
    (flag 1) footer: <Q body length> <I crc32 of the name table>
                     <I 0> <Q "MXTP CRC3">

Flag 1 is what :func:`save` writes: every entry is followed by its
CRC32 and the footer proves the file whole up front. Files of flag 0
(the reference's) still load, without the checksum proof. Every read
is bounds-checked: truncation or corruption raises an ``MXNetError``
naming the defect, never ``struct.error`` or silent garbage.

bfloat16 (dtype code 12) goes through torch: its bytes are written and
read as 16-bit integers and viewed as ``torch.bfloat16``.
"""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..base import MXNetError, dtype_name
from ..resilience import commit as _commit
from ..resilience.atomic import atomic_write

__all__ = ["load", "save"]

_LIST_MAGIC = 0x112          # kMXAPINDArrayListMagic
_ND_MAGIC = 0xF993FAC9       # NDArray binary magic (v2)
_FOOTER_MAGIC = 0x4D585450_43524333   # "MXTP CRC3"
_FMT_LEGACY, _FMT_CRC = 0, 1
_FOOTER_BYTES = 24           # <Q body_len> <I names_crc> <I 0> <Q magic>

_DTYPE_CODE = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
               "int32": 4, "int8": 5, "int64": 6, "bool": 7, "bfloat16": 12}
_CODE_DTYPE = {v: k for k, v in _DTYPE_CODE.items()}
_DEV_CPU, _DEV_GPU = 1, 2    # Context.devstr2type of "cpu" and "gpu"


def _host(arr):
    """(numpy array of the bytes to write, dtype name, device type, device
    id) of a tensor or a numpy array. A bfloat16 array's bytes come as
    16-bit integers."""
    if isinstance(arr, torch.Tensor):
        dev = arr.device
        typ, idx = ((_DEV_GPU, dev.index or 0) if dev.type == "cuda"
                    else (_DEV_CPU, 0))
        t = arr.detach().cpu().contiguous()
        name = dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), name, typ, idx
        return t.numpy(), name, typ, idx
    a = np.asarray(arr, order="C")
    name = a.dtype.name
    if name == "bfloat16":                  # an ml_dtypes array
        a = a.view(np.uint16)
    return a, name, _DEV_CPU, 0


def save(fname, data):
    """Save tensors or numpy arrays (a list, or a str -> array dict) to a
    ``.params`` file, atomically: a crash leaves the previous file or the
    new one, never a torn mix."""
    if isinstance(data, (torch.Tensor, np.ndarray)):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    with atomic_write(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, _FMT_CRC))
        f.write(struct.pack("<Q", len(arrays)))
        for arr in arrays:
            crc = _write_entry(f, arr)
            f.write(struct.pack("<I", crc))
        tail = [struct.pack("<Q", len(names))]
        for n in names:
            b = n.encode("utf-8")
            tail.append(struct.pack("<Q", len(b)))
            tail.append(b)
        tail_bytes = b"".join(tail)
        f.write(tail_bytes)
        # f.nbytes: the atomic handle's running byte count = body length
        f.write(struct.pack("<QIIQ", f.nbytes,
                            zlib.crc32(tail_bytes) & 0xFFFFFFFF, 0,
                            _FOOTER_MAGIC))


def _write_entry(f, arr) -> int:
    """Serialize one array; returns the CRC32 of the entry's bytes."""
    host, name, dev_type, dev_id = _host(arr)
    if name not in _DTYPE_CODE:
        raise MXNetError(f"nd.save: dtype {name!r} has no .params dtype "
                         f"code (supported: {sorted(_DTYPE_CODE)})")
    pieces = [struct.pack("<I", _ND_MAGIC),
              struct.pack("<I", host.ndim)]
    for s in host.shape:
        pieces.append(struct.pack("<q", s))
    pieces.append(struct.pack("<ii", dev_type, dev_id))
    pieces.append(struct.pack("<i", _DTYPE_CODE[name]))
    pieces.append(host.reshape(-1).view(np.uint8))   # the bytes, no copy
    crc = 0
    for piece in pieces:
        f.write(piece)
        crc = zlib.crc32(piece, crc)
    return crc & 0xFFFFFFFF


class _BoundedReader:
    """Bounds-checked reads over the container body: a short or
    out-of-bounds read is a truncation error, never struct.error. Can
    accumulate a CRC over what it reads."""

    def __init__(self, f, fname, limit, pool):
        self._f = f
        self._fname = fname
        self._limit = limit
        self._pool = pool
        self._crc = None

    def _check(self, n, what):
        if n < 0 or self._f.tell() + n > self._limit:
            raise MXNetError(
                f"{self._fname}: truncated or corrupt .params file — "
                f"{what} wants {n} bytes but only "
                f"{max(self._limit - self._f.tell(), 0)} remain (was the "
                "save interrupted?)")

    def read(self, n, what):
        self._check(n, what)
        data = self._f.read(n)
        if len(data) != n:
            raise MXNetError(
                f"{self._fname}: truncated .params file — short read "
                f"({len(data)}/{n} bytes) for {what}")
        if self._crc is not None:
            self._crc = zlib.crc32(data, self._crc)
        return data

    def read_into(self, buf, what):
        """Fill the writable byte buffer ``buf`` from the file: the bytes
        land where they are kept, read and checksummed in slices on the
        reader's threads."""
        n = len(buf)
        self._check(n, what)
        start = self._f.tell()
        crc, got = _commit.read_into_crc(self._pool, self._f.fileno(),
                                         start, buf)
        self._f.seek(start + got)
        if got != n:
            raise MXNetError(
                f"{self._fname}: truncated .params file — short read "
                f"({got}/{n} bytes) for {what}")
        if self._crc is not None:
            self._crc = _commit.crc32_combine(self._crc, crc, got)

    def unpack(self, fmt, what):
        return struct.unpack(fmt, self.read(struct.calcsize(fmt), what))

    def begin_crc(self):
        self._crc = 0

    def end_crc(self) -> int:
        crc, self._crc = self._crc, None
        return crc & 0xFFFFFFFF

    def tell(self):
        return self._f.tell()


def load(fname):
    """Load a ``.params`` file: a list of CPU tensors, or a dict when the
    file names them. Integrity is proven up front for flag-1 files
    (footer, per-entry CRC32); a defect raises ``MXNetError`` naming
    it."""
    with open(fname, "rb") as f, \
            ThreadPoolExecutor(_commit.CRC_THREADS) as pool:
        size = os.fstat(f.fileno()).st_size
        if size < 24:
            raise MXNetError(f"{fname}: truncated .params file — "
                             f"{size} bytes is smaller than any header")
        magic, fmt = struct.unpack("<QQ", f.read(16))
        if magic != _LIST_MAGIC:
            raise MXNetError(f"{fname}: bad magic {magic:#x} — not an "
                             "NDArray save file")
        names_crc = None
        if fmt == _FMT_CRC:
            if size < 16 + _FOOTER_BYTES:
                raise MXNetError(f"{fname}: truncated .params file — "
                                 "no room for the integrity footer")
            limit = size - _FOOTER_BYTES
            f.seek(limit)
            body_len, names_crc, _resv, fmagic = struct.unpack(
                "<QIIQ", f.read(_FOOTER_BYTES))
            if fmagic != _FOOTER_MAGIC or body_len != limit:
                raise MXNetError(
                    f"{fname}: truncated or corrupt .params file — "
                    "footer missing or inconsistent (the save was "
                    "interrupted before commit)")
            f.seek(16)
        elif fmt == _FMT_LEGACY:
            limit = size
        else:
            raise MXNetError(f"{fname}: unsupported .params format flag "
                             f"{fmt} — written by a newer version?")
        verify = fmt == _FMT_CRC
        r = _BoundedReader(f, fname, limit, pool)
        (count,) = r.unpack("<Q", "array count")
        if count > limit:
            raise MXNetError(f"{fname}: corrupt .params file — implausible "
                             f"array count {count}")
        arrays = [_read_entry(r, verify, fname, i) for i in range(count)]
        if verify:
            r.begin_crc()
        (n_names,) = r.unpack("<Q", "name count")
        if n_names > limit:
            raise MXNetError(f"{fname}: corrupt .params file — implausible "
                             f"name count {n_names}")
        names = []
        for i in range(n_names):
            (ln,) = r.unpack("<Q", f"name {i} length")
            try:
                names.append(r.read(ln, f"name {i}").decode("utf-8"))
            except UnicodeDecodeError as e:
                raise MXNetError(f"{fname}: corrupt .params file — "
                                 f"name {i} is not valid UTF-8") from e
        if verify:
            if r.end_crc() != names_crc:
                raise MXNetError(f"{fname}: checksum mismatch in the name "
                                 "table — the file is corrupt")
            if r.tell() != limit:
                raise MXNetError(
                    f"{fname}: corrupt .params file — "
                    f"{limit - r.tell()} unexpected trailing bytes")
    if names:
        return dict(zip(names, arrays))
    return arrays


def _read_entry(r, verify, fname, index) -> torch.Tensor:
    what = f"array entry {index}"
    r.begin_crc()
    (magic,) = r.unpack("<I", what)
    if magic != _ND_MAGIC:
        raise MXNetError(f"{fname}: corrupt NDArray entry {index} "
                         f"(bad entry magic {magic:#x})")
    (ndim,) = r.unpack("<I", what)
    if ndim > 64:
        raise MXNetError(f"{fname}: corrupt NDArray entry {index} — "
                         f"implausible rank {ndim}")
    shape = tuple(r.unpack("<q", what)[0] for _ in range(ndim))
    if any(s < 0 for s in shape):
        raise MXNetError(f"{fname}: corrupt NDArray entry {index} — "
                         f"negative dimension in shape {shape}")
    r.unpack("<ii", what)                    # device type and id
    (dtype_code,) = r.unpack("<i", what)
    dt = _CODE_DTYPE.get(dtype_code)
    if dt is None:
        raise MXNetError(
            f"{fname}: unknown dtype code {dtype_code} in entry {index} "
            "— file from a newer format or corrupt (refusing to guess "
            "a dtype)")
    count = int(np.prod(shape)) if ndim else 1
    npdt = np.dtype(np.int16 if dt == "bfloat16" else dt)
    raw = np.empty(shape, dtype=npdt)
    r.read_into(memoryview(raw.reshape(-1).view(np.uint8)), what + " data")
    crc = r.end_crc()
    if verify:
        (want,) = r.unpack("<I", what + " checksum")
        if crc != want:
            raise MXNetError(
                f"{fname}: checksum mismatch in entry {index} "
                f"(stored {want:#010x}, computed {crc:#010x}) — the "
                "file is corrupt")
    out = torch.from_numpy(raw)
    return out.view(torch.bfloat16) if dt == "bfloat16" else out

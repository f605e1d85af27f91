"""The port's ``.params`` container (mxnet_tpu_torch/ndarray) against the
JAX package's ``nd.save``/``nd.load``, on the CPU.

- The port's ``save`` of CPU tensors is byte-identical to the JAX
  ``nd.save`` of the same numpy arrays, for every dtype code (bfloat16
  through torch, not ml_dtypes), rank 0, an empty dimension, a list and
  a dict; each package loads the other's file bit for bit (the JAX side
  under ``jax.enable_x64``, so that its NDArray keeps 64-bit dtypes).
- The reference's corruptions (truncation, bad magic, format flag, entry
  CRC, name-table CRC, unknown dtype code, implausible rank and count,
  trailing bytes, a torn footer) raise ``MXNetError`` naming the same
  defect in both packages; a legacy flag-0 file loads in both.
- ``Block.save_parameters`` writes that container: the JAX package's
  ``load_parameters`` reads the port's file, and the port reads the JAX
  package's.
"""
import struct
import zlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.base import MXNetError

DTYPES = ["float32", "float64", "float16", "bfloat16", "uint8", "int8",
          "int32", "int64", "bool"]
_LIST_MAGIC, _ND_MAGIC = 0x112, 0xF993FAC9


def _np(dtype, shape, seed):
    rng = np.random.RandomState(seed)
    a = np.asarray(40 * rng.randn(*shape))
    if dtype == "bfloat16":
        return a.astype(ml_dtypes.bfloat16)
    return np.asarray(a > 0) if dtype == "bool" else a.astype(dtype)


def _torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """(dtype name, raw bytes) of an NDArray (its tensor), a tensor or a
    numpy array."""
    if isinstance(t, tnd.NDArray):
        t = t.handle
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().tobytes()
        return str(t.dtype).replace("torch.", ""), t.numpy().tobytes()
    return t.dtype.name, np.ascontiguousarray(t).view(np.uint8).tobytes()


def _cases(kind):
    """The arrays of one case: each dtype at rank 2, rank 0 and with an
    empty dimension, as a dict; or a list of mixed dtypes."""
    if kind == "list":
        return [_np(d, (3, 2), i) for i, d in enumerate(DTYPES)]
    return {"w": _np(kind, (3, 5), 0), "scalar": _np(kind, (), 1),
            "empty": _np(kind, (0, 4), 2)}


def _jax_save(path, arrays):
    with jax.enable_x64(True):
        if isinstance(arrays, dict):
            jmx.nd.save(path, {k: jmx.nd.NDArray(v)
                               for k, v in arrays.items()})
        else:
            jmx.nd.save(path, [jmx.nd.NDArray(v) for v in arrays])


def _jax_load(path):
    with jax.enable_x64(True):
        out = jmx.nd.load(path)
        if isinstance(out, dict):
            return {k: v.asnumpy() for k, v in out.items()}
        return [v.asnumpy() for v in out]


@pytest.mark.parametrize("kind", DTYPES + ["list"])
def test_save_is_the_jax_container_byte_for_byte(tmp_path, kind):
    arrays = _cases(kind)
    jpath, tpath = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    _jax_save(jpath, arrays)
    if isinstance(arrays, dict):
        tnd.save(tpath, {k: _torch(v) for k, v in arrays.items()})
    else:
        tnd.save(tpath, [_torch(v) for v in arrays])
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    # numpy arrays (bfloat16 ones from ml_dtypes) take the same path
    npath = str(tmp_path / "numpy.params")
    tnd.save(npath, arrays)
    with open(jpath, "rb") as f, open(npath, "rb") as g:
        assert f.read() == g.read()
    # each package loads the other's file bit for bit
    port, jaxs = tnd.load(jpath), _jax_load(tpath)
    items = (arrays.items() if isinstance(arrays, dict)
             else enumerate(arrays))
    for k, want in items:
        assert _bits(port[k]) == _bits(want), k
        assert tuple(port[k].shape) == want.shape and port[k].ctx \
            == tmx.cpu()
        assert _bits(jaxs[k]) == _bits(want), k


def _good_file(tmp_path):
    path = str(tmp_path / "good.params")
    tnd.save(path, {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                    "b": torch.ones(3)})
    with open(path, "rb") as f:
        return path, bytearray(f.read())


def _entry_offsets(raw):
    """Byte offsets of entry 0: its magic, its rank, its dtype code, its
    first data byte, and of the name count."""
    rank = 16 + 8 + 4
    dtype = rank + 4 + 2 * 8 + 8
    data = dtype + 4
    names = data + 6 * 4 + 4 + 4 + 4 + 8 + 8 + 4 + 3 * 4 + 4
    return 24, rank, dtype, data, names


def _corrupt(kind, raw):
    magic, rank, dtype, data, names = _entry_offsets(raw)
    raw = bytearray(raw)
    if kind == "truncated":
        return raw[:len(raw) // 2]
    if kind == "header":
        return raw[:20]
    if kind == "bad magic":
        raw[0:8] = struct.pack("<Q", 0xDEAD)
    elif kind == "format flag":
        raw[8:16] = struct.pack("<Q", 7)
    elif kind == "footer":
        raw[-8:] = struct.pack("<Q", 0)
    elif kind == "entry magic":
        raw[magic:magic + 4] = struct.pack("<I", 0x12345678)
    elif kind == "entry crc":
        raw[data] ^= 0xFF
    elif kind == "names crc":
        raw[len(raw) - 24 - 1] ^= 0x01
    elif kind == "dtype code":
        raw[dtype:dtype + 4] = struct.pack("<i", 99)
    elif kind == "rank":
        raw[rank:rank + 4] = struct.pack("<I", 65)
    elif kind == "count":
        raw[16:24] = struct.pack("<Q", 1 << 40)
    elif kind == "trailing":
        # one more byte after the name table, the footer rewritten to
        # cover it (the name table's CRC unchanged)
        body = bytes(raw[:-24]) + b"\0"
        names_crc = zlib.crc32(body[names:-1]) & 0xFFFFFFFF
        return bytearray(body + struct.pack(
            "<QIIQ", len(body), names_crc, 0, 0x4D585450_43524333))
    return raw


CORRUPTIONS = {
    "truncated": "truncated", "header": "smaller than any header",
    "bad magic": "bad magic", "format flag": "format flag",
    "footer": "footer missing or inconsistent",
    "entry magic": "bad entry magic", "entry crc": "checksum mismatch in "
    "entry 0", "names crc": "checksum mismatch in the name table",
    "dtype code": "unknown dtype code 99", "rank": "implausible rank 65",
    "count": "implausible array count", "trailing": "unexpected trailing"}


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_corruption_names_the_same_defect(tmp_path, kind):
    path, raw = _good_file(tmp_path)
    with open(path, "wb") as f:
        f.write(bytes(_corrupt(kind, raw)))
    with pytest.raises(JaxMXNetError, match=CORRUPTIONS[kind]) as jerr:
        jmx.nd.load(path)
    with pytest.raises(MXNetError, match=CORRUPTIONS[kind]) as terr:
        tnd.load(path)
    assert str(terr.value) == str(jerr.value)


def test_legacy_flag0_file_loads_in_both(tmp_path):
    """The reference's layout: flag word 0, no CRCs, no footer."""
    a = np.arange(8, dtype=np.float32).reshape(2, 4)
    b = np.arange(3, dtype=np.int64)
    path = str(tmp_path / "legacy.params")
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", _LIST_MAGIC, 0, 2))
        for arr, code in ((a, 0), (b, 6)):
            f.write(struct.pack("<II", _ND_MAGIC, arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            f.write(struct.pack("<iii", 1, 0, code))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", 2))
        for n in (b"w", b"i"):
            f.write(struct.pack("<Q", len(n)) + n)
    got = tnd.load(path)
    assert got["w"].asnumpy().tobytes() == a.tobytes()
    assert got["i"].handle.dtype == torch.int64 \
        and got["i"].tolist() == [0, 1, 2]
    assert _jax_load(path)["w"].tobytes() == a.tobytes()
    with open(path, "r+b") as f:
        f.truncate(40)
    with pytest.raises(MXNetError, match="truncated"):
        tnd.load(path)


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(5, in_units=3, activation="relu"),
            pkg.gluon.nn.BatchNorm(in_channels=5),
            pkg.gluon.nn.Dense(2, in_units=5))
    return net


def test_save_parameters_crosses_packages(tmp_path):
    """The port's ``save_parameters`` file loads into the JAX block, and
    the JAX block's into the port's, with equal values."""
    tnet = _mlp(tmx).initialize(ctx=tmx.cpu(),
                                generator=tmx.random.generator(3))
    with torch.no_grad():
        tnet[1].running_var.uniform_(0.5, 2.0)
    path = str(tmp_path / "port.params")
    tnet.save_parameters(path)
    jnet = _mlp(jmx)
    jnet.initialize(ctx=jmx.cpu())
    jnet.load_parameters(path, ctx=jmx.cpu())
    want = {k: v.detach().numpy() for k, v in tnet.collect_params().items()}
    for k, p in jnet._structural_names().items():
        np.testing.assert_array_equal(p.data().asnumpy(), want[k], k)

    jpath = str(tmp_path / "jax.params")
    jnet.collect_params().initialize(jmx.init.Normal(0.3), ctx=jmx.cpu(),
                                     force_reinit=True)
    jnet.save_parameters(jpath)
    other = _mlp(tmx).initialize(ctx=tmx.cpu())
    ptrs = {k: v.data_ptr() for k, v in other.collect_params().items()}
    other.load_parameters(jpath)
    for k, p in jnet._structural_names().items():
        t = other.collect_params()[k]
        np.testing.assert_array_equal(t.detach().numpy(),
                                      p.data().asnumpy(), k)
        assert t.data_ptr() == ptrs[k]
    with pytest.raises(MXNetError, match="not a parameter dict"):
        tnd.save(str(tmp_path / "list.params"), [torch.ones(2)])
        other.load_parameters(str(tmp_path / "list.params"))


@pytest.mark.parametrize("flip", [None, "first slice", "last slice"])
def test_an_entry_read_in_slices(tmp_path, flip):
    """An entry of more than one 2 MiB slice is read and checksummed in
    slices on threads: it loads as the JAX package's ``nd.load`` loads
    it, and a byte flipped in its first or last slice names the same
    defect in both packages."""
    arrays = {"big": _np("float32", (3, 400000), 7),
              "small": _np("int32", (3, 5), 8)}
    path = str(tmp_path / "big.params")
    _jax_save(path, arrays)
    if flip is not None:
        with open(path, "r+b") as f:
            f.seek(100 if flip == "first slice" else 4800000)
            byte = f.read(1)[0]
            f.seek(-1, 1)
            f.write(bytes([byte ^ 0x10]))
        with pytest.raises(JaxMXNetError) as jerr:
            jmx.nd.load(path)
        with pytest.raises(MXNetError, match="checksum mismatch in "
                           "entry 0") as terr:
            tnd.load(path)
        assert str(terr.value) == str(jerr.value)
        return
    got, want = tnd.load(path), _jax_load(path)
    assert list(got) == list(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k

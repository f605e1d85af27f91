"""The port's crash-consistency toolkit (mxnet_tpu_torch/resilience/)
against the JAX package's, on the CPU.

- ``commit``: a step that one package commits validates in the other,
  with the same manifest; keep-last GC, a stale ``latest`` pointer, a
  corrupt newest step and a torn stage give the same
  ``find_restorable`` answer, the same skipped steps and the same
  ``doctor_report`` in both.
- A ``ShardedTrainer.checkpoint`` crashed at each fault point of the
  atomic writes and of the commit (``open``, ``write``, ``fsync``,
  ``replace``, ``after_replace``, ``dir_fsync``, ``publish``, ``gc``)
  leaves a root from which a fresh trainer restores the previous step
  (or, after the publish rename, the new one) bit for bit.
- ``retry``: the same backoff schedule from the same seed, a transient
  error retried and journaled, a full disk failing at once with one
  ``disk_full`` record, in both packages.
"""
import errno
import json
import os
import random
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.diagnostics import journal as jjournal
from mxnet_tpu.resilience import atomic as jatomic
from mxnet_tpu.resilience import commit as jcommit
from mxnet_tpu.resilience import retry as jretry
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.diagnostics import journal as tjournal
from mxnet_tpu_torch.resilience import atomic as tatomic
from mxnet_tpu_torch.resilience import commit as tcommit
from mxnet_tpu_torch.resilience import retry as tretry

PKGS = {"jax": (jcommit, jatomic), "port": (tcommit, tatomic)}


def _stage(commit, atomic, root, step, payload):
    """Stage two files of ``payload`` bytes and commit them, keeping the
    last two steps."""
    stage = commit.prepare_stage(root, step)
    for name in ("ckpt.params", "ckpt.states"):
        with atomic.atomic_write(os.path.join(stage, name)) as f:
            f.write(payload + name.encode())
    return commit.finalize(root, step, meta={"world": 1}, keep_last=2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_committed_step_validates_in_the_other_package(tmp_path, writer):
    root = str(tmp_path / "root")
    doc = _stage(*PKGS[writer], root, 7, b"weights")
    reader = PKGS["port" if writer == "jax" else "jax"][0]
    assert reader.validate_step(root, 7) == doc
    assert reader.read_latest(root) == 7
    assert reader.find_restorable(root) == (7, doc)
    assert sorted(os.listdir(root)) == ["latest", "step-00000007"]


def _scenario(root, kind, commit, atomic):
    for step in (1, 2, 3):
        _stage(commit, atomic, root, step, b"step %d" % step)
    if kind == "stale_latest":
        commit.write_latest(root, 1)
    elif kind == "corrupt_newest":
        path = os.path.join(commit.step_dir(root, 3), "ckpt.states")
        with open(path, "r+b") as f:
            f.write(b"X")
    elif kind == "torn_stage":
        stage = commit.prepare_stage(root, 4)
        with open(os.path.join(stage, "ckpt.params"), "wb") as f:
            f.write(b"half")
    elif kind == "no_manifest":
        os.remove(os.path.join(commit.step_dir(root, 3), commit.MANIFEST))


@pytest.mark.parametrize("kind", ["keep_last", "stale_latest",
                                  "corrupt_newest", "torn_stage",
                                  "no_manifest"])
def test_find_restorable_agrees(tmp_path, kind):
    """The port builds each root; both packages read it."""
    root = str(tmp_path / "root")
    _scenario(root, kind, tcommit, tatomic)
    answers = []
    for commit, _ in PKGS.values():
        skipped = []
        found = commit.find_restorable(
            root, on_skip=lambda s, r: skipped.append((s, r)))
        report = commit.doctor_report(root)
        answers.append((found, skipped, report))
    assert answers[0] == answers[1]
    found, skipped, _ = answers[1]
    assert tcommit.committed_steps(root) == [2, 3]
    assert found[0] == (2 if kind in ("corrupt_newest", "no_manifest")
                        else 3)
    assert [s for s, _ in skipped] == ([3] if found[0] == 2 else [])


# -- the crash matrix ----------------------------------------------------------
class Crash(BaseException):
    """A process dying at a fault point: not an ``Exception``, so no
    cleanup runs."""


def _crash_at(point):
    def hook(p, path, nbytes=None, size=None):
        if p == point:
            raise Crash(p)
    return hook


def _trainer(seed):
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(8, in_units=5, activation="relu"),
            tmx.gluon.nn.BatchNorm(in_channels=8),
            tmx.gluon.nn.Dense(3, in_units=8))
    net.initialize(ctx=tmx.cpu(), generator=tmx.random.generator(seed))
    return tpar.ShardedTrainer(
        net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9},
        mesh=tpar.make_mesh({"data": 1, "model": 1}, devices=[tmx.cpu()]))


def _snapshot(tr):
    return {k: v.detach().clone() for k, v in
            {**tr._param_entries(), **tr._state_entries()}.items()}


@pytest.mark.parametrize("point", ["open", "write", "fsync", "replace",
                                   "after_replace", "dir_fsync", "publish",
                                   "gc"])
def test_a_crashed_checkpoint_leaves_a_restorable_step(tmp_path, point):
    root = str(tmp_path / "ckpt")
    rng = np.random.RandomState(0)
    x, y = rng.randn(6, 5).astype(np.float32), rng.randint(0, 3, (6,))
    tr = _trainer(0)
    tr.step(x, y)
    tr.checkpoint(root, keep_last=2)
    snaps = {1: _snapshot(tr)}
    tr.step(x, y)
    snaps[2] = _snapshot(tr)
    prev = tatomic.set_fault_hook(_crash_at(point))
    try:
        with pytest.raises(Crash):
            tr.checkpoint(root, keep_last=2)
    finally:
        tatomic.set_fault_hook(prev)
    fresh = _trainer(1)
    fresh.prepare(x)
    restored = fresh.restore(root)
    # a crash before the publish rename keeps the previous step; after it
    # the new step is committed whole
    assert restored == (2 if point == "gc" else 1)
    got = _snapshot(fresh)
    for k, want in snaps[restored].items():
        assert torch.equal(got[k], want), k
    assert fresh.num_update == restored
    if restored == 1:                  # the resumed step is the lost one
        fresh.step(x, y)
        got = _snapshot(fresh)
        assert all(torch.equal(got[k], v) for k, v in snaps[2].items())
    else:
        fresh.step(x, y)
    # the next checkpoint sweeps what the crash left
    fresh.checkpoint(root, keep_last=2)
    litter = [n for n in os.listdir(root) if ".tmp" in n]
    assert not litter, litter


# -- retry ---------------------------------------------------------------------
def _retry_records(tmp_path, name, retry, journal):
    path = tmp_path / f"{name}.jsonl"
    journal.reset_journal(str(path))
    retry.reset_disk_full_notes()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(errno.EIO, "transient")
        return "ok"

    def full():
        raise OSError(errno.ENOSPC, "no space", "/ckpt/step")

    try:
        out = [retry.backoff_delays(4, rng=random.Random(3)),
               retry.retry_call(flaky, retries=3, base_s=0.001,
                                sleep=lambda s: None, what="flaky",
                                rng=random.Random(5))]
        for _ in range(2):
            with pytest.raises(OSError):
                retry.retry_call(full, retries=3, sleep=lambda s: None,
                                 what="full")
        out.append(len(calls))
    finally:
        journal.reset_journal("off")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return out, [{k: v for k, v in r.items() if k not in ("ts", "up_s")}
                 for r in recs]


def test_retry_matches_jax(tmp_path):
    want = _retry_records(tmp_path, "jax", jretry, jjournal)
    got = _retry_records(tmp_path, "port", tretry, tjournal)
    assert got == want
    out, recs = got
    assert out[1] == "ok" and out[2] == 3
    assert [r["kind"] for r in recs] == ["retry", "retry", "disk_full"]


@pytest.mark.parametrize("size", [0, 1, 4096, 3 * 4096, 5 * 4096 + 77])
def test_sliced_crcs_agree_with_the_jax_package(tmp_path, monkeypatch,
                                                size):
    """``file_crc`` checksums 4 KiB slices on threads here and combines
    them: the same (crc32, size) as the JAX package's streamed pass; a
    step torn in its last slice fails validation with the same message
    in both packages; ``read_into_crc`` fills a buffer slice by slice
    and counts a short read."""
    from concurrent.futures import ThreadPoolExecutor
    monkeypatch.setattr(tcommit, "_CRC_SLICE", 4096)
    payload = np.random.RandomState(size).bytes(size)
    path = tmp_path / "blob"
    path.write_bytes(payload)
    assert tcommit.file_crc(str(path)) == jcommit.file_crc(str(path)) \
        == (zlib.crc32(payload) & 0xFFFFFFFF, size)
    root = str(tmp_path / "root")
    _stage(tcommit, tatomic, root, 3, payload)
    assert tcommit.validate_step(root, 3) == jcommit.validate_step(root, 3)
    if size:
        torn = os.path.join(tcommit.step_dir(root, 3), "ckpt.states")
        with open(torn, "r+b") as f:
            f.seek(size - 1)
            f.write(bytes([payload[-1] ^ 1]))
        with pytest.raises(ValueError) as jerr:
            jcommit.validate_step(root, 3)
        with pytest.raises(ValueError, match="CRC mismatch") as terr:
            tcommit.validate_step(root, 3)
        assert str(terr.value) == str(jerr.value)
    buf = bytearray(size + 100)
    with ThreadPoolExecutor(3) as pool, open(path, "rb") as f:
        crc, got = tcommit.read_into_crc(pool, f.fileno(), 0,
                                         memoryview(buf), slice_bytes=1000)
    assert (crc, got) == (zlib.crc32(payload) & 0xFFFFFFFF, size)
    assert bytes(buf[:size]) == payload

"""Heartbeat liveness over a shared directory (counterpart of the
``Heartbeat`` and ``LivenessReader`` of ``mxnet_tpu/elastic/membership.py``).

Every member's daemon heartbeat bumps a monotonic sequence number in
``<hb_dir>/<prefix>-<id>.json``; an observer declares a member lost
when its *sequence* stops advancing for ``deadline_s`` of the observer's
own monotonic clock, never by comparing wall clocks across hosts. The
serving replica pool (``serving.pool``) rides its readiness beacon
(queue depth, params step, bound port) in the same record.

The file layout and the record (``member``, ``pid``, ``seq`` and the
payload's keys) are the reference's byte for byte, so either package's
reader reads the other's beacons.

Not ported yet: the training control plane (``Cohort``, its epoch
ledger and deadline barriers, ``CohortConfig``), ROADMAP Queue 1 item
13. Stdlib + the journal + ``resilience.atomic``.
"""
from __future__ import annotations

import json
import os
import threading
import time

from ..base import MXNetError
from ..resilience import atomic

__all__ = ["BarrierTimeout", "Heartbeat", "LivenessReader", "RankLost"]

HEARTBEAT_S = 2.0
DEADLINE_S = 20.0
BARRIER_S = 120.0
POLL_S = 0.05


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    try:
        return float(v) if v else default
    except ValueError:
        return default


class RankLost(MXNetError):
    """A cohort member stopped heartbeating: raised instead of entering
    (or staying in) a collective wait, with the evidence."""

    def __init__(self, lost, survivors, epoch, where=""):
        self.lost = sorted(int(r) for r in lost)
        self.survivors = sorted(int(r) for r in survivors)
        self.epoch = int(epoch)
        self.where = where
        super().__init__(
            f"rank(s) {self.lost} lost (epoch {self.epoch}"
            + (f", at {where}" if where else "")
            + f"); survivors {self.survivors}")


class BarrierTimeout(MXNetError):
    """A cohort barrier expired with every missing member still
    heartbeating: a stall, not a death."""

    def __init__(self, tag, waiting_for, deadline_s):
        self.tag = tag
        self.waiting_for = sorted(int(r) for r in waiting_for)
        super().__init__(
            f"cohort barrier {tag!r} expired after {deadline_s:g}s still "
            f"waiting for live rank(s) {self.waiting_for}")


class Heartbeat:
    """Seq-file heartbeat daemon for one member of a group: every
    ``interval_s`` bump a monotonic sequence in
    ``<hb_dir>/<prefix>-<id>.json``, merging the optional ``payload()``
    dict into each record. Written through ``resilience.atomic`` (the
    fault hook reaches it) without fsync: a heartbeat is ephemeral
    evidence. A failed write is swallowed, and so is a failing payload
    (its exception's name lands as ``payload_error``): heartbeating must
    never kill the member it reports on."""

    def __init__(self, hb_dir, member, interval_s, payload=None,
                 prefix="rank"):
        self.hb_dir = str(hb_dir)
        self.member = member
        self.interval_s = float(interval_s)
        self.payload = payload
        self.prefix = prefix
        os.makedirs(self.hb_dir, exist_ok=True)
        self._seq = 0
        self._stop = threading.Event()
        self._thread = None
        # beat() runs on the daemon and on lifecycle threads that publish
        # a change at once (a draining replica). One writer at a time: a
        # beat arriving mid-write marks the state dirty and returns, and
        # the writer loops, sampling the payload again until nothing is
        # dirty, so the last write reflects a sample taken at or after
        # the last beat(). The file write runs outside the lock.
        self._beat_lock = threading.Lock()
        self._dirty = False
        self._writing = False

    @property
    def path(self) -> str:
        return os.path.join(self.hb_dir,
                            f"{self.prefix}-{self.member}.json")

    def beat(self) -> None:
        """Write one heartbeat now (when another thread's write is in
        flight, mark the state dirty and let that writer publish it)."""
        with self._beat_lock:
            self._seq += 1
            self._dirty = True
            if self._writing:
                return
            self._writing = True
        try:
            while True:
                with self._beat_lock:
                    if not self._dirty:
                        self._writing = False
                        return
                    self._dirty = False
                    doc = {"member": self.member, "pid": os.getpid(),
                           "seq": self._seq}
                if self.payload is not None:
                    try:
                        doc.update(self.payload())
                    except Exception as e:
                        doc["payload_error"] = type(e).__name__
                try:
                    with atomic.atomic_write(self.path, "w",
                                             durable=False) as f:
                        json.dump(doc, f)
                except OSError:
                    pass
        except BaseException:
            with self._beat_lock:      # the next beat() becomes the writer
                self._writing = False
            raise

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        self._stop.clear()
        self.beat()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"mxnet-torch-hb-{self.prefix}-{self.member}")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self.beat()

    def stop(self, resign=False) -> None:
        """Stop heartbeating; ``resign=True`` also removes the seq file
        (a graceful leave, seen as a loss at the next check)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1.0)
            self._thread = None
        if resign:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class LivenessReader:
    """Per-member (seq, first seen on this observer's monotonic clock)
    over a directory of :class:`Heartbeat` files. A member is alive
    while its sequence keeps advancing. A torn or unparsable file reads
    as no heartbeat (the last whole record's payload is kept); a missing
    file (a resignation) drops the payload."""

    def __init__(self, hb_dir, deadline_s, prefix="rank"):
        self.hb_dir = hb_dir
        self.deadline_s = deadline_s
        self.prefix = prefix
        self._seen = {}          # member -> (seq, monotonic first seen)
        self._docs = {}          # member -> last well-formed record

    def _read(self, member):
        try:
            with open(os.path.join(self.hb_dir,
                                   f"{self.prefix}-{member}.json"),
                      encoding="utf-8") as f:
                doc = json.load(f)
            seq = int(doc.get("seq", -1))
        except FileNotFoundError:
            self._docs.pop(member, None)
            return None
        except (OSError, ValueError):
            return None
        self._docs[member] = doc
        return seq

    def payload(self, member):
        """The last well-formed record observed for ``member`` (refreshed
        by :meth:`observe`), or None before one lands."""
        return self._docs.get(member)

    def members(self) -> list:
        """Member ids with a seq file (sorted; numeric ids numerically,
        before string ids)."""
        out = []
        try:
            names = os.listdir(self.hb_dir)
        except OSError:
            return out
        head = f"{self.prefix}-"
        for name in names:
            if name.startswith(head) and name.endswith(".json"):
                raw = name[len(head):-len(".json")]
                out.append(int(raw) if raw.isdigit() else raw)
        return sorted(out, key=lambda m: (isinstance(m, str), m))

    def observe(self, member):
        """Refresh this member's record; returns its idle seconds on the
        observer's clock (0.0 when its seq moved or at the first look)."""
        seq = self._read(member)
        now = time.monotonic()
        if seq is None:
            # no whole file: start (or keep) the grace clock, so a member
            # that never comes up is declared lost in the end
            prev = self._seen.get(member)
            if prev is None or prev[0] is not None:
                self._seen[member] = (None, now)
                return 0.0
            return now - prev[1]
        prev = self._seen.get(member)
        if prev is None or prev[0] != seq:
            self._seen[member] = (seq, now)
            return 0.0
        return now - prev[1]

    def alive(self, member) -> bool:
        idle = self.observe(member)
        return idle is not None and idle <= self.deadline_s

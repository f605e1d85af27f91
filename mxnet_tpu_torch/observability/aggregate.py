"""Pod-scope trace assembly — merge per-process files into one story
(counterpart of ``mxnet_tpu/observability/aggregate.py``; the same
merged document and critical path from the same files).

A pod run leaves a shared-FS run directory of per-process evidence
(``MXNET_TPU_TRACE_DIR``; the replica pool wires it for its workers):

- ``journal-*.jsonl`` / ``*.jsonl`` — one diagnostics journal PER
  process, carrying ``kind="span"`` records (``MXNET_TPU_TRACE=
  journal``), the ``trace_anchor`` clock-alignment record, and every
  correlated journal record;
- ``flight-*.json`` — crash flight-recorder dumps
  (observability/flight.py): the bounded span/journal rings of a
  process that was SIGKILLed, wedged, or exited, each with its own
  anchor.

This module folds them into ONE timeline:

- **clock alignment** — every process's spans sit on a monotonic
  ``perf_counter`` timeline whose zero is arbitrary; the anchor record
  pairs one wall-clock sample with one perf_counter sample, so
  ``wall = anchor.wall_s - anchor.perf_s + epoch_s + span.start_s``
  places all processes on one shared wall clock while keeping each
  process's INTRA-process precision purely monotonic (one trusted wall
  sample per process — the G11 no-wall-durations discipline, applied
  across processes).  A journal without an anchor falls back to each
  span record's own write-time ``ts`` minus its duration (coarser:
  per-record wall sampling);
- **merged Perfetto trace** (:func:`aggregate_chrome`) — one pid per
  PROCESS (never per rank: two replicas on one host share a rank) with
  ``process_name`` metadata, ``tid`` = thread;
- **cross-process critical path** (:func:`critical_path` /
  :func:`timeline_report`) — for one
  trace id (default: the slowest routed request), the ordered
  router-attempt → wire → dequeue/execute → respond chain with
  per-step wall offsets and the inter-step gaps (the wire/queue time
  no single process's profile can see).

Stdlib only, and tolerant of torn journal tails (a killed writer's last
line is skipped): assembly must work on wreckage.
"""
from __future__ import annotations

import json
import os
import re

from . import export as _export

_PREV_RE = re.compile(r"\.prev-\d+$")

__all__ = ["ProcessTrace", "aggregate_chrome", "critical_path",
           "scan_run_dir", "timeline_report"]

# span names in priority order for picking the "interesting" trace when
# the caller doesn't name one: a routed request beats a bare serving one
_ROOT_PREFERENCE = ("router_request", "serving_request", "elastic_recover")


class ProcessTrace:
    """One process's assembled evidence: spans (journal ∪ flight,
    deduped), the newest clock anchor, journal records, and provenance
    (which files fed it, whether a flight dump is present)."""

    __slots__ = ("label", "sources", "spans", "anchor", "records",
                 "flight", "identity")

    def __init__(self, label):
        self.label = label
        self.sources = []
        self.spans = []          # span dicts (journal schema)
        self.anchor = None       # newest anchor doc
        self.records = []        # non-span journal records
        self.flight = None       # flight dump doc (reason etc.)
        self.identity = {}       # rank/replica/pid/run_id

    # -- clock alignment -------------------------------------------------
    def span_wall_start(self, d):
        """Wall-clock start of one span dict: the ``_wall`` the scanner
        pinned from the span's OWN incarnation's anchor (a respawned
        worker appends a second incarnation — second anchor, new
        monotonic epoch — to the same journal file, so per-span anchor
        association matters), else this process's newest anchor, else
        the record's own write-time ts minus duration."""
        if d.get("_wall") is not None:
            return float(d["_wall"])
        off = _anchor_offset(self.anchor)
        if off is not None and d.get("start_s") is not None:
            return off + float(d["start_s"])
        ts = d.get("ts")            # journal write time (= span end)
        if ts is None:
            return None
        return float(ts) - float(d.get("dur_s") or 0.0)

    def dedupe(self):
        # (trace_id, span_id, incarnation): span counters restart per
        # process incarnation, and a trace id minted ELSEWHERE (the
        # router's, propagated over the wire) can reach two
        # incarnations of one replica — e.g. a retry of the same
        # request after a respawn — so the pair alone can collide
        # across incarnations.  The anchor epoch pinned at scan time
        # disambiguates them, while periodic-flight + journal
        # duplicates of the SAME span (same incarnation, same epoch)
        # still collapse.
        seen = set()
        out = []
        for d in self.spans:
            key = (d.get("trace_id"), d.get("span_id"), d.get("_inc"))
            if key in seen:
                continue
            seen.add(key)
            out.append(d)
        self.spans = out
        # journal records have no ids; a flight dump's journal_tail is
        # the last-N of the records already scanned from the journal
        # file (the common both-files case), so collapse by content or
        # every report count inflates by the duplicated tail
        seen_r = set()
        recs = []
        for r in self.records:
            key = json.dumps(r, sort_keys=True, default=str)
            if key in seen_r:
                continue
            seen_r.add(key)
            recs.append(r)
        self.records = recs


def _anchor_offset(anchor):
    """``wall_s - perf_s + epoch_s`` — add ``span.start_s`` for the
    span's wall start.  None for a missing/malformed anchor."""
    if not anchor:
        return None
    try:
        return (float(anchor["wall_s"]) - float(anchor["perf_s"])
                + float(anchor["epoch_s"]))
    except (KeyError, TypeError, ValueError):
        return None


def _pin_wall(span, anchor) -> dict:
    """Stamp ``_wall`` (and the incarnation tag ``_inc`` dedupe keys
    on) on a span from ITS incarnation's anchor (the anchor in effect
    where the span was read).  Internal keys never reach the chrome
    output — ``_chrome_event`` builds its args explicitly."""
    off = _anchor_offset(anchor)
    if off is None:
        return span
    span = dict(span)
    span["_inc"] = anchor.get("epoch_s")
    if span.get("start_s") is not None:
        span["_wall"] = off + float(span["start_s"])
    return span


def _scan_jsonl(path, proc):
    """Fold one journal file into ``proc`` (torn/junk lines skipped).
    Anchor association is positional: a span aligns with the newest
    anchor ABOVE it in the file — its own incarnation's."""
    current_anchor = None
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            kind = rec.get("kind")
            if kind == "span":
                proc.spans.append(_pin_wall(rec, current_anchor))
            elif kind == "trace_anchor":
                current_anchor = rec
                proc.anchor = rec       # newest wins (the fallback)
                for k in ("rank", "replica", "pid", "run_id"):
                    if rec.get(k) is not None:
                        proc.identity[k] = rec[k]
            else:
                proc.records.append(rec)


def _fold_flight(doc, proc):
    anchor = doc.get("anchor") if isinstance(doc.get("anchor"), dict) \
        else None
    if proc.flight is None:     # the CURRENT dump sorts first; rotated
        proc.flight = {"reason": doc.get("reason"),    # .prev-N dumps
                       "seq": doc.get("seq"),          # only add spans
                       "last_phase": doc.get("last_phase"),
                       "trace": doc.get("trace")}
    if anchor is not None and proc.anchor is None:
        proc.anchor = anchor
    for k in ("rank", "replica", "pid", "run_id"):
        if doc.get(k) is not None:
            proc.identity.setdefault(k, doc[k])
    proc.spans.extend(_pin_wall(d, anchor)
                      for d in doc.get("spans") or []
                      if isinstance(d, dict))
    proc.records.extend(r for r in doc.get("journal_tail") or []
                        if isinstance(r, dict) and r.get("kind") != "span")
    # spans that only survived in the journal_tail ring (trace mode
    # journal + a dump between writes) still join the timeline
    proc.spans.extend(_pin_wall(r, anchor)
                      for r in doc.get("journal_tail") or []
                      if isinstance(r, dict) and r.get("kind") == "span")


def _proc_label(stem, proc):
    ident = proc.identity
    if ident.get("replica") is not None:
        return f"replica {ident['replica']}"
    if ident.get("rank") is not None and ident.get("pid") is not None:
        return f"rank {ident['rank']} (pid {ident['pid']})"
    return stem


def scan_run_dir(run_dir) -> list:
    """Assemble one :class:`ProcessTrace` per process from a run
    directory.  A journal file IS a process; a ``flight-<label>.json``
    merges into the journal of the same label when one exists
    (``journal-<label>.jsonl``), else stands alone — the SIGKILLed
    worker whose journal went down with it.  Raises OSError when the
    directory itself is unreadable."""
    names = sorted(os.listdir(run_dir))
    procs: dict = {}

    def get(stem):
        p = procs.get(stem)
        if p is None:
            p = procs[stem] = ProcessTrace(stem)
        return p

    for name in names:
        path = os.path.join(run_dir, name)
        if name.endswith(".jsonl"):
            stem = name[:-len(".jsonl")]
            if stem.startswith("journal-"):
                stem = stem[len("journal-"):]
            p = get(stem)
            p.sources.append(name)
            try:
                _scan_jsonl(path, p)
            except OSError:
                continue
        elif name.startswith("flight-") and name.endswith(".json"):
            stem = name[len("flight-"):-len(".json")]
            # rotated previous-incarnation dumps (flight.py install
            # rotation) fold into the same process identity
            stem = _PREV_RE.sub("", stem)
            # the pool names journals by replica id, the recorder by
            # "replica-<id>" — normalize so they merge
            if stem.startswith("replica-"):
                stem = stem[len("replica-"):]
            p = get(stem)
            p.sources.append(name)
            try:
                from .flight import read_flight
                _fold_flight(read_flight(path), p)
            except (OSError, ValueError):
                continue
    _merge_by_identity(procs)
    out = []
    for stem in sorted(procs):
        p = procs[stem]
        if not (p.spans or p.records or p.flight):
            continue                 # an empty shell says nothing
        p.dedupe()
        p.label = _proc_label(stem, p)
        out.append(p)
    return out


def _merge_by_identity(procs: dict) -> None:
    """Fold ProcessTraces that are the SAME process under two filename
    stems: a flight dump whose label doesn't share the journal's stem
    — e.g. ``journal-r0.jsonl`` next to the recorder's default
    ``flight-rank0-pid1234.json`` when ``MXNET_TPU_REPLICA_ID`` is
    unset (the elastic per-rank flow) — would otherwise land on its
    own pid with every flight-flushed span DUPLICATED beside its
    journal copy (dedupe is per-ProcessTrace).  The pod identity block
    both files carry is the join key; pid-less shells stay separate."""
    by_ident: dict = {}
    for stem in sorted(procs):
        p = procs[stem]
        ident = p.identity
        if ident.get("pid") is None:
            continue
        key = (ident.get("run_id"), ident.get("rank"),
               ident.get("replica"), ident["pid"])
        first = by_ident.get(key)
        if first is None:
            by_ident[key] = p
            continue
        first.sources.extend(p.sources)
        first.spans.extend(p.spans)
        first.records.extend(p.records)
        if first.anchor is None:
            first.anchor = p.anchor
        if first.flight is None:
            first.flight = p.flight
        del procs[stem]


def aggregate_chrome(run_dir) -> dict:
    """The merged Perfetto document: every process's spans on one
    anchor-aligned wall timeline, one pid per process (collision-free
    by construction), ``process_name`` metadata naming each track."""
    procs = scan_run_dir(run_dir)
    placed = []                     # (proc, span, wall_start)
    for p in procs:
        for d in p.spans:
            w = p.span_wall_start(d)
            if w is not None:
                placed.append((p, d, w))
    t0 = min((w for _p, _d, w in placed), default=0.0)
    events = []
    for i, p in enumerate(procs):
        events.append(_export._metadata_event(
            i + 1, p.label + (f" [flight:{p.flight['reason']}]"
                              if p.flight else "")))
    pid_of = {id(p): i + 1 for i, p in enumerate(procs)}
    for p, d, w in sorted(placed, key=lambda t: t[2]):
        rebased = dict(d)
        rebased["start_s"] = w - t0
        events.append(_export._chrome_event(rebased, pid_of[id(p)]))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"run_dir": str(run_dir),
                         "processes": [p.label for p in procs],
                         "wall_t0": round(t0, 6)}}


# -- critical path -----------------------------------------------------------

def _pick_trace(placed):
    """Default trace choice: the slowest instance of the most
    interesting root kind present (routed request > bare serving
    request > elastic recovery)."""
    for root_name in _ROOT_PREFERENCE:
        best = None
        for _p, d, _w in placed:
            if d.get("name") != root_name:
                continue
            dur = float(d.get("dur_s") or 0.0)
            if best is None or dur > best[1]:
                best = (d.get("trace_id"), dur)
        if best is not None:
            return best[0]
    return None


def critical_path(procs, trace_id=None) -> dict:
    """One request's cross-process story: every span of ``trace_id``
    (default: the slowest routed request) ordered on the shared wall
    clock, each step naming its process, with the gap to the previous
    step — the wire/queue time that lives BETWEEN processes."""
    placed = []
    for p in procs:
        for d in p.spans:
            w = p.span_wall_start(d)
            if w is not None:
                placed.append((p, d, w))
    if trace_id is None:
        trace_id = _pick_trace(placed)
    if trace_id is None:
        return {"ok": False, "error": "no spans with a trace id found"}
    mine = sorted(((p, d, w) for p, d, w in placed
                   if d.get("trace_id") == trace_id),
                  key=lambda t: (t[2], t[1].get("span_id") or ""))
    if not mine:
        return {"ok": False, "trace_id": trace_id,
                "error": f"no spans for trace {trace_id!r}"}
    t0 = mine[0][2]
    steps = []
    prev_end = None
    for p, d, w in mine:
        dur_ms = round(float(d.get("dur_s") or 0.0) * 1000.0, 3)
        step = {"name": d.get("name"), "proc": p.label,
                "start_ms": round((w - t0) * 1000.0, 3),
                "dur_ms": dur_ms, "span_id": d.get("span_id"),
                "parent_id": d.get("parent_id")}
        if d.get("attrs"):
            status = d["attrs"].get("status")
            if status is not None:
                step["status"] = status
        if prev_end is not None:
            step["gap_ms"] = round((w - prev_end) * 1000.0, 3)
        this_end = w + dur_ms / 1000.0
        prev_end = this_end if prev_end is None \
            else max(prev_end, this_end)
        steps.append(step)
    end = max(w + float(d.get("dur_s") or 0.0) for _p, d, w in mine)
    return {"ok": True, "trace_id": trace_id, "steps": steps,
            "wall_ms": round((end - t0) * 1000.0, 3),
            "processes": sorted({p.label for p, _d, _w in mine})}


def timeline_report(run_dir, trace_id=None) -> dict:
    """Per-process assembly facts (span counts, anchor presence,
    flight-dump reason) plus the critical path of one trace; junk
    tolerated, always a dict with ``ok``."""
    try:
        procs = scan_run_dir(run_dir)
    except OSError as e:
        return {"ok": False, "path": str(run_dir),
                "error": f"cannot read {run_dir}: {e.strerror or e}"}
    if not procs:
        return {"ok": False, "path": str(run_dir),
                "error": "no journals or flight dumps in run dir (was "
                         "MXNET_TPU_TRACE_DIR set for the run?)"}
    proc_rows = []
    for p in procs:
        row = {"proc": p.label, "sources": list(p.sources),
               "spans": len(p.spans), "records": len(p.records),
               "anchored": p.anchor is not None}
        if p.flight:
            row["flight"] = {"reason": p.flight.get("reason"),
                             "last_phase": p.flight.get("last_phase")}
            tr = p.flight.get("trace") or {}
            if tr.get("dropped"):
                row["flight"]["ring_drops"] = tr["dropped"]
        proc_rows.append(row)
    cross = sum(1 for r in proc_rows if r["spans"])
    out = {"ok": True, "path": str(run_dir), "processes": proc_rows,
           "traced_processes": cross,
           "flight_dumps": [r["proc"] for r in proc_rows
                            if "flight" in r]}
    out["critical_path"] = critical_path(procs, trace_id=trace_id)
    return out

"""Exporters: Chrome trace-event JSON (Perfetto-loadable) and a tiny
stdlib ``/metrics`` HTTP endpoint (counterpart of
``mxnet_tpu/observability/export.py``; the same documents from the same
spans).

Chrome trace-event format (the subset Perfetto's JSON importer
accepts): one complete event (``"ph": "X"``) per finished span with
microsecond ``ts``/``dur``, ``tid`` = thread name, and the
trace/span/parent IDs under ``args`` so the Perfetto query engine can
reconstruct the tree and join against journal records.

Track identity: ``pid`` is the span's rank UNLESS any span in the
document carries a ``replica`` tag — two replicas on one host share a
rank, and keying pid on rank alone interleaved them into one unreadable
track.  With replicas present, each
distinct (rank, replica) process gets its own synthetic pid plus a
``process_name`` metadata event (``"ph": "M"``) naming it, so Perfetto
shows one labeled track group per process.

Sources: the live tracer ring (:func:`to_chrome_trace` /
:func:`export_chrome`) or a diagnostics JSONL journal written with
``MXNET_TPU_TRACE=journal`` (:func:`chrome_trace_from_journal`), so a
killed process's trace is still recoverable from its journal file.

Stdlib-only.
"""
from __future__ import annotations

import json
import threading

from . import trace as _trace

__all__ = ["chrome_trace_from_journal", "export_chrome", "read_span_records",
           "serve_metrics", "spans_to_chrome", "to_chrome_trace"]


def _chrome_event(d: dict, pid: int) -> dict:
    args = dict(d.get("attrs") or {})
    args["trace_id"] = d.get("trace_id")
    args["span_id"] = d.get("span_id")
    if d.get("parent_id"):
        args["parent_id"] = d["parent_id"]
    if d.get("replica") is not None:
        args["replica"] = d["replica"]
    start = float(d.get("start_s") or 0.0)
    dur = d.get("dur_s")
    return {"name": str(d.get("name", "?")),
            "cat": "mxnet_tpu",
            "ph": "X",
            "ts": round(start * 1e6, 3),
            "dur": round(float(dur or 0.0) * 1e6, 3),
            "pid": pid,
            "tid": str(d.get("thread") or "main"),
            "args": args}


def process_key(d: dict) -> tuple:
    """The process identity a span belongs to: (rank, replica).  Rank
    alone is NOT enough — two subprocess replicas on one host both
    read rank 0 (the merged-trace pid collision this keying fixes)."""
    return (int(d.get("rank") or 0), d.get("replica"))


def process_label(key: tuple) -> str:
    rank, replica = key
    if replica is not None:
        return f"replica {replica}"
    return f"rank {rank}"


def assign_pids(keys) -> dict:
    """Stable pid per process key.  Rank-only processes keep
    ``pid == rank`` (the pre-replica documents stay bit-identical);
    replica-tagged processes get synthetic pids above every rank so
    no two processes ever share a track."""
    keys = sorted(keys, key=lambda k: (k[1] is not None, k))
    pids, used = {}, set()
    for key in keys:
        rank, replica = key
        if replica is None and rank not in used:
            pids[key] = rank
            used.add(rank)
    nxt = max(used, default=-1) + 1
    for key in keys:
        if key in pids:
            continue
        pids[key] = nxt
        used.add(nxt)
        nxt += 1
    return pids


def _metadata_event(pid: int, label: str) -> dict:
    return {"name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": label}}


def spans_to_chrome(spans, labels=None) -> dict:
    """Span dicts (``Span.to_dict`` / journal ``span`` records) → a
    Chrome trace-event document (``{"traceEvents": [...]}``).

    ``labels`` (optional ``{process_key: str}``) overrides the track
    names.  Metadata ``process_name`` events are emitted only when the
    document spans more than one process or any span carries a replica
    tag, so a single-process rank-keyed document has no metadata."""
    spans = list(spans)
    keys = {process_key(d) for d in spans}
    pids = assign_pids(keys)
    events = []
    if labels or len(keys) > 1 or any(k[1] is not None for k in keys):
        for key in sorted(pids, key=lambda k: pids[k]):
            label = (labels or {}).get(key) or process_label(key)
            events.append(_metadata_event(pids[key], label))
    events.extend(_chrome_event(d, pids[process_key(d)]) for d in spans)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def to_chrome_trace(tracer=None) -> dict:
    """The live tracer ring as a Chrome trace-event document."""
    tracer = tracer or _trace.get_tracer()
    return spans_to_chrome(tracer.spans())


def export_chrome(path, tracer=None) -> int:
    """Write the ring to ``path`` as Chrome trace JSON (atomically — a
    kill mid-export must not leave a torn half-trace that Perfetto
    rejects); returns the event count."""
    from ..resilience.atomic import atomic_write
    doc = to_chrome_trace(tracer)
    with atomic_write(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


def read_span_records(path) -> list:
    """``kind="span"`` records of a JSONL journal, junk and torn lines
    skipped (the torn tail of a killed writer must not hide the healthy
    prefix).  Raises OSError when the file is unreadable."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("kind") == "span":
                out.append(rec)
    return out


def chrome_trace_from_journal(path) -> dict:
    """Convert a JSONL journal's ``kind="span"`` records to a Chrome
    trace-event document (:func:`read_span_records`)."""
    return spans_to_chrome(read_span_records(path))


# -- /metrics endpoint -------------------------------------------------------

def serve_metrics(render, host="127.0.0.1", port=0):
    """Start a daemon-thread HTTP server exposing ``GET /metrics``
    rendered by ``render()`` (Prometheus text).  Returns the
    ``http.server`` instance — read the bound port from
    ``httpd.server_address[1]`` (``port=0`` picks a free one), stop with
    ``httpd.shutdown()``.  Loopback by default: this is an operator
    scrape target, not a public surface."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            try:
                body = render().encode("utf-8")
            except Exception as e:          # scrape must not kill serving
                self.send_error(500, str(e)[:100])
                return
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):       # no stderr chatter per scrape
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=httpd.serve_forever,
                         name="mxnet-torch-metrics-http", daemon=True)
    t.start()
    return httpd

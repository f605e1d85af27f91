"""Replica wire protocol: length-prefixed JSON frames, stdlib only
(counterpart of ``mxnet_tpu/serving/wire.py``, byte for byte its frames).

The replica pool's subprocess workers (``serving/worker.py``) sit behind
a loopback TCP socket; the router talks to them with one frame shape in
each direction::

    !II  header_len payload_len   (8-byte big-endian prefix)
    header_len bytes              (UTF-8 JSON dict)
    payload_len bytes             (raw C-order array bytes, optional)

Requests: ``{"cmd": "predict", "shape": [...], "dtype": "float32",
"deadline_ms": ..., "v": 1}`` + array bytes; control commands
(``drain``, ``resume``, ``stats``, ``ping``, ``pin``, ``stop``) carry no
payload. Responses: ``{"ok": true, "v": 1, "shape": [...], "dtype": ...,
"params_step": N}`` + array bytes, or ``{"ok": false, "error": <class
name>, "retryable": bool, ...}``, which the router maps back onto the
structured serving errors. ``v`` is the protocol version; readers ignore
keys they do not know.

Trace propagation: predict, decode and error frames carry the caller's
trace context, ``{"v": 1, "trace": {"trace_id": ..., "span_id": ...}}``
(:func:`attach_trace`), so the worker's ``serving_request`` and
``serving_batch`` spans become children of the router's request span
(:func:`extract_parent`). ``trace`` is always optional: with tracing off
a frame gains only ``v``, and a malformed context is ignored.

Every read is bounded by the socket timeout the caller set, and both
length fields are capped, so a garbage peer cannot make a reader
allocate unbounded memory.
"""
from __future__ import annotations

import json
import struct

__all__ = ["MAX_HEADER", "MAX_PAYLOAD", "PROTOCOL_VERSION", "WireError",
           "attach_trace", "extract_parent", "recv_frame", "send_frame"]

_PREFIX = struct.Struct("!II")
MAX_HEADER = 1 << 20             # 1 MiB of JSON is already a bug
MAX_PAYLOAD = 1 << 30            # caps a corrupt length field, not traffic
PROTOCOL_VERSION = 1             # bump on incompatible header changes


def attach_trace(header: dict) -> dict:
    """Stamp the protocol version and the calling context's trace ids
    onto an outgoing frame header (in place; returns it). With tracing
    off, or outside any span, the header gains only ``v``."""
    from ..observability import trace as _trace
    header.setdefault("v", PROTOCOL_VERSION)
    ids = _trace.current_ids()
    if ids:
        header["trace"] = ids
    return header


def extract_parent(header: dict):
    """The propagated trace context of an incoming frame as a
    :class:`~..observability.trace.SpanContext` (the ``parent=`` a
    server-side root span re-anchors under), or None when the frame
    carries none or a malformed one."""
    doc = header.get("trace")
    if not isinstance(doc, dict):
        return None
    tid, sid = doc.get("trace_id"), doc.get("span_id")
    if not isinstance(tid, str) or not isinstance(sid, str):
        return None
    from ..observability import trace as _trace
    return _trace.SpanContext(tid, sid)


class WireError(ValueError):
    """Malformed frame (bad prefix, oversized length, torn stream)."""


def send_frame(sock, header: dict, payload: bytes = b"") -> None:
    """Serialize and send one frame (``sendall``, bounded by the
    socket's timeout). The payload is sent as it is, never copied into a
    concatenated buffer."""
    h = json.dumps(header).encode("utf-8")
    sock.sendall(_PREFIX.pack(len(h), len(payload)) + h)
    if payload:
        sock.sendall(payload)


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 16))
        if not chunk:
            raise WireError(f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock):
    """Read one frame; returns ``(header dict, payload bytes)``. Raises
    :class:`WireError` on a malformed stream and lets ``socket.timeout``
    and ``OSError`` of the bounded reads through."""
    raw = _recv_exact(sock, _PREFIX.size)
    hlen, plen = _PREFIX.unpack(raw)
    if hlen > MAX_HEADER or plen > MAX_PAYLOAD:
        raise WireError(f"frame lengths out of bounds ({hlen}, {plen})")
    try:
        header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"unparsable frame header: {e}") from None
    if not isinstance(header, dict):
        raise WireError("frame header is not a dict")
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload

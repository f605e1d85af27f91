"""Replica worker: one :class:`~.server.Server` behind a socket front
(counterpart of ``mxnet_tpu/serving/worker.py``).

``python -m mxnet_tpu_torch.serving worker --replica-id r0 --hb-dir
POOL/hb`` runs a serving replica as its own process, with its own CUDA
context, queue, predictor cache and hot-reload ``ParamStore``: the unit
the replica pool (``serving/pool.py``) multiplexes and SIGKILLs. It
serves on ``cuda:0`` unless ``--ctx cpu`` asks for the CPU; with
``--model mlp`` its ``start()`` captures the graph of every batch bucket
of the model's one feature shape before it admits traffic (the
reference's worker compiles at the first batch). The CUDA kernels it
runs load from the checkout's build directory; a worker builds one only
when no current library is there (``stats`` frames report
``kernels_built`` and the kernel launch counts).

Contract with the pool:

- the worker binds a loopback TCP socket (``--port 0`` picks a free
  one) and publishes the bound port in its heartbeat payload; the
  readiness beacon (``elastic.membership.Heartbeat``) is the one
  discovery channel;
- the beacon carries ``ready`` (started, not draining), ``queue_depth``,
  ``params_step``, ``last_batch_age_s``, ``port`` and ``pid``;
- requests arrive as wire frames (``serving/wire.py``); failures map
  onto the structured serving errors with the ``retryable`` verdict the
  router honours;
- ``drain`` closes admission at the front door, lets the queue empty
  under a bounded deadline and reports the residual; ``stop`` shuts the
  server down and exits 0;
- a predict frame's trace context (``wire.extract_parent``) re-anchors
  the request's ``serving_request`` span under the router's attempt,
  and an error frame echoes the context;
- the worker stamps ``MXNET_TPU_REPLICA_ID`` into its environment, and
  with ``MXNET_TPU_TRACE_DIR`` set it runs the flight recorder there
  (``observability.flight``): dumps at SIGTERM, exit and stall, and
  every ``MXNET_TPU_TRACE_FLIGHT_S`` seconds, so a SIGKILLed worker
  leaves its last spans behind.

``--tenants "a=scale,b=mlp@/ckpt/b"`` runs a :class:`~.fleet.Fleet`
instead: one tenant per entry, its block built by the factory of the
named worker model at page-in, hot-reloading from its own commit root
when ``@root`` is given. Requests name their tenant in the frame
header, failures come back tenant-labelled (a quarantined tenant as
``TenantQuarantined`` with the fleet's ``retryable`` verdict), and the
beacon advertises the served tenants.

Not ported yet, and refused by name: ``--mesh-axes`` (ROADMAP Queue 1
item 9), ``--aot-dir`` (the AOT store, item 5g) and the
``MXNET_TPU_TESTING_SLOW_PREDICT_S`` chaos seam (item 13).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading

import numpy as np

from ..diagnostics.journal import get_journal
from . import wire

__all__ = ["add_worker_args", "cmd_worker"]


def _build_block(model: str, dim: int, ctx):
    """The worker's model on ``ctx``, its weights drawn from a CPU
    generator seeded 0 (the same values on every device)."""
    from .. import random as _random
    from ..gluon import nn
    from ..gluon.block import HybridBlock
    from ..gluon.parameter import DeferredParams

    if model == "scale":
        class Scale(DeferredParams, HybridBlock):
            """y = x * w, scalar weight: shape-agnostic, padding-exact,
            and the weight's value fingerprints the served checkpoint."""

            def __init__(self):
                super().__init__()
                self._declare("w", (1,), init="ones")

            def infer_shape(self, x):
                pass

            def forward(self, x):
                return x * self.w

        net = Scale()
    elif model == "mlp":
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu", in_units=dim))
        net.add(nn.Dense(8, in_units=32))
    else:
        raise ValueError(f"unknown worker model {model!r} "
                         "(scale|mlp)")
    net.initialize(ctx=ctx, generator=_random.generator(0))
    return net


def _parse_tenants(spec: str) -> list:
    """``--tenants "a=scale,b=mlp@/ckpt/b"`` → [(name, model, root)].
    ``@root`` is optional; the model is one of the worker models."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, rest = part.partition("=")
        if not rest:
            raise ValueError(f"tenant spec {part!r} is not "
                             "name=model[@ckpt_root]")
        model, _, root = rest.partition("@")
        out.append((name.strip(), model.strip(), root.strip() or None))
    if not out:
        raise ValueError(f"--tenants {spec!r} names no tenants")
    return out


def _error_doc(exc, request_header=None) -> dict:
    doc = {"ok": False, "v": wire.PROTOCOL_VERSION,
           "error": type(exc).__name__,
           "retryable": bool(getattr(exc, "retryable", True)),
           "detail": str(exc)[:300]}
    for attr in ("stage", "late_ms", "depth", "limit", "tier",
                 "tenant", "reason", "slots", "queued"):
        v = getattr(exc, attr, None)
        if v is not None:
            doc[attr] = v
    # an error frame echoes the request's trace context unchanged
    trace_ctx = (request_header or {}).get("trace")
    if isinstance(trace_ctx, dict):
        doc["trace"] = trace_ctx
    return doc


class _Front:
    """The socket front door: accept loop + per-connection handlers,
    every wait bounded (accept timeout, per-socket recv timeouts)."""

    def __init__(self, server, args):
        self.server = server
        self.args = args
        self.stop_evt = threading.Event()
        self.draining = False
        self.sock = socket.create_server(("127.0.0.1", args.port))
        self.port = self.sock.getsockname()[1]
        self.sock.settimeout(0.25)

    def beacon(self) -> dict:
        doc = self.server.beacon()
        doc["port"] = self.port
        doc["draining"] = self.draining
        doc["ready"] = bool(doc["ready"]) and not self.draining \
            and not self.stop_evt.is_set()
        return doc

    def run(self):
        while not self.stop_evt.is_set():
            try:
                conn, _addr = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
        self.sock.close()

    def _handle(self, conn):
        with conn:
            conn.settimeout(10.0)          # the header must come promptly
            try:
                header, payload = wire.recv_frame(conn)
            except (OSError, wire.WireError):
                return                     # peer vanished: nothing to say
            try:
                self._dispatch(conn, header, payload)
            except (OSError, wire.WireError):
                pass                       # reply path gone: request ends
            except Exception as exc:       # a defect, not traffic: journal
                get_journal().crash(exc, where="replica_worker")
                try:
                    wire.send_frame(conn, _error_doc(exc, header))
                except OSError:
                    pass

    def _dispatch(self, conn, header, payload):
        from .batcher import RequestError
        cmd = header.get("cmd")
        if cmd == "predict":
            self._predict(conn, header, payload)
        elif cmd == "decode":
            self._decode(conn, header, payload)
        elif cmd == "drain":
            self.draining = True
            deadline = float(header.get("deadline_s", 20.0))
            residual = _wait_queue_empty(self.server, deadline)
            wire.send_frame(conn, {"ok": True, "residual": residual})
        elif cmd == "resume":
            self.draining = False
            wire.send_frame(conn, {"ok": True})
        elif cmd == "stats":
            from .. import kernels
            from ..kernels import _build
            st = json.loads(json.dumps(self.server.stats(), default=str))
            st["kernel_launches"] = kernels.launch_counts()
            st["kernels_built"] = list(_build.BUILT)
            wire.send_frame(conn, {"ok": True, "stats": st})
        elif cmd == "ping":
            wire.send_frame(conn, {"ok": True, "pid": os.getpid()})
        elif cmd == "pin":
            # pin or unpin the ParamStore to one step; the worker thread
            # moves the live version at its next turn
            step = header.get("step")
            took = bool(self.server.pin_params(step))
            wire.send_frame(conn, {"ok": True, "pinned": took,
                                   "step": step})
        elif cmd == "stop":
            wire.send_frame(conn, {"ok": True})
            self.stop_evt.set()
        else:
            wire.send_frame(conn, _error_doc(
                RequestError(f"unknown command {cmd!r}"), header))

    def _predict(self, conn, header, payload):
        from .batcher import RequestError, ServerStopped
        if self.draining or self.stop_evt.is_set():
            err = ServerStopped("replica draining")
            wire.send_frame(conn, _error_doc(err, header))
            return
        x = np.frombuffer(payload, dtype=header["dtype"]).reshape(
            header["shape"])
        deadline_ms = header.get("deadline_ms")
        budget_s = (deadline_ms / 1000.0 if deadline_ms
                    else self.server.config.result_timeout_s)
        conn.settimeout(budget_s + 10.0)
        # the frame's trace context: one trace_id across both processes
        parent = wire.extract_parent(header)
        try:
            resp = self.server.submit(x, deadline_ms=deadline_ms,
                                      tenant=header.get("tenant"),
                                      parent=parent)
            out = resp.result(timeout_s=budget_s + 5.0)
        except RequestError as exc:
            wire.send_frame(conn, _error_doc(exc, header))
            return
        if not isinstance(out, np.ndarray):
            err = RequestError("replica model returned a non-array tree; "
                               "the wire protocol ships single arrays")
            err.retryable = False
            wire.send_frame(conn, _error_doc(err, header))
            return
        wire.send_frame(
            conn,
            {"ok": True, "v": wire.PROTOCOL_VERSION,
             "shape": list(out.shape), "dtype": str(out.dtype),
             "params_step": resp.params_step},
            np.ascontiguousarray(out).tobytes())

    def _decode(self, conn, header, payload):
        from .batcher import RequestError, ServerStopped
        if self.draining or self.stop_evt.is_set():
            wire.send_frame(conn, _error_doc(
                ServerStopped("replica draining"), header))
            return
        prompt = np.frombuffer(payload, dtype=np.int32)
        deadline_ms = header.get("deadline_ms")
        budget_s = (deadline_ms / 1000.0 if deadline_ms
                    else self.server.config.result_timeout_s)
        conn.settimeout(budget_s + 10.0)
        try:
            stream = self.server.decode_submit(
                prompt, max_new_tokens=header.get("max_new"),
                deadline_ms=deadline_ms, tenant=header.get("tenant"))
            toks = stream.result(timeout_s=budget_s + 5.0)
        except RequestError as exc:
            wire.send_frame(conn, _error_doc(exc, header))
            return
        out = np.asarray(toks, dtype=np.int32)
        wire.send_frame(
            conn,
            {"ok": True, "v": wire.PROTOCOL_VERSION,
             "generated": int(out.size)},
            np.ascontiguousarray(out).tobytes())


def _wait_queue_empty(server, deadline_s, poll_s=0.02) -> int:
    """Bounded drain wait: poll until the admission queue is empty or
    the deadline passes. Returns the residual depth (0 = clean)."""
    from .pool import _wait_for
    _wait_for(lambda: server.queue_depth() == 0, deadline_s, poll_s)
    return server.queue_depth()


def add_worker_args(parser) -> None:
    parser.add_argument("--replica-id", required=True)
    parser.add_argument("--hb-dir", required=True,
                        help="pool heartbeat ledger directory")
    parser.add_argument("--heartbeat-s", type=float, default=0.5)
    parser.add_argument("--port", type=int, default=0,
                        help="0 = ephemeral; the bound port is published "
                             "in the heartbeat beacon")
    parser.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu",
                        help="serve on cuda:0 (default) or on the CPU")
    parser.add_argument("--model", default="scale", help="scale|mlp")
    parser.add_argument("--dim", type=int, default=16)
    parser.add_argument("--ckpt-root", default=None,
                        help="resilience.commit root for hot reload")
    parser.add_argument("--tenants", default=None,
                        help='a multi-tenant fleet: "a=scale,b=mlp@root"')
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--window-ms", type=float, default=2.0)
    parser.add_argument("--max-queue", type=int, default=64)
    parser.add_argument("--deadline-ms", type=float, default=2000.0)
    parser.add_argument("--reload-poll-s", type=float, default=0.5)
    parser.add_argument("--pin-step", type=int, default=None,
                        help="pin the ParamStore to this committed step "
                             "at startup")
    parser.add_argument("--aot-dir", default=None,
                        help="the AOT executable store (not ported yet)")
    parser.add_argument("--mesh-axes", default=None,
                        help="tensor-parallel serving (not ported yet)")
    parser.add_argument("--decode-slots", type=int, default=0,
                        help="run a continuous-batching decode engine "
                             "with this many slots beside the one-shot "
                             "batcher (0 = off; it serves TinyLM)")
    parser.add_argument("--decode-max-len", type=int, default=256,
                        help="decode engine per-slot capacity "
                             "(prompt + generated tokens)")


def _refuse_unported(args) -> None:
    for flag, value, item in (
            ("--mesh-axes", args.mesh_axes, "ROADMAP Queue 1 item 9"),
            ("--aot-dir", args.aot_dir, "the AOT store, ROADMAP Queue 1 "
             "item 5g")):
        if value:
            raise NotImplementedError(f"worker {flag} is not ported yet "
                                      f"({item})")
    if os.environ.get("MXNET_TPU_TESTING_SLOW_PREDICT_S"):
        raise NotImplementedError(
            "the MXNET_TPU_TESTING_SLOW_PREDICT_S chaos seam is not ported "
            "yet (chaos/, ROADMAP Queue 1 item 13)")


def cmd_worker(args) -> int:
    from ..context import cpu, gpu
    from ..elastic.membership import Heartbeat
    from ..observability import flight
    from .reload import ParamStore
    from .server import Server, ServerConfig

    _refuse_unported(args)
    # pod attribution: every span, anchor and flight record names the
    # replica, also when the worker is launched by hand
    os.environ.setdefault("MXNET_TPU_REPLICA_ID", str(args.replica_id))
    j = get_journal()
    j.set_phase("replica_worker_setup")
    # the flight recorder (MXNET_TPU_TRACE_DIR), before the model is
    # built: a worker killed while capturing still leaves its dump
    recorder = flight.install_from_env()
    ctx = cpu() if args.ctx == "cpu" else gpu(0)
    kw = {}
    if args.decode_slots:
        from .decode import DecodeConfig, TinyLM
        kw["decode_model"] = TinyLM(max_len=args.decode_max_len)
        kw["decode"] = DecodeConfig(slots=args.decode_slots)
    knobs = dict(max_batch=args.max_batch, window_ms=args.window_ms,
                 max_queue=args.max_queue,
                 default_deadline_ms=args.deadline_ms,
                 reload_poll_s=args.reload_poll_s, **kw)
    if args.tenants:
        from .fleet import Fleet, FleetConfig
        server = Fleet(FleetConfig(**knobs), ctx=ctx)
        for name, model, root in _parse_tenants(args.tenants):
            server.add_tenant(
                name, factory=lambda m=model: _build_block(m, args.dim, ctx),
                ckpt_root=root)
        server.start()
    else:
        net = _build_block(args.model, args.dim, ctx)
        if args.model == "mlp":
            # its one feature shape: every bucket's graph captured at
            # start()
            knobs["aot_prewarm"] = ((args.dim,),)
        store = ParamStore(args.ckpt_root) if args.ckpt_root else None
        if store is not None and args.pin_step is not None:
            store.pin_step(args.pin_step)  # before start(): the initial
                                           # reload lands on the pin
        server = Server(net, config=ServerConfig(**knobs),
                        param_store=store, ctx=ctx).start()

    front = _Front(server, args)
    hb = Heartbeat(args.hb_dir, args.replica_id, args.heartbeat_s,
                   payload=front.beacon, prefix="replica").start()
    j.event("replica_worker_start", replica=args.replica_id,
            port=front.port, model=args.model, pid=os.getpid())

    # a pool-side terminate (the restart fallback) still drains: flip the
    # stop event and let the main loop shut down cleanly
    signal.signal(signal.SIGTERM,
                  lambda signum, frame: front.stop_evt.set())

    j.set_phase("replica_worker_serve")
    try:
        front.run()
    finally:
        j.set_phase("replica_worker_stop")
        try:
            server.stop(timeout_s=30.0)
        finally:
            hb.stop(resign=True)
        if recorder is not None:
            recorder.stop(dump=True)       # the clean-exit flight dump
        j.event("replica_worker_stop", replica=args.replica_id)
    return 0


if __name__ == "__main__":        # direct run (the pool uses -m ..serving)
    ap = argparse.ArgumentParser()
    add_worker_args(ap)
    sys.exit(cmd_worker(ap.parse_args()))

#!/usr/bin/env python3
"""A CUDA-graph capture beside a serving thread, on the card.

    python3 tools/capture_probe.py                 # both modes
    python3 tools/capture_probe.py --mode global   # one mode, in-process

Server A (an MLP of three Dense layers, 1024 -> 4096 -> 4096 -> 1024,
relu through the matmul-epilogue kernel, batch buckets 1-8 prewarmed as
CUDA graphs) answers requests from 4 client threads: each answer is a
graph replay on A's worker thread and a copy of the outputs to the host.
Meanwhile the main thread builds server B of the same model 3 times;
B's ``start()`` captures one CUDA graph per bucket. The capture mode
comes from ``gluon.cached_graph.CudaGraphs.capture_error_mode``.

Without ``--mode`` each mode runs in its own process (a failed capture
may leave its process unusable): "global", CUDA's default, in which a
call that is unsafe during a capture (a synchronizing copy, an event
query) on any thread fails and invalidates the capture, and
"thread_local", the port's, in which only the capturing thread is
barred. Each process prints one JSON line: B's captures ("ok" or the
error), A's answers, failures and wrong answers (each must equal the
first answer within 1e-5 of its max |value|), and A's latency p50/p99
while B was being built and captured and while it was not. Needs one
CUDA card and the checkout's kernels (built at first use).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("global", "thread_local")
CLIENTS = 4
ROUNDS = 3
WIDTHS = (1024, 4096, 4096, 1024)
TOL = 1e-5      # of max |answer|: batches of other sizes take other GEMMs


def _percentile(values, q):
    values = sorted(values)
    if not values:
        return None
    return values[min(int(len(values) * q / 100.0), len(values) - 1)]


def probe(mode):
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import cached_graph, nn
    from mxnet_tpu_torch.serving import Server, ServerConfig
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cached_graph.CudaGraphs.capture_error_mode = mode

    def build():
        net = nn.HybridSequential()
        for i, (n_in, n_out) in enumerate(zip(WIDTHS, WIDTHS[1:])):
            last = i == len(WIDTHS) - 2
            net.add(nn.Dense(n_out, activation=None if last else "relu",
                             in_units=n_in))
        net.initialize(ctx=mx.gpu(0), generator=mx.random.generator(0))
        return Server(net, ServerConfig(max_batch=8,
                                        aot_prewarm=((WIDTHS[0],),)),
                      ctx=mx.gpu(0))

    a = build().start()
    x = np.random.RandomState(0).randn(WIDTHS[0]).astype(np.float32)
    ref = a.predict(x)
    scale = float(np.abs(ref).max())
    stop = threading.Event()
    answers, failures, wrong = [], [], []

    def client():
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                y = a.predict(x, timeout_s=60)
            except Exception as exc:      # counted and reported
                failures.append(f"{type(exc).__name__}: {str(exc)[:160]}")
                time.sleep(0.01)
                continue
            err = float(np.abs(y - ref).max())
            if not err <= TOL * scale:
                wrong.append(err)
            answers.append((t0, time.monotonic()))

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(CLIENTS)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    captures, windows = [], []
    for _ in range(ROUNDS):
        t0 = time.monotonic()
        try:
            b = build().start()
            captures.append({"ok": b.last_prewarm["compiled"],
                             "s": round(time.monotonic() - t0, 3)})
            b.stop()
            del b
        except Exception as exc:          # the finding, reported
            captures.append(f"{type(exc).__name__}: {str(exc)[:200]}")
        windows.append((t0, time.monotonic()))
        time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    a.stop()

    def inside(span):
        return any(w0 <= span[0] <= w1 or w0 <= span[1] <= w1
                   for w0, w1 in windows)

    during = [(t1 - t0) * 1e3 for t0, t1 in answers if inside((t0, t1))]
    other = [(t1 - t0) * 1e3 for t0, t1 in answers if not inside((t0, t1))]
    return {"mode": mode, "card": torch.cuda.get_device_name(0),
            "captures": captures, "answers": len(answers),
            "failures": len(failures), "failure_kinds": sorted(
                set(f.split(":")[0] for f in failures)),
            "first_failure": failures[0] if failures else None,
            "wrong": len(wrong),
            "latency_ms_during_b": {"n": len(during),
                                    "p50": _percentile(during, 50),
                                    "p99": _percentile(during, 99)},
            "latency_ms_otherwise": {"n": len(other),
                                     "p50": _percentile(other, 50),
                                     "p99": _percentile(other, 99)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=MODES, default=None)
    args = ap.parse_args()
    if args.mode is not None:
        print(json.dumps(probe(args.mode)), flush=True)
        return 0
    for mode in MODES:
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--mode", mode],
                capture_output=True, text=True, timeout=300,
                env=dict(os.environ, MXNET_TPU_JOURNAL="off"))
        except subprocess.TimeoutExpired:
            print(json.dumps({"mode": mode, "result": "timed out (300 s)"}),
                  flush=True)
            continue
        lines = out.stdout.strip().splitlines()
        print(lines[-1] if out.returncode == 0 and lines else json.dumps(
            {"mode": mode, "exit": out.returncode,
             "stderr_tail": out.stderr.strip()[-600:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

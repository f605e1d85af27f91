#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (nothing is caught):

1. card   — require CUDA; print the card's name and power limit
            (nvidia-smi) and switch TF32 off for matmul and cuDNN.
2. build  — compile every CUDA kernel of the port from its source with
            nvcc for sm_90a, all sources at once; print the seconds.
3. kernel — hold the conv-epilogue kernel (K1) against its plain PyTorch
            version on the card: ResNet-50 v1's own epilogue shapes at
            batch 8 and ragged ones; row, column and none modes; with and
            without a residual; all five activations; float32 and
            bfloat16. Per case: max error, tolerance, kernel and plain
            times (CUDA graphs of back-to-back launches over enough input
            copies to exceed the 50 MB L2, timed with CUDA events after
            warm-up) and the bytes bound at 3.35 TB/s.
4. serve  — full-width ResNet-50 v1 (224x224x3, 1000 classes, seeded
            random weights and BatchNorm statistics) behind the port's
            Server on cuda:0, batch buckets 1-8, float32. 32 single-image
            requests from 4 threads must all be answered; K1 must run 48
            times per batch forward; the logits must match the same model
            and weights run on the CPU (plain versions).

The line before the last lists every kernel as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside this file, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
FP32_OPS_PER_S = 67e12               # H100 SXM float32 outside tensor cores
BATCH = 8
SEED = 0
N_REQUESTS = 32
LOGIT_RTOL = 1e-3                    # of max |logit|, TF32 off


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# -- phase 1: card -----------------------------------------------------------
def phase_card(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


# -- phase 2: build ----------------------------------------------------------
def phase_build():
    from mxnet_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    outputs = _build.build_all()
    secs = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.load(name)
    regs, spills = [], 0
    for text in outputs.values():
        for line in text.splitlines():
            if "Used" in line and "registers" in line:
                regs.append(int(line.split("Used")[1].split()[0]))
            if "spill stores" in line:
                spills += int(line.split("bytes spill stores")[0]
                              .split()[-1])
    log(f"build: {list(_build.SOURCES)} in {secs:.2f} s with "
        f"{os.path.basename(_build.nvcc_path())} (sm_90a); kernels "
        f"compiled {len(regs)}, max registers {max(regs, default=0)}, "
        f"spill-store bytes {spills}")
    return secs


# -- phase 3: kernel ---------------------------------------------------------
def resnet50_epilogues(batch):
    """(name, shape, vectors?, residual?) of the 48 conv-epilogue calls of
    one ResNet-50 v1 forward at 224x224: per bottleneck two BatchNorm+relu
    (row mode over NCHW) and one residual add+relu (no vectors)."""
    calls = []
    for stage, (blocks, channels, side) in enumerate(
            [(3, 256, 56), (4, 512, 28), (6, 1024, 14), (3, 2048, 7)], 1):
        for b in range(blocks):
            for k in (1, 3):
                calls.append((f"s{stage}.{b}.bn{k}_relu",
                              (batch, channels // 4, side, side), True,
                              False))
            calls.append((f"s{stage}.{b}.residual_relu",
                          (batch, channels, side, side), False, True))
    return calls


def _bytes(shape, dtype_size, vectors, with_res, channels):
    n = math.prod(shape)
    return dtype_size * (n * (2 + int(with_res))
                         + (2 * channels if vectors else 0))


_ACT_OPS = {"identity": 0, "relu": 1, "gelu": 8, "tanh": 6, "sigmoid": 4}


def bound_ms(shape, dtype_size, vectors, with_res, channels, act):
    """The larger of bytes / HBM rate and operations / fp32 rate, in ms;
    returns (ms, "bytes" or "operations")."""
    n = math.prod(shape)
    by = _bytes(shape, dtype_size, vectors, with_res, channels) \
        / HBM_BYTES_PER_S
    ops = n * (2 * int(vectors) + int(with_res) + _ACT_OPS[act]) \
        / FP32_OPS_PER_S
    return (by * 1e3, "bytes") if by >= ops else (ops * 1e3, "operations")


def graph_ms(torch, launch, n_copies, reps=5):
    """Device time of one ``launch(i)`` (i cycles over the input copies),
    from CUDA graphs of back-to-back launches timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(min(3, n_copies)):       # warm-up
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    n_launch = max(n_copies, 32)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_launch):
            launch(i % n_copies)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * n_launch)
    del graph
    return ms


def run_case(torch, ce, case):
    name, shape, axis, vectors, with_res, act, dtype = case
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    channels = shape[axis]
    esize = torch.tensor([], dtype=dtype).element_size()
    per_launch = _bytes(shape, esize, vectors, with_res, channels)
    n_copies = max(1, min(64, math.ceil(160e6 / per_launch)))

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    xs = [rnd(*shape) for _ in range(n_copies)]
    rs = [rnd(*shape) for _ in range(n_copies)] if with_res else None
    s = (torch.rand(channels, generator=gen, device=dev) + 0.5).to(dtype) \
        if vectors else None
    b = rnd(channels, scale=0.1) if vectors else None
    with torch.inference_mode():
        got = ce.fused_conv_epilogue(xs[0], s, b, rs[0] if rs else None,
                                     channel_axis=axis, act_type=act)
        want = ce.fused_conv_epilogue_plain(xs[0], s, b,
                                            rs[0] if rs else None,
                                            channel_axis=axis, act_type=act)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol + tol * want.float().abs()).all()) \
            and got.shape == want.shape and got.dtype == want.dtype
        k_ms = graph_ms(torch, lambda i: ce.fused_conv_epilogue(
            xs[i], s, b, rs[i] if rs else None, channel_axis=axis,
            act_type=act), n_copies)
        p_ms = graph_ms(torch, lambda i: ce.fused_conv_epilogue_plain(
            xs[i], s, b, rs[i] if rs else None, channel_axis=axis,
            act_type=act), n_copies)
    bnd, by = bound_ms(shape, esize, vectors, with_res, channels, act)
    mode = "none" if not vectors else (
        "col" if axis in (-1, len(shape) - 1) else "row")
    log(f"  {name:24s} {str(tuple(shape)):22s} {mode:4s} "
        f"res={int(with_res)} {act:8s} {str(dtype)[6:]:8s} "
        f"max_err={err:.3e} tol={tol:g} kernel_ms={k_ms:.6f} "
        f"plain_ms={p_ms:.6f} bound_ms={bnd:.6f} ({by}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"conv_epilogue disagrees with its plain version on {name} "
             f"{tuple(shape)} {act} {dtype}: max_err {err} > tol {tol}")
    return {"err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd,
            "bound_by": by}


def phase_kernel(torch, ce):
    log("kernel: conv_epilogue vs its plain version on the card")
    calls = resnet50_epilogues(BATCH)
    if len(calls) != 48:
        fail(f"expected 48 epilogue calls per forward, listed {len(calls)}")
    per_shape = {}
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, vectors, with_res in calls:
            key = (shape, vectors, with_res, dtype)
            if key not in per_shape:
                per_shape[key] = run_case(torch, ce, (
                    name, shape, 1, vectors, with_res, "relu", dtype))
    # ragged shapes, every mode, residual or not, every activation
    ragged = [("ragged_row", (3, 5, 7, 11), 1, True),
              ("ragged_col", (77, 13), -1, True),
              ("ragged_none", (1, 2048, 7, 7), 1, False),
              ("batch1_bn_row", (1, 512, 7, 7), 1, True)]
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for act in ("identity", "relu", "gelu", "tanh", "sigmoid"):
            for name, shape, axis, vectors in ragged:
                for with_res in ((False, True) if vectors else (True,)):
                    r = run_case(torch, ce, (name, shape, axis, vectors,
                                             with_res, act, dtype))
                    errs[dtype] = max(errs[dtype], r["err"])
    f32 = [per_shape[(shape, v, res, torch.float32)]
           for _, shape, v, res in calls]
    bf16 = [per_shape[(shape, v, res, torch.bfloat16)]
            for _, shape, v, res in calls]
    results["ms"] = sum(r["ms"] for r in f32)
    results["plain_ms"] = sum(r["plain_ms"] for r in f32)
    results["bound_ms"] = sum(r["bound_ms"] for r in f32)
    results["bound_by"] = "bytes" if all(
        r["bound_by"] == "bytes" for r in f32) else "operations"
    results["max_abs_err"] = max(r["err"] for r in f32)
    results["max_abs_err_bf16"] = max(max(r["err"] for r in bf16),
                                      errs[torch.bfloat16])
    results["max_abs_err_ragged_fp32"] = errs[torch.float32]
    total_bytes = sum(_bytes(shape, 4, v, res, shape[1])
                      for _, shape, v, res in calls)
    log(f"kernel: one ResNet-50 forward at batch {BATCH}, float32, 48 "
        f"launches: kernel {results['ms']:.6f} ms, plain "
        f"{results['plain_ms']:.6f} ms, bound {results['bound_ms']:.6f} ms "
        f"({total_bytes / 1e9:.4f} GB at 3.35 TB/s)")
    return results


# -- phase 4: serve ----------------------------------------------------------
def phase_serve(torch, mx, card, ctx, size=224):
    """Serve ResNet-50 v1 on ``ctx`` at ``size`` x ``size`` inputs."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.serving import Server, ServerConfig
    import numpy as np

    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=mx.random.generator(SEED))
    with torch.inference_mode():
        for b in (1, 2, 4, 8):          # materialize and warm every bucket
            net(torch.zeros(b, 3, size, size, device=ctx.torch_device))
    _sync(torch)
    rng = np.random.RandomState(SEED)
    stats = {}
    for name, t in net.collect_params().items():
        shape = tuple(t.shape)
        if name.endswith("running_mean") or name.endswith("beta"):
            stats[name] = rng.randn(*shape).astype(np.float32) * 0.1
        elif name.endswith("running_var") or name.endswith("gamma"):
            stats[name] = rng.rand(*shape).astype(np.float32) + 0.5
    params = {k: v.detach().cpu().numpy()
              for k, v in net.collect_params().items()}
    params.update(stats)
    net.load_dict(params)
    images = rng.randn(N_REQUESTS, 3, size, size).astype(np.float32)

    server = Server(net, ServerConfig(max_batch=8), ctx=ctx).start()

    def round_trip(indices, n_threads):
        """Submit ``images[indices]`` from ``n_threads`` threads, each
        submitting its share at once, and wait for every answer."""
        results, errors = {}, []

        def client(idx):
            try:
                pending = [(i, server.submit(images[i])) for i in idx]
                for i, p in pending:
                    results[i] = p.result(120)
            except Exception as exc:      # reported below, then fail
                errors.append(repr(exc))

        indices = list(indices)
        threads = [threading.Thread(target=client,
                                    args=(indices[k::n_threads],))
                   for k in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads) \
                or len(results) != len(indices):
            fail(f"serving failed: {len(results)} of {len(indices)} "
                 f"answered; errors {errors}")
        return results, wall

    # warm-up: every batch bucket once through the worker thread, which
    # keeps its own per-thread library state (cuDNN and cuBLAS handles)
    for b in (8, 4, 2, 1):
        round_trip(range(b), 1)
    from mxnet_tpu_torch import kernels
    _sync(torch)
    before = server.stats()
    server.latency.reset()
    server.exec_ms.reset()
    kernels.reset_launch_counts()
    results, wall = round_trip(range(N_REQUESTS), 4)
    launches = kernels.launch_counts()
    after = server.stats()
    server.stop()
    batches = after["batches"] - before["batches"]
    if after["served"] - before["served"] != N_REQUESTS:
        fail(f"only {after['served'] - before['served']} of {N_REQUESTS} "
             "requests answered")
    if launches["conv_epilogue"] != 48 * batches:
        fail(f"conv_epilogue launched {launches['conv_epilogue']} times "
             f"for {batches} batch forwards (want 48 each)")
    lat, ex = after["latency_ms"], after["exec_ms"]
    log(f"serve: {N_REQUESTS} requests (4 threads, each submitting 8 at "
        f"once) answered in {batches} batches, conv_epilogue launches "
        f"{launches['conv_epilogue']} (= 48 x {batches}); latency p50 "
        f"{lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms; "
        f"{N_REQUESTS / wall:.2f} "
        f"images/s ({wall * 1e3:.3f} ms wall) on {card}")
    log(f"serve: predictor call per batch (worker thread): p50 "
        f"{ex['p50']:.3f} ms, max {ex['max']:.3f} ms over {ex['count']} "
        f"batches")
    results = [results[i] for i in range(N_REQUESTS)]

    profile_forward(torch, net, ctx, size)

    # the same model and weights on the CPU: the plain versions
    out = np.stack(results)
    if out.shape != (N_REQUESTS, 1000) or not np.isfinite(out).all():
        fail(f"logits have shape {out.shape} or are not finite")
    cpu_net = resnet50_v1()
    cpu_net.load_dict({k: v.detach().cpu().numpy()
                       for k, v in net.collect_params().items()},
                      ctx=mx.cpu())
    with torch.inference_mode():
        ref = np.concatenate([
            cpu_net(torch.from_numpy(images[i:i + 8])).numpy()
            for i in range(0, N_REQUESTS, 8)])
    scale = float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    log(f"serve: logits vs the CPU run: max abs err {err:.6e}, max |logit| "
        f"{scale:.6e}, relative {err / scale:.3e} (tolerance {LOGIT_RTOL:g} "
        f"of max |logit|, TF32 off)")
    if not err <= LOGIT_RTOL * scale:
        fail(f"served logits differ from the CPU run by {err} "
             f"> {LOGIT_RTOL} x {scale}")
    return launches


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def profile_forward(torch, net, ctx, size, batch=BATCH, reps=10):
    """Where one batch forward's time goes, on the calling thread: the
    host clock around forward + synchronize (median of ``reps``), and
    the device time of every kernel from torch.profiler."""
    if ctx.device_type != "gpu":
        return
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(batch, 3, size, size, device=ctx.torch_device)
    with torch.inference_mode():
        for _ in range(3):
            net(x)
        torch.cuda.synchronize()
        wall = _median_ms(lambda: (net(x), torch.cuda.synchronize()), reps)
    from mxnet_tpu_torch.serving import Predictor
    padded = x.cpu().numpy()
    pred = Predictor(net, ctx.torch_device)
    pred(padded)
    log(f"profile: batch {batch}: predictor call (host copy in, forward, "
        f"logits out) {_median_ms(lambda: pred(padded), reps):.3f} ms, "
        f"forward alone {wall:.3f} ms (medians of {reps}, calling thread)")
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(3):
                net(x)
            torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    dev = {e.key: (e.count / 3, e.self_device_time_total / 3e3)
           for e in rows}
    device_ms = sum(ms for _, ms in dev.values())
    if device_ms <= 0:
        log(f"profile: batch {batch} forward {wall:.3f} ms wall (median of "
            f"{reps}); device time not measured (profiler saw no kernels)")
        return
    k1 = sum(ms for k, (_, ms) in dev.items() if "conv_epilogue" in k)
    k1_calls = sum(c for k, (c, _) in dev.items() if "conv_epilogue" in k)
    log(f"profile: batch {batch} forward {wall:.3f} ms wall (median of "
        f"{reps}), kernels {device_ms:.3f} ms on the device "
        f"({sum(c for c, _ in dev.values()):.0f} launches), device busy "
        f"{device_ms / wall:.3f} of the wall time; conv_epilogue "
        f"{k1:.3f} ms in {k1_calls:.0f} launches")
    for key, (calls, ms) in sorted(dev.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  {ms:9.4f} ms {calls:5.0f}x  {key[:90]}")


def main():
    if not os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch")):
        fail(f"no mxnet_tpu_torch package beside {__file__}: run from the "
             "root of a checkout")
    sys.path.insert(0, ROOT)
    import torch
    card = phase_card(torch)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kernels import conv_epilogue as ce
    phase_build()
    k1 = phase_kernel(torch, ce)
    launches = phase_serve(torch, mx, card, mx.gpu(0))
    line = {"kernels": [{
        "name": "conv_epilogue", "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/conv_epilogue.cu",
        "replaces": "mxnet_tpu/pallas/kernels.py:126",
        "launches": launches["conv_epilogue"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "status": "ok",
        "per": f"one ResNet-50 v1 forward at batch {BATCH}, float32 "
               "(48 launches)",
        "max_abs_err_bf16": k1["max_abs_err_bf16"],
        "max_abs_err_ragged_fp32": k1["max_abs_err_ragged_fp32"]}]}
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

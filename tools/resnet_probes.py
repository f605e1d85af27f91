#!/usr/bin/env python3
"""Probes of the PyTorch/CUDA port's ResNet-50 v1 (``mxnet_tpu_torch``).

Run from the root of a checkout:

    python3 tools/resnet_probes.py gate-sensitivity [--steps N]
    python3 tools/resnet_probes.py ab-forward DIR_A DIR_B
    python3 tools/resnet_probes.py bf16-divergence
    python3 tools/resnet_probes.py gate-flips [--trials N]

``gate-sensitivity`` (CPU) asks how far a batch-1 training step's
gradients, the ones ``chip_smoke.py``'s ResNet gate compares, move when
the input moves by 1e-7 of itself: a rounding-sized change, like the
difference between cuDNN's and the CPU's convolutions. Full-width
ResNet-50 v1 (Xavier from seed 0) on ``examples/train_imagenet.py``'s
synthetic batch; the running statistics are warmed by one training
forward at batch 8, or by ``--steps`` SGD steps (lr 0.1, momentum 0.9,
wd 1e-4) at batch 8. It prints each gate quantity's change relative to
its max |value|, first as computed, then with the relu decisions of the
unperturbed step replayed (``chip_smoke.ReluTape``), and how many relu
inputs changed sign.

``ab-forward`` (card) times the batch-8 predict forward of ResNet-50 v1
in two checkouts, in turns A B B A A B, each in a fresh process: the
median and minimum host wall of 60 forwards after 10 warm-up ones.

``bf16-divergence`` (card) asks why ``chip_smoke.py``'s bf16 ResNet
gate replays values: ResNet-50 v1 through ``ShardedTrainer(compute_dtype=
"bfloat16")`` trains 3 steps at batch 64 on the card, then one batch-1
step of the trainer's differentiated function runs on the card and on
the CPU from the same weights, the card's relu decisions replayed. It
prints each BatchNorm output's max difference relative to its max
|value|, in forward order, and the gate's five gradients' relative
differences, first so, then with ``chip_smoke.ValueTape`` (each
BatchNorm's and residual epilogue's value and gradient replayed).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-7


def gate_sensitivity(steps):
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    net = resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=mx.cpu(),
                   generator=mx.random.generator(0))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(8, 3, 224, 224).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, (8,)).astype(np.float32))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    if steps:
        with torch.no_grad():
            net(x[:1])                        # materialize the shapes
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(chip_smoke.RN_SGD))
        for _ in range(steps):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            mx.autograd.backward(loss)
            trainer.step(x.shape[0])
    else:
        with mx.autograd.record():
            net(x)                            # warm the statistics only
    state = {k: v.detach().numpy().copy()
             for k, v in net.collect_params().items()}
    noise = torch.from_numpy(np.random.RandomState(5).randn(1, 3, 224, 224)
                             .astype(np.float32))

    def step(xb, tape):
        model = resnet50_v1()
        model.load_dict(state, ctx=mx.cpu())
        with tape:
            with mx.autograd.record():
                loss = loss_fn(model(xb), y[:1])
            mx.autograd.backward(loss)
        params = model.collect_params()
        out = {k: params[k].grad.numpy().copy()
               for k in chip_smoke.RN_GATE_PARAMS}
        out.update({k: params[k].detach().numpy().copy()
                    for k in chip_smoke.RN_GATE_STATS})
        out["loss"] = loss.detach().numpy()
        return out

    def change(got, ref):
        return {k: float(np.abs(got[k] - ref[k]).max()
                         / np.abs(ref[k]).max()) for k in ref}

    tape = chip_smoke.ReluTape(torch)
    ref = step(x[:1], tape)
    moved = x[:1] * (1 + EPS * noise)
    free = step(moved, _Nothing())
    tape.replay = True
    replayed = step(moved, tape)
    print(json.dumps({"steps": steps, "input_change": EPS,
                      "change_of_max_value": change(free, ref),
                      "change_with_relu_replayed": change(replayed, ref),
                      "relu_inputs_changed_sign": tape.differ,
                      "relu_inputs": tape.total}, indent=1))


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
net = resnet50_v1()
net.initialize(mx.init.Xavier(), ctx=mx.gpu(0),
               generator=mx.random.generator(0))
x = torch.randn(8, 3, 224, 224, device="cuda")
wall = []
with torch.inference_mode():
    for i in range(70):
        t0 = time.perf_counter()
        net(x)
        torch.cuda.synchronize()
        if i >= 10:
            wall.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"checkout": sys.argv[1], "median_ms":
                  statistics.median(wall), "min_ms": min(wall)}))
"""


def ab_forward(dir_a, dir_b):
    for d in (dir_a, dir_b, dir_b, dir_a, dir_a, dir_b):
        out = subprocess.run([sys.executable, "-c", CHILD,
                              os.path.abspath(d)], capture_output=True,
                             text=True, timeout=600, check=True)
        print(out.stdout.strip().splitlines()[-1], flush=True)


def bf16_divergence():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import nn as ops_nn

    cs.phase_card(torch)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(64, 3, 224, 224).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, (64,)).astype(np.int32))
    net, trainer = cs.sh_resnet(torch, mx, mx.gpu(0), "bfloat16")
    for _ in range(3):
        trainer.step(x.to(dev), y.to(dev))
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in net.collect_params().items()}
    cpu_tr = cs.sh_resnet(torch, mx, mx.cpu(), "bfloat16", state)[1]
    cpu_tr.prepare(x[:1])
    batch_norm, outs = ops_nn.batch_norm, []

    def recorded(*args, **kwargs):
        out, mean, var = batch_norm(*args, **kwargs)
        outs.append(out.detach().float().cpu())
        return out, mean, var

    for teacher in (False, True):
        tapes = [cs.ReluTape(torch)] + ([cs.ValueTape(torch)] if teacher
                                        else [])
        got = []
        for tr, replay in ((trainer, False), (cpu_tr, True)):
            outs.clear()
            for tape in tapes:
                tape.replay = replay
            ops_nn.batch_norm = recorded
            try:
                with contextlib.ExitStack() as stack:
                    for tape in tapes:
                        stack.enter_context(tape)
                    _, grads, _ = tr._loss_and_grads(
                        [x[:1].to(tr.device)], y[:1].to(tr.device))
            finally:
                ops_nn.batch_norm = batch_norm
            named = dict(zip((n for n, _ in tr._named), grads))
            got.append(([o.clone() for o in outs],
                        {k: named[k].float().cpu() for k in
                         cs.RN_GATE_PARAMS}))
        (card_bn, card_g), (cpu_bn, cpu_g) = got
        print(json.dumps({
            "values_replayed": teacher,
            "bn_rel_by_layer": [round(float((a - b).abs().max()
                                            / b.abs().max()), 5)
                                for a, b in zip(card_bn, cpu_bn)],
            "grad_rel": {k: float((card_g[k] - cpu_g[k]).abs().max()
                                  / cpu_g[k].abs().max())
                         for k in cs.RN_GATE_PARAMS}}), flush=True)


def gate_flips(trials):
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    card = cs.phase_card(torch)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(cs.RN_BATCH, 3, cs.RN_SIZE, cs.RN_SIZE)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, (cs.RN_BATCH,))
                         .astype(np.float32)).to(dev)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def gate_step(model, xb, yb):
        with mx.autograd.record():
            loss = loss_fn(model(xb), yb)
        mx.autograd.backward(loss)
        params = model.collect_params()
        return {k: params[k].grad.detach().cpu().numpy().copy()
                for k in cs.RN_GATE_PARAMS}

    def rel(got, want):
        return {k: float(np.abs(got[k] - want[k]).max()
                         / np.abs(want[k]).max()) for k in want}

    for trial in range(trials):
        net = resnet50_v1()
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0),
                       generator=mx.random.generator(cs.SEED))
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(cs.RN_SGD))
        losses = []
        for _ in range(cs.TRAIN_STEPS + 1):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            mx.autograd.backward(loss)
            trainer.step(cs.RN_BATCH)
            losses.append(round(float(loss.detach().mean()), 6))
        state = {k: v.detach().cpu().numpy().copy()
                 for k, v in net.collect_params().items()}
        relu, pool = cs.ReluTape(torch), cs.PoolTape(torch)
        with relu, pool:
            card_g = gate_step(net, x[:1], y[:1])
        relu.replay = pool.replay = True
        out = {}
        for what, apply in (("relu replayed", False),
                            ("relu and max pool replayed", True)):
            pool.apply, pool.differ, pool.total = apply, 0, 0
            cpu_net = resnet50_v1()
            cpu_net.load_dict(state, ctx=mx.cpu())
            with relu, pool:
                cpu_g = gate_step(cpu_net, x[:1].cpu(), y[:1].cpu())
            out[what] = rel(card_g, cpu_g)
        print(json.dumps({"trial": trial, "card": card, "losses": losses,
                          "max_pool_choices_differ": pool.differ,
                          "max_pool_outputs": pool.total,
                          "relu_inputs_differ": relu.differ,
                          "grad_rel": out}), flush=True)
        del net, trainer
        torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="probe", required=True)
    sens = sub.add_parser("gate-sensitivity")
    sens.add_argument("--steps", type=int, default=0)
    ab = sub.add_parser("ab-forward")
    ab.add_argument("dir_a")
    ab.add_argument("dir_b")
    sub.add_parser("bf16-divergence")
    flips = sub.add_parser("gate-flips")
    flips.add_argument("--trials", type=int, default=8)
    args = parser.parse_args()
    if args.probe == "gate-sensitivity":
        gate_sensitivity(args.steps)
    elif args.probe == "bf16-divergence":
        bf16_divergence()
    elif args.probe == "gate-flips":
        gate_flips(args.trials)
    else:
        ab_forward(args.dir_a, args.dir_b)


if __name__ == "__main__":
    main()

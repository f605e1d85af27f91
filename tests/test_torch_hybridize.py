"""``hybridize()`` in the port (mxnet_tpu_torch/gluon/cached_graph.py) on
the CPU.

1. The JAX package's hybridized blocks (``jax.jit``) against the port's
   hybridized blocks (eager on the CPU, the device a caller asks for
   explicitly) on the same numpy inputs: the narrow ResNet V1 and the
   narrow BERT (2 layers, 64 units), in predict mode and under
   ``record()``. Weights travel with ``convert.py``; BERT runs with
   dropout 0, as tests/test_torch_train.py's slice test does.
2. The graph cache's bookkeeping, driven by a stand-in capture backend
   on the CPU: ``capture`` runs the function once (as a capture
   records it) and ``replay`` runs it again writing into the captured
   outputs and dropout bits, without counting kernel launches (as a
   CUDA graph's replay reads and writes fixed buffers and calls no
   wrapper). Keys, clearing, the outermost block's ownership, a second
   program while a backward is pending, launch counts across replays,
   the bits tape and state left as an eager step leaves it.
3. ``Server.prewarm`` on the CPU returns the reference's keys.

Tolerances are stated in each test."""
from unittest import mock

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import cached_graph as cg
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from mxnet_tpu_torch.kernels import _common as _kernels_common
from mxnet_tpu_torch.kernels import conv_epilogue as ce
from mxnet_tpu_torch.serving import Server, ServerConfig

from torch_parity import bert_pair, narrow_pair


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else t.asnumpy()


def _within(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


# -- 1. the JAX package's hybridized blocks against the port's ---------------
def _resnet_step(jnet, tnet, x, y):
    jl = jgluon.loss.SoftmaxCrossEntropyLoss()
    tl = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with jag.record():
        jloss = jl(jnet(jmx.nd.array(x)), jmx.nd.array(y))
    jloss.backward()
    with tag.record():
        tloss = tl(tnet(torch.from_numpy(x)), torch.from_numpy(y))
    tag.backward(tloss)
    return _np(tloss), jloss.asnumpy()


@pytest.mark.parametrize("mode", ["predict", "record"])
def test_hybridized_resnet_matches_jax_hybridized(mode):
    """Narrow bottleneck ResNet V1, batch 8, 32x32, seeded BatchNorm
    statistics, both packages hybridized. Predict: logits within 1e-5 of
    max |value|. Record (one step): the per-sample loss and every running
    statistic within 1e-5, every gradient within 1e-4 of its max |value|
    (the convolutions' backward sums over the batch and the image in
    another order in the two packages; measured up to 2.2e-5, as for the
    unhybridized slice test in tests/test_torch_resnet_train.py)."""
    jnet, tnet = narrow_pair(seed=3, in_shape=(8, 3, 32, 32))
    jnet.hybridize()
    tnet.hybridize()
    rng = np.random.RandomState(9)
    x = rng.randn(8, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, (8,)).astype(np.float32)
    if mode == "predict":
        want = jnet(jmx.nd.array(x)).asnumpy()
        with torch.inference_mode():
            got = tnet(torch.from_numpy(x)).numpy()
        _within(got, want, 1e-5, "logits")
        return
    got, want = _resnet_step(jnet, tnet, x, y)
    _within(got, want, 1e-5, "loss")
    tparams = tnet.collect_params()
    for name, p in jnet._structural_names().items():
        if p.grad_req == "null":
            _within(_np(tparams[name]), p.data().asnumpy(), 1e-5, name)
        else:
            _within(_np(tparams[name].grad), p.grad().asnumpy(), 1e-4,
                    f"grad {name}")


@pytest.mark.parametrize("mode", ["predict", "record"])
def test_hybridized_bert_matches_jax_hybridized(mode):
    """Narrow BERT (2 layers, 64 units, 4 heads, vocab 100, dropout 0),
    both packages hybridized, int32 ids (2, 12). Predict: seq_out,
    pooled and the MLM scores within 1e-5 of max |value|. Record: the
    masked-LM loss over every position and every gradient within
    1e-5."""
    jnet, tnet, _ = bert_pair(seed=0, dropout=0.0, use_classifier=False)
    jnet.hybridize()
    tnet.hybridize()
    rng = np.random.RandomState(9)
    ids = rng.randint(0, 100, (2, 12)).astype(np.int32)
    labels = rng.randint(0, 100, (2, 12)).astype(np.float32)
    jx = jmx.nd.array(ids, dtype="int32")
    if mode == "predict":
        want = jnet(jx)
        with torch.inference_mode():
            got = tnet(torch.from_numpy(ids))
        assert len(got) == len(want) == 3
        for g, w, what in zip(got, want, ("seq_out", "pooled", "mlm")):
            _within(_np(g), w.asnumpy(), 1e-5, what)
        return
    jl = jgluon.loss.SoftmaxCrossEntropyLoss()
    tl = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with jag.record():
        jloss = jl(jnet(jx)[-1], jmx.nd.array(labels))
    jloss.backward()
    with tag.record():
        tloss = tl(tnet(torch.from_numpy(ids))[-1], torch.from_numpy(labels))
    tag.backward(tloss)
    _within(_np(tloss), jloss.asnumpy(), 1e-5, "loss")
    tparams = tnet.collect_params()
    for name, p in jnet._structural_names().items():
        if name in tparams:
            g = tparams[name].grad
            _within(np.zeros(p.shape, np.float32) if g is None else _np(g),
                    p.grad().asnumpy(), 1e-5, f"grad {name}")


# -- 2. the graph cache's bookkeeping with a stand-in backend ------------------
class _StubGraph:
    def __init__(self, fn, out, bits):
        self.fn, self.out, self.bits = fn, out, bits

    def replay(self):
        before = kernels.launch_counts()
        with trandom.draws(keep_states=False) as seen:
            new = self.fn()
        after = kernels.launch_counts()
        kernels.add_launches({k: before[k] - after[k] for k in after})
        with torch.no_grad():
            for s, n in zip(list(self.out) + self.bits,
                            list(new) + seen.drawn):
                if s is not None and n is not None:
                    s.copy_(n)

    def reset(self):
        self.fn = None


class Stub:
    """The CPU stand-in for ``cached_graph.CudaGraphs``."""

    def __init__(self):
        self.generators = []

    @staticmethod
    def accepts(device):
        return device.type == "cpu"

    @staticmethod
    def new_pool(device):
        return None

    @staticmethod
    def warm_up(fn, device):
        fn()

    def capture(self, fn, pool, generators, device):
        self.generators.append(list(generators))
        outer = trandom._tape.draws            # the capture's draw list
        # the run stands for a capture: the stream "is capturing", so a
        # wrapper's launch counts as captured, not run
        with trandom.draws(keep_states=False) as seen, mock.patch.object(
                _kernels_common, "stream_capturing", lambda: True):
            out = fn()
        outer.drawn.extend(seen.drawn)
        return _StubGraph(fn, out, seen.drawn), out


def _stubbed(net):
    net.hybridize()
    net._graphs = cg.GraphCache(Stub())
    return net


def _resnet(seed=0):
    net = tresnet.ResNetV1(tresnet.BottleneckV1, [1, 1, 1, 1],
                           [8, 16, 32, 64, 128], classes=10)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu(),
                   generator=trandom.generator(seed))
    return net


def _twins(make):
    """Two copies of one model: the first hybridized on the stand-in."""
    a, b = make(), make()
    with torch.no_grad():
        b(torch.zeros(2, 3, 32, 32))
    a.load_dict({k: v.detach().numpy() for k, v in
                 b.collect_params().items()}, ctx=tmx.cpu())
    return _stubbed(a), b


def _train_call(net, x, y, loss_fn=None):
    loss_fn = loss_fn or tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tag.record():
        loss = loss_fn(net(x), y)
    tag.backward(loss)
    return loss.detach()


def _grad(p):
    """A parameter's gradient; one the step did not reach is zeros in a
    hybridized block (as the reference's VJP gives) and None in an eager
    one."""
    return _np(torch.zeros_like(p) if p.grad is None else p.grad)


def _same_state(a, b, tol=1e-6):
    pa, pb = a.collect_params(), b.collect_params()
    assert set(pa) == set(pb)
    for name in pa:
        if pa[name].requires_grad:
            _within(_grad(pa[name]), _grad(pb[name]), tol, f"grad {name}")
        _within(_np(pa[name]), _np(pb[name]), tol, name)


def test_stub_program_per_key_and_fresh_outputs():
    """One program per (mode, recording, shapes, dtypes): a repeated call
    reuses it; another batch size, dtype, mode or recording captures
    another. Each call returns new tensors that a later call leaves as
    they were, equal to the eager forward."""
    net = _resnet()
    net(torch.zeros(2, 3, 32, 32))
    x = torch.randn(4, 3, 32, 32, generator=trandom.generator(1))
    with torch.no_grad():
        want = net(x)
    _stubbed(net)
    with torch.no_grad():
        first = net(x)
        second = net(x * 2)
    assert net._graphs.captures == 1
    assert first is not second and torch.equal(first, want)
    with torch.no_grad():
        net(x[:2])
        net(x[:2].clone())                     # the same key again
        with tag.train_mode():
            net(x)
    assert net._graphs.captures == 3
    _train_call(net, x, torch.zeros(4))
    assert net._graphs.captures == 4
    with torch.no_grad():
        assert not torch.equal(net(x), first)  # training moved the stats
    assert len(net._graphs) == 4


def test_stub_only_the_outermost_block_captures():
    """Nested hybridized blocks run inside the outer block's program:
    only the outer cache holds programs."""
    net = _resnet()
    net(torch.zeros(2, 3, 32, 32))
    _stubbed(net)
    inner = [m for m in net.modules() if m is not net
             and m.__dict__.get("_graphs") is not None]
    assert inner                                  # hybridize() recursed
    with torch.no_grad():
        net(torch.randn(2, 3, 32, 32))
    _train_call(net, torch.randn(2, 3, 32, 32), torch.zeros(2))
    assert len(net._graphs) == 2
    assert all(len(m._graphs) == 0 for m in inner)


def test_stub_training_leaves_the_state_of_eager_steps():
    """Three recorded SGD-momentum steps hybridized and eager from the
    same weights: the loss, every gradient, every weight and running
    statistic within 1e-6 of max |value| (the warm-up and the capture
    leave the running statistics as they were; each replay updates them
    once)."""
    net, eager = _twins(_resnet)
    x = torch.randn(4, 3, 32, 32, generator=trandom.generator(2))
    y = torch.tensor([1.0, 2.0, 3.0, 4.0])
    sgd = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    trainers = [tmx.gluon.Trainer(m.collect_params(), "sgd", dict(sgd))
                for m in (net, eager)]
    for _ in range(3):
        got, want = _train_call(net, x, y), _train_call(eager, x, y)
        _within(_np(got), _np(want), 1e-6, "loss")
        _same_state(net, eager)
        for t in trainers:
            t.step(4)
    assert net._graphs.captures == 1


def test_stub_second_program_while_a_backward_is_pending():
    """Two calls at one key in one record() and one backward: the second
    call takes a second program (the first still owes its backward), the
    gradients equal eager ones, and both programs are free afterwards."""
    net, eager = _twins(_resnet)
    gen = trandom.generator(3)
    x1, x2 = torch.randn(2, 4, 3, 32, 32, generator=gen)
    y = torch.tensor([1.0, 2.0, 3.0, 4.0])
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for m in (net, eager):
        with tag.record():
            loss = loss_fn(m(x1), y) + 2 * loss_fn(m(x2), y)
        tag.backward(loss)
    assert len(net._graphs) == 2
    assert not any(p.busy for p in net._graphs.programs())
    _same_state(net, eager)
    _train_call(net, x1, y)
    assert len(net._graphs) == 2


def test_stub_forward_without_backward_frees_its_program():
    """A recorded forward whose outputs are dropped frees its program."""
    net = _stubbed(_resnet())
    x = torch.randn(2, 3, 32, 32)
    for _ in range(3):
        with tag.record():
            out = net(x)
        assert [p.busy for p in net._graphs.programs()] == [True]
        del out
    assert len(net._graphs) == 1


def test_stub_grad_req_add_accumulates_as_eager():
    """grad_req "add" over two steps: the gradients the block hands to
    autograd are copies, so a replay cannot overwrite an accumulated
    .grad."""
    net, eager = _twins(_resnet)
    for m in (net, eager):
        for p in m.collect_params().values():
            if p.requires_grad:
                p.grad_req = "add"
    gen = trandom.generator(4)
    for _ in range(2):
        x = torch.randn(2, 3, 32, 32, generator=gen)
        y = torch.tensor([1.0, 7.0])
        _train_call(net, x, y)
        _train_call(eager, x, y)
    _same_state(net, eager)
    first = next(p for p in net.collect_params().values() if p.requires_grad)
    prog = next(p for p in net._graphs.programs() if p.grads)
    assert all(g.data_ptr() != first.grad.data_ptr() for g in prog.grads
               if g is not None)


def test_stub_clearing_and_rebinding():
    """hybridize(), initialize(force_reinit=True) and a load that fills a
    deferred parameter drop the programs; a parameter or layer assigned
    anew is caught before the next replay and the block captures again; a
    load into live parameters keeps the program and reaches its next
    replay."""
    net = _resnet()
    net(torch.zeros(2, 3, 32, 32))
    x = torch.randn(2, 3, 32, 32, generator=trandom.generator(5))

    def call():
        with torch.no_grad():
            return net(x)

    def recaptured(action, cleared):
        call()
        before = net._graphs.captures
        call()
        assert net._graphs.captures == before
        action()
        assert (len(net._graphs) == 0) == cleared
        out = call()
        assert net._graphs.captures == before + 1
        return out

    _stubbed(net)
    call()
    graphs = net._graphs
    net.hybridize()                              # a new, empty cache
    assert len(graphs) == 0 and net._graphs is not graphs
    _stubbed(net)
    recaptured(lambda: net.initialize(force_reinit=True, ctx=tmx.cpu(),
                                      generator=trandom.generator(6)),
               cleared=True)
    state = {k: v.detach().numpy() for k, v in net.collect_params().items()}

    def lazy_load():          # a new deferred layer filled by a load
        net.output = tnn.Dense(10)
        net.load_dict(state, ctx=tmx.cpu())

    recaptured(lazy_load, cleared=True)

    def want():
        with torch.no_grad():
            return tnn.Dense.forward(net.output, net.features(x))

    new = torch.nn.Parameter(net.output.weight.detach() * 2)
    out = recaptured(lambda: setattr(net.output, "weight", new),
                     cleared=False)
    assert torch.equal(out, want())

    def swap():               # a new layer initialized on its own
        net.output = tnn.Dense(10, in_units=128)
        net.output.initialize(ctx=tmx.cpu(), generator=trandom.generator(7))

    out = recaptured(swap, cleared=False)
    assert torch.equal(out, want())
    captures = net._graphs.captures
    net.load_dict({k: v * 0.5 for k, v in state.items()}, ctx=tmx.cpu())
    out = call()
    assert net._graphs.captures == captures     # in place: no capture
    assert torch.equal(out, want())


def test_stub_launch_counts_added_per_replay():
    """A forward that launches a kernel once: the warm-up counts (it ran),
    the capture does not (its stream was capturing: it ran nothing), each
    replay adds the launch it captured."""

    class Counted(tnn.HybridSequential):
        def forward(self, x):
            ce.launch_count.add()
            return super().forward(x)

    net = Counted()
    net.add(tnn.Dense(3, in_units=4))
    net.initialize(ctx=tmx.cpu(), generator=trandom.generator(0))
    _stubbed(net)
    x = torch.ones(2, 4)
    kernels.reset_launch_counts()
    with torch.no_grad():
        net(x)
    assert kernels.launch_counts()["conv_epilogue"] == 1 + 1   # warm, replay
    prog = net._graphs.programs()[0]
    assert prog.fwd_launches == {"conv_epilogue": 1}
    with torch.no_grad():
        net(x)
        net(x)
    assert kernels.launch_counts()["conv_epilogue"] == 4


def _dropout_net():
    net = tnn.HybridSequential()
    net.add(tnn.Dense(64, in_units=16), tnn.Dropout(0.5),
            tnn.Dense(8, in_units=64, epilogue_dropout=0.5))
    net.initialize(ctx=tmx.cpu(), generator=trandom.generator(0))
    return net


def test_stub_dropout_generators_tape_and_seed():
    """Dropout inside a program: the capture registers the generator the
    warm-up drew from; a recording tape receives the program's bits after
    each replay, and an eager call replaying them gives the same output;
    two replays draw different masks and reseeding reproduces them; a
    replaying tape makes the call raise."""
    net = _stubbed(_dropout_net())
    eager = _dropout_net()
    x = torch.randn(4, 16, generator=trandom.generator(1))
    outs, masks = [], []
    for seed in (11, 11, None):
        if seed is not None:
            trandom.seed(seed)
        with trandom.bits_tape() as tape:
            with tag.train_mode():
                outs.append(net(x))
        masks.append([b.clone() for b in tape.drawn])
    assert net._graphs.backend.generators == [
        [trandom.device_generator("cpu")]]
    assert len(masks[0]) == 2
    assert all(torch.equal(a, b) for a, b in zip(masks[0], masks[1]))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(masks[1][0], masks[2][0])
    with trandom.bits_tape(replay=masks[2]), tag.train_mode():
        assert torch.equal(eager(x), outs[2])
    trandom.seed(11)
    with tag.train_mode():
        assert torch.equal(eager(x), outs[0])    # the eager draws too
    with trandom.bits_tape(replay=masks[0]):
        with pytest.raises(MXNetError, match="replay"):
            net(x)


def test_stub_hybridized_bert_trains_as_eager():
    """The narrow BERT MLM with dropout 0.1 recorded on the stand-in, its
    bits replayed into an eager twin: loss and every gradient within
    1e-6 of max |value|."""
    cfg = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
               max_length=64, vocab_size=100, dropout=0.1, use_pooler=False,
               use_classifier=False)

    def make():
        net = tbert.BERTModel(**cfg)
        net.initialize(tmx.init.Normal(0.02), ctx=tmx.cpu(),
                       generator=trandom.generator(0))
        net(torch.zeros(1, 2, dtype=torch.int32))
        return net

    net, eager = _stubbed(make()), make()
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 100, (2, 12)).astype(np.int32))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()

    def step(m):
        with tag.record():
            loss = loss_fn(m(ids)[1], ids.float())
        tag.backward(loss)
        return loss.detach()

    step(net)                                   # capture, then replay
    with trandom.bits_tape() as tape:
        got = step(net)
    with trandom.bits_tape(replay=[b.clone() for b in tape.drawn]):
        want = step(eager)
    _within(_np(got), _np(want), 1e-6, "loss")
    _same_state(net, eager)


# -- 3. prewarm --------------------------------------------------------------
def test_prewarm_returns_the_reference_keys():
    """Server.prewarm on the CPU builds every batch bucket x feature shape
    (a predictor that runs eagerly: nothing captured), skips a shape
    outside the grid, and returns the reference's keys; start() runs it
    from ``config.aot_prewarm`` and the next batch hits the cache."""
    import inspect
    from mxnet_tpu.serving import server as jserver
    src = inspect.getsource(jserver.Server.prewarm)
    ref_keys = {"warmed", "loaded", "compiled", "skipped", "ms"}
    assert all(f'"{k}"' in src for k in ref_keys)
    net = tnn.HybridSequential()
    net.add(tnn.Dense(3, in_units=4))
    net.initialize(ctx=tmx.cpu(), generator=trandom.generator(0))
    cfg = ServerConfig(max_batch=4, dim_buckets={0: (2, 4)},
                       aot_prewarm=((3,), (9,)))
    server = Server(net, cfg, ctx=tmx.cpu())
    out = server.prewarm()
    assert set(out) == ref_keys
    assert (out["warmed"], out["loaded"], out["compiled"]) == (3, 0, 0)
    assert out["skipped"] == [[9]]
    assert server.prewarm()["warmed"] == 0        # all cached now
    server.start()
    try:
        got = server.predict(np.ones(4, np.float32), timeout_s=30)
    finally:
        server.stop()
    stats = server.stats()
    assert stats["prewarm"]["warmed"] == 0 and stats["cache"]["misses"] == 3
    with torch.no_grad():
        want = net(torch.ones(1, 4))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

"""ResNet V1 training in the port against the JAX package on the CPU: K1
(the conv epilogue) under autograd against ``jax.vjp`` of the JAX N-D
wrapper, BatchNorm's training branch against the JAX op, the Gluon
BatchNorm layer's running statistics against the JAX layer's, and the
slice as a whole: a narrow bottleneck ResNet V1 taking three SGD-momentum
steps through record -> SoftmaxCrossEntropyLoss -> backward ->
Trainer.step in both packages.

Inputs are seeded numpy arrays handed to both sides. Tolerances are
stated in each test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops.nn import _batch_norm
from mxnet_tpu.pallas.kernels import fused_conv_epilogue as jax_fused
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.kernels import conv_epilogue as ce
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import nn as tops

from torch_parity import jax_recorded_loss, narrow_pair

ACTS = ("identity", "relu", "gelu", "tanh", "sigmoid")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if hasattr(a, "asnumpy"):
        return a.asnumpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _leaf(a):
    return None if a is None else torch.from_numpy(a).requires_grad_()


# -- K1 under autograd -------------------------------------------------------
# (name, shape, channel axis, scale?, bias?, res?)
K1_CASES = [
    ("row", (2, 6, 5, 4), 1, True, True, False),
    ("row_res", (2, 6, 5, 4), 1, True, True, True),
    ("col", (3, 5, 8), -1, True, True, False),
    ("col_res", (3, 5, 8), -1, True, True, True),
    ("residual_only", (2, 6, 5, 4), 1, False, False, True),
    ("scale_none", (2, 6, 5, 4), 1, False, True, True),
    ("bias_none", (3, 5, 8), -1, True, False, False),
]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("name,shape,axis,has_s,has_b,has_r", K1_CASES,
                         ids=[c[0] for c in K1_CASES])
def test_conv_epilogue_vjp_matches_jax(name, shape, axis, has_s, has_b,
                                       has_r, act):
    """The output and the gradients of every input given (y, scale, bias,
    res) equal ``jax.vjp`` of the JAX N-D wrapper, float32 at atol = rtol
    = 1e-5; scale and bias gradients come back as (C,) vectors."""
    rng = np.random.RandomState(11)
    c = shape[axis]
    y = (rng.randn(*shape) * 2).astype(np.float32)
    s = (rng.rand(c) + 0.5).astype(np.float32) if has_s else None
    b = (rng.randn(c) * 0.3).astype(np.float32) if has_b else None
    r = rng.randn(*shape).astype(np.float32) if has_r else None
    g = rng.randn(*shape).astype(np.float32)
    given = [(i, a) for i, a in enumerate((y, s, b, r)) if a is not None]

    def jfn(*args):
        full = [None] * 4
        for (i, _), a in zip(given, args):
            full[i] = a
        return jax_fused(full[0], full[1], full[2], full[3],
                         channel_axis=axis, act_type=act)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for _, a in given))
    want_grads = vjp(jnp.asarray(g))
    leaves = [_leaf(a) for a in (y, s, b, r)]
    out = ce.fused_conv_epilogue(*leaves, channel_axis=axis, act_type=act)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    _close(out, want, 1e-5, "out")
    for (i, a), w in zip(given, want_grads):
        assert tuple(leaves[i].grad.shape) == a.shape
        _close(leaves[i].grad, w, 1e-5, f"grad of input {i}")


def test_conv_epilogue_saves_nothing_without_grad():
    """Under no_grad / inference_mode, or with no input requiring grad,
    the call makes no graph node (nothing is saved); on the CPU no kernel
    launch is counted either way."""
    y = torch.randn(2, 3, 4, 4, requires_grad=True)
    s = torch.rand(3, requires_grad=True)
    kernels.reset_launch_counts()
    with torch.no_grad():
        assert ce.fused_conv_epilogue(y, s, channel_axis=1).grad_fn is None
    with torch.inference_mode():
        assert ce.fused_conv_epilogue(y, s, channel_axis=1).grad_fn is None
    assert ce.fused_conv_epilogue(y.detach(), res=y.detach()).grad_fn is None
    assert ce.fused_conv_epilogue(y, s, channel_axis=1).grad_fn is not None
    assert kernels.launch_counts()["conv_epilogue"] == 0


def test_residual_epilogue_is_differentiable():
    """ops.contrib.conv_epilogue(x, res), ResNet's residual add + relu,
    gives relu'(x + res) * g to both inputs."""
    rng = np.random.RandomState(12)
    x, r, g = (rng.randn(2, 4, 3, 3).astype(np.float32) for _ in range(3))
    tx, tr = _leaf(x), _leaf(r)
    tcontrib.conv_epilogue(tx, tr).backward(torch.from_numpy(g))
    want = g * (x + r > 0)
    _close(tx.grad, want, 0)
    _close(tr.grad, want, 0)


# -- BatchNorm's training branch ---------------------------------------------
def _bn_inputs(case, axis):
    """Seeded (x, gamma, beta, moving_mean, moving_var) for one case, x
    (2, 5, 4, 4) NCHW or (2, 4, 4, 5) channel-last: 32 values per channel."""
    rng = np.random.RandomState(21)
    c = 5
    x = rng.randn(2, c, 4, 4) * 2 + 0.5
    mean = rng.randn(c) * 0.1
    var = rng.rand(c) + 0.5
    if case == "suspicious":
        # |mean| >> std on a zero running mean: channel 1 is 8 + k/64, k in
        # -2..2, so every sum is exact in fp32 and e2 > 4096 * var
        x[:, 1] = 8.0 + rng.randint(-2, 3, x[:, 1].shape) / 64.0
        x[:, 3] += 300.0
        mean[:] = 0.0
    elif case == "warm":
        mean = x.mean(axis=(0, 2, 3)) + rng.randn(c) * 0.05
    elif case == "constant_channel":
        # channel 2 constant and equal to its shift: e2 = mean_c² = 0, the
        # tie of maximum(e2 - mean_c², 0); channel 4 constant off the shift
        x[:, 2] = 0.75
        mean[2] = 0.75
        x[:, 4] = -1.25
    gamma = rng.rand(c) + 0.5
    beta = rng.randn(c) * 0.1
    if axis == -1:
        x = np.moveaxis(x, 1, -1)
    return [np.ascontiguousarray(a, np.float32)
            for a in (x, gamma, beta, mean, var)]


@pytest.mark.parametrize("case", ["ordinary", "suspicious", "warm",
                                  "constant_channel"])
@pytest.mark.parametrize("axis", [1, -1])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("act_type", [None, "relu"])
def test_batch_norm_training_matches_jax(case, axis, fix_gamma, act_type):
    """``batch_norm(training=True)`` against the JAX op: the output and
    the reported batch mean and biased var, then the gradients wrt x,
    gamma and beta of all three outputs under seeded head gradients (so
    the reported var's tie at maximum(0, 0) is differentiated too);
    float32 at atol = rtol = 1e-5. The running statistics are inputs
    only: neither side changes them."""
    x, gamma, beta, mean, var = _bn_inputs(case, axis)
    kw = dict(eps=1e-5, fix_gamma=fix_gamma, axis=axis, act_type=act_type,
              training=True)
    rng = np.random.RandomState(22)
    c = x.shape[axis]
    # the head of out in multiples of 2^-10: on a constant channel
    # (variance 0, so 1/sqrt(eps) = 316 multiplies every rounding) the
    # gradient of gamma is sum(g·x) - sum(g)·mean, 0 in exact arithmetic;
    # these heads keep both sums exact, so it is 0 in both packages
    # rather than two summation orders' rounding times 316
    heads = [(rng.randint(-2048, 2049, x.shape) / 1024).astype(np.float32),
             rng.randn(c).astype(np.float32),
             rng.randn(c).astype(np.float32)]
    jm, jv = jnp.asarray(mean), jnp.asarray(var)
    want, vjp = jax.vjp(lambda a, g, b: _batch_norm(a, g, b, jm, jv, **kw),
                        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    want_grads = vjp(tuple(jnp.asarray(h) for h in heads))
    tx, tg, tb = _leaf(x), _leaf(gamma), _leaf(beta)
    tm, tv = torch.from_numpy(mean), torch.from_numpy(var)
    got = tops.batch_norm(tx, tg, tb, tm, tv, **kw)
    torch.autograd.backward(got, [torch.from_numpy(h) for h in heads])
    for name, g, w in zip(("out", "mean"), got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, 1e-5, name)
    # the reported var is e2 - mean_c², a difference of two fp32 sums:
    # where it cancels (channel 3 of "suspicious": mean 300, std 2) the
    # two packages' summation orders part it by an ulp of e2, so each
    # channel's tolerance adds 4 ulps of e2 to 1e-5 (+ 1e-5 relative)
    xc = np.moveaxis(x, axis, 0).reshape(c, -1).astype(np.float64) \
        - mean[:, None]
    e2 = (xc ** 2).mean(axis=1)
    slack = 1e-5 + 4 * 2.0 ** -23 * e2
    assert tuple(got[2].shape) == (c,)
    assert (np.abs(_np(got[2]) - _np(want[2]))
            <= slack + 1e-5 * np.abs(_np(want[2]))).all(), (got[2], want[2])
    for name, leaf, w in zip(("x", "gamma", "beta"), (tx, tg, tb),
                             want_grads):
        grad = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        _close(grad, w, 1e-5, f"grad {name}")
    np.testing.assert_array_equal(tm.numpy(), mean)
    np.testing.assert_array_equal(tv.numpy(), var)
    if case == "constant_channel":
        assert float(got[2][2].detach()) == 0.0


def test_batch_norm_training_shift_is_not_saved():
    """The running mean, the shift of the moments, may be written in place
    between the forward and the backward (as the layer does)."""
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    g, b = torch.rand(3, requires_grad=True), torch.randn(3)
    rm, rv = torch.randn(3), torch.rand(3) + 0.5
    out, mean, var = tops.batch_norm(x, g, b, rm, rv, fix_gamma=False,
                                     training=True, act_type="relu")
    rm.copy_(mean.detach())
    rv.mul_(0.5)
    out.sum().backward()
    assert x.grad is not None and g.grad is not None


# -- the Gluon layer's running statistics -------------------------------------
def _layer_batches(c=6):
    """Three seeded NCHW batches: the first with channel 1 at 8 + k/64,
    k in -2..2 (mean² > 4096 · var, so the cold adoption keeps the init
    var there) and channel 3 at 6 + j/32, j in -64..64 (|mean| > std but
    adopted); both exact in fp32 sums; then two ordinary batches."""
    rng = np.random.RandomState(31)
    first = rng.randn(2, c, 4, 4) * 1.5 + 0.3
    first[:, 1] = 8.0 + rng.randint(-2, 3, first[:, 1].shape) / 64.0
    first[:, 3] = 6.0 + rng.randint(-64, 65, first[:, 3].shape) / 32.0
    rest = [rng.randn(2, c, 4, 4) * (1 + k) - k for k in (1, 2)]
    return [np.asarray(a, np.float32) for a in [first] + rest]


@pytest.mark.parametrize("activation", [None, "relu"])
def test_batch_norm_layer_running_statistics_match_jax(activation):
    """Three training calls of the Gluon BatchNorm in both packages, from
    the init statistics (mean 0, var 1): the first adopts the batch's
    mean and var (cold), except channel 1's var, which stays 1
    (susp_cold); the next two mix with momentum 0.9. After each call the
    running mean and var and the output agree at atol = rtol = 1e-5; a
    predict-mode call leaves them alone."""
    jlayer = jnn.BatchNorm(in_channels=6, activation=activation)
    jlayer.initialize(ctx=jmx.cpu())
    tlayer = tnn.BatchNorm(in_channels=6, activation=activation)
    tlayer.initialize(ctx=tmx.cpu())
    for step, x in enumerate(_layer_batches()):
        with jag.record():
            want = jlayer(jmx.nd.array(x))
        with tag.record():
            got = tlayer(torch.from_numpy(x))
        _close(got, want, 1e-5, f"out, call {step}")
        _close(tlayer.running_mean, jlayer.running_mean.data(), 1e-5,
               f"running_mean, call {step}")
        _close(tlayer.running_var, jlayer.running_var.data(), 1e-5,
               f"running_var, call {step}")
        if step == 0:
            assert float(tlayer.running_var[1]) == 1.0          # susp_cold
            assert float(tlayer.running_var[3]) != 1.0          # adopted
            np.testing.assert_allclose(_np(tlayer.running_mean[3]),
                                       x[:, 3].mean(), rtol=1e-5)
    before = [t.clone() for t in (tlayer.running_mean, tlayer.running_var)]
    with torch.inference_mode():
        tlayer(torch.from_numpy(_layer_batches()[0]))
    for b, t in zip(before, (tlayer.running_mean, tlayer.running_var)):
        assert torch.equal(b, t)


def test_batch_norm_layer_use_global_stats_keeps_statistics():
    """With use_global_stats the layer normalizes with the running
    statistics in training too and leaves them as they are."""
    layer = tnn.BatchNorm(in_channels=3, use_global_stats=True)
    layer.initialize(ctx=tmx.cpu())
    x = torch.randn(2, 3, 4, 4) * 3 + 1
    with tag.record():
        out = layer(x)
    assert torch.equal(layer.running_mean, torch.zeros(3))
    assert torch.equal(layer.running_var, torch.ones(3))
    torch.testing.assert_close(out, x * (1 + 1e-5) ** -0.5)


# -- the whole slice ---------------------------------------------------------
TRAIN_BATCH = 16
TRAIN_CLASSES = 10
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _state(jnet):
    return {k: p.data().asnumpy() for k, p in jnet._structural_names().items()}


def _within(got, want, tol, what):
    """Each tensor within ``tol`` of its max |value| (floored at 1e-30)."""
    for name, w in want.items():
        g = got[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what} {name}: {err} > {tol} x {scale}"


def test_narrow_resnet_trains_as_the_jax_package(monkeypatch):
    """Three steps of record -> SoftmaxCrossEntropyLoss -> backward ->
    Trainer("sgd", lr 0.1, momentum 0.9, wd 1e-4).step(B) on the narrow
    bottleneck ResNet V1 (batch 16, 32x32, seeded BatchNorm statistics)
    in both packages. Per step: the batch's mean loss within 1e-5
    relative, and each per-sample loss within 1e-5 of the largest (a
    sample's loss is logsumexp minus its logit, so its own relative error
    grows as it falls: the forward's rounding, as the predict-mode
    logits' 1e-4 in test_torch_resnet.py); every parameter's gradient, then every weight and running
    statistic after the update, within 1e-4 of that tensor's max |value|.

    Each step starts both packages from the same weights and running
    statistics: after the comparison the JAX package's are carried into
    the port (the momentum buffers run on). Free-running fp32 copies
    part within a few steps at lr 0.1: a weight that differs by rounding
    moves a relu input across its kink, and the few values per channel
    of the deepest BatchNorms amplify that flip. Carrying the state
    compares three steps at three states, momentum and warm statistics
    included, without that amplification. Even so, one relu input within
    rounding of 0 decides a tie rather than arithmetic and moves every
    gradient upstream of it by about 1 / (values per channel), so the
    seeds are ones whose three steps put no relu input there (with
    ``narrow_pair(seed=8)`` one input of ``features.4.0.body.3`` flips
    in step 1). From the init statistics (mean 0, var 1) the first
    step's moments are taken about 0 and lose bits, in both packages
    alike, where a channel's |mean| is several times its std; the cold
    adoption is held against the JAX layer on exact data above.

    Every K1 call in training goes through its autograd Function (3 per
    bottleneck, 12 per forward); the output Dense reaches no K2."""
    calls = {"k1": 0, "k2": 0}
    base = ce._ConvEpilogue

    class Counted(base):
        @staticmethod
        def forward(ctx, *args):
            calls["k1"] += 1
            return base.forward(ctx, *args)

    inner = tcontrib.matmul_epilogue
    monkeypatch.setattr(ce, "_ConvEpilogue", Counted)
    monkeypatch.setattr(tcontrib, "matmul_epilogue",
                        lambda *a, **k: calls.__setitem__("k2", 1)
                        or inner(*a, **k))
    jnet, tnet = narrow_pair(seed=3, classes=TRAIN_CLASSES,
                             in_shape=(TRAIN_BATCH, 3, 32, 32))
    rng = np.random.RandomState(9)
    x = rng.randn(TRAIN_BATCH, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, TRAIN_CLASSES, (TRAIN_BATCH,)).astype(np.float32)
    jx, jy = jmx.nd.array(x), jmx.nd.array(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jloss = jgluon.loss.SoftmaxCrossEntropyLoss()
    tloss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    jtrainer = jgluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    ttrainer = tmx.gluon.Trainer(tnet.collect_params(), "sgd", dict(SGD))
    kernels.reset_launch_counts()
    losses = []
    for step in range(3):
        # the JAX package's record() -> loss -> backward, one jitted program
        jl = jax_recorded_loss(jnet, jloss, jx._data, jy._data)
        with tag.record():
            tl = tloss(tnet(tx), ty)
        tag.backward(tl)
        got, want = _np(tl), _np(jl)
        np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        losses.append(float(got.mean()))
        tparams = tnet.collect_params()
        _within({k: _np(t.grad) for k, t in tparams.items() if t.requires_grad},
                {k: p.grad().asnumpy()
                 for k, p in jnet._structural_names().items()
                 if p.grad_req != "null"}, 1e-4, f"step {step} gradient")
        jtrainer.step(TRAIN_BATCH)
        ttrainer.step(TRAIN_BATCH)
        want = _state(jnet)
        assert set(tparams) == set(want)
        _within({k: _np(t) for k, t in tparams.items()}, want, 1e-4,
                f"after step {step}")
        tmx.convert.load_jax_params(tnet, want, ctx=tmx.cpu())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert calls == {"k1": 3 * 12, "k2": 0}
    assert not any(kernels.launch_counts().values())      # CPU path

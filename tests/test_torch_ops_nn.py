"""The port's operators (mxnet_tpu_torch/ops) against the JAX package's
registered ops on the same numpy inputs, on the CPU, at float32
atol = rtol = 1e-5: convolution, max/avg/global pooling, inference
BatchNorm with and without a fused activation, FullyConnected,
Activation and Flatten."""
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd, nd
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import tensor as ttensor


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-5,
                               atol=1e-5)


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("stride,pad,dilate,group,bias", [
    ((1, 1), (1, 1), (1, 1), 1, True),
    ((2, 2), (0, 0), (1, 1), 1, False),
    ((2, 1), (1, 2), (2, 1), 2, True),
])
def test_convolution(stride, pad, dilate, group, bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 9, 8).astype(np.float32)
    w = (rng.randn(6, 4 // group, 3, 3) * 0.2).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    kw = dict(kernel=(3, 3), stride=stride, pad=pad, dilate=dilate,
              num_filter=6, num_group=group, no_bias=not bias)
    want = nd.Convolution(nd.array(x), nd.array(w),
                          *([nd.array(b)] if bias else []), **kw)
    got = tnn.convolution(_t(x), _t(w), _t(b) if bias else None, **kw)
    _close(got, want)


@pytest.mark.parametrize("pool_type,kernel,stride,pad,conv,incl", [
    ("max", (3, 3), (2, 2), (1, 1), "valid", True),
    ("max", (2, 2), (2, 2), (0, 0), "full", True),
    ("avg", (3, 3), (2, 2), (1, 1), "valid", True),
    ("avg", (3, 3), (2, 2), (1, 1), "valid", False),
    ("avg", (2, 3), (2, 2), (1, 1), "full", False),
])
def test_pooling(pool_type, kernel, stride, pad, conv, incl):
    x = np.random.RandomState(1).randn(2, 3, 7, 9).astype(np.float32)
    kw = dict(kernel=kernel, pool_type=pool_type, stride=stride, pad=pad,
              pooling_convention=conv, count_include_pad=incl)
    _close(tnn.pooling(_t(x), **kw), nd.Pooling(nd.array(x), **kw))


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_global_pooling(pool_type):
    x = np.random.RandomState(2).randn(2, 5, 7, 7).astype(np.float32)
    kw = dict(kernel=(1, 1), pool_type=pool_type, global_pool=True)
    got = tnn.pooling(_t(x), **kw)
    assert tuple(got.shape) == (2, 5, 1, 1)
    _close(got, nd.Pooling(nd.array(x), **kw))


@pytest.mark.parametrize("axis", [1, -1])
@pytest.mark.parametrize("act_type", [None, "relu"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_inference(act_type, fix_gamma, axis):
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 4, 5) * 2 + 0.5).astype(np.float32)
    c = x.shape[axis]
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = (rng.randn(c) * 0.1).astype(np.float32)
    mean = (rng.randn(c) * 0.5).astype(np.float32)
    var = (rng.rand(c) * 3 + 0.5).astype(np.float32)
    kw = dict(eps=1e-5, fix_gamma=fix_gamma, axis=axis, act_type=act_type)
    want = nd.BatchNorm(*(nd.array(a) for a in (x, gamma, beta, mean, var)),
                        **kw)
    got = tnn.batch_norm(*(_t(a) for a in (x, gamma, beta, mean, var)), **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_batch_norm_training_branch_is_not_ported():
    """The training branch is ported: it returns the JAX op's output and
    batch mean and biased var (atol = rtol = 1e-5), leaves the running
    statistics as they are, and with ``use_global_stats`` normalizes
    with the running ones as predict mode does. (tests/
    test_torch_resnet_train.py holds its gradients.)"""
    rng = np.random.RandomState(6)
    x = (rng.randn(2, 3, 4, 4) * 2 + 0.5).astype(np.float32)
    v = np.ones(3, np.float32)
    mean = (rng.randn(3) * 0.1).astype(np.float32)
    kw = dict(eps=1e-5, fix_gamma=False)
    with autograd.train_mode():
        want = nd.BatchNorm(*(nd.array(a) for a in (x, v, v, mean, v)), **kw)
    kw["training"] = True
    tm = _t(mean.copy())
    got = tnn.batch_norm(_t(x), _t(v), _t(v), tm, _t(v), **kw)
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(got[2].numpy(), x.var(axis=(0, 2, 3)),
                               rtol=1e-5)
    assert torch.equal(tm, _t(mean))
    glob = tnn.batch_norm(_t(x), _t(v), _t(v), tm, _t(v),
                          use_global_stats=True, **kw)
    pred = tnn.batch_norm(_t(x), _t(v), _t(v), tm, _t(v),
                          **dict(kw, training=False))
    for g, w in zip(glob, pred):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("flatten,bias", [(True, True), (False, False)])
def test_fully_connected(flatten, bias):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 4, 5).astype(np.float32)
    k = 20 if flatten else 5
    w = (rng.randn(7, k) * 0.3).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    kw = dict(num_hidden=7, no_bias=not bias, flatten=flatten)
    want = nd.FullyConnected(nd.array(x), nd.array(w),
                             *([nd.array(b)] if bias else []), **kw)
    _close(tnn.fully_connected(_t(x), _t(w), _t(b) if bias else None, **kw),
           want)


@pytest.mark.parametrize("act_type", ["relu", "sigmoid", "tanh", "softrelu",
                                      "softsign", "relu6"])
def test_activation(act_type):
    x = (np.random.RandomState(5).randn(4, 9) * 4).astype(np.float32)
    _close(tnn.activation(_t(x), act_type=act_type),
           nd.Activation(nd.array(x), act_type=act_type))


def test_flatten_and_contrib_conv_epilogue():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    r = rng.randn(2, 3, 4, 5).astype(np.float32)
    _close(ttensor.flatten(_t(x)), nd.Flatten(nd.array(x)))
    _close(tcontrib.conv_epilogue(_t(x), _t(r)),
           nd.contrib.conv_epilogue(nd.array(x), nd.array(r)))

"""The rest of Gluon in the port (mxnet_tpu_torch/gluon: the nn layers and
losses, utils, contrib.nn and contrib.estimator, and the operators they
call) against the JAX package on the CPU.

The same seeded numpy inputs and parameters go through the JAX class
and the port's (``torch_parity.carry_block``). Each layer runs in
training mode (the port's under ``autograd.record()``, the JAX one's
forward and VJP as one jitted program) and is compared on its outputs,
the gradients of its inputs and parameters (from seeded head
gradients) and its running statistics, float32 within 1e-5 of each
one's max |value|.
The blocks of examples/train_dcgan.py and train_vae.py are built as the
examples build them."""
import importlib.util
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon import contrib as jcontrib
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops.nn import _ctc_loss, _deconvolution, _leaky_relu
from mxnet_tpu.ops.tensor import _pad, _reshape
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import contrib as tcontrib
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.guardrails import fused
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops import tensor as ttensor

from torch_parity import assert_close_of_max, carry_block, recorded_pair

tF = tmx.nd

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- layers --------------------------------------------------------------
# name -> (factory of the block from an nn namespace, input shapes)
LAYERS = {
    "Conv1D": (lambda nn: nn.Conv1D(6, 3, strides=2, padding=1, dilation=2,
                                    groups=2), [(2, 4, 11)]),
    "Conv3D": (lambda nn: nn.Conv3D(4, (2, 3, 3), strides=(1, 2, 1),
                                    padding=1, activation="relu"),
               [(2, 3, 4, 6, 5)]),
    "Conv1DTranspose_adj_ge_stride": (
        lambda nn: nn.Conv1DTranspose(4, 3, strides=2, padding=1,
                                      output_padding=2), [(2, 3, 7)]),
    "Conv1DTranspose_adj_past_pad": (
        lambda nn: nn.Conv1DTranspose(3, 3, padding=0, output_padding=2,
                                      groups=3), [(2, 3, 5)]),
    "Conv2DTranspose_adj_groups": (
        lambda nn: nn.Conv2DTranspose(6, 3, strides=2, padding=1,
                                      output_padding=1, groups=2),
        [(2, 4, 5, 4)]),
    "Conv2DTranspose_dilated": (
        lambda nn: nn.Conv2DTranspose(3, (3, 2), strides=(1, 2),
                                      padding=(2, 0), dilation=(2, 1),
                                      use_bias=False), [(1, 2, 6, 5)]),
    "Conv3DTranspose_adj_groups": (
        lambda nn: nn.Conv3DTranspose(4, 2, strides=2, output_padding=1,
                                      groups=2, activation="tanh"),
        [(1, 2, 3, 2, 3)]),
    "MaxPool1D_ceil": (lambda nn: nn.MaxPool1D(3, 2, padding=1,
                                               ceil_mode=True), [(2, 3, 10)]),
    "MaxPool3D_ceil": (lambda nn: nn.MaxPool3D(2, 2, ceil_mode=True),
                       [(1, 2, 5, 4, 5)]),
    "AvgPool1D_nopad_count": (
        lambda nn: nn.AvgPool1D(3, 2, padding=1, ceil_mode=True,
                                count_include_pad=False), [(2, 3, 10)]),
    "AvgPool3D_nopad_count": (
        lambda nn: nn.AvgPool3D(3, 2, padding=1, count_include_pad=False),
        [(1, 2, 5, 6, 5)]),
    "AvgPool2D_ceil": (lambda nn: nn.AvgPool2D(3, 2, padding=1,
                                               ceil_mode=True), [(1, 2, 6, 7)]),
    "GlobalMaxPool1D": (lambda nn: nn.GlobalMaxPool1D(), [(2, 3, 7)]),
    "GlobalMaxPool2D": (lambda nn: nn.GlobalMaxPool2D(), [(2, 3, 4, 5)]),
    "GlobalMaxPool3D": (lambda nn: nn.GlobalMaxPool3D(), [(1, 3, 3, 4, 2)]),
    "GlobalAvgPool1D": (lambda nn: nn.GlobalAvgPool1D(), [(2, 3, 7)]),
    "GlobalAvgPool3D": (lambda nn: nn.GlobalAvgPool3D(), [(1, 3, 3, 4, 2)]),
    "ReflectionPad2D": (lambda nn: nn.ReflectionPad2D(2), [(2, 3, 4, 5)]),
    "GroupNorm": (lambda nn: nn.GroupNorm(num_groups=2), [(2, 6, 3, 4)]),
    "InstanceNorm": (lambda nn: nn.InstanceNorm(epsilon=1e-3),
                     [(2, 3, 4, 5)]),
    "SyncBatchNorm": (lambda nn: nn.SyncBatchNorm(momentum=0.8),
                      [(4, 3, 2, 5)]),
    "BatchNorm_no_scale_center": (
        lambda nn: nn.BatchNorm(scale=False, center=False), [(4, 3, 5)]),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.2), [(3, 7)]),
    "PReLU": (lambda nn: nn.PReLU(in_channels=3), [(2, 3, 4)]),
    "PReLU_shared": (lambda nn: nn.PReLU(), [(2, 3, 4)]),
    "ELU": (lambda nn: nn.ELU(alpha=0.7), [(3, 7)]),
    "SELU": (lambda nn: nn.SELU(), [(3, 7)]),
    "Swish": (lambda nn: nn.Swish(beta=1.5), [(3, 7)]),
    "GELU": (lambda nn: nn.GELU(), [(3, 7)]),
    "Lambda": (lambda nn: nn.Lambda("tanh"), [(3, 7)]),
    "HybridLambda": (lambda nn: nn.HybridLambda(
        lambda F, x: F.reshape(F.relu(x), (-1, 2, 0))), [(3, 4, 5)]),
    "HybridLambda_by_name": (lambda nn: nn.HybridLambda("sigmoid"),
                             [(3, 7)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    """Outputs, input and parameter gradients and running statistics
    under record(), float32 within 1e-5 of max |value|."""
    make, shapes = LAYERS[name]
    inputs = [_x(i + len(name), *s) for i, s in enumerate(shapes)]
    jblock, tblock = make(jnn), make(tnn)
    carry_block(jblock, tblock, inputs, scale=0.5)
    got, want = recorded_pair(jblock, tblock, inputs)
    assert_close_of_max(got, want, TOL)


CONTRIB = {
    "HybridConcurrent": lambda c, nn: _concurrent(c.HybridConcurrent(axis=1),
                                                  nn),
    "Concurrent": lambda c, nn: _concurrent(c.Concurrent(axis=-1), nn),
    "Identity": lambda c, nn: c.Identity(),
}


def _concurrent(block, nn):
    block.add(nn.Dense(3, flatten=False), nn.Activation("tanh"),
              nn.Dense(2, flatten=False, activation="relu"))
    return block


@pytest.mark.parametrize("name", sorted(CONTRIB))
def test_contrib_nn_matches_jax(name):
    inputs = [_x(5, 4, 6)]
    jblock = CONTRIB[name](jcontrib.nn, jnn)
    tblock = CONTRIB[name](tcontrib.nn, tnn)
    carry_block(jblock, tblock, inputs, scale=0.5)
    got, want = recorded_pair(jblock, tblock, inputs)
    assert_close_of_max(got, want, TOL)


def test_moe_ffn_raises_naming_item_9():
    with pytest.raises(MXNetError, match="Queue 1 item 9"):
        tcontrib.nn.MoEFFN(units=8, hidden_size=16, num_experts=2)


def test_namespace_names_item_6_for_a_missing_operator():
    """The Lambdas resolve names in mx.nd: batch_dot works (item 6 ported
    it), a deferred operator raises naming its ROADMAP item."""
    x = torch.arange(8, dtype=torch.float32).reshape(2, 2, 2)
    want = torch.matmul(x, x)
    assert torch.equal(tnn.Lambda("batch_dot")(x, x), want)
    assert torch.equal(
        tnn.HybridLambda(lambda F, x: F.batch_dot(x, x))(x), want)
    with pytest.raises(MXNetError, match="Queue 1 item 10"):
        tnn.Lambda("box_nms")
    with pytest.raises(MXNetError, match="Queue 1 item 10"):
        tnn.HybridLambda(lambda F, x: F.contrib.box_nms(x))(x)
    assert tnn.Lambda("relu")(torch.tensor([-1.0, 2.0])).tolist() == [0, 2]


# -- operators the layers call -------------------------------------------
@pytest.mark.parametrize("shape,codes,reverse", [
    ((2, 3, 4), (0, -1), False), ((2, 3, 4), (-2,), False),
    ((2, 3, 4), (-3, 0), False), ((2, 12), (0, -4, 3, -1), False),
    ((2, 3, 4), (-1, 0), True), ((6, 4), (-4, -1, 2, 0), False)])
def test_reshape_codes_match_jax(shape, codes, reverse):
    x = _x(0, *shape)
    want = np.asarray(_reshape(jnp.asarray(x), shape=codes, reverse=reverse))
    got = ttensor.reshape(torch.from_numpy(x), codes, reverse=reverse)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad_modes_match_jax(mode):
    x = _x(1, 2, 3, 4, 5)
    width = (0, 0, 0, 0, 1, 2, 3, 0)
    want = np.asarray(_pad(jnp.asarray(x), mode=mode, pad_width=width,
                           constant_value=1.5))
    got = ttensor.pad(torch.from_numpy(x), mode=mode, pad_width=width,
                      constant_value=1.5)
    np.testing.assert_array_equal(got.numpy(), want)
    if mode != "constant":
        with pytest.raises(MXNetError):
            ttensor.pad(torch.from_numpy(x), mode=mode,
                        pad_width=(0, 1) + (0,) * 6)


@pytest.mark.parametrize("act", ["leaky", "prelu", "elu", "selu", "gelu",
                                 "rrelu"])
def test_leaky_relu_modes_and_grads_match_jax(act):
    """Every mode, values and the gradient of a seeded head, 1e-5; x
    holds exact zeros, where ``x >= 0`` takes the positive branch."""
    x = _x(2, 4, 3, 5)
    x[0, 0, :2] = 0.0
    gamma = np.array([0.1, 0.3, 0.5], np.float32)
    head = _x(3, 4, 3, 5)
    kw = dict(act_type=act, slope=0.3)
    jx = jmx.nd.array(x)
    jx.attach_grad()
    with jag.record():
        jy = jmx.nd.LeakyReLU(jx, jmx.nd.array(gamma), **kw) \
            if act == "prelu" else jmx.nd.LeakyReLU(jx, **kw)
    jy.backward(jmx.nd.array(head))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tops.leaky_relu(tx, torch.from_numpy(gamma) if act == "prelu"
                         else None, **kw)
    ty.backward(torch.from_numpy(head))
    assert_close_of_max({"y": ty.detach().numpy(), "dx": tx.grad.numpy()},
                        {"y": jy.asnumpy(), "dx": jx.grad.asnumpy()}, TOL)
    want = np.asarray(_leaky_relu(jnp.asarray(x), *([jnp.asarray(gamma)]
                      if act == "prelu" else []), **kw))
    np.testing.assert_allclose(ty.detach().numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_deconvolution_target_shape_is_not_read_as_in_jax():
    x, w = _x(4, 1, 2, 5, 5), _x(5, 2, 3, 3, 3)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=3)
    want = np.asarray(_deconvolution(jnp.asarray(x), jnp.asarray(w),
                                     target_shape=(20, 20), **kw))
    got = tops.deconvolution(torch.from_numpy(x), torch.from_numpy(w),
                             target_shape=(20, 20), **kw)
    assert tuple(got.shape) == want.shape == (1, 3, 9, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())


# -- losses ------------------------------------------------------------------
def _labels01(seed, *shape):
    return np.random.RandomState(seed).randint(0, 2, shape).astype(
        np.float32)


def _ctc_inputs(layout, label_layout, lengths, padded):
    rng = np.random.RandomState(7)
    pred = rng.randn(3, 9, 6).astype(np.float32)        # N, T, C (blank 5)
    label = rng.randint(0, 5, (3, 4)).astype(np.float32)
    label[1, 1] = label[1, 2]                            # a repeat
    if padded:
        label[0, 2:] = -1
        label[2, 3:] = -1
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    extra = [np.array([9, 7, 8], np.float32),
             np.array([2, 4, 3], np.float32)] if lengths else []
    return [pred, label] + extra


LOSSES = {
    "L1Loss": (lambda g: g.loss.L1Loss(weight=0.5),
               lambda: [_x(1, 4, 3, 2), _x(2, 4, 3, 2)]),
    "SigmoidBCE_logits": (lambda g: g.loss.SigmoidBinaryCrossEntropyLoss(),
                          lambda: [_x(1, 5, 3) * 3, _labels01(2, 5, 3)]),
    "SigmoidBCE_pos_weight": (
        lambda g: g.loss.SigmoidBCELoss(),
        lambda: [_x(1, 5, 3) * 3, _labels01(2, 5, 3), None,
                 np.array([0.5, 2.0, 3.0], np.float32)]),
    "SigmoidBCE_from_sigmoid": (
        lambda g: g.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True),
        lambda: [1 / (1 + np.exp(-_x(1, 5, 3))), _labels01(2, 5, 3)]),
    "SigmoidBCE_from_sigmoid_pos_weight": (
        lambda g: g.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True),
        lambda: [1 / (1 + np.exp(-_x(1, 5, 3))), _labels01(2, 5, 3), None,
                 np.array([0.5, 2.0, 3.0], np.float32)]),
    "KLDivLoss": (lambda g: g.loss.KLDivLoss(),
                  lambda: [np.log(_softmax(_x(1, 4, 6))),
                           _softmax(_x(2, 4, 6))]),
    "KLDivLoss_from_scores": (
        lambda g: g.loss.KLDivLoss(from_logits=False, axis=1),
        lambda: [_x(1, 4, 6), _softmax(_x(2, 4, 6), axis=1)]),
    "HuberLoss": (lambda g: g.loss.HuberLoss(rho=0.7),
                  lambda: [_x(1, 6, 4), _x(2, 6, 4)]),
    "HingeLoss": (lambda g: g.loss.HingeLoss(margin=0.5),
                  lambda: [_x(1, 6, 4), np.sign(_x(2, 6, 4))]),
    "SquaredHingeLoss": (lambda g: g.loss.SquaredHingeLoss(),
                         lambda: [_x(1, 6, 4), np.sign(_x(2, 6, 4))]),
    "LogisticLoss_signed": (lambda g: g.loss.LogisticLoss(),
                            lambda: [_x(1, 6, 4) * 2, np.sign(_x(2, 6, 4))]),
    "LogisticLoss_binary": (
        lambda g: g.loss.LogisticLoss(label_format="binary"),
        lambda: [_x(1, 6, 4) * 2, _labels01(2, 6, 4)]),
    "TripletLoss": (lambda g: g.loss.TripletLoss(margin=2),
                    lambda: [_x(1, 5, 4), _x(2, 5, 4), _x(3, 5, 4)]),
    "CosineEmbeddingLoss": (
        lambda g: g.loss.CosineEmbeddingLoss(margin=0.2),
        lambda: [_x(1, 6, 5), _x(2, 6, 5),
                 np.array([1, -1, 1, -1, 1, -1], np.float32)]),
    "CTCLoss_NTC_padded": (lambda g: g.loss.CTCLoss(),
                           lambda: _ctc_inputs("NTC", "NT", False, True)),
    "CTCLoss_TNC_TN_lengths_padded": (
        lambda g: g.loss.CTCLoss(layout="TNC", label_layout="TN",
                                 weight=2.0),
        lambda: _ctc_inputs("TNC", "TN", True, True)),
}


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    """The per-sample loss and the gradient of its seeded weighted sum
    w.r.t. the first input, float32 within 1e-5 of max |value|."""
    make, arrays = LOSSES[name]
    args = [None if a is None else np.asarray(a, np.float32)
            for a in arrays()]
    got, want = recorded_pair(make(jgluon), make(tmx.gluon), args,
                              grad_inputs=[0])
    assert got["out0"].ndim == 1 and np.isfinite(got["out0"]).all()
    assert_close_of_max(got, want, TOL)


@pytest.mark.parametrize("blank,n_labels", [("first", 3), ("last", 0)])
def test_ctc_op_blank_label_and_no_labels_match_jax(blank, n_labels):
    """The op's -log p per sample with blank_label first and last, and
    the all-blank path when there are no labels (L = 0), with data
    lengths; 1e-5."""
    import jax
    rng = np.random.RandomState(11)
    data = rng.randn(7, 3, 5).astype(np.float32)
    labels = rng.randint(1, 4, (3, n_labels)).astype(np.float32)
    lengths = np.array([7, 5, 6], np.float32)
    op = jax.jit(_ctc_loss, static_argnames=("blank_label",))
    want = np.asarray(op(jnp.asarray(data), jnp.asarray(labels),
                         blank_label=blank,
                         data_lengths=jnp.asarray(lengths)))
    got = tops.ctc_loss(torch.from_numpy(data), torch.from_numpy(labels),
                        data_lengths=torch.from_numpy(lengths),
                        blank_label=blank)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())


# -- gluon.utils -------------------------------------------------------------
@pytest.mark.parametrize("even", [True, False])
def test_split_data_and_split_and_load_match_jax(even):
    x = _x(3, 7 if not even else 8, 3)
    want = [s.asnumpy() for s in jgluon.utils.split_data(
        jmx.nd.array(x), 3 if not even else 4, even_split=even)]
    got = tmx.gluon.utils.split_data(torch.from_numpy(x),
                                     3 if not even else 4, even_split=even)
    assert [g.shape for g in [t.numpy() for t in got]] == \
        [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    loaded = tmx.gluon.utils.split_and_load(x, [tmx.cpu(), tmx.cpu()],
                                            even_split=False)
    assert [tuple(t.shape) for t in loaded] == [(x.shape[0] // 2, 3),
                                               (x.shape[0] - x.shape[0] // 2,
                                                3)]
    assert all(t.device.type == "cpu" for t in loaded)
    with pytest.raises(MXNetError):
        tmx.gluon.utils.split_data(torch.ones(7, 2), 2)


def _count_host_reads(monkeypatch):
    reads = []
    real = fused.host_fetch
    monkeypatch.setattr(fused, "host_fetch",
                        lambda *v: reads.append(len(v)) or real(*v))
    return reads


@pytest.mark.parametrize("check", [True, False])
@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(check, max_norm, monkeypatch):
    """The scaled arrays and the norm, 1e-5; one host read with
    check_isfinite (a float comes back), none without (a 0-d tensor)."""
    arrays = [_x(i, *s) for i, s in enumerate([(3, 4), (5,), (2, 2, 2)])]
    jarr = [jmx.nd.array(a) for a in arrays]
    jnorm = jgluon.utils.clip_global_norm(jarr, max_norm,
                                          check_isfinite=check)
    tarr = [torch.from_numpy(a.copy()) for a in arrays]
    reads = _count_host_reads(monkeypatch)
    tnorm = tmx.gluon.utils.clip_global_norm(tarr, max_norm,
                                             check_isfinite=check)
    assert len(reads) == (1 if check else 0)
    if check:
        assert isinstance(tnorm, float)
    else:
        assert isinstance(tnorm, torch.Tensor) and tnorm.ndim == 0
    jn = float(jnorm if check else jnorm.asnumpy())
    np.testing.assert_allclose(float(tnorm), jn, rtol=TOL)
    for t, j in zip(tarr, jarr):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=0,
                                   atol=TOL * np.abs(j.asnumpy()).max())


def test_clip_global_norm_global_norm_nonfinite_and_sparse(monkeypatch):
    """``global_norm=`` replaces the reduction; a non-finite norm warns
    and leaves the arrays (check_isfinite) or scales by 1 (without); a
    sparse COO array takes part through its stored values, which are
    scaled in place, and an uncoalesced one raises."""
    a = [torch.ones(4)]
    reads = _count_host_reads(monkeypatch)
    assert tmx.gluon.utils.clip_global_norm(a, 1.0, global_norm=4.0) == 4.0
    assert len(reads) == 1
    np.testing.assert_allclose(a[0].numpy(), np.full(4, 0.25), rtol=1e-6)
    b = [torch.tensor([1.0, float("inf")])]
    with pytest.warns(UserWarning, match="non-finite"):
        norm = tmx.gluon.utils.clip_global_norm(b, 1.0)
    assert norm == float("inf") and b[0][0] == 1.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        norm = tmx.gluon.utils.clip_global_norm(b, 1.0,
                                                check_isfinite=False)
    assert not torch.isfinite(norm) and b[0][0] == 1.0
    sparse = torch.eye(3).to_sparse()
    norm = tmx.gluon.utils.clip_global_norm([sparse], 1.0)
    np.testing.assert_allclose(norm, np.sqrt(3.0), rtol=1e-6)
    np.testing.assert_allclose(sparse.to_dense().numpy(),
                               np.eye(3) / np.sqrt(3.0), rtol=1e-6)
    loose = torch.sparse_coo_tensor([[0, 0]], torch.ones(2, 3), (4, 3),
                                    check_invariants=False)
    with pytest.raises(MXNetError, match="coalesce"):
        tmx.gluon.utils.clip_global_norm([loose], 1.0)


def test_check_sha1_and_download_as_jax(tmp_path):
    path = tmp_path / "f.bin"
    path.write_bytes(b"mxnet" * 1000)
    import hashlib
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    for utils in (jgluon.utils, tmx.gluon.utils):
        assert utils.check_sha1(str(path), digest)
        assert not utils.check_sha1(str(path), "0" * 40)
    with pytest.raises(jmx.base.MXNetError) as jerr:
        jgluon.utils.download("http://example.com/x")
    with pytest.raises(MXNetError) as terr:
        tmx.gluon.utils.download("http://example.com/x")
    assert str(terr.value) == str(jerr.value)


# -- contrib.estimator -------------------------------------------------------
def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
    return net


def test_estimator_two_epochs_early_stopping_and_checkpoint(tmp_path):
    """Estimator.fit with SGD over a list of 4 batches against the JAX
    Estimator over an NDArrayIter of the same data: the early-stopping
    handler (patience 0, min_delta 10) stops after epoch 1, so both run
    2 of 5 epochs; the weights after them 1e-5; the checkpoint handler
    writes epoch0, epoch1 and final; the port's epoch-1 file reloads
    into a fresh port net and into the JAX net, equal to the trained
    weights."""
    from mxnet_tpu.gluon.contrib import estimator as jest
    from mxnet_tpu_torch.gluon.contrib import estimator as test_
    rng = np.random.RandomState(0)
    data = rng.randn(32, 5).astype(np.float32)
    label = rng.randint(0, 3, 32).astype(np.float32)
    jnet, tnet = _mlp(jnn), _mlp(tnn)
    carry_block(jnet, tnet, [data[:8]], scale=0.5)
    runs = {}
    for pkg, net, est_mod, dirname in (
            ("jax", jnet, jest, "j"), ("port", tnet, test_, "t")):
        gl = jgluon if pkg == "jax" else tmx.gluon
        trainer = gl.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1})
        est = est_mod.Estimator(net, gl.loss.SoftmaxCrossEntropyLoss(),
                                trainer=trainer)
        if pkg == "jax":
            train = jmx.io.NDArrayIter(data, label, batch_size=8)
            val = jmx.io.NDArrayIter(data, label, batch_size=8)
        else:
            train = [(torch.from_numpy(data[i:i + 8]),
                      torch.from_numpy(label[i:i + 8]))
                     for i in range(0, 32, 8)]
            val = train
        monitor = est.val_metrics[-1]
        stop = est_mod.EarlyStoppingHandler(monitor, patience=0,
                                            min_delta=10.0)
        ckpt = est_mod.CheckpointHandler(str(tmp_path / dirname))
        epochs = []
        begin = type("B", (est_mod.EpochBegin,), {
            "epoch_begin": lambda self, e, epoch=None, **k:
                epochs.append(epoch)})()
        est.fit(train, val, epochs=5, event_handlers=[stop, ckpt, begin])
        runs[pkg] = (epochs, est.train_metrics[0].get(), monitor.get())
    assert runs["port"][0] == runs["jax"][0] == [0, 1]
    for k in ("train", "val"):
        i = 1 if k == "train" else 2
        assert runs["port"][i][0] == runs["jax"][i][0]
        np.testing.assert_allclose(runs["port"][i][1], runs["jax"][i][1],
                                   rtol=1e-5)
    want = {k: p.data().asnumpy() for k, p in jnet._structural_names().items()}
    got = {k: v.detach().numpy() for k, v in tnet.collect_params().items()}
    assert_close_of_max(got, want, TOL)
    for d in ("j", "t"):
        assert sorted(os.listdir(tmp_path / d)) == [
            "model-epoch0.params", "model-epoch1.params",
            "model-final.params"]
    fresh = _mlp(tnn)
    fresh.load_parameters(str(tmp_path / "t" / "model-epoch1.params"),
                          ctx=tmx.cpu())
    assert_close_of_max({k: v.detach().numpy()
                         for k, v in fresh.collect_params().items()},
                        want, TOL)
    back = _mlp(jnn)
    back.load_parameters(str(tmp_path / "t" / "model-epoch1.params"),
                         ctx=jmx.cpu())
    assert_close_of_max({k: p.data().asnumpy()
                         for k, p in back._structural_names().items()},
                        want, TOL)


# -- the DCGAN and VAE examples' blocks --------------------------------------
def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port_generator(ngf=16):
    net = tnn.HybridSequential()
    net.add(
        tnn.Dense(ngf * 2 * 4 * 4, use_bias=False),
        tnn.HybridLambda(lambda F, x: F.reshape(x, (-1, 32, 4, 4))),
        tnn.Conv2DTranspose(ngf, 4, strides=2, padding=1, use_bias=False),
        tnn.Activation("relu"),
        tnn.Conv2DTranspose(1, 4, strides=2, padding=1, use_bias=False),
        tnn.Activation("tanh"))
    return net


def _port_discriminator(ndf=16):
    net = tnn.HybridSequential()
    net.add(
        tnn.Conv2D(ndf, 4, strides=2, padding=1),
        tnn.LeakyReLU(0.2),
        tnn.Conv2D(ndf * 2, 4, strides=2, padding=1),
        tnn.LeakyReLU(0.2),
        tnn.Dense(1))
    return net


class _PortVAE(tmx.gluon.HybridBlock):
    """examples/train_vae.py's VAE with the port's blocks."""

    def __init__(self, nz=8, nf=16):
        super().__init__()
        self._nz = nz
        self.enc = tnn.HybridSequential()
        self.enc.add(tnn.Conv2D(nf, 4, strides=2, padding=1),
                     tnn.Activation("relu"),
                     tnn.Conv2D(nf * 2, 4, strides=2, padding=1),
                     tnn.Activation("relu"), tnn.Dense(2 * nz))
        self.dec = tnn.HybridSequential()
        self.dec.add(tnn.Dense(nf * 2 * 4 * 4, activation="relu"),
                     tnn.HybridLambda(
                         lambda F, x: F.reshape(x, (-1, nf * 2, 4, 4))),
                     tnn.Conv2DTranspose(nf, 4, strides=2, padding=1),
                     tnn.Activation("relu"),
                     tnn.Conv2DTranspose(1, 4, strides=2, padding=1),
                     tnn.Activation("tanh"))

    def forward(self, x, eps):
        h = self.enc(x)
        mu = tF.slice_axis(h, axis=1, begin=0, end=self._nz)
        logvar = tF.slice_axis(h, axis=1, begin=self._nz, end=2 * self._nz)
        return self.dec(mu + tF.exp(0.5 * logvar) * eps), mu, logvar


EXAMPLES = {
    "dcgan_generator": (lambda ex: ex.build_generator(),
                        _port_generator, "train_dcgan", [(4, 16)]),
    "dcgan_discriminator": (lambda ex: ex.build_discriminator(),
                            _port_discriminator, "train_dcgan",
                            [(4, 1, 16, 16)]),
    "vae": (lambda ex: ex.VAE(), _PortVAE, "train_vae",
            [(4, 1, 16, 16), (4, 8)]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_blocks_match_jax(name):
    """The blocks as the examples build them: outputs and the gradients of
    inputs and parameters in training mode, 1e-5 of max |value|."""
    jmake, tmake, module, shapes = EXAMPLES[name]
    inputs = [_x(i + 3, *s) for i, s in enumerate(shapes)]
    jblock, tblock = jmake(_example(module)), tmake()
    carry_block(jblock, tblock, inputs, scale=0.2)
    got, want = recorded_pair(jblock, tblock, inputs)
    assert_close_of_max(got, want, TOL)

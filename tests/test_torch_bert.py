"""BERT in the port (mxnet_tpu_torch/gluon/model_zoo/bert.py) and the
layers and operators it runs on, against the JAX package on the CPU.

The narrow BERT (2 layers, units 64, hidden 128, 4 heads, max_length 64,
vocab 100) carries its weights across; its outputs (seq_out, pooled, nsp
and the MLM decoder's scores) agree within 1e-4 of each output's largest
|value|: looser than one op's 1e-5 because matrix products sum in another
order through two cells. Single layers and operators agree at float32
atol = rtol = 1e-5."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as torch_bert
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.ops import tensor as ttensor

from torch_parity import NARROW_BERT, bert_outputs, bert_pair


@pytest.fixture(scope="module")
def pair():
    return bert_pair(seed=0)


def _ids(seed, batch=3, seq=12, high=100):
    return np.random.RandomState(seed).randint(0, high, (batch, seq)) \
        .astype(np.int32)


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    assert got.shape == want.shape
    assert np.isfinite(got).all() and scale > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("token_types", [False, True])
def test_narrow_bert_matches_jax(pair, token_types, masked):
    jnet, tnet, _ = pair
    ids = _ids(1)
    tt = _ids(2, high=2) if token_types else None
    mp = np.random.RandomState(3).randint(0, 12, (3, 4)).astype(np.int32) \
        if masked else None
    got, want = bert_outputs(jnet, tnet, ids, tt, mp)
    assert [g.shape for g in got] == [(3, 12, 64), (3, 64), (3, 2),
                                      (3, 4 if masked else 12, 100)]
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_bert_without_heads_returns_seq_out():
    jnet, tnet, _ = bert_pair(seed=4, use_pooler=False, use_decoder=False,
                              use_classifier=False)
    got, want = bert_outputs(jnet, tnet, _ids(5, batch=2, seq=64))
    assert len(got) == 1 and got[0].shape == (2, 64, 64)
    _close(got[0], want[0], 1e-4)


def test_names_and_shapes_equal_jax_without_the_alias(pair):
    jnet, tnet, arrays = pair
    want = {k: v.shape for k, v in arrays.items()}
    assert want.pop("position_embed") == want["position_weight"]
    got = {k: tuple(v.shape) for k, v in tnet.state_dict().items()}
    assert got == want
    assert "encoder.transformer_cells.0.attention.qkv.weight" in got
    assert "encoder.transformer_cells.1.ffn.ffn_1.bias" in got
    for name in ("encoder.transformer_cells.0.ln1.gamma",
                 "word_embed.weight", "pooler.weight", "decoder.3.bias",
                 "classifier.weight"):
        assert name in got


def test_bert_base_shapes_and_launches():
    net = torch_bert.bert_12_768_12(use_decoder=False, vocab_size=30522)
    net.initialize(tmx.init.Normal(0.02), ctx=tmx.cpu(),
                   generator=tmx.random.generator(0))
    with torch.inference_mode():
        seq_out, pooled, nsp = net(torch.zeros(1, 4, dtype=torch.int32))
    assert (seq_out.shape, pooled.shape, nsp.shape) == ((1, 4, 768),
                                                        (1, 768), (1, 2))
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes["position_weight"] == (512, 768)
    assert shapes["word_embed.weight"] == (30522, 768)
    assert shapes["encoder.transformer_cells.11.ffn.ffn_1.weight"] \
        == (3072, 768)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 109_483_778
    # 25 matmul-epilogue calls per forward: ffn_1 and ffn_2 of 12 cells
    # and the pooler; qkv, proj and the NSP classifier are not fused
    fused = [n for n, m in net.named_modules()
             if isinstance(m, tnn.Dense) and m._fuse]
    assert len(fused) == 25 and "pooler" in fused
    assert not any(n.endswith(("qkv", "proj")) or n == "classifier"
                   for n in fused)


def test_alias_must_equal_its_canonical_array(pair):
    _, _, arrays = pair
    fresh = torch_bert.BERTModel(**NARROW_BERT)
    bad = dict(arrays)
    bad["position_embed"] = arrays["position_embed"] + 1.0
    with pytest.raises(MXNetError, match="position_embed"):
        load_jax_params(fresh, bad, ctx=tmx.cpu())
    missing = dict(arrays)
    missing.pop("position_weight")        # the alias cannot stand in
    with pytest.raises(MXNetError, match="position_weight"):
        load_jax_params(torch_bert.BERTModel(**NARROW_BERT), missing,
                        ctx=tmx.cpu())


def test_dropout_is_identity_in_predict_mode_and_raises_in_training():
    """Predict mode is the identity. Training draws a mask: a layer put
    in training mode, and the narrow BERT under ``autograd.record()``,
    whose forward draws once per dropout site (the embedding's, two per
    cell) and once per cell for ffn_2's epilogue dropout. In training the
    op raises on explicit bits that do not fit its input."""
    x = torch.randn(3, 5)
    layer = tnn.Dropout(0.1)
    assert layer(x) is x
    assert tops.dropout(x, p=0.5) is x
    layer.train()
    out = layer(torch.ones(64, 64))
    assert (out == 0).any() and (out != 0).any()
    with pytest.raises(MXNetError, match="bits"):
        tops.dropout(x, p=0.5, mode="always",
                     bits=torch.zeros(3, 4, dtype=torch.uint8))
    with pytest.raises(MXNetError, match="bits"):
        tops.dropout(x, p=0.5, training=True, bits=torch.zeros(3, 5))
    _, tnet, _ = bert_pair(seed=6)
    ids = torch.from_numpy(_ids(7))
    with torch.inference_mode():
        predict = tnet(ids)[0]
    with tmx.autograd.record(), tmx.random.bits_tape() as tape:
        train = tnet(ids)[0]
    assert len(tape.drawn) == 1 + 3 * NARROW_BERT["num_layers"]
    assert torch.isfinite(train).all()
    assert not torch.allclose(train.detach(), predict)


def _dense_pair(act, use_bias, epilogue_dropout=0.0, in_units=6):
    jd = jnn.Dense(5, activation=act, use_bias=use_bias, flatten=False,
                   in_units=in_units, epilogue_dropout=epilogue_dropout)
    td = tnn.Dense(5, activation=act, use_bias=use_bias, flatten=False,
                   in_units=in_units, epilogue_dropout=epilogue_dropout)
    jd.initialize(jmx.init.Normal(0.5), ctx=jmx.cpu())
    rng = np.random.RandomState(8)
    arrays = {"weight": (rng.randn(5, in_units) * 0.5).astype(np.float32)}
    if use_bias:
        arrays["bias"] = rng.randn(5).astype(np.float32)
    for k, v in arrays.items():
        getattr(jd, k).set_data(nd.array(v))
    td.load_dict(arrays, ctx=tmx.cpu())
    return jd, td


@pytest.mark.parametrize("act,use_bias,drop,fused", [
    ("relu", True, 0.0, True), ("tanh", True, 0.0, True),
    ("sigmoid", True, 0.0, True), ("gelu", True, 0.0, True),
    (None, True, 0.1, True), ("gelu", True, 0.1, True),
    (None, True, 0.0, False), ("gelu", False, 0.0, False),
    ("relu", False, 0.1, False), ("softrelu", True, 0.0, False),
])
def test_dense_fused_and_unfused_match_jax(act, use_bias, drop, fused):
    jd, td = _dense_pair(act, use_bias, drop)
    assert td._fuse == fused
    x = np.random.RandomState(9).randn(2, 3, 6).astype(np.float32)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = td(torch.from_numpy(x)).numpy()
    assert kernels.launch_counts()["matmul_epilogue"] == 0    # CPU tensor
    want = jd(nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_jax(axis):
    rng = np.random.RandomState(10)
    x = (rng.randn(2, 6, 5) * 3 + 40).astype(np.float32)   # |mean| >> std
    c = x.shape[axis]
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    want = nd.LayerNorm(nd.array(x), nd.array(gamma), nd.array(beta),
                        axis=axis, eps=1e-12).asnumpy()
    got = tops.layer_norm(*(torch.from_numpy(a) for a in (x, gamma, beta)),
                          axis=axis, eps=1e-12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    layer = tnn.LayerNorm(axis=axis, epsilon=1e-12)
    layer.initialize(ctx=tmx.cpu())
    with torch.inference_mode():
        layer(torch.from_numpy(x))               # infers (C,)
    layer.load_dict({"gamma": gamma, "beta": beta})
    with torch.inference_mode():
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                                   want, rtol=1e-5, atol=1e-5)


def test_embedding_matches_jax_including_out_of_range_ids():
    rng = np.random.RandomState(11)
    weight = rng.randn(7, 3).astype(np.float32)
    ids = np.array([[0, 6, -1, -7], [7, -8, 100, 3]], np.int32)
    want = nd.Embedding(nd.array(ids, dtype="int32"), nd.array(weight),
                        input_dim=7, output_dim=3).asnumpy()
    assert np.isnan(want[1, :3]).all() and np.isfinite(want[0]).all()
    layer = tnn.Embedding(7, 3)
    layer.load_dict({"weight": weight}, ctx=tmx.cpu())
    with torch.inference_mode():
        got = layer(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)          # NaN rows included
    np.testing.assert_array_equal(
        tops.embedding(torch.from_numpy(ids.astype(np.float32)),
                       torch.from_numpy(weight)).numpy(), want)


def test_gelu_matches_jax():
    x = (np.random.RandomState(12).randn(4, 9) * 3).astype(np.float32)
    want = jnn.GELU()(nd.array(x)).asnumpy()
    with torch.inference_mode():
        got = tnn.GELU()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tops.leaky_relu(torch.from_numpy(x), act_type="gelu").numpy(),
        nd.LeakyReLU(nd.array(x), act_type="gelu").asnumpy(), rtol=1e-5,
        atol=1e-5)
    # the other modes are ported now (tests/test_torch_gluon_layers.py);
    # an unknown one raises in both packages
    np.testing.assert_allclose(
        tops.leaky_relu(torch.from_numpy(x), act_type="elu").numpy(),
        nd.LeakyReLU(nd.array(x), act_type="elu").asnumpy(), rtol=1e-5,
        atol=1e-5)
    with pytest.raises(MXNetError, match="unknown act_type"):
        tops.leaky_relu(torch.from_numpy(x), act_type="swish")


@pytest.mark.parametrize("causal", [False, True])
def test_fused_self_attention_matches_jax(causal):
    qkv = np.random.RandomState(13).randn(2, 9, 3 * 12).astype(np.float32)
    want = nd.contrib.fused_self_attention(nd.array(qkv), heads=3,
                                           causal=causal).asnumpy()
    got = tcontrib.fused_self_attention(torch.from_numpy(qkv), heads=3,
                                        causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_attention_above_1024_raises_naming_k3():
    """Above 1024 tokens the port no longer raises naming K3: it streams
    through the flash-attention path, here at S 1025 (its plain version
    on the CPU) against the JAX package. ``seq_parallel`` still raises."""
    qkv = np.random.RandomState(15).randn(1, 1025, 3 * 12) \
        .astype(np.float32)
    want = nd.contrib.fused_self_attention(nd.array(qkv), heads=2).asnumpy()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = tcontrib.fused_self_attention(torch.from_numpy(qkv), heads=2)
    assert kernels.launch_counts()["flash_attention"] == 0      # CPU path
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    tcontrib.fused_self_attention(torch.zeros(1, 1024, 6), heads=2)
    with pytest.raises(MXNetError, match="seq_parallel"):
        torch_bert.MultiHeadAttention(8, 2, seq_parallel="ring")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1100, 1536])
def test_long_fused_self_attention_matches_jax(s, causal):
    """The streaming branch (S > 1024) against JAX
    ``_fused_self_attention``, which transposes to [B, H, S, D] for its
    flash path; the port reads the fused QKV as strided views."""
    from mxnet_tpu.ops.contrib import _fused_self_attention
    qkv = np.random.RandomState(s).randn(2, s, 3 * 32).astype(np.float32)
    want = np.asarray(_fused_self_attention(qkv, heads=2, causal=causal,
                                            block_size=256))
    with torch.inference_mode():
        got = tcontrib.fused_self_attention(
            torch.from_numpy(qkv), heads=2, causal=causal, block_size=256)
    assert got.shape == (2, s, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_long_context_narrow_bert_matches_jax():
    """The narrow BERT with a 2048-row position table, weights carried by
    convert.py, at S 1536: every encoder cell takes the streaming
    attention branch. Outputs within 1e-4 of max |value|."""
    jnet, tnet, arrays = bert_pair(seed=16, max_length=2048)
    assert arrays["position_weight"].shape == (2048, 64)
    assert tuple(tnet.position_weight.shape) == (2048, 64)
    got, want = bert_outputs(jnet, tnet, _ids(17, batch=1, seq=1536),
                             _ids(18, batch=1, seq=1536, high=2))
    assert [g.shape for g in got] == [(1, 1536, 64), (1, 64), (1, 2),
                                      (1, 1536, 100)]
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_tensor_ops_match_jax():
    rng = np.random.RandomState(14)
    data = rng.randn(2, 5, 3).astype(np.float32)
    idx = np.array([[0, 1, -1, 1], [4, -1, 7, -9]], np.int32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        ttensor.gather_nd(t(data), t(idx)).numpy(),
        nd.gather_nd(nd.array(data), nd.array(idx, dtype="int32"))
        .asnumpy())
    table = rng.randn(8, 3).astype(np.float32)
    like = np.zeros((2, 5, 3), np.float32)
    np.testing.assert_array_equal(
        ttensor.slice_like(ttensor.expand_dims(t(table), axis=0), t(like),
                           axes=(1,)).numpy(),
        nd.slice_like(nd.expand_dims(nd.array(table), axis=0),
                      nd.array(like), axes=(1,)).asnumpy())
    np.testing.assert_array_equal(
        ttensor.squeeze(t(data[:, :1]), axis=1).numpy(),
        nd.squeeze(nd.array(data[:, :1]), axis=(1,)).asnumpy())
    pos = np.array([[3, 1], [0, 2], [4, 4]], np.int32)
    jpos = nd.array(pos, dtype="int32")
    got = ttensor.broadcast_like(
        tcontrib.arange_like(t(pos), axis=0).reshape(-1, 1), t(pos))
    want = nd.broadcast_like(
        nd.reshape(nd.arange_like(jpos, axis=0), shape=(-1, 1)),
        jpos)
    np.testing.assert_array_equal(got.numpy(), want.asnumpy())
    np.testing.assert_array_equal(
        ttensor.stack(got, t(pos), axis=0).numpy(),
        nd.stack(want, jpos, axis=0).asnumpy())
    np.testing.assert_array_equal(
        tcontrib.arange_like(t(data), start=1.0, step=0.5).numpy(),
        nd.arange_like(nd.array(data), start=1.0, step=0.5)
        .asnumpy())

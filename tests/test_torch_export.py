"""``HybridBlock.export``, ``gluon.SymbolBlock`` and
``serving.Server.from_checkpoint`` in the port against the JAX package,
on the CPU.

The port traces a block's tensor ``forward`` on meta tensors into the
JAX package's graph: full-width ResNet-50 v1 exports the JAX export's
operator counts (Convolution 53, BatchNorm 53 of which 32 carry
``act_type=relu``, ``_contrib_conv_epilogue`` 16, Pooling 2, Activation
1, FullyConnected 1); a narrow ResNet V1 and a 2-layer BERT export the
same counts as the JAX package's own export of the same network. The
JAX package's ``SymbolBlock.imports`` of the port's files answers as the
JAX Gluon model with the same weights (1e-5 relative, 1e-6 absolute),
the port's ``SymbolBlock`` as the port's model (bit for bit), and
``Server.from_checkpoint`` serves the pair."""
from collections import Counter

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from torch_parity import bert_pair, narrow_pair

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _counts(sym):
    return Counter(n.op for n in sym._topo() if n.op is not None)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_resnet50_v1_export_counts():
    """Full width, traced on meta tensors: no forward, no card."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = vision.resnet50_v1()
    net.initialize(ctx=CPU, generator=tmx.random.generator(0))
    with torch.inference_mode():         # infers the deferred shapes
        net(torch.zeros(1, 3, 32, 32))
    from mxnet_tpu_torch.gluon.export import trace
    sym = trace(net, [((1, 3, 224, 224), torch.float32)], ["data"])
    counts = _counts(sym)
    assert counts == {"Convolution": 53, "BatchNorm": 53,
                      "_contrib_conv_epilogue": 16, "Pooling": 2,
                      "Activation": 1, "FullyConnected": 1}
    assert sum(1 for n in sym._topo() if n.op == "BatchNorm"
               and n.attrs.get("act_type") == "relu") == 32
    assert sym.list_arguments()[:2] == ["data", "features.0.weight"]
    assert "features.1.running_mean" in sym.list_auxiliary_states()
    assert sym.infer_shape(data=(2, 3, 224, 224))[1] == [(2, 1000)]


def _export_both(jnet, tnet, x, tmp_path):
    """Both packages' exports of the same network after a forward on
    ``x``; returns (port files, JAX files)."""
    with torch.inference_mode():
        tnet(torch.from_numpy(x))
    jnet(jmx.nd.array(x, dtype=str(x.dtype)))
    t_files = tnet.export(str(tmp_path / "port"), 3)
    j_files = jnet.export(str(tmp_path / "jax"), 3)
    return t_files, j_files


def test_narrow_resnet_export_as_jax(tmp_path):
    jnet, tnet = narrow_pair()
    x = np.random.RandomState(1).randn(3, 3, 32, 32).astype(np.float32)
    t_files, j_files = _export_both(jnet, tnet, x, tmp_path)
    t_sym, j_sym = tmx.sym.load(t_files[0]), jmx.sym.load(j_files[0])
    assert _counts(t_sym) == _counts(j_sym)
    want = jnet(jmx.nd.array(x)).asnumpy()
    # the JAX package serves the port's files
    jblock = jmx.gluon.SymbolBlock.imports(t_files[0], ["data"], t_files[1])
    _close(jblock(jmx.nd.array(x)).asnumpy(), want)
    # the port serves its own (bit for bit) and the JAX package's files
    tblock = tmx.gluon.SymbolBlock.imports(t_files[0], "data", t_files[1],
                                           ctx=CPU)
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            tblock(torch.from_numpy(x)).numpy(), got)
        from_jax = tmx.gluon.SymbolBlock.imports(j_files[0], ["data"],
                                                 j_files[1], ctx=CPU)
        _close(from_jax(torch.from_numpy(x)).numpy(), want)
    assert sorted(k for k in tmx.nd.load(t_files[1]) if k.startswith("aux:")) \
        == sorted("aux:" + n for n in t_sym.list_auxiliary_states())
    assert sorted(dict(tblock.collect_params())) == \
        sorted(dict(tnet.collect_params()))


def test_bert_export_as_jax(tmp_path):
    jnet, tnet, _ = bert_pair(use_decoder=False)
    ids = np.random.RandomState(2).randint(0, 100, (2, 9)).astype(np.int32)
    t_files, j_files = _export_both(jnet, tnet, ids, tmp_path)
    t_sym, j_sym = tmx.sym.load(t_files[0]), jmx.sym.load(j_files[0])
    counts = _counts(t_sym)
    assert counts == _counts(j_sym)
    for op in ("FullyConnected", "_contrib_matmul_epilogue",
               "_contrib_fused_self_attention", "LayerNorm", "Dropout",
               "Embedding", "broadcast_add", "slice"):
        assert counts[op] > 0, op
    want = [w.asnumpy() for w in jnet(jmx.nd.array(ids, dtype="int32"))]
    jblock = jmx.gluon.SymbolBlock.imports(t_files[0], ["data"], t_files[1])
    for g, w in zip(jblock(jmx.nd.array(ids, dtype="int32")), want):
        _close(g.asnumpy(), w)
    tblock = tmx.gluon.SymbolBlock.imports(t_files[0], ["data"],
                                           t_files[1], ctx=CPU)
    tblock.hybridize()               # on the CPU: runs eagerly
    with torch.inference_mode():
        got = tblock(torch.from_numpy(ids))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_server_from_checkpoint_answers(tmp_path):
    from mxnet_tpu_torch.serving import Server, ServerConfig
    jnet, tnet = narrow_pair()
    x = np.random.RandomState(4).randn(4, 3, 32, 32).astype(np.float32)
    with torch.inference_mode():
        want = tnet(torch.from_numpy(x)).numpy()
    prefix = str(tmp_path / "served")
    tnet.export(prefix, 0)
    server = Server.from_checkpoint(prefix, 0, config=ServerConfig(
        max_batch=4, window_ms=20), ctx=CPU).start()
    try:
        pending = [server.submit(x[i]) for i in range(4)]
        got = np.stack([np.asarray(p.result(60)) for p in pending])
    finally:
        server.stop()
    _close(got, want)


def test_symbolblock_without_params_initializes_from_inputs():
    d = tmx.sym.var("data")
    out = tmx.sym.FullyConnected(tmx.sym.BatchNorm(d, name="bn"),
                                 num_hidden=3, name="fc")
    block = tmx.gluon.SymbolBlock(out, d)
    with pytest.raises(MXNetError, match="initialize"):
        block(torch.ones(2, 4))
    block.initialize(tmx.init.Xavier(), ctx=CPU,
                     generator=tmx.random.generator(0))
    y = block(torch.ones(2, 4))
    assert y.shape == (2, 3)
    names = dict(block.collect_params())
    assert set(names) == {"bn_gamma", "bn_beta", "bn_moving_mean",
                          "bn_moving_var", "fc_weight", "fc_bias"}
    assert not names["bn_moving_mean"].requires_grad
    np.testing.assert_array_equal(names["bn_moving_var"].numpy(), 1)


def test_export_refuses_what_it_cannot_map():
    class Odd(tmx.gluon.HybridBlock):
        def forward(self, x):
            return torch.cumsum(x, 0)

    class Fresh(tmx.gluon.HybridBlock):
        def forward(self, x):
            return tmx.ops.nn.activation(torch.ones(2, 3) * x.shape[0],
                                         act_type="relu")
    spec = [((2, 3), "float32")]
    with pytest.raises(MXNetError, match="cumsum"):
        Odd().export("unused", input_specs=spec)
    with pytest.raises(MXNetError, match="no traced operator made"):
        Fresh().export("unused", input_specs=spec)
    with pytest.raises(MXNetError, match="forward"):
        Odd().export("unused")


def test_export_torch_calls_map_to_operators(tmp_path):
    """Arithmetic, slicing, reshape, permute and sigmoid in a forward
    become MXNet operators with the same values."""
    class Mixed(tmx.gluon.HybridBlock):
        def forward(self, x):
            y = (x * 2 + 1) / 3 - x
            y = torch.sigmoid(y[:, 1:3]).reshape(2, 2, 1).permute(0, 2, 1)
            return 1 - y, y + y
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    block = Mixed()
    with torch.inference_mode():
        want = block(torch.from_numpy(x))
    files = block.export(str(tmp_path / "mixed"))
    sym = tmx.sym.load(files[0])
    assert {"_mul_scalar", "_plus_scalar", "_div_scalar", "elemwise_sub",
            "slice", "sigmoid", "reshape", "transpose", "_rminus_scalar",
            "elemwise_add"} <= set(_counts(sym))
    with CPU:
        got = sym.eval(data=x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.numpy(), rtol=1e-6)
    jgot = jmx.sym.load(files[0]).eval(data=jmx.nd.array(x))
    for g, w in zip(jgot, want):
        _close(g.asnumpy(), w.numpy())


def test_fleet_serves_an_imported_symbolblock(tmp_path):
    """A fleet tenant whose factory imports an exported pair."""
    from mxnet_tpu_torch.serving import Fleet, FleetConfig
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(4, activation="relu"), nn.Dense(2))
    net.initialize(ctx=CPU, generator=tmx.random.generator(0))
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    with torch.inference_mode():
        want = net(torch.from_numpy(x)).numpy()
    prefix = str(tmp_path / "tenant")
    sym_file, params_file = net.export(prefix)
    fleet = Fleet(FleetConfig(max_batch=2, window_ms=1.0,
                              reload_poll_s=-1.0), ctx=CPU)
    fleet.add_tenant("sym", factory=lambda: tmx.gluon.SymbolBlock.imports(
        sym_file, ["data"], params_file, ctx=CPU))
    fleet.start()
    try:
        got = np.stack([np.asarray(fleet.submit(x[i], tenant="sym")
                                   .result(60)) for i in range(3)])
    finally:
        fleet.stop()
    _close(got, want)

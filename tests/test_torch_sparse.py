"""Row-sparse gradients and lazy updates in the port against the JAX
package, on the CPU (tests/test_sparse_train.py but its kvstore test,
which waits for ROADMAP Queue 1 item 8), and the sparse storage types.

``nn.Embedding(sparse_grad=True)`` under ``autograd.record()`` gives its
weight a gradient of the batch's rows (duplicates summed); the Trainer
applies SGD, momentum SGD and Adam to those rows alone (untouched rows
keep their values and their optimizer state). The same seeded tokens and
targets go through both packages from the same weights: gradients and
weights within 1e-5 relative (1e-6 absolute), row sets exact. Also:
``RowSparseNDArray``/``CSRNDArray`` against the JAX ones, CSR @ dense,
``clip_global_norm`` over a row-sparse gradient, the fp16 master-weight
path, and a hybridized block keeping a dense gradient."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray.sparse import RowSparseNDArray as JRowSparse
from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray

CPU = tmx.cpu()
VOCAB, DIM = 50, 8
RTOL, ATOL = 1e-5, 1e-6


def _nets(sparse, jax_too=True, seed=0):
    """The port's Embedding -> Dense(4) and, with ``jax_too``, the JAX
    package's, the same seeded weights in both."""
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tmx.gluon.nn.Embedding(VOCAB, DIM, sparse_grad=sparse),
             tmx.gluon.nn.Dense(4, flatten=False, in_units=DIM))
    tnet.initialize(tmx.init.Xavier(), ctx=CPU,
                    generator=tmx.random.generator(seed))
    if not jax_too:
        return tnet, None
    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Embedding(VOCAB, DIM, sparse_grad=sparse),
             jmx.gluon.nn.Dense(4, flatten=False, in_units=DIM))
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(np.zeros((1, 2))))
    for jp, tp in zip(jnet.collect_params().values(),
                      tnet.collect_params().values()):
        jp.set_data(jmx.nd.array(tp.detach().numpy().copy()))
    return tnet, jnet


def _weights(net):
    return [(p.detach().numpy().copy() if isinstance(p, torch.Tensor)
             else p.data().asnumpy()) for p in net.collect_params().values()]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _record(mx, net, tokens, target=None):
    with mx.autograd.record():
        out = net(mx.nd.array(tokens, ctx=CPU) if mx is tmx
                  else mx.nd.array(tokens))
        if target is None:
            loss = out.sum()
        else:
            loss = mx.gluon.loss.L2Loss()(
                out, mx.nd.array(target, ctx=CPU) if mx is tmx
                else mx.nd.array(target))
    loss.backward()


def test_sparse_grad_is_row_sparse_touching_only_batch_rows():
    tokens = np.array([[3, 7, 7], [11, 3, 42]])
    tnet, jnet = _nets(True)
    _record(tmx, tnet, tokens)
    _record(jmx, jnet, tokens)
    w = tnet[0].weight
    assert w.grad.is_sparse and w.grad_stype == "row_sparse"
    g = tmx.nd.NDArray(w).grad
    jg = jnet[0].weight.grad()
    assert isinstance(g, RowSparseNDArray) and isinstance(jg, JRowSparse)
    assert g.stype == "row_sparse" and g.indices.tolist() == [3, 7, 11, 42]
    assert g.indices.tolist() == jg.indices.tolist()
    _close([g.data.numpy(), g.asnumpy()], [jg.data, jg.asnumpy()])
    dense, _ = _nets(False, jax_too=False)
    _record(tmx, dense, tokens)
    _close([g.asnumpy()], [dense[0].weight.grad.numpy()])


@pytest.mark.parametrize("optname,kw,steps", [
    ("sgd", {"learning_rate": 0.1}, 3),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 3),
    ("adam", {"learning_rate": 0.01}, 3),
    ("sgd", {"learning_rate": 0.5, "wd": 0.1}, 2),
])
def test_lazy_training_matches_jax(optname, kw, steps):
    """Sparse training in both packages from the same weights: every
    weight after each step within 1e-5; rows no batch touched keep their
    initial values exactly (the lazy update decays nothing else)."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, VOCAB, (steps, 4, 3))
    targets = rng.randn(steps, 4, 3, 4).astype(np.float32)
    tnet, jnet = _nets(True)
    w0 = _weights(tnet)[0].copy()
    ttr = tmx.gluon.Trainer(tnet.collect_params(), optname, dict(kw))
    jtr = jmx.gluon.Trainer(jnet.collect_params(), optname, dict(kw),
                            kvstore=None)
    for i in range(steps):
        _record(tmx, tnet, tokens[i], targets[i])
        _record(jmx, jnet, tokens[i], targets[i])
        ttr.step(4)
        jtr.step(4)
        _close(_weights(tnet), _weights(jnet))
    untouched = sorted(set(range(VOCAB)) - set(tokens.ravel().tolist()))
    np.testing.assert_array_equal(_weights(tnet)[0][untouched],
                                  w0[untouched])
    if kw.get("momentum"):
        mom = ttr._updater.states[0].numpy()
        rows = set(np.nonzero(np.any(mom != 0, axis=1))[0].tolist())
        assert rows <= set(tokens.ravel().tolist())


def test_sgd_sparse_training_matches_dense():
    """Plain SGD without wd: the lazy update is the dense one."""
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, VOCAB, (4, 4, 3))
    targets = rng.randn(4, 4, 3, 4).astype(np.float32)
    runs = []
    for sparse in (True, False):
        net, _ = _nets(sparse, jax_too=False)
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        for i in range(4):
            _record(tmx, net, tokens[i], targets[i])
            tr.step(4)
        runs.append(_weights(net))
    _close(*runs)


def test_stale_sparse_grad_applies_nothing():
    net, _ = _nets(True, jax_too=False)
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5, "momentum": 0.9})
    _record(tmx, net, np.array([[1, 2]]))
    tr.step(1)
    before = _weights(net)[0].copy()
    tr.step(1)                      # no new backward: the rows are spent
    np.testing.assert_array_equal(_weights(net)[0], before)


def test_hybridized_block_keeps_a_dense_gradient():
    net, _ = _nets(True, jax_too=False)
    net.hybridize()
    _record(tmx, net, np.array([[3, 7]]))
    g = net[0].weight.grad
    assert not g.is_sparse
    rows = set(np.nonzero(np.any(g.numpy() != 0, axis=1))[0].tolist())
    assert rows <= {3, 7}


def test_multi_precision_updates_touched_rows_only():
    """fp16 weights with fp32 masters: the touched rows move, by the
    master's update cast to fp16; the others keep their bits."""
    net, _ = _nets(True, jax_too=False)
    net.cast("float16")
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5, "multi_precision": True})
    w0 = net[0].weight.detach().clone()
    with tmx.autograd.record():
        loss = net(torch.tensor([[4, 9]])).float().sum()
    tmx.autograd.backward(loss)
    tr.step(1)
    w1 = net[0].weight.detach()
    master = tr._updater.states[0][1]
    assert torch.equal(w1[[4, 9]], master[[4, 9]].half())
    keep = [i for i in range(VOCAB) if i not in (4, 9)]
    assert torch.equal(w1[keep], w0[keep])
    assert not torch.equal(w1[[4, 9]], w0[[4, 9]])


def test_clip_global_norm_row_sparse_as_jax():
    data = np.random.RandomState(2).randn(3, 4).astype(np.float32) * 3
    t = RowSparseNDArray(torch.from_numpy(data.copy()), [1, 5, 7], (9, 4))
    j = JRowSparse(data.copy(), [1, 5, 7], (9, 4))
    dense = np.ones((2, 2), np.float32)
    tn = tmx.gluon.utils.clip_global_norm(
        [t, tmx.nd.array(dense, ctx=CPU)], 1.0)
    jd = jmx.nd.array(dense)
    jn = jmx.gluon.utils.clip_global_norm([j, jd], 1.0)
    np.testing.assert_allclose(tn, float(jn), rtol=1e-6)
    np.testing.assert_allclose(t.data.numpy(), j.data, rtol=1e-6)


def test_storage_types_as_jax():
    rng = np.random.RandomState(3)
    dense = rng.randn(4, 5).astype(np.float32)
    dense[dense < 0.3] = 0
    dense[2] = 0
    t_rs = tmx.nd.array(dense, ctx=CPU).tostype("row_sparse")
    j_rs = jmx.nd.array(dense).tostype("row_sparse")
    assert t_rs.indices.tolist() == j_rs.indices.tolist()
    np.testing.assert_array_equal(t_rs.asnumpy(), j_rs.asnumpy())
    kept = t_rs.retain([1, 3, 4])
    assert kept.indices.tolist() == j_rs.retain([1, 3, 4]).indices.tolist()
    np.testing.assert_array_equal(kept.asnumpy(),
                                  j_rs.retain([1, 3, 4]).asnumpy())
    t_csr = tmx.nd.array(dense, ctx=CPU).tostype("csr")
    j_csr = jmx.nd.array(dense).tostype("csr")
    assert t_csr.stype == "csr" and t_csr.shape == j_csr.shape
    np.testing.assert_array_equal(t_csr.indptr.numpy(), j_csr.indptr)
    np.testing.assert_array_equal(t_csr.indices.numpy(), j_csr.indices)
    np.testing.assert_array_equal(t_csr.data.numpy(), j_csr.data)
    rhs = rng.randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(t_csr.dot(tmx.nd.array(rhs, ctx=CPU))
                               .asnumpy(),
                               j_csr.dot(jmx.nd.array(rhs)).asnumpy(),
                               rtol=1e-5, atol=1e-6)
    built = tmx.nd.sparse.csr_matrix(
        (j_csr.data, j_csr.indices, j_csr.indptr), shape=(4, 5), ctx=CPU)
    np.testing.assert_array_equal(built.tostype("default").asnumpy(), dense)
    rs = tmx.nd.sparse.row_sparse_array((dense[[0, 3]], [0, 3]),
                                        shape=(4, 5), ctx=CPU)
    assert rs.dtype == np.float32 and rs.shape == (4, 5)
    with pytest.raises(tmx.MXNetError):
        rs.tostype("csr")

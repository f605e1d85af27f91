"""``mx.mod`` and ``mx.model`` in the port against the JAX package, on
the CPU: ``Module.fit`` of an MLP with BatchNorm and of the MNIST
example's ``lenet_symbol`` (the JAX side imported from
examples/train_mnist.py) from the same ``arg_params`` — every batch's
outputs and the final parameters and moving statistics —, ``score`` and
``predict``, epoch checkpoints with ``keep_last`` and ``fit(resume=
True)`` past a truncated newest file (the ``ckpt_fallback`` and
``resume`` journal records), ``Module.save_checkpoint`` / ``load`` with
optimizer states, ``BucketingModule`` (shared parameters across
buckets) and ``SequentialModule``. Values within 1e-5 relative (1e-6
absolute); a resume restores the parameters bit for bit."""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.diagnostics import journal as jjournal
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.diagnostics import journal as tjournal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import train_mnist  # noqa: E402  (the JAX package's example)

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def mlp(mx):
    d = mx.sym.var("data")
    h = mx.sym.FullyConnected(d, num_hidden=8, name="fc1")
    h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def lenet_port():
    """examples/train_mnist.py's lenet_symbol, written with the port."""
    sym = tmx.sym
    data = sym.var("data")
    c1 = sym.Activation(sym.Convolution(data, kernel=(5, 5), num_filter=20),
                        act_type="tanh")
    p1 = sym.Pooling(c1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    c2 = sym.Activation(sym.Convolution(p1, kernel=(5, 5), num_filter=50),
                        act_type="tanh")
    p2 = sym.Pooling(c2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f = sym.Flatten(p2)
    fc1 = sym.Activation(sym.FullyConnected(f, num_hidden=500),
                         act_type="tanh")
    fc2 = sym.FullyConnected(fc1, num_hidden=10)
    return sym.SoftmaxOutput(fc2, name="softmax")


def _data(n, shape, classes, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *shape).astype(np.float32),
            rng.randint(0, classes, n).astype(np.float32))


def _params(sym, data_shape, seed=1, scale=0.3):
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    rng = np.random.RandomState(seed)
    args = {n: (rng.randn(*s) * scale).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s, np.float32) if n.endswith("var")
               else np.zeros(s, np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _fit(mx, sym, x, y, args, aux, batch, epochs=1, **fit_kw):
    kw = {"ctx": CPU} if mx is tmx else {}
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod = mx.mod.Module(sym, context=mx.cpu())
    outs = []
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: mx.nd.array(v, **kw) for k, v in args.items()},
            aux_params={k: mx.nd.array(v, **kw) for k, v in aux.items()},
            batch_end_callback=lambda p: outs.append(
                mod.get_outputs()[0].asnumpy()), **fit_kw)
    a, x_ = mod.get_params()
    return mod, outs, {k: v.asnumpy() for k, v in {**a, **x_}.items()}


def _fit_both(t_sym, j_sym, x, y, batch, epochs=1, scale=0.3):
    args, aux = _params(t_sym, (batch,) + x.shape[1:], scale=scale)
    with CPU:
        tmod, t_outs, t_par = _fit(tmx, t_sym, x, y, args, aux, batch,
                                   epochs)
    jmod, j_outs, j_par = _fit(jmx, j_sym, x, y, args, aux, batch, epochs)
    assert len(t_outs) == len(j_outs) > 0
    for a, b in zip(t_outs, j_outs):
        _close(a, b)
    assert sorted(t_par) == sorted(j_par)
    for k in t_par:
        _close(t_par[k], j_par[k])
    return tmod, jmod


def test_fit_mlp_batchnorm_as_jax():
    x, y = _data(40, (6,), 3)
    tmod, jmod = _fit_both(mlp(tmx), mlp(jmx), x, y, batch=8, epochs=2)
    with CPU:
        t_score = tmod.score(tmx.io.NDArrayIter(x, y, batch_size=8), "acc")
        t_pred = tmod.predict(tmx.io.NDArrayIter(x[:20], y[:20],
                                                 batch_size=8))
    j_score = jmod.score(jmx.io.NDArrayIter(x, y, batch_size=8), "acc")
    j_pred = jmod.predict(jmx.io.NDArrayIter(x[:20], y[:20], batch_size=8))
    assert t_score == j_score
    assert t_pred.shape == (20, 3)
    _close(t_pred.asnumpy(), j_pred.asnumpy())


def test_fit_lenet_as_jax():
    x, y = _data(16, (1, 28, 28), 10)
    # Xavier-sized weights: logits of a few units, not saturated tanh
    # chains whose float32 accumulation orders drift apart
    _fit_both(lenet_port(), train_mnist.lenet_symbol(), x, y, batch=8,
              scale=0.05)


def _records(journal, kinds):
    return [r for r in journal.recent() if r["kind"] in kinds]


def _resume_run(mx, journal_mod, prefix, x, y, args, aux):
    _fit(mx, mlp(mx), x, y, args, aux, 8, epochs=3,
         checkpoint_prefix=prefix, keep_last=2)
    assert mx.model.list_checkpoint_epochs(prefix) == [2, 3]
    with open(f"{prefix}-0003.params", "r+b") as f:    # torn newest file
        f.truncate(os.path.getsize(f"{prefix}-0003.params") // 2)
    journal = journal_mod.reset_journal("off")
    try:
        fresh = mx.mod.Module(mlp(mx), context=mx.cpu())
        fresh.fit(mx.io.NDArrayIter(x, y, batch_size=8), num_epoch=4,
                  optimizer="sgd",
                  optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                  checkpoint_prefix=prefix, keep_last=2, resume=True,
                  initializer=mx.init.Uniform(0.5))
        recs = _records(journal, ("ckpt_fallback", "resume"))
    finally:
        journal_mod.reset_journal()
    a, x_ = fresh.get_params()
    assert mx.model.list_checkpoint_epochs(prefix) == [3, 4]
    return recs, {k: v.asnumpy() for k, v in {**a, **x_}.items()}


def test_checkpoint_resume_past_a_torn_file_as_jax(tmp_path):
    x, y = _data(24, (6,), 3)
    args, aux = _params(mlp(tmx), (8, 6))
    with CPU:
        t_recs, t_par = _resume_run(tmx, tjournal, str(tmp_path / "t"),
                                    x, y, args, aux)
    j_recs, j_par = _resume_run(jmx, jjournal, str(tmp_path / "j"),
                                x, y, args, aux)
    assert [r["kind"] for r in t_recs] == [r["kind"] for r in j_recs] == \
        ["ckpt_fallback", "resume"]
    assert t_recs[0]["epoch"] == 3 and t_recs[1]["epoch"] == 2
    for k in t_par:
        _close(t_par[k], j_par[k])


def test_resume_restores_parameters_bit_for_bit(tmp_path):
    x, y = _data(16, (6,), 3)
    args, aux = _params(mlp(tmx), (8, 6))
    prefix = str(tmp_path / "run")
    with CPU:
        mod, _, params = _fit(tmx, mlp(tmx), x, y, args, aux, 8, epochs=1,
                              checkpoint_prefix=prefix)
        fresh = tmx.mod.Module(mlp(tmx), context=CPU)
        # num_epoch == the saved epoch: resume restores and trains nothing
        fresh.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                  checkpoint_prefix=prefix, resume=True)
        a, x_ = fresh.get_params()
        for k, v in {**a, **x_}.items():
            np.testing.assert_array_equal(v.asnumpy(), params[k])
        with pytest.raises(MXNetError, match="checkpoint_prefix"):
            fresh.fit(tmx.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                      resume=True)


def test_save_load_checkpoint_with_optimizer_states(tmp_path):
    x, y = _data(16, (6,), 3)
    args, aux = _params(mlp(tmx), (8, 6))
    prefix = str(tmp_path / "m")
    with CPU:
        mod, _, params = _fit(tmx, mlp(tmx), x, y, args, aux, 8)
        mod.save_checkpoint(prefix, 7, save_optimizer_states=True)
        sym, arg_p, aux_p = tmx.model.load_checkpoint(prefix, 7)
        assert sym.list_arguments() == mlp(tmx).list_arguments()
        loaded = tmx.mod.Module.load(prefix, 7, load_optimizer_states=True,
                                     context=CPU)
        loaded.bind(tmx.io.NDArrayIter(x, y, 8).provide_data,
                    tmx.io.NDArrayIter(x, y, 8).provide_label)
        loaded.init_params()
        loaded.init_optimizer(optimizer="sgd",
                              optimizer_params={"momentum": 0.9})
        a, x_ = loaded.get_params()
        for k, v in {**a, **x_}.items():
            np.testing.assert_array_equal(v.asnumpy(), params[k])
        assert sorted(loaded._updater.states) == \
            sorted(mod._updater.states)
    # the JAX package reads the port's pair
    jsym, jarg, jaux = jmx.model.load_checkpoint(prefix, 7)
    assert jsym.list_arguments() == sym.list_arguments()
    for k in jarg:
        np.testing.assert_array_equal(jarg[k].asnumpy(), arg_p[k].asnumpy())


def _bucket_run(mx):
    kw = {"ctx": CPU} if mx is tmx else {}

    def sym_gen(key):
        data = mx.sym.var("data")
        h = mx.sym.FullyConnected(data, num_hidden=6, name="shared")
        h = mx.sym.Activation(h, act_type="tanh")
        out = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            h, num_hidden=3, name="head"), name="softmax")
        return out, ("data",), ("softmax_label",)
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=4,
                                 context=mx.cpu())
    batches = []
    for i, rows in enumerate((4, 2, 4, 2)):
        x, y = _data(rows, (5,), 3, seed=i)
        batches.append(mx.io.DataBatch(
            data=[mx.nd.array(x, **kw)], label=[mx.nd.array(y, **kw)],
            bucket_key=rows,
            provide_data=[mx.io.DataDesc("data", (rows, 5))],
            provide_label=[mx.io.DataDesc("softmax_label", (rows,))]))
    mod.bind(batches[0].provide_data, batches[0].provide_label)
    args, _ = _params(sym_gen(4)[0], (4, 5))
    mod.init_params(arg_params={k: mx.nd.array(v, **kw)
                                for k, v in args.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.2})
    outs = []
    for b in batches:
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    a, _ = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in a.items()}, mod


def test_bucketing_module_as_jax():
    with CPU:
        t_outs, t_par, tmod = _bucket_run(tmx)
    j_outs, j_par, _ = _bucket_run(jmx)
    for a, b in zip(t_outs, j_outs):
        _close(a, b)
    for k in t_par:
        _close(t_par[k], j_par[k])
    assert sorted(tmod._buckets) == [2, 4]
    w2 = tmod._buckets[2]._exec.arg_dict["shared_weight"]
    assert w2 is tmod._buckets[4]._exec.arg_dict["shared_weight"]


def _sequential_run(mx):
    kw = {"ctx": CPU} if mx is tmx else {}
    x, y = _data(24, (5,), 3, seed=4)
    net1 = mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.var("data"), num_hidden=7, name="sfc1"), act_type="relu")
    net2 = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.var("data"), num_hidden=3, name="sfc2"), name="softmax")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(net1, label_names=[], context=mx.cpu())) \
       .add(mx.mod.Module(net2, context=mx.cpu()), take_labels=True,
            auto_wiring=True)
    it = mx.io.NDArrayIter(x, y, batch_size=8)
    seq.bind(it.provide_data, it.provide_label)
    rng = np.random.RandomState(9)
    args = {"sfc1_weight": rng.randn(7, 5), "sfc1_bias": rng.randn(7),
            "sfc2_weight": rng.randn(3, 7), "sfc2_bias": rng.randn(3)}
    seq.init_params(arg_params={k: mx.nd.array(v.astype(np.float32), **kw)
                                for k, v in args.items()})
    seq.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    metric = mx.metric.create("acc")
    outs = []
    for batch in it:
        seq.forward(batch, is_train=True)
        seq.backward()
        seq.update()
        seq.update_metric(metric, batch.label)
        outs.append(seq.get_outputs()[0].asnumpy())
    a, _ = seq.get_params()
    return outs, {k: v.asnumpy() for k, v in a.items()}, metric.get()


def test_sequential_module_as_jax():
    with CPU:
        t_outs, t_par, t_metric = _sequential_run(tmx)
    j_outs, j_par, j_metric = _sequential_run(jmx)
    assert t_metric == j_metric
    for a, b in zip(t_outs, j_outs):
        _close(a, b)
    for k in t_par:
        _close(t_par[k], j_par[k])


def test_module_errors():
    mod = tmx.mod.Module(mlp(tmx), context=CPU)
    with pytest.raises(MXNetError, match="bind"):
        mod.init_params()
    with pytest.raises(MXNetError, match="num_epoch"):
        mod.fit(None)
    with pytest.raises(MXNetError, match="bind"):
        mod.forward(None)


def test_initializer_fills_moving_statistics_as_jax():
    """A symbol's BatchNorm statistics are ``*_moving_mean`` / ``*_moving_
    var``: zeros and ones, as the JAX initializer fills them (the port's
    initializer knew only Gluon's ``running_*`` names)."""
    import torch
    for name in ("bn1_moving_mean", "bn1_moving_var", "bn1_gamma",
                 "bn1_beta", "x_running_var"):
        t = torch.full((4,), 7.0)
        tmx.init.Uniform(0.5)(name, t)
        j = jmx.nd.full((4,), 7.0)
        jmx.init.Uniform(0.5)(name, j)
        np.testing.assert_array_equal(t.numpy(), j.asnumpy())

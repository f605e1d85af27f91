"""``mx.sym`` in the port against the JAX package, on the CPU: graph
composition and naming (with ``mx.name`` and ``mx.AttrScope``),
``infer_shape`` / ``infer_type`` (exact), JSON read by each package from
the other with equal outputs, ``simple_bind`` forward and backward for
``grad_req`` "write" and "add", BatchNorm's moving statistics in
training, the ``CSE`` and ``FuseAttention`` passes (both patterns) and
the ``MXNET_SUBGRAPH_BACKEND`` hook, symbolic ``foreach`` /
``while_loop`` / ``cond``, ``mx.viz`` text, and shape inference through
the nodes of the hand-written kernels without a card (meta tensors).

The same seeded numpy inputs go through both packages; float32 values
within 1e-5 relative (1e-6 absolute)."""
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def mlp(mx, fix_gamma=False):
    d = mx.sym.var("data")
    h = mx.sym.FullyConnected(d, num_hidden=8, name="fc1")
    h = mx.sym.BatchNorm(h, fix_gamma=fix_gamma, name="bn1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _values(sym, shapes, seed=0):
    """Seeded numpy values of every argument and aux state of ``sym``."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    vals = {}
    for i, (n, s) in enumerate(zip(sym.list_arguments(), arg_shapes)):
        vals[n] = _rand(*s, seed=seed + i, scale=0.5)
    if "softmax_label" in vals:
        vals["softmax_label"] = np.random.RandomState(seed).randint(
            0, 3, vals["softmax_label"].shape).astype(np.float32)
    aux = {n: (np.abs(_rand(*s, seed=seed + 50 + i)) + 0.5
               if n.endswith("var") else _rand(*s, seed=seed + 50 + i))
           for i, (n, s) in enumerate(zip(sym.list_auxiliary_states(),
                                          aux_shapes))}
    return vals, aux


def test_compose_lists_and_names_as_jax():
    t, j = mlp(tmx), mlp(jmx)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    ti, ji = t.get_internals(), j.get_internals()
    assert ti.list_outputs() == ji.list_outputs()
    assert t.get_internals()["fc1_output"].name == "fc1"
    for mx in (tmx, jmx):
        a = mx.sym.var("a")
        g = mx.sym.Group([a * 2, 1 - a, a / 4, 3 / a, a ** 2, -a])
        assert len(g) == 6
    assert [s._node.op for s in (tmx.sym.var("a") > 1, tmx.sym.var("a") ==
                                 tmx.sym.var("b"))] == \
        [s._node.op for s in (jmx.sym.var("a") > 1, jmx.sym.var("a") ==
                              jmx.sym.var("b"))]


def test_name_and_attr_scopes_reach_symbols_as_jax():
    def build(mx):
        with mx.name.Prefix("net_"):
            with mx.AttrScope(ctx_group="dev1"):
                fc = mx.sym.FullyConnected(mx.sym.var("x"), num_hidden=2)
            act = mx.sym.Activation(fc, act_type="relu")
        return fc, act
    (tf, ta), (jf, ja) = build(tmx), build(jmx)
    assert tf.name == jf.name == "net_fullyconnected0"
    assert ta.name == ja.name and ta.list_arguments() == ja.list_arguments()
    assert tf.attr("__ctx_group__") == jf.attr("__ctx_group__") == "dev1"
    assert ta.attr("__ctx_group__") is None


@pytest.mark.parametrize("shapes", [{"data": (4, 5)}, {"data": (2, 7)},
                                    {"fc1_weight": (8, 5)}])
def test_infer_shape_and_type_exact(shapes):
    t, j = mlp(tmx), mlp(jmx)
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    assert t.infer_type() == j.infer_type()


def test_infer_shape_conv_pool_concat_as_jax():
    def net(mx):
        d = mx.sym.var("data")
        c = mx.sym.Convolution(d, kernel=(3, 3), num_filter=4, pad=(1, 1),
                               name="c1")
        p = mx.sym.Pooling(c, kernel=(2, 2), stride=(2, 2), pool_type="max")
        q = mx.sym.Pooling(c, kernel=(2, 2), stride=(2, 2), pool_type="avg")
        cat = mx.sym.concat(p, q, dim=1)
        return mx.sym.FullyConnected(mx.sym.Flatten(cat), num_hidden=5)
    shapes = {"data": (2, 3, 8, 8)}
    assert net(tmx).infer_shape(**shapes) == net(jmx).infer_shape(**shapes)


def test_kernel_nodes_infer_shapes_without_a_card():
    """BatchNorm(act_type="relu") and _contrib_conv_epilogue (K1),
    _contrib_matmul_epilogue (K2), _contrib_flash_attention above 1024
    keys (K3): shapes come from meta tensors, with no CUDA."""
    S = tmx.sym
    x = S.var("x")
    bn = S.BatchNorm(x, act_type="relu", name="bn")
    k1 = S.contrib.conv_epilogue(bn, x, act_type="relu")
    assert k1.infer_shape(x=(2, 4, 5, 5))[1] == [(2, 4, 5, 5)]
    k2 = S.contrib.matmul_epilogue(S.var("y"), S.var("b"), act_type="gelu")
    assert k2.infer_shape(y=(6, 32), b=(32,))[1] == [(6, 32)]
    q, k, v = S.var("q"), S.var("k"), S.var("v")
    k3 = S.contrib.flash_attention(q, k, v)
    assert k3.infer_shape(q=(1, 2, 1100, 16), k=(1, 2, 1100, 16),
                          v=(1, 2, 1100, 16))[1] == [(1, 2, 1100, 16)]
    qkv = S.contrib.fused_self_attention(S.var("qkv"), heads=2)
    assert qkv.infer_shape(qkv=(1, 1100, 48))[1] == [(1, 1100, 16)]


def _bind_pair(grad_req, seed=0):
    shapes = {"data": (4, 5), "softmax_label": (4,)}
    vals, aux = _values(mlp(tmx), shapes, seed)
    t_ex = mlp(tmx).simple_bind(ctx=CPU, grad_req=grad_req, **shapes)
    j_ex = mlp(jmx).simple_bind(grad_req=grad_req, **shapes)
    for ex, nd, kw in ((t_ex, tmx.nd, {"ctx": CPU}), (j_ex, jmx.nd, {})):
        ex.copy_params_from({k: nd.array(v, **kw) for k, v in vals.items()},
                            {k: nd.array(v, **kw) for k, v in aux.items()})
    return t_ex, j_ex


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_simple_bind_forward_backward_as_jax(grad_req):
    t_ex, j_ex = _bind_pair(grad_req)
    for step in range(2):
        x = _rand(4, 5, seed=10 + step)
        t_out = t_ex.forward(is_train=True, data=tmx.nd.array(x, ctx=CPU))
        j_out = j_ex.forward(is_train=True, data=jmx.nd.array(x))
        _close(t_out[0], j_out[0])
        t_ex.backward()
        j_ex.backward()
        for name in j_ex.grad_dict:
            _close(t_ex.grad_dict[name], j_ex.grad_dict[name])
    for name in j_ex.aux_dict:
        _close(t_ex.aux_dict[name], j_ex.aux_dict[name])
    assert [a.shape for a in t_ex.arg_arrays] == \
        [a.shape for a in j_ex.arg_arrays]
    _close(t_ex.forward(is_train=False)[0], j_ex.forward(is_train=False)[0])


def test_batchnorm_aux_update_and_predict_as_jax():
    """Training forwards move the moving statistics (momentum 0.9) as
    the JAX DAG does; predict forwards leave them."""
    t_ex, j_ex = _bind_pair("write", seed=3)
    before = t_ex.aux_dict["bn1_moving_mean"].asnumpy().copy()
    t_ex.forward(is_train=False)
    j_ex.forward(is_train=False)
    np.testing.assert_array_equal(t_ex.aux_dict["bn1_moving_mean"]
                                  .asnumpy(), before)
    for _ in range(3):
        t_ex.forward(is_train=True)
        j_ex.forward(is_train=True)
    assert not np.allclose(t_ex.aux_dict["bn1_moving_mean"].asnumpy(),
                           before)
    for name in ("bn1_moving_mean", "bn1_moving_var"):
        _close(t_ex.aux_dict[name], j_ex.aux_dict[name])


def test_backward_needs_a_training_forward_and_out_grads():
    t_ex, j_ex = _bind_pair("write")
    t_ex.forward(is_train=False)
    with pytest.raises(MXNetError, match="forward\\(is_train=True\\)"):
        t_ex.backward()
    # a head gradient through a non-loss head
    grads = {}
    for mx, kw in ((tmx, {"ctx": CPU}), (jmx, {})):
        d = mx.sym.var("d")
        w = mx.sym.var("w")
        y = mx.sym.FullyConnected(d, w, num_hidden=3, no_bias=True)
        ex = y.bind(mx.cpu(), {"d": mx.nd.array(_rand(2, 4), **kw),
                               "w": mx.nd.array(_rand(3, 4, seed=1), **kw)},
                    grad_req={"d": "null", "w": "write"})
        ex.forward(is_train=True)
        ex.backward(mx.nd.array(_rand(2, 3, seed=2), **kw))
        grads[mx] = ex.grad_dict["w"]
    _close(grads[tmx], grads[jmx])


def test_eval_and_json_both_ways():
    shapes = {"data": (4, 5), "softmax_label": (4,)}
    vals, aux = _values(mlp(tmx), shapes, seed=5)
    feed = {**vals, **aux}
    t_sym, j_sym = mlp(tmx), mlp(jmx)
    want = j_sym.eval(**{k: jmx.nd.array(v) for k, v in feed.items()})[0]
    # the JAX package reads the port's JSON, the port the JAX package's
    j_from_t = jmx.sym.load_json(t_sym.tojson())
    t_from_j = tmx.sym.load_json(j_sym.tojson())
    assert t_from_j.list_arguments() == j_sym.list_arguments()
    assert j_from_t.list_auxiliary_states() == \
        t_sym.list_auxiliary_states()
    _close(j_from_t.eval(**{k: jmx.nd.array(v)
                            for k, v in feed.items()})[0], want)
    with CPU:
        _close(t_from_j.eval(**{k: tmx.nd.array(v)
                                for k, v in feed.items()})[0], want)
        _close(t_sym.eval(**feed)[0], want)
    graph = __import__("json").loads(t_sym.tojson())
    assert graph["attrs"]["mxnet_version"] == ["int", 10700]
    assert graph["heads"] == [[len(graph["nodes"]) - 1, 0, 0]]
    v = tmx.sym.var("x", shape=(2, 3), lr_mult=2.0)
    back = tmx.sym.load_json(v.tojson())
    assert back.attr("__shape__") == (2, 3)
    assert back.attr("__lr_mult__") == "2.0"


def test_save_load_file(tmp_path):
    path = str(tmp_path / "net-symbol.json")
    mlp(tmx).save(path)
    j = jmx.sym.load(path)
    assert j.list_arguments() == mlp(jmx).list_arguments()
    assert tmx.sym.load(path).tojson() == tmx.sym.load_json(
        mlp(tmx).tojson()).tojson()


def _attention(mx, scale=0.125, div=False):
    q, k, v = mx.sym.var("q"), mx.sym.var("k"), mx.sym.var("v")
    s = mx.sym.batch_dot(q, k, transpose_b=True)
    s = s / (1 / scale) if div else s * scale
    return mx.sym.batch_dot(mx.sym.softmax(s, axis=-1), v)


def _interleaved(mx, heads=2):
    qkv = mx.sym.var("qkv")
    att = mx.sym.contrib.interleaved_matmul_selfatt_qk(qkv, heads=heads)
    return mx.sym.contrib.interleaved_matmul_selfatt_valatt(
        qkv, mx.sym.softmax(att, axis=-1), heads=heads)


def _ops(sym):
    return sorted(n.op for n in sym._topo() if n.op is not None)


@pytest.mark.parametrize("div", [False, True])
def test_fuse_attention_pattern1_as_jax(div):
    feed = {n: _rand(3, 9, 4, seed=i) for i, n in enumerate("qkv")}
    t = tmx.sym.apply_pass(_attention(tmx, div=div), "FuseAttention")
    j = jmx.sym.apply_pass(_attention(jmx, div=div), "FuseAttention")
    assert _ops(t) == _ops(j) == ["_contrib_flash_attention"]
    want = _attention(jmx, div=div).eval(
        **{k: jmx.nd.array(v) for k, v in feed.items()})[0]
    with CPU:
        _close(t.eval(**feed)[0], want)
    _close(j.eval(**{k: jmx.nd.array(v) for k, v in feed.items()})[0], want)


def test_fuse_attention_pattern2_as_jax():
    feed = {"qkv": _rand(5, 2, 3 * 8, seed=4)}
    t = tmx.sym.apply_pass(_interleaved(tmx), "FuseAttention")
    j = jmx.sym.apply_pass(_interleaved(jmx), "FuseAttention")
    assert _ops(t) == _ops(j)
    assert "_contrib_flash_attention" in _ops(t)
    want = _interleaved(jmx).eval(qkv=jmx.nd.array(feed["qkv"]))[0]
    with CPU:
        _close(t.eval(**feed)[0], want)


def test_cse_pass_as_jax():
    def build(mx):
        x = mx.sym.var("x")
        a = mx.sym.FullyConnected(x, num_hidden=4, name="fc")
        b = mx.sym.FullyConnected(x, num_hidden=4, name="fc")
        return mx.sym.relu(a) + mx.sym.relu(b) + mx.sym.Dropout(x, p=0.5) \
            * 0
    t = tmx.sym.apply_pass(build(tmx), "CSE")
    j = jmx.sym.apply_pass(build(jmx), "CSE")
    assert _ops(t) == _ops(j)
    assert _ops(t).count("FullyConnected") == 1
    assert t.list_arguments() == j.list_arguments()
    assert tmx.sym.list_passes() == jmx.sym.list_passes()
    with pytest.raises(MXNetError, match="unknown graph pass"):
        tmx.sym.apply_pass(t, "nope")


def test_env_subgraph_backend_hook(monkeypatch):
    feed = {n: _rand(2, 6, 4, seed=i) for i, n in enumerate("qkv")}
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "FuseAttention,nope")
    with pytest.warns(UserWarning, match="nope"):
        ex = _attention(tmx).bind(CPU, {k: tmx.nd.array(v, ctx=CPU)
                                        for k, v in feed.items()},
                                  grad_req="null")
    assert _ops(ex._symbol) == ["_contrib_flash_attention"]
    monkeypatch.delenv("MXNET_SUBGRAPH_BACKEND")
    want = _attention(jmx).eval(**{k: jmx.nd.array(v)
                                   for k, v in feed.items()})[0]
    _close(ex.forward()[0], want)


def _loop_inputs():
    return {"x": _rand(4, 2, 3, seed=1, scale=0.5),
            "w": _rand(3, 3, seed=2, scale=0.5),
            "h0": np.zeros((2, 3), np.float32)}


def _foreach(mx):
    x, w, h0 = mx.sym.var("x"), mx.sym.var("w"), mx.sym.var("h0")

    def body(xt, h):
        h2 = mx.sym.tanh(mx.sym.dot(xt, w) + h)
        return h2 * 2, h2
    outs, last = mx.sym.contrib.foreach(body, x, h0, name="scan")
    return mx.sym.Group([outs, last])


def _while(mx):
    i, s = mx.sym.var("i"), mx.sym.var("s")
    outs, (i2, s2) = mx.sym.contrib.while_loop(
        lambda i, s: i < 3, lambda i, s: (s * 1, [i + 1, s * 2]), [i, s],
        max_iterations=5, name="loop")
    return mx.sym.Group([outs, i2, s2])


def _cond(mx):
    p, a, b = mx.sym.var("p"), mx.sym.var("a"), mx.sym.var("b")
    return mx.sym.contrib.cond(p, lambda: a + b, lambda: a - b, name="br")


@pytest.mark.parametrize("build,feed", [
    (_foreach, _loop_inputs()),
    (_while, {"i": np.zeros(1, np.float32), "s": np.ones((2,), np.float32)}),
    (_cond, {"p": np.ones(1, np.float32), "a": _rand(2, 2),
             "b": _rand(2, 2, seed=1)}),
    (_cond, {"p": np.zeros(1, np.float32), "a": _rand(2, 2),
             "b": _rand(2, 2, seed=1)})])
def test_symbolic_control_flow_as_jax(build, feed):
    t, j = build(tmx), build(jmx)
    assert t.list_arguments() == j.list_arguments()
    want = j.eval(**{k: jmx.nd.array(v) for k, v in feed.items()})
    with CPU:
        got = t.eval(**feed)
        via_json = tmx.sym.load_json(j.tojson()).eval(**feed)
    assert len(got) == len(want)
    for g, v, w in zip(got, via_json, want):
        _close(g, w)
        _close(v, w)
    shapes = {k: v.shape for k, v in feed.items()}
    assert t.infer_shape(**shapes)[1] == j.infer_shape(**shapes)[1]


def test_foreach_gradient_as_jax():
    feed = _loop_inputs()
    grads = {}
    for mx, kw in ((tmx, {"ctx": CPU}), (jmx, {})):
        sym = _foreach(mx)[0]
        ex = sym.bind(mx.cpu(), {k: mx.nd.array(v, **kw)
                                 for k, v in feed.items()},
                      grad_req={"x": "null", "w": "write", "h0": "null"})
        ex.forward(is_train=True)
        ex.backward(mx.nd.array(np.ones((4, 2, 3), np.float32), **kw))
        grads[mx] = ex.grad_dict["w"]
    _close(grads[tmx], grads[jmx])


def test_monitor_hook_collects_matching_outputs():
    class Mon:
        activated = True
        _pattern_re = re.compile(".*relu.*")

        def __init__(self):
            self.seen = {}

        def _collect(self, name, val):
            self.seen[name] = val
    got = {}
    for mx, kw in ((tmx, {"ctx": CPU}), (jmx, {})):
        t_ex = mlp(mx).simple_bind(grad_req="null", data=(2, 5),
                                   **({"ctx": CPU} if mx is tmx else {}))
        mon = Mon()
        t_ex.install_monitor(mon)
        t_ex.forward(is_train=False, data=mx.nd.array(_rand(2, 5), **kw))
        got[mx] = mon.seen
    assert sorted(got[tmx]) == sorted(got[jmx]) == ["relu1_output"]


def test_viz_text_as_jax(capsys):
    shape = {"data": (2, 5)}
    tmx.viz.print_summary(mlp(tmx), shape=shape)
    t_text = capsys.readouterr().out
    jmx.viz.print_summary(mlp(jmx), shape=shape)
    j_text = capsys.readouterr().out
    assert t_text == j_text and "Total params" in t_text
    for hide in (True, False):
        assert tmx.viz.plot_network(mlp(tmx), hide_weights=hide).source == \
            jmx.viz.plot_network(mlp(jmx), hide_weights=hide).source
    with pytest.raises(MXNetError, match="graphviz"):
        tmx.viz.plot_network(mlp(tmx)).render()


def test_deferred_and_unknown_names():
    with pytest.raises(MXNetError, match="Queue 1 item 7"):
        tmx.sym.RNN
    with pytest.raises(MXNetError, match="item 10"):
        tmx.sym.contrib.box_nms
    with pytest.raises(AttributeError):
        tmx.sym.no_such_op
    assert callable(tmx.sym.contrib.foreach) and callable(tmx.sym.linalg.gemm2)
    assert callable(tmx.sym.random.uniform)

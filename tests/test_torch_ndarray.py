"""The port's NDArray surface against the JAX package's, on the CPU: the
creation functions and their dtypes, indexing (get and set), the
arithmetic, comparison, reflected and in-place operators, the host
transfers, the shape methods, ``attach_grad``/``backward``/``grad``
(``grad_req="add"`` too) against the JAX package's autograd, and
``nd.save``/``nd.load`` across the packages. Values are exact where an
op only moves or compares values, else within 1e-6 of max |value|.
Also the NDArray boundary of Gluon blocks and the port's own rules:
no ``ctx`` means the card, views write through, ``out=`` and
``__setitem__`` under ``record()`` raise rather than overwrite a
recorded value silently."""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
tnd, jnd = tmx.nd, jmx.nd


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _same(got, want, exact=True):
    got = got.asnumpy() if hasattr(got, "asnumpy") else np.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("source,dtype", [
    ([[1, 2], [3, 4]], None), (np.arange(6, dtype=np.float64), None),
    (np.arange(6, dtype=np.int64), None), (np.arange(6, dtype=np.int32),
                                           None),
    (np.array([True, False]), None), (np.arange(4), "float16"),
    (3.5, None), (np.arange(6, dtype=np.float32), "int32")])
def test_array_dtype_rules_match_jax(source, dtype):
    """``array`` keeps an ndarray's dtype but 64 bits become 32 (JAX runs
    with x64 off); a list or a scalar becomes float32."""
    _same(tnd.array(source, ctx=CPU, dtype=dtype),
          jnd.array(source, dtype=dtype))


def test_creation_functions_match_jax():
    _same(tnd.zeros((2, 3), ctx=CPU), jnd.zeros((2, 3)))
    _same(tnd.ones(4, ctx=CPU, dtype="int32"), jnd.ones(4, dtype="int32"))
    _same(tnd.full((2, 2), 7.5, ctx=CPU), jnd.full((2, 2), 7.5))
    _same(tnd.empty((3,), ctx=CPU), jnd.empty((3,)))
    _same(tnd.arange(2, 11, 3, repeat=2, ctx=CPU),
          jnd.arange(2, 11, 3, repeat=2))
    _same(tnd.arange(5, ctx=CPU), jnd.arange(5))
    _same(tnd.eye(3, 4, k=1, ctx=CPU), jnd.eye(3, 4, k=1))
    _same(tnd.linspace(0, 1, 5, ctx=CPU), jnd.linspace(0, 1, 5), exact=False)
    _same(tnd.linspace(0, 1, 4, endpoint=False, ctx=CPU),
          jnd.linspace(0, 1, 4, endpoint=False), exact=False)
    a, b = _x(0, 2, 3), _x(1, 2, 3)
    _same(tnd.concat(tnd.array(a, ctx=CPU), tnd.array(b, ctx=CPU), dim=0),
          jnd.concat(jnd.array(a), jnd.array(b), dim=0))
    _same(tnd.stack(tnd.array(a, ctx=CPU), tnd.array(b, ctx=CPU), axis=2),
          jnd.stack(jnd.array(a), jnd.array(b), axis=2))
    _same(tnd.moveaxis(tnd.array(a, ctx=CPU), 0, 1),
          jnd.moveaxis(jnd.array(a), 0, 1))
    idx = np.array([0, 2, 1], np.float32)
    tout, jout = tnd.zeros((3, 4), ctx=CPU), jnd.zeros((3, 4))
    tnd.onehot_encode(tnd.array(idx, ctx=CPU), tout)
    jnd.onehot_encode(jnd.array(idx), jout)
    _same(tout, jout)
    _same(tnd.zeros_like(tnd.array(a, ctx=CPU)), jnd.zeros_like(jnd.array(a)))
    _same(tnd.ones_like(tnd.array(a, ctx=CPU)), jnd.ones_like(jnd.array(a)))


def test_properties_and_host_transfers():
    a = _x(2, 2, 3)
    t, j = tnd.array(a, ctx=CPU), jnd.array(a)
    assert (t.shape, t.size, t.ndim, t.dtype, t.stype) == \
        (j.shape, j.size, j.ndim, j.dtype, j.stype)
    assert t.ctx == t.context == CPU and isinstance(t.handle, torch.Tensor)
    assert t.tolist() == j.tolist()
    assert tnd.array([2.5], ctx=CPU).asscalar() == \
        jnd.array([2.5]).asscalar() == 2.5
    assert tnd.array([3], ctx=CPU).item() == jnd.array([3]).item() == 3.0
    with pytest.raises(MXNetError, match="not a scalar"):
        t.asscalar()
    assert np.array_equal(np.asarray(t), a)
    assert float(tnd.array([1.5], ctx=CPU)) == 1.5
    assert len(t) == 2 and [r.shape for r in t] == [(3,), (3,)]
    _same(t.astype("int32"), j.astype("int32"))
    _same(t.T, j.T)
    c = t.copy()
    c[:] = 0
    assert t.asnumpy().any()                     # copy owns its storage
    dst = tnd.zeros((2, 3), ctx=CPU, dtype="float16")
    t.copyto(dst)
    _same(dst, j.copyto(jnd.zeros((2, 3), dtype="float16")))
    assert t.as_in_context(CPU) is t
    assert t.copyto(CPU).ctx == CPU
    b = tnd.array(np.ones(2, np.float32), ctx=CPU, dtype="bfloat16")
    assert b.dtype == torch.bfloat16 and b.asnumpy().dtype == np.float32
    back = pickle.loads(pickle.dumps(t))
    _same(back, t)


def test_shape_methods_match_jax():
    a = _x(3, 2, 3, 4)
    t, j = tnd.array(a, ctx=CPU), jnd.array(a)
    _same(t.reshape((0, -1)), j.reshape((0, -1)))
    _same(t.reshape(6, 4), j.reshape(6, 4))
    _same(t.reshape(shape=(-3, 0)), j.reshape(shape=(-3, 0)))
    _same(t.reshape_like(tnd.zeros((4, 6), ctx=CPU)),
          j.reshape_like(jnd.zeros((4, 6))))
    _same(t.transpose((2, 0, 1)), j.transpose((2, 0, 1)))
    _same(t.transpose(), j.transpose())
    _same(t.flatten(), j.flatten())
    _same(t.expand_dims(1), j.expand_dims(1))
    _same(t.expand_dims(0).squeeze(0), j.expand_dims(0).squeeze(0))
    _same(t.swapaxes(0, 2), j.swapaxes(0, 2))
    _same(t.flip(1), j.flip(1))
    _same(t.slice((0, 1), (2, 3)), j.slice((0, 1), (2, 3)))
    _same(t.slice_axis(2, 1, 3), j.slice_axis(2, 1, 3))
    idx = np.array([2, 0], np.float32)
    _same(t.take(tnd.array(idx, ctx=CPU), axis=1),
          j.take(jnd.array(idx), axis=1))
    _same(tnd.array(idx, ctx=CPU).one_hot(3), jnd.array(idx).one_hot(3))
    _same(t.pad("constant", (0, 0, 0, 0, 1, 2), 1.5),
          j.pad("constant", (0, 0, 0, 0, 1, 2), 1.5))
    _same(t.clip(-0.5, 0.5), j.clip(-0.5, 0.5))
    _same(t.tile((1, 2, 1)), j.tile((1, 2, 1)))
    _same(t.repeat(2, axis=0), j.repeat(2, axis=0))
    for g, w in zip(t.split(2, axis=2), j.split(2, axis=2)):
        _same(g, w)
    _same(tnd.array(a[:1], ctx=CPU).broadcast_to((2, 3, 4)),
          jnd.array(a[:1]).broadcast_to((2, 3, 4)))
    _same(tnd.array(a[:1], ctx=CPU).broadcast_like(t),
          jnd.array(a[:1]).broadcast_like(j))
    # methods generated from the registry
    _same(t.mean(axis=1), j.mean(axis=1), exact=False)
    _same(t.sum(), j.sum(), exact=False)
    _same(t.max(axis=(0, 2)), j.max(axis=(0, 2)))
    _same(t.exp(), j.exp(), exact=False)
    _same(t.argmax(axis=2), j.argmax(axis=2))


@pytest.mark.parametrize("key", [
    1, -1, slice(0, 2), (0, slice(1, 3)), (slice(None), 2),
    (Ellipsis, 1), "array", "tuple_array"])
def test_getitem_and_setitem_match_jax(key):
    a = _x(4, 3, 4)
    t, j = tnd.array(a, ctx=CPU), jnd.array(a)
    tkey = jkey = key
    if key == "array":
        idx = np.array([2, 0], np.int32)
        tkey, jkey = tnd.array(idx, ctx=CPU), jnd.array(idx)
    elif key == "tuple_array":
        idx = np.array([1, 3], np.int32)
        tkey = (slice(None), tnd.array(idx, ctx=CPU))
        jkey = (slice(None), jnd.array(idx))
    _same(t[tkey], j[jkey])
    value = _x(5, *j[jkey].shape)
    t[tkey] = tnd.array(value, ctx=CPU)
    j[jkey] = jnd.array(value)
    _same(t, j)
    t[tkey] = 2.5
    j[jkey] = 2.5
    _same(t, j)


def test_basic_indexing_writes_through_as_the_reference():
    """A basic slice is a view (the reference's write-through; the JAX
    package copies on read)."""
    t = tnd.array(np.zeros((2, 3), np.float32), ctx=CPU)
    row = t[1]
    row[:] = 4.0
    assert t.asnumpy()[1].tolist() == [4.0, 4.0, 4.0]


SCALARS = (2.0, 0.5)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "truediv", "mod", "pow",
                                "eq", "ne", "gt", "ge", "lt", "le"])
def test_binary_operators_match_jax(op):
    a = np.round(_x(6, 2, 3) * 2) / 2
    b = np.abs(np.round(_x(7, 2, 3) * 2) / 2) + 0.5
    if op == "pow":
        a = np.abs(a) + 0.5
    t, j = tnd.array(a, ctx=CPU), jnd.array(a)
    tb, jb = tnd.array(b, ctx=CPU), jnd.array(b)
    name = f"__{op}__"
    exact = op in ("eq", "ne", "gt", "ge", "lt", "le", "add", "sub")
    _same(getattr(t, name)(tb), getattr(j, name)(jb), exact)
    for s in SCALARS:
        _same(getattr(t, name)(s), getattr(j, name)(s), exact)
        rname = f"__r{op}__"
        if hasattr(jnd.NDArray, rname) and op not in (
                "eq", "ne", "gt", "ge", "lt", "le"):
            tb_pos = tnd.array(b, ctx=CPU)
            _same(getattr(tb_pos, rname)(s), getattr(jb, rname)(s), exact)


def test_unary_and_inplace_operators_match_jax():
    a = _x(8, 2, 3)
    t, j = tnd.array(a, ctx=CPU), jnd.array(a)
    _same(-t, -j)
    _same(abs(t), abs(j))
    storage = t.handle.data_ptr()
    for op, val in (("__iadd__", 1.5), ("__isub__", 0.25),
                    ("__imul__", 2.0), ("__itruediv__", 4.0)):
        t = getattr(t, op)(val)
        j = getattr(j, op)(val)
        _same(t, j, exact=False)
        t = getattr(t, op)(tnd.array(a, ctx=CPU))
        j = getattr(j, op)(jnd.array(a))
        _same(t, j, exact=False)
    assert t.handle.data_ptr() == storage        # written in place


def test_attach_grad_backward_matches_jax_autograd():
    """``grad_req="add"`` accumulates across two backward passes, "write"
    replaces; both against the JAX package's autograd on one expression
    (with a reflected scalar, a slice, a reduction, an op and a head
    gradient)."""
    a, b = _x(9, 3, 4), _x(10, 3, 4)
    head = _x(11, 3)
    grads = {}
    for pkg, nd_ in (("t", tnd), ("j", jnd)):
        kw = {"ctx": CPU} if pkg == "t" else {}
        x, w = nd_.array(a, **kw), nd_.array(b, **kw)
        x.attach_grad(grad_req="add")
        w.attach_grad()
        for _ in range(2):
            with (tmx if pkg == "t" else jmx).autograd.record():
                y = (2.0 - x * w) ** 2
                z = nd_.tanh(y[:, 1:]).sum(axis=1) + (x / 3.0).mean(axis=1)
            z.backward(nd_.array(head, **kw))
        grads[pkg] = (x.grad.asnumpy(), w.grad.asnumpy(), z.asnumpy())
    for g, w_ in zip(grads["t"], grads["j"]):
        _same(g, w_, exact=False)


def test_autograd_backward_takes_ndarray_heads():
    x = tnd.array(_x(12, 2, 3), ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y = x * 3.0
    tmx.autograd.backward([y], [tnd.ones((2, 3), ctx=CPU)])
    assert np.allclose(x.grad.asnumpy(), 3.0)
    z = x * 2.0                         # outside record: nothing recorded
    with pytest.raises(MXNetError, match="no recorded graph"):
        z.backward()


def test_setitem_and_out_under_record_do_not_overwrite_silently():
    x = tnd.array(_x(13, 2, 3), ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y = x * 1.0
        z = tnd.exp(y)                    # exp saves its output
        z[0] = 0.0
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        z.backward()
    with tmx.autograd.record():
        with pytest.raises(MXNetError, match="records its gradient"):
            tnd.exp(x, out=x)
    # outside record() out= writes the storage
    tgt = tnd.zeros((2, 3), ctx=CPU)
    res = tnd.exp(x, out=tgt)
    assert res is tgt and np.allclose(tgt.asnumpy(), np.exp(x.asnumpy()))


def test_save_and_load_across_the_packages(tmp_path):
    arrays = {"w": _x(14, 3, 4), "i": np.arange(5, dtype=np.int32)}
    tpath, jpath = str(tmp_path / "t.params"), str(tmp_path / "j.params")
    tnd.save(tpath, {k: tnd.array(v, ctx=CPU) for k, v in arrays.items()})
    jnd.save(jpath, {k: jnd.array(v) for k, v in arrays.items()})
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    got, want = tnd.load(jpath), jnd.load(tpath)
    assert sorted(got) == sorted(want) == ["i", "w"]
    for k in arrays:
        assert isinstance(got[k], tnd.NDArray) and got[k].ctx == CPU
        _same(got[k], want[k])
    tnd.save(tpath, [tnd.array(arrays["w"], ctx=CPU)])
    _same(tnd.load(tpath)[0], jnd.load(tpath)[0])


def test_no_ctx_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(MXNetError, match="no CUDA device"):
        tnd.array([1.0, 2.0])
    with pytest.raises(MXNetError, match="no CUDA device"):
        tnd.zeros((2,))
    with tmx.cpu():                      # a scope asks for the CPU
        assert tnd.ones((2,)).ctx == CPU


def test_block_boundary_wraps_and_unwraps():
    """A block called with NDArrays returns NDArrays (tuples too) and
    records inside record(); with tensors it returns tensors, also when
    its forward returns an NDArray (an nd sampler's)."""
    dense = tmx.gluon.nn.Dense(3, in_units=4)
    dense.initialize(ctx=CPU, generator=tmx.random.generator(0))
    x = tnd.array(_x(15, 2, 4), ctx=CPU)
    out = dense(x)
    assert isinstance(out, tnd.NDArray) and not out.handle.requires_grad
    with tmx.autograd.record():
        loss = (dense(x) ** 2).sum()
    loss.backward()
    assert dense.weight.grad is not None
    want = dense(x.handle).detach().numpy()
    np.testing.assert_array_equal(out.asnumpy(), want)

    class Pair(tmx.gluon.HybridBlock):
        def forward(self, a):
            return a * 2, tnd.random.uniform(shape=(2,), ctx=CPU)

    pair = Pair()
    got = pair(x)
    assert isinstance(got, tuple) and all(isinstance(g, tnd.NDArray)
                                          for g in got)
    got = pair(x.handle)
    assert all(isinstance(g, torch.Tensor) for g in got)
    lam = tmx.gluon.nn.HybridLambda(lambda F, v: F.reshape(v, (-1, 2)))
    assert isinstance(lam(x.handle), torch.Tensor)
    assert lam(x).shape == (4, 2)

"""``mx.np`` and ``mx.npx`` in the port against the JAX package's, on the
CPU.

Every name of the port's ``mx.np`` (the JAX package's ``_FUNCS`` that
its jnp has), ``mx.np.linalg``, ``mx.np.fft`` and ``mx.npx`` takes the
seeded arguments of ``tools/np_cases.py`` (which ``chip_smoke.py`` phase
29 (d) shares); the values, shapes and dtypes must match the JAX
function's within the case's tolerance: exact for what only moves,
selects, compares or counts; 1e-6 of max |value| for elementwise
arithmetic; 1e-5 relative for reductions, transcendental functions and
linalg; a looser one named in the table with its reason. The JAX side
runs each family of names as one ``jax.jit`` program (the jnp function
the JAX package's wrapper calls; ``mx.npx`` over NDArrays of the traced
values), computed once per module; the names whose output shape depends
on the values run eagerly through the wrapper. The factorizations (qr,
svd, eig, eigh, eigvals) are held through what they determine. Also:
the samplers of ``mx.np.random`` (dtype and support; the ones with a
shape or dtype rule of their own drawn in both packages), the
callbacks, autograd through ``mx.np``, and ``npx.rnn`` /
``npx.box_nms`` raising naming their ROADMAP items."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from tools import np_cases as cases

CPU = tmx.cpu()


def _fn(mod, name):
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _port(ns, name, args, kw):
    with CPU:
        fn = _fn(ns, name)
        return fn(*cases.args_of(args, lambda a: tmx.np.array(a, ctx=CPU)),
                  **kw)


def _family(name):
    if name in cases.EAGER:
        return "eager"
    return name.split(".")[0] if "." in name else \
        ("unary" if name in cases._UNARY["exact"] + cases._UNARY["rel"]
         else "other")


def _jax_refs(table, root, jax_root):
    """{name: the JAX result as numpy (nested tuples kept)}: one jitted
    program per family over all its cases."""
    def to_np(x):
        if isinstance(x, (tuple, list)):
            return tuple(to_np(e) for e in x)
        if isinstance(x, jax.Array):
            return np.asarray(x)
        if hasattr(x, "asnumpy"):
            return x.asnumpy()
        return x

    refs, families = {}, {}
    for name in table:
        families.setdefault(_family(name) if root == "np" else "npx",
                            []).append(name)
    for fam, names in families.items():
        made = {n: table[n][0](cases.rng_for(n)) for n in names}
        if fam == "eager":
            for n in names:
                args, kw = made[n]
                refs[n] = to_np(_fn(jax_root, n)(
                    *cases.args_of(args, jmx.np.array), **kw))
            continue
        arrays = {n: [a for a in cases.args_of(made[n][0], lambda a: a)]
                  for n in names}

        def program(arrs, names=names):
            out = {}
            for n in names:
                args, kw = made[n]
                it = iter(arrs[n])
                call = [next(it) for _ in args]
                if root == "np":
                    out[n] = _fn(jnp, n)(*call, **kw)
                    continue
                # mx.npx over NDArrays of the traced values
                box = [jmx.nd.NDArray(c, _skip_device_put=True)
                       if isinstance(c, jax.Array) else c for c in call]
                res = _fn(jax_root, n)(*box, **kw)
                out[n] = res._data if hasattr(res, "_data") else \
                    tuple(r._data for r in res)
            return out

        jitted = {n: [jnp.asarray(a) if isinstance(a, np.ndarray)
                      else [jnp.asarray(e) for e in a]
                      if isinstance(a, list) and a
                      and isinstance(a[0], np.ndarray) else a
                      for a in arrays[n]] for n in names}
        static = {n: [not isinstance(a, (np.ndarray, list)) or
                      (isinstance(a, list) and not isinstance(
                          a[0] if a else None, np.ndarray))
                      for a in arrays[n]] for n in names}
        dyn = {n: [a for a, s in zip(jitted[n], static[n]) if not s]
               for n in names}

        def run(dyn_arrs, names=names):
            full = {}
            for n in names:
                it = iter(dyn_arrs[n])
                full[n] = [a if s else next(it)
                           for a, s in zip(jitted[n], static[n])]
            return program(full)

        out = jax.jit(run)(dyn)
        for n in names:
            refs[n] = to_np(out[n])
    return refs


@pytest.fixture(scope="module")
def np_refs():
    return _jax_refs(cases.CASES, "np", jmx.np)


@pytest.fixture(scope="module")
def npx_refs():
    return _jax_refs(cases.NPX_CASES, "npx", jmx.npx)


def test_every_name_is_covered():
    assert set(tmx.np.FUNCS) == {n for n in cases.CASES if "." not in n}
    assert set(tmx.np.FUNCS) <= set(dir(jnp)) and \
        set(tmx.np.FUNCS) <= set(jmx.np.__all__)
    for sub in ("linalg", "fft"):
        names = {n.split(".")[1] for n in cases.CASES
                 if n.startswith(sub + ".")}
        names |= set(cases.LINALG_FACTORS) if sub == "linalg" else set()
        assert names == {n for n in dir(getattr(jmx.np, sub))
                         if not n.startswith("_")}, sub
    public = {n for n in dir(jmx.np.random) if not n.startswith("_")}
    assert public <= set(dir(tmx.np.random)), public - set(dir(
        tmx.np.random))
    assert set(cases.NPX_CASES) | {"set_np", "reset_np", "is_np_array",
                                   "dropout", "batch_norm", "ctc_loss",
                                   "seed", "waitall", "box_nms", "rnn"} \
        == set(tmx.npx.__all__)


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_np_name_matches_jax(name, np_refs):
    make, tol = cases.CASES[name]
    args, kw = make(cases.rng_for(name))
    got = _port(tmx.np, name, args, kw)
    cases.check(got, np_refs[name], tol, name)


@pytest.mark.parametrize("name", sorted(cases.LINALG_FACTORS))
def test_factorizations_determine_the_same(name):
    """qr/svd/eig/eigh/eigvals: the products and invariants they fix
    (Q R = A, U S V^T = A with the same singular values, A v = w v with
    the same eigenvalues sorted), dtypes as the JAX package's."""
    args, kw = cases.LINALG_FACTORS[name](cases.rng_for(name))
    a = args[0]
    got = _port(tmx.np, f"linalg.{name}", args, kw)
    want = _fn(jmx.np, f"linalg.{name}")(jmx.np.array(a), **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    g = [x.asnumpy() for x in got]
    w = [x.asnumpy() for x in want]
    if name == "qr":
        np.testing.assert_allclose(g[0] @ g[1], a, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.abs(g[1]), np.abs(w[1]), rtol=1e-4,
                                   atol=1e-5)
    elif name == "svd":
        np.testing.assert_allclose((g[0] * g[1]) @ g[2], a, atol=1e-5)
        np.testing.assert_allclose(g[1], w[1], rtol=1e-5)
    elif name == "eigh":
        np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
        np.testing.assert_allclose(a @ g[1], g[1] * g[0][..., None, :],
                                   atol=1e-4)
    else:
        vals = g[0]
        np.testing.assert_allclose(np.sort_complex(vals),
                                   np.sort_complex(w[0]), rtol=1e-4)


@pytest.mark.parametrize("name", sorted(cases.NPX_CASES))
def test_npx_name_matches_jax(name, npx_refs):
    make, tol = cases.NPX_CASES[name]
    args, kw = make(cases.rng_for(name))
    got = _port(tmx.npx, name, args, kw)
    cases.check(got, npx_refs[name], tol, name)


@pytest.mark.parametrize("name,args,item", [
    ("rnn", (None, None), "item 7"), ("box_nms", (), "item 10")])
def test_npx_deferred_raise(name, args, item):
    with pytest.raises(MXNetError, match=f"Queue 1 {item}"):
        getattr(tmx.npx, name)(tmx.nd.ones((2, 2), ctx=CPU), *args)


_SAMPLERS = {
    # name: (args, kwargs, support check, the JAX package's dtype)
    "uniform": ((-1.0, 2.0), {"size": (400,)},
                lambda v: (v >= -1).all() and (v < 2).all(), "float32"),
    "normal": ((), {"size": (400,)}, lambda v: abs(v.mean()) < 0.3,
               "float32"),
    "randint": ((3, 9), {"size": (50,)},
                lambda v: (v >= 3).all() and (v < 9).all(), "int32"),
    "gamma": ((2.0,), {"size": (300,)}, lambda v: (v > 0).all(), "float32"),
    "beta": ((2.0, 3.0), {"size": (100,)},
             lambda v: ((v > 0) & (v < 1)).all(), "float32"),
    "dirichlet": ((np.float32([1, 2, 3]),), {"size": (4,)},
                  lambda v: np.allclose(v.sum(-1), 1, atol=1e-5), "float32"),
    "poisson": ((3.0,), {"size": (200,)}, lambda v: (v >= 0).all(),
                "int32"),
    "geometric": ((0.3,), {"size": (200,)}, lambda v: (v >= 1).all(),
                  "int32"),
    "binomial": ((10, 0.3), {"size": (200,)}, lambda v: (v <= 10).all(),
                 "int32"),
    "choice": ((10,), {"size": (5,), "replace": False},
               lambda v: len(set(v.tolist())) == 5, "int32"),
    "multinomial": ((20, np.float32([0.2, 0.3, 0.5])), {"size": (3,)},
                    lambda v: (v.sum(-1) == 20).all(), "int32"),
    "exponential": ((), {"size": (100,)}, lambda v: (v > 0).all(),
                    "float32"),
    "pareto": ((3.0,), {"size": (100,)}, lambda v: (v > 0).all(),
               "float32"),
    "weibull": ((2.0,), {"size": (100,)}, lambda v: (v > 0).all(),
                "float32"),
    "multivariate_normal": ((np.zeros(2, np.float32),
                             np.eye(2, dtype=np.float32)), {"size": (5,)},
                            lambda v: v.shape == (5, 2), "float32"),
}
# the samplers whose shape or dtype rule is their own, drawn in both
# packages (each JAX sampler compiles at its first draw); the others keep
# the JAX package's dtype, written in the table from its code
_AGAINST_JAX = ("randint", "geometric", "multinomial", "dirichlet",
                "choice", "uniform")


@pytest.mark.parametrize("name", sorted(_SAMPLERS))
def test_np_random_samplers(name):
    """Shapes and dtypes as the JAX package's samplers give them, values
    in their support."""
    args, kw, check, dtype = _SAMPLERS[name]
    with CPU:
        tmx.np.random.seed(0)
        got = getattr(tmx.np.random, name)(*args, **kw)
    if name in _AGAINST_JAX:
        want = getattr(jmx.np.random, name)(*args, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (got.shape, got.dtype, want.shape, want.dtype)
    assert str(got.dtype) == dtype, got.dtype
    assert check(got.asnumpy()), got.asnumpy()


def test_callbacks_match_jax():
    x = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    jx, tx = jmx.np.array(x), tmx.np.array(x, ctx=CPU)
    pairs = [
        (jmx.np.apply_along_axis(lambda v: jmx.np.sum(v * v), 1, jx),
         tmx.np.apply_along_axis(lambda v: tmx.np.sum(v * v), 1, tx)),
        (jmx.np.apply_over_axes(jmx.np.sum, jx, [0, 1]),
         tmx.np.apply_over_axes(tmx.np.sum, tx, [0, 1])),
        (jmx.np.piecewise(jx, [jx < 0, jx >= 0],
                          [lambda v: -v, lambda v: v * 2]),
         tmx.np.piecewise(tx, [tx < 0, tx >= 0],
                          [lambda v: -v, lambda v: v * 2])),
    ]
    for want, got in pairs:
        cases.check(got, want, "rel", "callback")


def test_np_records_like_nd():
    """A chain of mx.np calls under record() differentiates as the JAX
    package's tape does."""
    x = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    jx = jmx.np.array(x)
    jx.attach_grad()
    with jmx.autograd.record():
        jl = jmx.np.sum(jmx.np.tanh(jx) * jmx.np.mean(jx, axis=0))
    jl.backward()
    tx = tmx.np.array(x, ctx=CPU)
    tx.attach_grad()
    with tmx.autograd.record():
        tl = tmx.np.sum(tmx.np.tanh(tx) * tmx.np.mean(tx, axis=0))
    tl.backward()
    np.testing.assert_allclose(tl.asnumpy(), jl.asnumpy(), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(),
                               rtol=1e-5, atol=1e-6)
    with tmx.autograd.pause():
        assert not tmx.np.sum(tx)._data.requires_grad

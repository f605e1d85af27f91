"""``mx.nd``'s operators in the port against the JAX package's, on the CPU.

One case per ported name (the JAX registry's names less the registry's
``DEFERRED`` table): the same seeded numpy inputs and parameters go
through the JAX op's pure function (``mxnet_tpu.ops.registry.get(name)
.fn`` on jnp arrays; the ops of one family run as one ``jax.jit``
program, computed once per module) and through the port's ``mx.nd``
wrapper on CPU NDArrays. The port's op must take the JAX op's inputs
and parameters in the same order. Tolerances: exact (values and dtype)
for ops that only move, select or compare values; 1e-6 of max |value|
for elementwise arithmetic; 1e-5 relative for reductions,
transcendental functions and linalg (``assert_allclose(rtol=1e-5)``
with an absolute floor of 1e-5 of max |value| for values near 0); a
looser tolerance is named per op in the case table
(``tools/nd_op_cases.py``, which ``chip_smoke.py`` phase 28 shares)
with its reason. The samplers
are held to the JAX ones' shapes, dtypes and supports here and by
their moments in ``test_torch_nd_random.py``.

Also: the port registers exactly the JAX names less ``DEFERRED``, each
deferred name raises naming its ROADMAP item, the gradients of the
loss heads, ``smooth_l1``, ``BlockGrad`` and ``SequenceMask`` against
``jax.vjp``, and ``out=`` reaching a Gluon Parameter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu  # noqa: F401 - registers the JAX ops
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg
from tools.nd_op_cases import (RANDOM, check, f32, f32_maker, nd_fn,
                               rng_for, seq_inputs, spec)

CPU = tmx.cpu()
nd = tmx.nd
# Custom runs a user's CustomOp: tests/test_torch_custom_op.py
PORTED = sorted(set(jreg.list_ops()) - set(treg.DEFERRED) - {"Custom"})


def _primary(name):
    return jreg.get(name).name


def _jax_call(name, inputs, params):
    op = jreg.get(name)
    kw = op.coerce_params(dict(params))
    if op.needs_rng:
        kw["rng"] = jax.random.key(0)
    if op.needs_mode:
        kw["training"] = name in _TRAINING
    out = op.fn(*[jnp.asarray(a) for a in inputs], **kw)
    return list(out) if isinstance(out, (tuple, list)) else [out]


_TRAINING = {"BatchNorm", "_contrib_BatchNormWithReLU"}
_EAGER = {"_contrib_boolean_mask", "_contrib_index_copy",
          "_contrib_AdaptiveAvgPooling2D"}


@pytest.fixture(scope="module")
def jax_refs():
    """Every primary op's JAX outputs: one jitted program per family
    (the JAX module that registers it), the data-dependent ones eager."""
    names = sorted({_primary(n) for n in PORTED} - set(RANDOM))
    families = {}
    for p in names:
        families.setdefault(jreg.get(p).fn.__module__, []).append(p)
    refs = {}
    for fam, members in families.items():
        eager = [p for p in members if p in _EAGER]
        jitted = [p for p in members if p not in _EAGER]
        inputs = {p: spec(p)[0](rng_for(p)) for p in members}

        def run(arrays, jitted=jitted):
            return {p: _jax_call(p, arrays[p], spec(p)[1]) for p in jitted}
        out = jax.jit(run)({p: inputs[p] for p in jitted})
        for p in eager:
            out[p] = _jax_call(p, inputs[p], spec(p)[1])
        refs.update({p: (inputs[p], [np.asarray(o) for o in v])
                     for p, v in out.items()})
    return refs


def _port_call(name, inputs, params):
    arrays = [nd.array(a, ctx=CPU) for a in inputs]
    if name in ("BatchNorm", "BatchNormWithReLU",
                "_contrib_BatchNormWithReLU"):
        with tmx.autograd.train_mode():
            out = nd_fn(nd, name)(*arrays, **params)
    else:
        out = nd_fn(nd, name)(*arrays, **params)
    out = out if isinstance(out, list) else [out]
    assert all(isinstance(o, nd.NDArray) for o in out)
    return [_host(o) for o in out]


def _host(a):
    """An NDArray's values; a bfloat16 one as float32 beside its dtype
    name (numpy holds no bfloat16 here)."""
    if str(a.dtype) == "torch.bfloat16":
        return ("bfloat16", a.asnumpy())
    return a.asnumpy()


def test_port_registers_the_jax_names_less_deferred():
    assert set(treg.list_ops()) == set(PORTED) | {"Custom"}
    assert not set(treg.list_ops()) & set(treg.DEFERRED)
    assert set(treg.DEFERRED) <= set(jreg.list_ops())
    assert len(PORTED) == 300 and len(treg.DEFERRED) == 46


@pytest.mark.parametrize("name", PORTED)
def test_op_matches_jax(name, jax_refs):
    jop, top = jreg.get(name), treg.get(name)
    assert top.name == jop.name and top.num_inputs == jop.num_inputs, name
    assert [p.name for p in top.params] == [p.name for p in jop.params], name
    assert (top.needs_rng, top.needs_mode, top.differentiable) == (
        jop.needs_rng, jop.needs_mode, jop.differentiable), name
    p = _primary(name)
    if p in RANDOM:
        # the JAX sampler's shapes and dtypes (jax.eval_shape: no draw)
        inputs, params, support = RANDOM[p]
        want = jax.eval_shape(lambda *a: _jax_call(p, a, params), *inputs)
        got = _port_call(name, inputs,
                         params if inputs else {**params, "ctx": CPU})
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w)
            if support is None:                 # _shuffle: a permutation
                np.testing.assert_array_equal(np.sort(g), inputs[0])
            else:
                assert support(g), g
        return
    inputs, want = jax_refs[p]
    got = _port_call(name, inputs, spec(p)[1])
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        check(g, w, spec(p)[2], name)


@pytest.mark.parametrize("name", sorted(treg.DEFERRED))
def test_deferred_name_raises_naming_its_item(name):
    item = treg.DEFERRED[name].split(" (")[0]
    with pytest.raises(MXNetError, match=f"Queue 1 {item}"):
        treg.get(name)
    if name.startswith("_contrib_"):
        where, short = nd.contrib, name[len("_contrib_"):]
    elif name.startswith("_"):
        where, short = nd._internal, name
    else:
        where, short = nd, name
    with pytest.raises(MXNetError, match=f"Queue 1 {item}"):
        getattr(where, short)


# -- gradients against jax.vjp ------------------------------------------------
GRAD_CASES = {
    "SoftmaxOutput": (lambda r: [f32(r, 3, 4), np.float32([0, 3, -1])],
                      {"grad_scale": 0.5, "use_ignore": True}),
    "SoftmaxOutput_multi": (lambda r: [f32(r, 2, 3, 4),
                                       np.float32([[0, 2, 1, 1],
                                                   [2, 0, 0, 1]])],
                            {"multi_output": True}),
    "LinearRegressionOutput": (lambda r: [f32(r, 3, 2), f32(r, 3, 2)],
                               {"grad_scale": 2.0}),
    "MAERegressionOutput": (lambda r: [f32(r, 3, 2), f32(r, 3, 2)], {}),
    "LogisticRegressionOutput": (lambda r: [f32(r, 4), f32(r, 4)], {}),
    "MakeLoss": (f32_maker(2, 3), {"grad_scale": 3.0}),
    "smooth_l1": (f32_maker(3, 4), {"scalar": 1.5}),
    "BlockGrad": (f32_maker(2, 3), {}),
    "SequenceMask": (seq_inputs, {"use_sequence_length": True,
                                  "value": 2.0}),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_gradient_matches_jax_vjp(case):
    """The gradient of the first input from a seeded head gradient (the
    loss heads ignore it, as MXNet's do), 1e-6 of max |value|."""
    name = case.split("_multi")[0]
    make, params = GRAD_CASES[case]
    rng = rng_for(case)
    inputs = make(rng)
    jop = jreg.get(name)
    kw = jop.coerce_params(dict(params))
    rest = [jnp.asarray(a) for a in inputs[1:]]
    # BlockGrad's head carries no graph: differentiate BlockGrad(x) * x
    extra = (lambda y, x: y * x) if name == "BlockGrad" else \
        (lambda y, x: y)
    out, vjp = jax.vjp(lambda x: extra(jop.fn(x, *rest, **kw), x),
                       jnp.asarray(inputs[0]))
    head = rng.randn(*out.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(head))
    x = nd.array(inputs[0], ctx=CPU)
    x.attach_grad()
    with tmx.autograd.record():
        y = extra(getattr(nd, name)(
            x, *[nd.array(a, ctx=CPU) for a in inputs[1:]], **params), x)
    y.backward(nd.array(head, ctx=CPU))
    got = x.grad.asnumpy()
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(y.asnumpy(), np.asarray(out), rtol=0,
                               atol=1e-6 * float(np.abs(out).max()))


def test_out_reaches_a_gluon_parameter():
    """``nd.sgd_update(w, g, lr=.1, out=w)`` with ``w`` an NDArray over a
    Dense layer's weight writes the Parameter in place (the JAX package's
    sgd_update values); inside record() an out= onto a leaf that records
    its gradient raises."""
    dense = tmx.gluon.nn.Dense(3, in_units=4)
    dense.initialize(ctx=CPU, generator=tmx.random.generator(0))
    w0 = dense.weight.detach().numpy().copy()
    g = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    w = nd.NDArray(dense.weight)
    before = dense.weight.data_ptr()
    res = nd.sgd_update(w, nd.array(g, ctx=CPU), lr=0.1, wd=0.01, out=w)
    assert res is w and dense.weight.data_ptr() == before
    want = jreg.get("sgd_update").fn(jnp.asarray(w0), jnp.asarray(g),
                                     lr=0.1, wd=0.01)
    np.testing.assert_array_equal(dense.weight.detach().numpy(),
                                  np.asarray(want))
    with tmx.autograd.record():
        with pytest.raises(MXNetError, match="records its gradient"):
            nd.sgd_update(w, nd.array(g, ctx=CPU), lr=0.1, out=w)

"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
build a network in the JAX package with seeded, non-trivial BatchNorm
statistics and carry its parameters into the same network of the port."""
import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as torch_resnet

NARROW = ([1, 1, 1, 1], [8, 16, 32, 64, 128])


def narrow_pair(seed=0, classes=10, in_shape=(3, 3, 32, 32)):
    """The narrow bottleneck ResNetV1 in both packages, same weights."""
    jnet = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, *NARROW,
                               classes=classes)
    tnet = torch_resnet.ResNetV1(torch_resnet.BottleneckV1, *NARROW,
                                 classes=classes)
    return carry(jnet, tnet, seed, in_shape)


def carry(jnet, tnet, seed, in_shape):
    """Initialize ``jnet`` and infer its shapes on a batch of
    ``in_shape`` (test batches of that shape then reuse the compiled
    ops), give its BatchNorms seeded gamma, beta and running statistics,
    and load all of it into ``tnet`` on the CPU."""
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jnet(jmx.nd.array(np.zeros(in_shape, np.float32)))   # infer shapes
    rng = np.random.RandomState(seed)
    for name, param in jnet._structural_names().items():
        shape = param.shape
        if name.endswith("running_mean") or name.endswith("beta"):
            param.set_data(jmx.nd.array(rng.randn(*shape) * 0.1))
        elif name.endswith("running_var") or name.endswith("gamma"):
            param.set_data(jmx.nd.array(rng.rand(*shape) + 0.5))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._structural_names().items()}
    load_jax_params(tnet, arrays, ctx=tmx.cpu())
    return jnet, tnet


def logits(jnet, tnet, x):
    """Predict-mode outputs of both networks on the numpy batch ``x``."""
    want = jnet(jmx.nd.array(x)).asnumpy()
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    return got, want


NARROW_BERT = dict(num_layers=2, units=64, hidden_size=128, num_heads=4,
                   max_length=64, vocab_size=100)


def bert_pair(seed=0, **overrides):
    """The narrow BERT (2 layers, units 64, hidden 128, 4 heads,
    max_length 64, vocab 100) in both packages, with seeded weights,
    biases and LayerNorm parameters carried into the port on the CPU.
    ``overrides`` change the configuration of both."""
    from mxnet_tpu.gluon.model_zoo import bert as jax_bert
    from mxnet_tpu_torch.gluon.model_zoo import bert as torch_bert
    cfg = {**NARROW_BERT, **overrides}
    jnet = jax_bert.BERTModel(**cfg)
    tnet = torch_bert.BERTModel(**cfg)
    jnet.initialize(jmx.init.Normal(0.02), ctx=jmx.cpu())
    zeros = jmx.nd.array(np.zeros((1, 2), np.int32), dtype="int32")
    jnet(zeros, zeros, zeros)                             # infer shapes
    rng = np.random.RandomState(seed)
    params = jnet._structural_names()
    for name in sorted(params):
        param = params[name]
        shape = param.shape
        if name.endswith("gamma"):
            value = 1.0 + 0.1 * rng.randn(*shape)
        else:
            value = (0.05 if name.endswith("weight") else 0.02) \
                * rng.randn(*shape)
        param.set_data(jmx.nd.array(value.astype(np.float32)))
    arrays = {k: p.data().asnumpy() for k, p in params.items()}
    load_jax_params(tnet, arrays, ctx=tmx.cpu())
    return jnet, tnet, arrays


def bert_outputs(jnet, tnet, ids, token_types=None, masked_positions=None):
    """Predict-mode outputs of both BERTs on int numpy inputs (None skips
    one), as lists of numpy arrays (port, JAX)."""
    args = (ids, token_types, masked_positions)
    want = jnet(*(None if a is None else jmx.nd.array(a, dtype="int32")
                  for a in args))
    with torch.inference_mode():
        got = tnet(*(None if a is None else torch.from_numpy(a)
                     for a in args))
    return ([g.numpy() for g in _as_list(got)],
            [w.asnumpy() for w in _as_list(want)])


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def carry_block(jblock, tblock, inputs, seed=0, scale=None):
    """The same seeded parameters in both blocks: the port's ``tblock``
    infers its shapes on the numpy ``inputs`` with seeded Xavier weights
    on the CPU; gamma and running variance take values in [0.5, 1.5),
    beta and running mean normals times 0.1, PReLU's alpha values in [0,
    0.5), and with ``scale`` every other parameter normals times
    ``scale`` (else Xavier's stay). The arrays load into the JAX
    ``jblock`` through ``load_dict`` (no JAX initializer, forward or
    per-array conversion runs: the JAX package compiles each op and each
    conversion once per shape) and into ``tblock`` through
    ``load_jax_params``. Returns the arrays."""
    tblock.initialize(tmx.init.Xavier(), ctx=tmx.cpu(),
                      generator=tmx.random.generator(seed))
    with torch.no_grad():
        tblock(*[torch.from_numpy(a) for a in inputs])
    rng = np.random.RandomState(seed)
    arrays = {}
    for name, t in sorted(tblock.collect_params().items()):
        if name.endswith(("gamma", "running_var")):
            value = rng.rand(*t.shape) + 0.5
        elif name.endswith(("beta", "running_mean")):
            value = rng.randn(*t.shape) * 0.1
        elif name.endswith("alpha"):
            value = rng.rand(*t.shape) * 0.5
        elif scale is not None:
            value = rng.randn(*t.shape) * scale
        else:
            value = t.detach().numpy()
        arrays[name] = value.astype(np.float32)
    import jax
    jblock.load_dict({k: jmx.nd.NDArray(jax.device_put(v),
                                        _skip_device_put=True)
                      for k, v in arrays.items()}, ctx=jmx.cpu())
    load_jax_params(tblock, arrays, ctx=tmx.cpu())
    return arrays


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _jax_recorded(jblock, inputs, idx, seed):
    """The JAX block's training-mode forward and its VJP from seeded head
    gradients as one jitted program over ``functional_apply`` (one XLA
    compile instead of one per op and per op's VJP). Returns (outputs,
    heads, updated auxiliary arrays, parameter gradients, input
    gradients) and the (trainable, aux) parameters."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.gluon.block import functional_apply
    from mxnet_tpu import autograd as jag
    trainable, aux = jblock._param_split()
    tr = [p.data()._data for p in trainable]
    ax = [p.data()._data for p in aux]
    xs = [None if a is None else jnp.asarray(a) for a in inputs]

    def fwd(tr, dxs):
        full = list(xs)
        for i, d in zip(idx, dxs):
            full[i] = d
        if tr or ax:
            outs, _, aux_new = functional_apply(
                jblock, jax.random.key(0), tr, ax, full, training=True)
            return outs, aux_new
        with jag.pause(train_mode=True):     # a loss: inputs may be None
            outs = jblock(*[None if d is None else jmx.nd.NDArray(
                d, ctx=jmx.cpu(), _skip_device_put=True) for d in full])
        return [o._data for o in _outputs(outs)], []

    def run(tr, dxs, heads):
        outs, vjp_fn, aux_new = jax.vjp(fwd, tr, dxs, has_aux=True)
        g_tr, g_dx = vjp_fn(heads)
        return outs, aux_new, g_tr, g_dx

    dxs = [xs[i] for i in idx]
    shapes = jax.eval_shape(lambda t, d: fwd(t, d)[0], tr, dxs)
    rng = np.random.RandomState(seed)
    heads = [rng.randn(*o.shape).astype(np.float32) for o in shapes]
    return (heads, *jax.jit(run)(tr, dxs, [jnp.asarray(h) for h in heads])
            ), trainable, aux


def recorded_pair(jblock, tblock, inputs, seed=1, grad_inputs=None):
    """Both blocks in training mode on the numpy ``inputs`` (those whose
    index is in ``grad_inputs``, default all, get gradients), then
    backward from seeded head gradients: the JAX block through
    :func:`_jax_recorded`, the port's under ``autograd.record()``.
    Returns two dicts (port, JAX) of numpy arrays: each output
    ``out{i}``, each input gradient ``dx{i}``, each parameter's gradient
    ``grad:{name}`` and each parameter and running statistic after the
    pass ``{name}``."""
    idx = list(range(len(inputs)) if grad_inputs is None else grad_inputs)
    (heads, jouts, aux_new, g_tr, g_dx), trainable, aux = _jax_recorded(
        jblock, inputs, idx, seed)
    txs = [None if a is None else torch.from_numpy(a.copy())
           for a in inputs]
    for i in idx:
        txs[i].requires_grad_()
    with tmx.autograd.record():
        touts = _outputs(tblock(*txs))
    torch.autograd.backward(touts, [torch.from_numpy(h) for h in heads])
    got = {f"out{i}": o.detach().numpy() for i, o in enumerate(touts)}
    want = {f"out{i}": np.asarray(o) for i, o in enumerate(jouts)}
    for k, i in enumerate(idx):
        got[f"dx{i}"] = txs[i].grad.numpy()
        want[f"dx{i}"] = np.asarray(g_dx[k])
    names = {id(p): n for n, p in jblock._structural_names().items()}
    tparams = tblock.collect_params()
    for p, g in zip(trainable, g_tr):
        name = names[id(p)]
        got[name] = tparams[name].detach().numpy()
        want[name] = p.data().asnumpy()
        got[f"grad:{name}"] = tparams[name].grad.numpy()
        want[f"grad:{name}"] = np.asarray(g)
    for p, a in zip(aux, aux_new):
        name = names[id(p)]
        got[name] = tparams[name].detach().numpy()
        want[name] = np.asarray(a)
    return got, want


def assert_close_of_max(got, want, rtol):
    """Every array of ``want`` (a dict) matched by ``got``'s within
    ``rtol`` of its max |value| (an all-zero array exactly)."""
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                                   err_msg=key)


def jitted_logits(jnet, tnet, x):
    """Predict-mode outputs of both networks on the numpy batch ``x``, the
    JAX network's forward as one jitted program over
    ``functional_apply`` (one XLA compile instead of one per op)."""
    import jax
    from mxnet_tpu.gluon.block import functional_apply
    trainable, aux = jnet._param_split()
    run = jax.jit(lambda t, a, x: functional_apply(
        jnet, jax.random.key(0), t, a, [x], training=False)[0][0])
    want = np.asarray(run([p.data()._data for p in trainable],
                          [p.data()._data for p in aux], x))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    return got, want


_LOSS_PROGRAMS = {}


def jax_recorded_loss(jnet, jloss, x, label, output=0):
    """The JAX package's eager ``with autograd.record(): l =
    jloss(jnet(x)[output], label)`` then ``l.backward()``, as one jitted
    program over ``functional_apply`` (op by op the JAX side compiles
    each op and each op's VJP, minutes for a ResNet): the per-sample
    loss, the BatchNorm statistics and every trainable parameter's
    gradient from a head gradient of ones, written where the eager pass
    writes them (the statistics into the auxiliary parameters, the
    gradients into the parameters' gradient buffers, which
    ``Trainer.step`` reads). ``x`` and ``label`` are jnp arrays. Returns
    the per-sample loss as numpy; the program is built at the net's
    first call and reused."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.gluon.block import functional_apply
    trainable, aux = jnet._param_split()
    key = (id(jnet), id(jloss), output)
    prog = _LOSS_PROGRAMS.get(key)
    if prog is None:
        def run(tr, ax, xs, ys):
            def f(tr):
                outs, _, aux_new = functional_apply(
                    jnet, jax.random.key(0), tr, ax, [xs], training=True)
                wrap = [jmx.nd.NDArray(a, ctx=jmx.cpu(),
                                       _skip_device_put=True)
                        for a in (outs[output], ys)]
                return jloss(*wrap)._data, aux_new
            loss, vjp, aux_new = jax.vjp(f, tr, has_aux=True)
            (grads,) = vjp(jnp.ones_like(loss))
            return loss, aux_new, grads
        prog = _LOSS_PROGRAMS[key] = jax.jit(run)
    loss, aux_new, grads = prog([p.data()._data for p in trainable],
                                [p.data()._data for p in aux], x, label)
    for p, a in zip(aux, aux_new):
        p._data[0]._rebind(a)
    for p, g in zip(trainable, grads):
        p._grad[0]._rebind(g)
    return np.asarray(loss)

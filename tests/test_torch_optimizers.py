"""The port's optimizers (mxnet_tpu_torch/optimizer/, ops/optimizer_op.py)
against the JAX package's, on the same numpy inputs, on the CPU.

- Each update rule of ``ops.optimizer_op`` the slice adds (NAG, AdamW,
  LAMB's two phases, RMSProp, FTRL, AdaGrad, signSGD, the ``mp_`` SGD
  pair) against the JAX op: within 1e-6 of max |value|, with ``lr``
  and LAMB's ``t`` as numbers and as 0-d tensors, and LAMB's bias
  corrections given in place of ``t``.
- ``Optimizer``'s lr and wd lookup (scheduler, ``param_dict``,
  ``set_lr_mult`` / ``set_wd_mult`` by index and by name), its
  ``learning_rate`` and ``set_learning_rate`` under a scheduler, and
  ``begin_num_update``: equal to the JAX package's.
- Each of the 14 registered optimizers through the eager
  ``gluon.Trainer`` and the 13 with a functional rule through
  ``parallel.ShardedTrainer``, 3 steps of a two-layer MLP on one batch,
  with a ``PolyScheduler`` (warm-up, then decay), ``wd`` 1e-3,
  ``clip_gradient`` 0.1 and the multipliers lr 2 (first weight), wd 0
  (first bias), wd 2 (second weight) and lr 0 (second bias; 0.5 for
  FTRL and FTML, whose rules divide by the lr and give NaN at 0 in both
  packages): the loss
  within 1e-5 relative and every weight and state within 1e-5 of max
  |value| after each step, for every optimizer (none needs more, those
  that divide by a small accumulator included).
- SGLD: with its noise taken out in both packages, the update equal
  within 1e-5; its noise, drawn from the device's ``mx.random``
  generator, of mean 0 and variance lr within 5 standard errors.
- The multipliers reach ``ShardedTrainer`` by trainable index at the
  first step, as in the reference; with a warm-up from lr 0 the
  reference's quotient freezes every lr at 0 and the port's does not
  (``parallel/sharded.py`` ``_lr_mult``).
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jpar
from mxnet_tpu.ops import optimizer_op as jops
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.ops import optimizer_op as tops

BATCH = 8
HYPER = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9},
    "nag": {"learning_rate": 0.1, "momentum": 0.9},
    "adam": {"learning_rate": 0.01},
    "adamw": {"learning_rate": 0.01},
    "lamb": {"learning_rate": 0.01},
    "rmsprop": {"learning_rate": 0.01},
    "adagrad": {"learning_rate": 0.1},
    "ftrl": {"learning_rate": 0.1},
    "signum": {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 0.01},
    "sgld": {"learning_rate": 0.01},
    "adadelta": {"rho": 0.9},
    "nadam": {"learning_rate": 0.01},
    "dcasgd": {"learning_rate": 0.1, "momentum": 0.9},
    "ftml": {"learning_rate": 0.01},
}
FUNCTIONAL = [k for k in HYPER if k != "sgld"]
# structural name -> (lr_mult, wd_mult)
MULTS = {"0.weight": (2.0, 1.0), "0.bias": (1.0, 0.0),
         "1.weight": (1.0, 2.0), "1.bias": (0.0, 1.0)}
DIVIDE_BY_LR = ("ftrl", "ftml")        # lr 0 gives NaN in both packages


def _mults(name):
    if name not in DIVIDE_BY_LR:
        return MULTS
    return dict(MULTS, **{"1.bias": (0.5, 1.0)})


def _np(t):
    return t.detach().float().numpy()


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# -- update rules --------------------------------------------------------------
def _op_cases():
    rng = np.random.RandomState(0)
    w, g, m, v = (_rand(rng, 5, 7) for _ in range(4))
    v = np.abs(v)
    kw = dict(lr=0.05, wd=1e-2, rescale_grad=0.5, clip_gradient=0.8)
    return {
        "nag": ("_nag_mom_update", (w, g, m), dict(kw, momentum=0.9)),
        "adamw": ("_adamw_update", (w, g, m, v),
                  dict(kw, beta1=0.8, beta2=0.95, epsilon=1e-6, eta=0.7)),
        "lamb1": ("_lamb_phase1", (w, g, m, v),
                  dict(beta1=0.8, beta2=0.95, epsilon=1e-6, t=3,
                       bias_correction=True, wd=1e-2, rescale_grad=0.5,
                       clip_gradient=0.8)),
        "lamb2": ("_lamb_phase2", (w, g, np.float32(2.5), np.float32(0.7)),
                  dict(lr=0.05, lower_bound=3.0, upper_bound=10.0)),
        "rmsprop": ("_rmsprop_update", (w, g, v),
                    dict(kw, gamma1=0.9, epsilon=1e-8)),
        "ftrl": ("_ftrl_update", (w, g, m, v),
                 dict(kw, lamda1=0.3, beta=1.0)),
        "adagrad": ("_adagrad_update", (w, g, v), dict(kw, epsilon=1e-7)),
        "signsgd": ("_signsgd_update", (w, g), kw),
        "mp_sgd": ("_mp_sgd_update", (w.astype(np.float16), g, w), kw),
        "mp_sgd_mom": ("_mp_sgd_mom_update",
                       (w.astype(np.float16), g, m, w),
                       dict(kw, momentum=0.9)),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
@pytest.mark.parametrize("scalars", ["numbers", "tensors"])
def test_update_rules_match_jax(case, scalars):
    """One update, out of place, against the JAX op; the in-place form
    writes the same values into its arguments."""
    import jax.numpy as jnp
    name, args, kw = _op_cases()[case]
    want = getattr(jops, name)(*[jnp.asarray(a) for a in args], **kw)
    want = want if isinstance(want, tuple) else (want,)
    tkw = dict(kw)
    if scalars == "tensors":
        for k in ("lr", "t", "rescale_grad"):
            if k in tkw:
                tkw[k] = torch.tensor(float(tkw[k]))
    targs = [torch.from_numpy(np.array(a)) for a in args]
    got = getattr(tops, name)(*targs, **tkw)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        w = w.astype(np.float32)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
    public = {"_nag_mom_update": "nag_mom_update",
              "_rmsprop_update": "rmsprop_update",
              "_adagrad_update": "adagrad_update",
              "_ftrl_update": "ftrl_update",
              "_adamw_update": "adamw_update"}.get(name)
    if public:
        getattr(tops, public)(*targs, **tkw)
        written = [targs[0]] + targs[2:]       # the weight and the state
        for t, g in zip(written, got):
            assert torch.equal(t, g)


def test_lamb_phase1_takes_the_step_corrections():
    """``corrections=(1 - beta1 ** t, 1 - beta2 ** t)``, computed once
    per step by ``ShardedTrainer`` for every weight, gives LAMB's first
    phase bit for bit as ``t`` does, and the JAX op's within 1e-6."""
    import jax.numpy as jnp
    _, args, kw = _op_cases()["lamb1"]
    want = jops._lamb_phase1(*[jnp.asarray(a) for a in args], **kw)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    t = torch.tensor(float(kw["t"]))
    by_t = tops._lamb_phase1(*targs, **dict(kw, t=t))
    given = tops._lamb_phase1(*targs, **dict(
        kw, t=None, corrections=(1 - kw["beta1"] ** t,
                                 1 - kw["beta2"] ** t)))
    for a, b, w in zip(by_t, given, want):
        assert torch.equal(a, b)
        w = np.asarray(w)
        np.testing.assert_allclose(_np(b), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


# -- the Optimizer's lookup ----------------------------------------------------
def test_optimizer_lr_and_wd_lookup_match_jax():
    """``_get_lr`` / ``_get_wd`` through the scheduler, ``param_dict``
    (attributes), index and name tables; ``learning_rate`` following the
    scheduler; ``set_learning_rate`` refused under it; the update count
    starting at ``begin_num_update``."""

    class P:                                   # a parameter's attributes
        def __init__(self, lr_mult, wd_mult):
            self.lr_mult, self.wd_mult = lr_mult, wd_mult

    def build(pkg):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = pkg.optimizer.create(
            "sgd", learning_rate=0.4, wd=0.1, lr_scheduler=sched,
            param_idx2name={3: "w3", 4: "w4"}, begin_num_update=5,
            param_dict={0: P(2.0, 0.0)})
        opt.set_lr_mult({1: 3.0, "w3": 0.5})
        opt.set_wd_mult({2: 4.0, "w4": 0.25})
        return opt

    jopt, topt = build(jmx), build(tmx)
    assert topt.lr_scheduler.base_lr == jopt.lr_scheduler.base_lr == 0.4
    for opt in (jopt, topt):
        opt._update_count(0)
        opt._update_count(0)
    assert topt.num_update == jopt.num_update == 7
    assert topt.learning_rate == jopt.learning_rate
    for i in range(6):
        assert topt._get_lr(i) == jopt._get_lr(i), i
        assert topt._get_wd(i) == jopt._get_wd(i), i
    with pytest.raises(MXNetError, match="lr_scheduler"):
        topt.set_learning_rate(0.1)
    plain = tmx.optimizer.create("sgd", learning_rate=0.3)
    plain.set_learning_rate(0.2)
    assert plain.learning_rate == plain._get_lr(0) == 0.2


def test_multi_precision_keeps_an_fp32_master():
    """``multi_precision`` with a bf16 weight: the state holds the fp32
    master, updated in fp32 (equal to an fp32 weight's update), and the
    weight is the master rounded."""
    rng = np.random.RandomState(1)
    w, g = _rand(rng, 4, 6), _rand(rng, 4, 6)
    opt = tmx.optimizer.create("adam", learning_rate=0.1,
                               multi_precision=True)
    ref = tmx.optimizer.create("adam", learning_rate=0.1)
    upd, ref_upd = (tmx.optimizer.get_updater(o) for o in (opt, ref))
    low = torch.from_numpy(w).bfloat16()
    w32 = low.float()
    for _ in range(2):
        upd(0, torch.from_numpy(g).bfloat16(), low)
        ref_upd(0, torch.from_numpy(g).bfloat16().float(), w32)
    (_, _), master = upd.states[0]
    assert master.dtype == torch.float32 and low.dtype == torch.bfloat16
    assert torch.equal(master, w32)
    assert torch.equal(low, w32.bfloat16())


# -- the trainers --------------------------------------------------------------
def _pair():
    """(jax net, port net, x, y): a two-layer MLP with one set of
    weights, and one batch."""
    jnet = jgluon.nn.HybridSequential()
    jnet.add(jgluon.nn.Dense(8, in_units=6, activation="relu"),
             jgluon.nn.Dense(4, in_units=8))
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tmx.gluon.nn.Dense(8, in_units=6, activation="relu"),
             tmx.gluon.nn.Dense(4, in_units=8))
    rng = np.random.RandomState(3)
    arrays = {k: (0.5 * rng.randn(*p.shape)).astype(np.float32)
              for k, p in jnet._structural_names().items()}
    for k, p in jnet._structural_names().items():
        p.set_data(jmx.nd.array(arrays[k]))
    load_jax_params(tnet, arrays, ctx=tmx.cpu())
    x, y = _rand(rng, BATCH, 6), _rand(rng, BATCH, 4)
    return jnet, tnet, x, y


def _params(name, pkg):
    lr = HYPER[name].get("learning_rate", 1.0)
    sched = pkg.lr_scheduler.PolyScheduler(
        max_update=10, pwr=1, warmup_steps=2, warmup_begin_lr=lr / 4)
    return dict(HYPER[name], wd=1e-3, clip_gradient=0.1, lr_scheduler=sched)


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _jax_weights(jnet):
    return {k: p.data().asnumpy() for k, p in jnet._structural_names().items()}


def _port_weights(tnet):
    return {k: _np(v) for k, v in tnet.collect_params().items()}


def _zero_noise(monkeypatch):
    """SGLD without its noise in both packages."""
    from mxnet_tpu import ndarray as jnd
    from mxnet_tpu_torch.optimizer import optimizer as topt
    monkeypatch.setattr(jnd.random, "normal",
                        lambda loc, scale, shape, ctx=None, **kw:
                        jnd.zeros(shape))
    monkeypatch.setattr(topt, "_sgld_noise",
                        lambda weight, lr: torch.zeros_like(weight))


@pytest.mark.parametrize("name", sorted(HYPER))
def test_eager_trainer_matches_jax(name, monkeypatch):
    """Three ``gluon.Trainer`` steps, the multipliers set as parameter
    attributes (``collect_params(name).setattr``) in both packages."""
    if name == "sgld":
        _zero_noise(monkeypatch)
    jnet, tnet, x, y = _pair()
    for key, (lr_mult, wd_mult) in _mults(name).items():
        jp = jnet._structural_names()[key]
        jp.lr_mult, jp.wd_mult = lr_mult, wd_mult
        sel = tnet.collect_params(key.replace(".", r"\.") + "$")
        sel.setattr("lr_mult", lr_mult)
        sel.setattr("wd_mult", wd_mult)
    jtr = jgluon.Trainer(jnet.collect_params(), name, _params(name, jmx))
    ttr = tmx.gluon.Trainer(tnet.collect_params(), name, _params(name, tmx))
    jl, tl = jgluon.loss.L2Loss(), tmx.gluon.loss.L2Loss()
    jx, jy = jmx.nd.array(x), jmx.nd.array(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for step in range(3):
        with jmx.autograd.record():
            jloss = jl(jnet(jx), jy)
        jloss.backward()
        jtr.step(BATCH)
        with tmx.autograd.record():
            tloss = tl(tnet(tx), ty)
        tmx.autograd.backward(tloss)
        ttr.step(BATCH)
        assert float(tloss.detach().mean()) == pytest.approx(
            float(jloss.mean().asnumpy()), rel=1e-5)
        want, got = _jax_weights(jnet), _port_weights(tnet)
        for k in want:
            _close(got[k], want[k], 1e-5, f"{name} step {step} {k}")
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 3


def _sharded(name, pkg, net, mesh):
    tr = pkg.parallel.ShardedTrainer(
        net, pkg.gluon.loss.L2Loss(), name, _params(name, pkg), mesh=mesh)
    mults = list(_mults(name).values())
    tr._optimizer.set_lr_mult({i: m[0] for i, m in enumerate(mults)})
    tr._optimizer.set_wd_mult({i: m[1] for i, m in enumerate(mults)})
    return tr


def _jax_mesh():
    return jpar.make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])


def _port_mesh():
    return tpar.make_mesh({"data": 1, "model": 1}, devices=[tmx.cpu()])


@pytest.mark.parametrize("name", FUNCTIONAL)
def test_sharded_trainer_matches_jax(name):
    """Three ``ShardedTrainer`` steps (the functional rules), the
    multipliers set by trainable index with ``set_lr_mult`` /
    ``set_wd_mult``: the losses, the weights and the optimizer state."""
    jnet, tnet, x, y = _pair()
    jtr = _sharded(name, jmx, jnet, _jax_mesh())
    ttr = _sharded(name, tmx, tnet, _port_mesh())
    for step in range(3):
        jloss = float(jtr.step(x, y).asnumpy())
        tloss = float(ttr.step(x, y))
        assert tloss == pytest.approx(jloss, rel=1e-5), step
        want, got = _jax_weights(jnet), _port_weights(tnet)
        for k in want:
            _close(got[k], want[k], 1e-5, f"{name} step {step} {k}")
        for i, (js, ts) in enumerate(zip(jtr._states, ttr._states)):
            assert len(js) == len(ts)
            for j, (a, b) in enumerate(zip(js, ts)):
                _close(_np(b), np.asarray(a, np.float32), 1e-5,
                       f"{name} step {step} state {i}:{j}")
    assert [n for n, _ in ttr._named] == list(MULTS)
    assert ttr.num_update == jtr.num_update == 3


def test_sgld_noise_and_deterministic_part():
    """SGLD's update minus its noise equals the reference's formula;
    the noise (a weight with zero gradient and wd 0) has mean 0 and
    variance lr within 5 standard errors, and ``mx.random.seed``
    repeats it."""
    lr, n = 0.04, 1 << 14
    w0 = torch.zeros(n)

    def noise(seed):
        tmx.random.seed(seed)
        w = w0.clone()
        upd = tmx.optimizer.get_updater(tmx.optimizer.create(
            "sgld", learning_rate=lr))
        upd(0, torch.zeros(n), w)
        return w

    a, b, c = noise(5), noise(5), noise(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    mean, var = float(a.mean()), float(a.var())
    assert abs(mean) <= 5 * np.sqrt(lr / n)
    assert abs(var - lr) <= 5 * lr * np.sqrt(2.0 / n)

    rng = np.random.RandomState(2)
    w, g = _rand(rng, 3, 5), _rand(rng, 3, 5)
    opt = tmx.optimizer.create("sgld", learning_rate=lr, wd=0.1,
                               rescale_grad=0.5, clip_gradient=0.3)
    tmx.random.seed(7)
    got = torch.from_numpy(w.copy())
    opt.update(0, got, torch.from_numpy(g), None)
    tmx.random.seed(7)
    drawn = tmx.optimizer.optimizer._sgld_noise(torch.from_numpy(w), lr)
    want = w - lr / 2 * (np.clip(g * 0.5, -0.3, 0.3) + 0.1 * w)
    np.testing.assert_allclose(_np(got - drawn), want, rtol=0, atol=1e-6)


def test_sharded_multipliers_by_index_and_warmup_from_zero():
    """A parameter's ``wd_mult`` attribute alone does not reach a
    ``ShardedTrainer`` (in both packages); ``set_wd_mult`` by index
    does. With a warm-up from lr 0 the reference divides ``_get_lr(i)``
    by a learning rate of 0 at its first step and every lr stays 0, so
    its weights never move; the port takes the multiplier itself and
    follows the schedule."""
    jnet, tnet, x, y = _pair()
    tnet.collect_params(r"0\.bias$").setattr("wd_mult", 0.0)
    ttr = tpar.ShardedTrainer(tnet, tmx.gluon.loss.L2Loss(), "sgd",
                              {"learning_rate": 0.1, "wd": 0.5},
                              mesh=_port_mesh())
    ttr.step(x, y)
    assert ttr._hyper[0] == [0.5] * 4
    ttr = tpar.ShardedTrainer(tnet, tmx.gluon.loss.L2Loss(), "sgd",
                              {"learning_rate": 0.1, "wd": 0.5},
                              mesh=_port_mesh())
    ttr._optimizer.set_wd_mult({1: 0.0})
    ttr.step(x, y)
    assert ttr._hyper[0] == [0.5, 0.0, 0.5, 0.5]

    jnet, tnet, x, y = _pair()
    start = _jax_weights(jnet)
    trainers = []
    for pkg, net, mesh in ((jmx, jnet, _jax_mesh()),
                           (tmx, tnet, _port_mesh())):
        sched = pkg.lr_scheduler.PolyScheduler(max_update=10, pwr=1,
                                               warmup_steps=4)
        trainers.append(pkg.parallel.ShardedTrainer(
            net, pkg.gluon.loss.L2Loss(), "sgd",
            {"learning_rate": 0.1, "lr_scheduler": sched}, mesh=mesh))
    for _ in range(2):
        for tr in trainers:
            tr.step(x, y)
    for k, w in _jax_weights(jnet).items():
        np.testing.assert_array_equal(w, start[k])
    moved = [float(np.abs(_np(p) - start[k]).max())
             for k, p in tnet.collect_params().items()]
    assert min(moved) > 0


@pytest.mark.parametrize("event", ["deferred", "load_dict", "cast",
                                   "reinit"])
def test_multipliers_survive_the_parameter_lifecycle(event):
    """``collect_params(select).setattr`` on a layer whose shapes are
    still to infer: the attributes survive the first forward's
    materialization, a ``load_dict`` that rebinds the uninitialized
    parameters to the load device, ``Block.cast`` and a second
    ``initialize(force_reinit=True)`` before the first forward (which
    replaces the uninitialized parameters again), and reach the
    optimizer through ``gluon.Trainer``."""
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(5), tmx.gluon.nn.Dense(2))
    assert net[0].weight.lr_mult == net[0].weight.wd_mult == 1.0
    net.collect_params(r".*bias$").setattr("wd_mult", 0.0)
    net.collect_params(r"1\.weight$").setattr("lr_mult", 3.0)
    if event == "load_dict":
        rng = np.random.RandomState(0)
        net.load_dict({"0.weight": _rand(rng, 5, 4), "0.bias": _rand(rng, 5),
                       "1.weight": _rand(rng, 2, 5), "1.bias": _rand(rng, 2)},
                      ctx=tmx.cpu())
    else:
        net.initialize(ctx=tmx.cpu(), generator=tmx.random.generator(0))
        if event == "reinit":
            net.initialize(ctx=tmx.cpu(), generator=tmx.random.generator(1),
                           force_reinit=True)
        net(torch.zeros(3, 4))
    if event == "cast":
        net.cast("bfloat16")
    params = net.collect_params()
    assert not any(isinstance(p, torch.nn.UninitializedParameter)
                   for p in params.values())
    assert {k: (p.lr_mult, p.wd_mult) for k, p in params.items()} == {
        "0.weight": (1.0, 1.0), "0.bias": (1.0, 0.0),
        "1.weight": (3.0, 1.0), "1.bias": (1.0, 0.0)}
    opt = tmx.gluon.Trainer(params, "sgd", {"learning_rate": 0.5,
                                            "wd": 0.1}).optimizer
    assert [opt._get_lr(i) for i in range(4)] == [0.5, 0.5, 1.5, 0.5]
    assert [opt._get_wd(i) for i in range(4)] == [0.1, 0.0, 0.1, 0.0]

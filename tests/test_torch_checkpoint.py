"""The checkpoint family of the port's trainers (parallel/sharded.py,
parallel/_ckpt.py, elastic/reshard.py, gluon/trainer.py, the optimizer's
``Updater`` states, rollback under ``GuardConfig(ckpt_root=)``) against
the JAX package's, on the CPU, with a narrow MLP (Dense, BatchNorm,
Dropout, Dense).

- ``ShardedTrainer``: save at step k, a fresh trainer (other seed, other
  weights) loads, and steps k+1..k+3 are bit-equal to an uninterrupted
  run, dropout included (the generator's state is in the meta), for SGD
  with momentum, Adam with bf16 masters, and LAMB with a scheduler and
  ``guard=`` in ``run_steps`` windows; every live tensor keeps its
  ``data_ptr()`` across the load.
- A JAX ``ShardedTrainer`` checkpoint (no dropout) loads into the port
  bit for bit (the JAX key is left alone and journaled), and the port's
  next step matches JAX's next step within 1e-5 of max |value|; the JAX
  ``nd.load`` reads the port's pair with the reference's meta keys and
  values.
- A per-shard checkpoint of the JAX package's 8-device CPU mesh (the
  head Dense sharded over "model") loads through
  ``load_checkpoint_resharded``, bit-equal; the layout-locked load
  refuses it as the reference does.
- The error paths (optimizer, master_dtype, state arity, missing entry,
  wrong shape, a file without meta) raise the reference's messages; each
  of the 13 functional optimizers keeps the reference's state arity.
- ``gluon.Trainer``: ``save_states``/``load_states`` (with
  ``save_parameters``) and ``checkpoint``/``restore`` resume bit-equal;
  ``Updater.get_states``/``set_states`` round-trip bf16 states bit for
  bit and the pickled optimizer carries what the reference's carries,
  and no tensor.
- Rollback in both trainers against the JAX trainers: the same restored
  step, lr after the backoff and ``divergence_rollback`` record, and the
  next step's loss within 1e-5.
"""
import json
import pickle

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.diagnostics import journal as jjournal
from mxnet_tpu.guardrails.monitor import GuardConfig as JGuard
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.diagnostics import journal as tjournal
from mxnet_tpu_torch.guardrails.monitor import GuardConfig as TGuard

IN, HIDDEN, CLASSES, BATCH = 5, 8, 3, 6
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}


def _build(pkg, hidden=HIDDEN, dropout=0.0, extra=False):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(hidden, in_units=IN, activation="relu"),
            pkg.gluon.nn.BatchNorm(in_channels=hidden))
    if dropout:
        net.add(pkg.gluon.nn.Dropout(dropout))
    net.add(pkg.gluon.nn.Dense(CLASSES, in_units=hidden))
    if extra:
        net.add(pkg.gluon.nn.Dense(CLASSES, in_units=CLASSES))
    return net


def _port_net(seed, **kw):
    return _build(tmx, **kw).initialize(
        ctx=tmx.cpu(), generator=tmx.random.generator(seed))


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [((2 * rng.randn(BATCH, IN)).astype(np.float32),
             rng.randint(0, CLASSES, (BATCH,))) for _ in range(n)]


def _port_mesh():
    return tpar.make_mesh({"data": 1, "model": 1}, devices=[tmx.cpu()])


def _jax_mesh():
    return jpar.make_mesh({"data": 1, "model": 1}, devices=jax.devices()[:1])


def _live(tr):
    return {**tr._param_entries(), **tr._state_entries()}


def _snap(tr):
    return {k: v.detach().clone() for k, v in _live(tr).items()}


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# -- the port's own resume, bit for bit ------------------------------------------
RESUME = {
    "sgd_momentum": dict(opt="sgd", params=SGD, kw={}),
    "adam_bf16_masters": dict(opt="adam", params={"learning_rate": 1e-2},
                              kw=dict(compute_dtype="bfloat16",
                                      master_dtype="bfloat16")),
    "lamb_guard_run_steps": dict(opt="lamb", params={
        "learning_rate": 1e-2, "wd": 0.01}, kw={}),
}


def _resume_trainer(case, seed):
    cfg = RESUME[case]
    params, kw = dict(cfg["params"]), dict(cfg["kw"])
    if case == "lamb_guard_run_steps":
        params["lr_scheduler"] = tmx.lr_scheduler.PolyScheduler(
            max_update=100, base_lr=1e-2, pwr=1, warmup_steps=3)
        kw["guard"] = TGuard(clip_norm=1.0)
    return tpar.ShardedTrainer(
        _port_net(seed, dropout=0.3),
        tmx.gluon.loss.SoftmaxCrossEntropyLoss(), cfg["opt"], params,
        mesh=_port_mesh(), **kw)


def _advance(tr, case, batches):
    if case == "lamb_guard_run_steps":
        return [float(tr.run_steps(*b, num_steps=3)) for b in batches]
    return [float(tr.step(*b)) for b in batches]


@pytest.mark.parametrize("case", sorted(RESUME))
def test_port_resume_is_bit_equal(tmp_path, case):
    batches = _batches(5)
    root, prefix = str(tmp_path / "ckpt"), str(tmp_path / "pair")
    tmx.random.seed(7)
    a = _resume_trainer(case, 0)
    _advance(a, case, batches[:2])
    k = a.num_update
    if case == "sgd_momentum":
        assert a.checkpoint(root, keep_last=2) == k
    else:
        a.save_checkpoint(prefix)
    want_losses = _advance(a, case, batches[2:])
    want = _snap(a)

    tmx.random.seed(999)       # the resumed run must not read the seed
    b = _resume_trainer(case, 1)
    b.prepare(batches[0][0])
    ptrs = {n: t.data_ptr() for n, t in _live(b).items()}
    if case == "sgd_momentum":
        assert b.restore(root) == k
    else:
        b.load_checkpoint(prefix)
    assert b.num_update == k
    assert {n: t.data_ptr() for n, t in _live(b).items()} == ptrs
    assert _advance(b, case, batches[2:]) == want_losses
    _equal(_snap(b), want)
    if case == "adam_bf16_masters":     # BatchNorm's statistics stay fp32
        assert all(t.dtype == torch.bfloat16 for n, t in _live(b).items()
                   if not n.startswith("aux:"))


# -- JAX checkpoints into the port, the port's pair into JAX's nd.load ----------
def _pair_of_trainers(opt="sgd", params=SGD, jkw=None, tkw=None):
    """A JAX and a port ``ShardedTrainer`` of one MLP (no dropout) with
    the same weights and BatchNorm statistics."""
    jnet, tnet = _build(jmx), _build(tmx)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    rng = np.random.RandomState(4)
    arrays = {k: (rng.rand(*p.shape) + 0.5 if k.endswith("var")
                  else 0.5 * rng.randn(*p.shape)).astype(np.float32)
              for k, p in jnet._structural_names().items()}
    for k, p in jnet._structural_names().items():
        p.set_data(jmx.nd.array(arrays[k]))
    load_jax_params(tnet, arrays, ctx=tmx.cpu())
    jtr = jpar.ShardedTrainer(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=_jax_mesh(), **(jkw or {}))
    ttr = tpar.ShardedTrainer(
        tnet, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=_port_mesh(), **(tkw or {}))
    return jtr, ttr


def _jax_live(jtr):
    out = {f"arg:{jtr._struct_name(p)}": np.asarray(p._data[0]._data)
           for p in jtr._trainable}
    out.update((f"aux:{jtr._struct_name(p)}", np.asarray(p._data[0]._data))
               for p in jtr._aux)
    for p, st in zip(jtr._trainable, jtr._states):
        for j, s in enumerate(st):
            out[f"state:{jtr._struct_name(p)}:{j}"] = np.asarray(s)
    return out


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jtr, ttr = _pair_of_trainers()
    batches = _batches(3, seed=2)
    for x, y in batches[:2]:
        jtr.step(x, y)
    prefix = str(tmp_path / "jax")
    jtr.save_checkpoint(prefix)
    saved = _jax_live(jtr)
    jloss = float(jtr.step(*batches[2]).asnumpy())

    ttr.prepare(batches[0][0])
    journal = tjournal.reset_journal("off")
    try:
        ttr.load_checkpoint(prefix)
        kinds = [r["kind"] for r in journal.recent()]
    finally:
        tjournal.reset_journal()
    assert "rng_not_restored" in kinds and ttr.num_update == 2
    live = _live(ttr)
    assert set(live) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(live[k].detach().numpy(), v, k)
    tloss = float(ttr.step(*batches[2]))
    assert tloss == pytest.approx(jloss, rel=1e-5)
    after = _jax_live(jtr)
    for k, v in _live(ttr).items():
        want = after[k]
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(v.detach().numpy() - want).max()) \
            <= 1e-5 * scale, k


def test_jax_nd_load_reads_the_ports_pair(tmp_path):
    jtr, ttr = _pair_of_trainers()
    x = _batches(1)[0][0]
    jtr.prepare(x)
    ttr.prepare(x)
    jtr.save_checkpoint(str(tmp_path / "jax"))
    ttr.save_checkpoint(str(tmp_path / "port"))
    for suffix in (".params", ".states"):
        jfile = jmx.nd.load(str(tmp_path / "jax") + suffix)
        tfile = jmx.nd.load(str(tmp_path / "port") + suffix)
        assert set(tfile) == set(jfile)
        jmeta, tmeta = (json.loads(bytes(f["__meta__"].asnumpy()).decode())
                        for f in (jfile, tfile))
        assert set(tmeta) == set(jmeta)
        for key in ("format", "optimizer", "num_update", "master_dtype",
                    "state_arity", "per_shard", "shard_files"):
            assert tmeta[key] == jmeta[key], key
        for k in jfile:
            if k != "__meta__":
                np.testing.assert_array_equal(tfile[k].asnumpy(),
                                              jfile[k].asnumpy(), k)


def test_per_shard_jax_checkpoint_loads_resharded(tmp_path):
    """The JAX package's 8-device CPU mesh ({"data": 4, "model": 2}, the
    head Dense's weight split over "model"), saved per shard: one
    ``.shard<rank>`` file of ``name|index`` pieces."""
    mesh = jpar.make_mesh({"data": 4, "model": 2})
    jnet = _build(jmx, hidden=16)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jtr = jpar.ShardedTrainer(
        jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
        {"learning_rate": 1e-2}, mesh=mesh,
        param_rules=[(r"0\.weight", jpar.PartitionSpec("model", None))])
    rng = np.random.RandomState(1)
    x = rng.randn(8, IN).astype(np.float32)
    y = rng.randint(0, CLASSES, (8,))
    jtr.step(x, y)
    prefix = str(tmp_path / "sharded")
    jtr.save_checkpoint(prefix, per_shard=True)
    want = _jax_live(jtr)
    pieces = jmx.nd.load(prefix + ".params.shard0")
    assert any(k.startswith("arg:0.weight|0:8") for k in pieces)

    ttr = tpar.ShardedTrainer(
        _port_net(0, hidden=16), tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        "adam", {"learning_rate": 1e-2}, mesh=_port_mesh())
    ttr.prepare(x)
    with pytest.raises(MXNetError, match="mesh or sharding layout changed"):
        ttr.load_checkpoint(prefix)
    ttr.load_checkpoint_resharded(prefix)
    assert ttr.num_update == 1
    for k, v in _live(ttr).items():
        np.testing.assert_array_equal(v.detach().numpy(), want[k], k)


OPTIMIZERS = {"sgd": {"momentum": 0.9}, "nag": {"momentum": 0.9},
              "adam": {}, "adamw": {}, "lamb": {}, "rmsprop": {},
              "adagrad": {}, "ftrl": {}, "signum": {"momentum": 0.9},
              "adadelta": {}, "nadam": {}, "dcasgd": {"momentum": 0.9},
              "ftml": {}}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_state_arity_and_meta_match_jax(opt):
    """Each functional optimizer keeps as many state tensors per weight
    as the reference's, so a JAX ``.states`` meta passes the port's
    check; the meta's strings are the reference's."""
    jtr, ttr = _pair_of_trainers(opt, OPTIMIZERS[opt])
    x = _batches(1)[0][0]
    jtr.prepare(x)
    ttr.prepare(x)
    jmeta, tmeta = jtr._ckpt_meta(False), ttr._ckpt_meta(False)
    for key in ("optimizer", "state_arity", "master_dtype", "num_update"):
        assert tmeta[key] == jmeta[key], key
    ttr._check_states_meta(jmeta)


def _jax_net(**kw):
    net = _build(jmx, **kw)
    net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    return net


def _error_pair(pkg, case, tmp_path):
    """Save a checkpoint with SGD momentum in fp32, load it into a
    mismatched trainer of package ``pkg``; returns the error."""
    x = _batches(1)[0][0]
    is_jax = pkg == "jax"
    mods = (jmx, jpar) if is_jax else (tmx, tpar)

    def trainer(opt="sgd", params=SGD, **kw):
        net = _jax_net(**kw.pop("net", {})) if is_jax else \
            _port_net(0, **kw.pop("net", {}))
        tr = mods[1].ShardedTrainer(
            net, mods[0].gluon.loss.SoftmaxCrossEntropyLoss(), opt,
            dict(params), mesh=_jax_mesh() if is_jax else _port_mesh(), **kw)
        tr.prepare(x)
        return tr

    prefix = str(tmp_path / f"{pkg}-ck")
    trainer().save_checkpoint(prefix)
    loads = {
        "optimizer": lambda: trainer("adam", {}).load_states(
            prefix + ".states"),
        "master_dtype": lambda: trainer(
            compute_dtype="bfloat16", master_dtype="bfloat16").load_states(
            prefix + ".states"),
        "arity": lambda: trainer(params={"learning_rate": 0.1}).load_states(
            prefix + ".states"),
        "missing": lambda: trainer(net={"extra": True}).load_checkpoint(
            prefix),
        "shape": lambda: trainer(net={"hidden": 4}).load_checkpoint(prefix),
        "no_meta": lambda: trainer().load_states(prefix + "-plain.params"),
    }
    plain = {"w": np.ones(2, np.float32)}
    if is_jax:
        jmx.nd.save(prefix + "-plain.params",
                    {k: jmx.nd.array(v) for k, v in plain.items()})
    else:
        tmx.nd.save(prefix + "-plain.params", plain)
    err = JaxMXNetError if is_jax else MXNetError
    with pytest.raises(err) as info:
        loads[case]()
    return str(info.value).replace(f"{pkg}-ck", "ck")


@pytest.mark.parametrize("case", ["optimizer", "master_dtype", "arity",
                                  "missing", "shape", "no_meta"])
def test_error_paths_match_jax(tmp_path, case):
    assert _error_pair("port", case, tmp_path) == \
        _error_pair("jax", case, tmp_path)


# -- gluon.Trainer -----------------------------------------------------------------
def _gluon_run(net, tr, batches):
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in batches:
        with tmx.autograd.record():
            loss = loss_fn(net(torch.from_numpy(x)),
                           torch.from_numpy(y).long())
        tmx.autograd.backward(loss)
        tr.step(BATCH)
        losses.append(float(loss.detach().mean()))
    return losses


def _gluon_live(net, tr):
    out = dict(net.collect_params())
    for i, st in tr._updater.states.items():
        for j, s in enumerate(st if isinstance(st, tuple) else (st,)):
            out[f"state:{i}:{j}"] = s
    return out


def _gluon_state(net, tr):
    return {k: v.detach().clone() for k, v in _gluon_live(net, tr).items()}


@pytest.mark.parametrize("how", ["states", "checkpoint"])
def test_gluon_trainer_resume_is_bit_equal(tmp_path, how):
    batches = _batches(5, seed=3)

    def build(seed):
        net = _port_net(seed)
        return net, tmx.gluon.Trainer(net.collect_params(), "adam",
                                      {"learning_rate": 1e-2, "wd": 1e-3})

    net, tr = build(0)
    _gluon_run(net, tr, batches[:2])
    root = str(tmp_path / "ckpt")
    if how == "states":
        net.save_parameters(str(tmp_path / "net.params"))
        tr.save_states(str(tmp_path / "tr.states"))
    else:
        assert tr.checkpoint(root) == 2
    want_losses = _gluon_run(net, tr, batches[2:])
    want = _gluon_state(net, tr)

    net2, tr2 = build(1)
    _gluon_run(net2, tr2, batches[:1])       # live states to copy into
    ptrs = {k: v.data_ptr() for k, v in _gluon_live(net2, tr2).items()}
    if how == "states":
        net2.load_parameters(str(tmp_path / "net.params"))
        tr2.load_states(str(tmp_path / "tr.states"))
    else:
        assert tr2.restore(root) == 2
    assert {k: v.data_ptr() for k, v in _gluon_live(net2, tr2).items()} \
        == ptrs
    assert tr2.optimizer.num_update == 2
    assert _gluon_run(net2, tr2, batches[2:]) == want_losses
    _equal(_gluon_state(net2, tr2), want)


def test_updater_states_round_trip_and_carry_what_jax_carries():
    w = torch.linspace(-1, 1, 12, dtype=torch.bfloat16).reshape(3, 4)
    w.lr_mult, w.wd_mult = 0.5, 0.0
    sched = tmx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                               wd=1e-3, lr_scheduler=sched,
                               param_dict={0: w})
    opt.set_lr_mult({1: 2.0})
    opt._guard_lr_backoff = 0.25
    up = tmx.optimizer.get_updater(opt)
    for _ in range(3):
        up(0, torch.ones_like(w), w)
    blob = up.get_states(dump_optimizer=True)
    states, carried = pickle.loads(blob)
    assert not any(isinstance(v, torch.Tensor)
                   for v in vars(carried).values())
    assert carried.param_dict[0].lr_mult == 0.5

    other = tmx.optimizer.get_updater(
        tmx.optimizer.create("sgd", learning_rate=1.0, param_dict={0: w}))
    other.set_states(blob)
    assert other.optimizer.param_dict[0] is w
    assert other.states[0].dtype == torch.bfloat16
    assert torch.equal(other.states[0].view(torch.int16),
                       up.states[0].view(torch.int16))
    assert other.optimizer._get_lr(0) == opt._get_lr(0)
    assert other.optimizer._guard_lr_backoff == 0.25

    jopt = jmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                wd=1e-3, lr_scheduler=jmx.lr_scheduler
                                .FactorScheduler(step=2, factor=0.5))
    jopt.set_lr_mult({1: 2.0})
    jup = jmx.optimizer.get_updater(jopt)
    for _ in range(3):
        jup(0, jmx.nd.ones((3, 4)), jmx.nd.array(np.zeros((3, 4))))
    _, jcarried = pickle.loads(jup.get_states(dump_optimizer=True))
    skip = {"param_dict", "lr_scheduler", "_guard_lr_backoff"}
    assert {k: v for k, v in vars(carried).items() if k not in skip} == \
        {k: v for k, v in vars(jcarried).items() if k not in skip}
    assert vars(carried.lr_scheduler) == vars(jcarried.lr_scheduler)


# -- rollback ----------------------------------------------------------------------
def _gluon_rollback_trainer(pkg, guard):
    """A ``gluon.Trainer`` of the MLP with ``_pair_of_trainers``'
    weights; returns its step function (the mean loss) and itself."""
    is_jax = pkg is jmx
    net = _build(pkg)
    if is_jax:
        net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
        net.hybridize()                # two compiles instead of one per op
    else:
        net.initialize(ctx=tmx.cpu())
    names = net._structural_names() if is_jax else net.collect_params()
    rng = np.random.RandomState(4)
    arrays = {k: (rng.rand(*p.shape) + 0.5 if k.endswith("var")
                  else 0.5 * rng.randn(*p.shape)).astype(np.float32)
              for k, p in names.items()}
    if is_jax:
        for k, p in names.items():
            p.set_data(jmx.nd.array(arrays[k]))
    else:
        load_jax_params(net, arrays, ctx=tmx.cpu())
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(SGD),
                           guard=guard)
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()

    def step(x, y):
        if is_jax:
            with jmx.autograd.record():
                loss = loss_fn(net(jmx.nd.array(x)), jmx.nd.array(y))
            loss.backward()
            tr.step(BATCH, loss=loss)
            return float(loss.asnumpy().mean())
        with tmx.autograd.record():
            loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y))
        tmx.autograd.backward(loss)
        tr.step(BATCH, loss=loss)
        return float(loss.detach().mean())
    return step, tr


def _rollback_run(pkg, kind, root, jr_path):
    """Three steps, a checkpoint, two poisoned steps (the second rolls
    back), one clean step. Returns (committed step, lr after the
    rollback, rollback records, last loss)."""
    journal_mod = jjournal if pkg is jmx else tjournal
    guard = (JGuard if pkg is jmx else TGuard)(
        max_consecutive_skips=2, max_rollbacks=1, ckpt_root=root)
    if kind == "sharded":
        jtr, ttr = _pair_of_trainers(**{"jkw" if pkg is jmx else "tkw":
                                        {"guard": guard}})
        tr = jtr if pkg is jmx else ttr

        def step(x, y):
            loss = tr.step(x, y)
            return float(loss.asnumpy() if pkg is jmx else loss)
    else:
        step, tr = _gluon_rollback_trainer(pkg, guard)
    x, y = _batches(1, seed=5)[0]
    bad = x.copy()
    bad[0, 0] = np.inf
    journal_mod.reset_journal(jr_path)
    try:
        for _ in range(3):
            step(x, y)
        committed = tr.checkpoint(root)
        step(bad, y)
        step(bad, y)                   # the second skip rolls back
        lr = tr.learning_rate
        last = step(x, y)
    finally:
        journal_mod.reset_journal("off")
    with open(jr_path) as f:
        recs = [json.loads(line) for line in f]
    rb = [{k: v for k, v in r.items() if k not in ("ts", "up_s", "phase")}
          for r in recs if r["kind"] == "divergence_rollback"]
    return committed, lr, rb, last


@pytest.mark.parametrize("kind", ["sharded", "gluon"])
def test_rollback_matches_jax(tmp_path, kind):
    want = _rollback_run(jmx, kind, str(tmp_path / "jax-ckpt"),
                         str(tmp_path / "jax.jsonl"))
    got = _rollback_run(tmx, kind, str(tmp_path / "port-ckpt"),
                        str(tmp_path / "port.jsonl"))
    assert got[:3] == want[:3]
    assert got[0] == 3 and got[1] == pytest.approx(0.05)
    assert len(got[2]) == 1 and got[2][0]["restored_step"] == 3
    assert got[3] == pytest.approx(want[3], rel=1e-5)

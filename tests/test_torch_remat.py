"""``ShardedTrainer(remat=)`` in the port (mxnet_tpu_torch/parallel/
_remat.py) on a one-device CPU mesh: the narrow BERT MLM (2 layers, 64
units, S 16, Adam) and the narrow ResNet V1 of ``torch_parity.NARROW``
(batch 8, 32x32, seeded BatchNorm statistics, SGD momentum), fp32, one
step per policy.

- Against the JAX package's ``ShardedTrainer`` under the same policy
  (``jax.checkpoint``; the ResNet under ``"dots"``, BERT under
  ``"full"``), from the same converted weights, dropout off:
  the loss within 1e-5 relative, every weight and optimizer state within
  1e-4 of max |value|, the BatchNorm statistics within 1e-5.
- Against the port's own ``remat=None`` step from the same state and
  dropout seed (the port's models alone, seeded; BERT at dropout 0.1):
  bit-equal in the loss, every weight,
  the optimizer state and the BatchNorm statistics. This fails if the
  recompute draws new dropout bits, folds BatchNorm's batch statistics a
  second time, or reads the running mean after the fold. The recompute
  is seen to run: every block's forward runs twice under ``"full"``.
- ``run_steps(2)`` under remat equals two ``step()`` calls, bit for
  bit; so does the graph step on the CPU stand-in capture backend.
- An unknown policy raises the reference's message; a callable (a
  PyTorch selective-checkpoint policy) is accepted.
"""
import copy
import functools

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

import jax
import mxnet_tpu_torch as tmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as torch_resnet

from test_torch_hybridize import Stub
from test_torch_sharded import JaxMLM, PortMLM, _close, _jax_state, \
    _port_state
from torch_parity import NARROW, NARROW_BERT, bert_pair, narrow_pair

POLICIES = ["full", "dots", "dots_no_batch"]
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
ADAM = {"learning_rate": 1e-3}
RN_BATCH, RN_CLASSES = 8, 10
MLM_BATCH, MLM_SEQ, MLM_VOCAB = 4, 16, 100


def _models(model, dropout=0.0):
    """(jax block, port block, numpy batch) of ``model``, same weights."""
    if model == "resnet":
        jnet, tnet = narrow_pair(seed=3, classes=RN_CLASSES,
                                 in_shape=(RN_BATCH, 3, 32, 32))
        rng = np.random.RandomState(9)
        return jnet, tnet, (rng.randn(RN_BATCH, 3, 32, 32),
                            rng.randint(0, RN_CLASSES, (RN_BATCH,)))
    jnet, tnet, _ = bert_pair(seed=0, dropout=dropout, use_pooler=False,
                              use_classifier=False, vocab_size=MLM_VOCAB)
    ids = np.random.RandomState(1).randint(0, MLM_VOCAB, (MLM_BATCH, MLM_SEQ))
    return JaxMLM(jnet), PortMLM(tnet), (ids, ids)


def _port_trainer(block, model, remat):
    opt, params = ("sgd", SGD) if model == "resnet" else ("adam", ADAM)
    return tpar.ShardedTrainer(
        block, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=tpar.make_mesh({"data": 1, "model": 1}, devices=[tmx.cpu()]),
        remat=remat)


def _stats_and_rest(state):
    stats = {k: v for k, v in state.items()
             if k.endswith(("running_mean", "running_var"))}
    return stats, {k: v for k, v in state.items() if k not in stats}


@pytest.mark.parametrize("model,policy", [("resnet", "dots"),
                                          ("bert", "full")])
def test_remat_step_matches_jax(model, policy):
    """One fp32 step under ``policy`` in both packages, dropout off. The
    other policies meet the same bounds: each is bit-equal to the port's
    ``remat=None`` step (below), and so is this one."""
    jnet, tnet, batch = _models(model)
    opt, params = ("sgd", SGD) if model == "resnet" else ("adam", ADAM)
    jtr = jpar.ShardedTrainer(
        jnet, jgluon.loss.SoftmaxCrossEntropyLoss(), opt, dict(params),
        mesh=jpar.make_mesh({"data": 1, "model": 1},
                            devices=jax.devices()[:1]), remat=policy)
    ttr = _port_trainer(tnet, model, policy)
    jl = float(jtr.step(*batch).asnumpy())
    tl = float(ttr.step(*batch))
    assert tl == pytest.approx(jl, rel=1e-5)
    got_stats, got = _stats_and_rest(_port_state(ttr))
    want_stats, want = _stats_and_rest(_jax_state(jtr))
    _close(got, want, 1e-4, policy)
    _close(got_stats, want_stats, 1e-5, f"{policy} statistics")


@functools.lru_cache(maxsize=None)
def _dropout_model(model):
    """The port block of ``model`` alone (BERT at dropout 0.1), seeded
    weights and, for the ResNet, seeded BatchNorm statistics, and its
    batch; built once, each trainer takes a copy."""
    gen = trandom.generator(11)
    if model == "resnet":
        net = torch_resnet.ResNetV1(torch_resnet.BottleneckV1, *NARROW,
                                    classes=RN_CLASSES)
        net.initialize(tmx.init.Xavier(), ctx=tmx.cpu(), generator=gen)
        rng = np.random.RandomState(9)
        batch = (rng.randn(RN_BATCH, 3, 32, 32),
                 rng.randint(0, RN_CLASSES, (RN_BATCH,)))
        with torch.no_grad():
            net(torch.zeros(1, 3, 32, 32))
            for name, t in net.collect_params().items():
                if name.endswith("running_mean"):
                    t.normal_(0.0, 0.1, generator=gen)
                elif name.endswith("running_var"):
                    t.uniform_(0.5, 1.5, generator=gen)
        return net, batch
    net = PortMLM(BERTModel(**{**NARROW_BERT, "vocab_size": MLM_VOCAB},
                            dropout=0.1, use_pooler=False,
                            use_classifier=False))
    net.initialize(tmx.init.Normal(0.02), ctx=tmx.cpu(), generator=gen)
    ids = np.random.RandomState(1).randint(0, MLM_VOCAB, (MLM_BATCH, MLM_SEQ))
    with torch.no_grad():
        net(torch.zeros(1, 2, dtype=torch.int32))
    return net, (ids, ids)


def _run(model, remat, steps_of):
    """``steps_of(trainer, batch)`` on a fresh copy of the model under
    ``remat`` after dropout seed 5; returns (its losses, the state)."""
    net, batch = _dropout_model(model)
    tr = _port_trainer(copy.deepcopy(net), model, remat)
    trandom.seed(5)
    losses = steps_of(tr, batch)
    return losses, _port_state(tr)


def _bit_equal(a, b):
    (la, sa), (lb, sb) = a, b
    assert la == lb
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def _two_steps(tr, batch):
    return [float(tr.step(*batch)) for _ in range(2)]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", ["resnet", "bert"])
def test_remat_step_is_bit_equal_to_plain_step(model, policy):
    """Two steps under ``policy`` against two ``remat=None`` steps."""
    _bit_equal(_run(model, policy, _two_steps),
               _run(model, None, _two_steps))


def test_full_remat_runs_the_forward_again():
    """Under ``"full"`` each block's forward runs twice per step (the
    first forward and the recompute); under None once."""
    calls = {}
    for remat in (None, "full"):
        seen = []

        def counted(tr, batch):
            for m in tr._block.modules():
                m.register_forward_hook(lambda *a: seen.append(1))
            return [float(tr.step(*batch))]

        _run("bert", remat, counted)
        calls[remat] = len(seen)
    assert calls["full"] == 2 * calls[None] > 0


@pytest.mark.parametrize("model", ["resnet", "bert"])
def test_run_steps_under_remat_equals_steps(model):
    """``run_steps(2)`` under ``"dots"`` against two ``step()`` calls of
    a ``remat=None`` trainer: bit-equal (a window draws its dropout bits
    as two steps do)."""
    window = _run(model, "dots", lambda tr, b: [
        float(tr.run_steps(*b, num_steps=2))])
    steps = _run(model, None, lambda tr, b: _two_steps(tr, b)[-1:])
    _bit_equal(window, steps)


def test_graph_step_under_remat_on_the_stand_in():
    """The graph step under ``"full"`` on the CPU stand-in backend
    (capture, then replays) against the eager ``remat=None`` step, BERT
    at dropout 0.1: three steps bit-equal; one program."""
    def three_steps(graphed):
        def steps_of(tr, batch):
            tr._backend = Stub() if graphed else None
            out = []
            for step in range(3):
                trandom.seed(step)
                out.append(float(tr.step(*batch)))
            assert len(tr._programs) == int(graphed)
            return out
        return steps_of

    _bit_equal(_run("bert", "full", three_steps(True)),
               _run("bert", None, three_steps(False)))


def test_policy_refusal_and_callable():
    """An unknown policy raises the reference's message; a callable is
    taken as a PyTorch selective-checkpoint policy (here: save every
    matmul) and its step equals the ``remat=None`` step."""
    net = tmx.gluon.nn.Dense(3, in_units=4).initialize(ctx=tmx.cpu())
    loss = tmx.gluon.loss.L2Loss()
    mesh = tpar.make_mesh({"data": 1}, devices=[tmx.cpu()])
    for bad in ("dots_saveable", 3):
        with pytest.raises(MXNetError, match="unknown remat policy"):
            tpar.ShardedTrainer(net, loss, "sgd", mesh=mesh, remat=bad)
    seen = []

    def policy(ctx, op, *args, **kwargs):
        seen.append(op)
        if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    _bit_equal(_run("bert", policy, _two_steps),
               _run("bert", None, _two_steps))
    assert seen

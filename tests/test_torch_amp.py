"""AMP and the fused guard in the port (mxnet_tpu_torch/contrib/amp,
mxnet_tpu_torch/guardrails/fused.py, the fp16 path of gluon.Trainer,
Block.cast and the loss's amp_safe) against the JAX package on the CPU.

The same numpy inputs go through the JAX function and its port:
``guard_stats`` (the finiteness flag bit for bit, the global norm within
1e-6 relative), ``select`` and ``update_guard_state`` (bit for bit),
``DynamicLossScaler``'s growth and halving sequence (equal), and the
eager ``Trainer`` under ``amp.init("float16")`` with an injected inf
gradient (the step skipped in both, the weights bit-unchanged, the scale
halved) and under ``amp.init("bfloat16")`` (no check: the update runs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.guardrails import fused as jfused
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.guardrails import fused as tfused

from torch_parity import narrow_pair


@pytest.fixture
def amp_off():
    """Both packages' AMP state is process-wide: reset it after a test."""
    yield
    jamp.reset()
    tamp.reset()


def _leaves(case):
    rng = np.random.RandomState(4)
    leaves = [rng.randn(3, 5).astype(np.float32),
              rng.randn(7).astype(np.float32) * 100,
              rng.randn(2, 2, 2).astype(np.float32) * 1e-3]
    loss = np.float32(2.5)
    if case == "nan_leaf":
        leaves[1][3] = np.nan
    elif case == "inf_leaf":
        leaves[2][1, 0, 1] = -np.inf
    elif case == "nonfinite_loss":
        loss = np.float32(np.inf)
    elif case == "square_overflows":
        leaves[0][0, 0] = 3e19               # finite, its square is not
    return leaves, loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["finite", "nan_leaf", "inf_leaf",
                                  "nonfinite_loss", "square_overflows"])
def test_guard_stats_matches_jax(case, dtype):
    """(finite, global norm) over the same leaves and loss: the flag
    equal, the norm within 1e-6 relative (each leaf's squared norm in
    fp32; the port sums per-leaf norms squared, the JAX package per-leaf
    sums of squares)."""
    leaves, loss = _leaves(case)
    jl = [jnp.asarray(a).astype(dtype) for a in leaves]
    tl = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in leaves]
    for with_loss in (False, True):
        jf, jn = jfused.guard_stats(jl, jnp.asarray(loss) if with_loss
                                    else None)
        tf, tn = tfused.guard_stats(tl, torch.tensor(loss) if with_loss
                                    else None)
        assert tf.dtype == torch.bool and tn.dtype == torch.float32
        assert bool(tf) == bool(jf)
        jn, tn = float(jn), float(tn)
        if np.isfinite(jn):
            assert tn == pytest.approx(jn, rel=1e-6)
        else:
            assert not np.isfinite(tn)


@pytest.mark.parametrize("finite", [True, False])
def test_select_and_guard_counters_match_jax(finite):
    """Skip-step selection and the (total, consecutive) skip counters over
    four steps, bit for bit."""
    rng = np.random.RandomState(1)
    new = [rng.randn(4).astype(np.float32), rng.randn(2, 3).astype(np.float32)]
    old = [rng.randn(4).astype(np.float32), rng.randn(2, 3).astype(np.float32)]
    jsel = jfused.select(jnp.asarray(finite), [jnp.asarray(a) for a in new],
                         [jnp.asarray(a) for a in old])
    tsel = tfused.select(torch.tensor(finite),
                         [torch.from_numpy(a) for a in new],
                         [torch.from_numpy(a) for a in old])
    for j, t in zip(jsel, tsel):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jstate, tstate = jfused.init_guard_state(), tfused.init_guard_state()
    for flag in (finite, False, True, not finite):
        jstate = jfused.update_guard_state(jstate, jnp.asarray(flag))
        tstate = tfused.update_guard_state(tstate, torch.tensor(flag))
        assert [int(v) for v in tstate] == [int(v) for v in jstate]
        assert all(v.dtype == torch.int32 for v in tstate)


def test_clip_scale_and_host_fetch_match_jax():
    """clip_scale on finite and non-finite norms; host_fetch returns
    Python scalars of the same values in one read."""
    for norm in (0.5, 7.0, np.inf, np.nan):
        j = float(jfused.clip_scale(jnp.float32(norm), 2.0))
        t = float(tfused.clip_scale(torch.tensor(norm, dtype=torch.float32),
                                    2.0))
        assert t == pytest.approx(j, rel=1e-7)
    vals = (True, np.float32(1.5), np.int32(3))
    got = tfused.host_fetch(*(torch.tensor(v) for v in vals))
    want = jfused.host_fetch(*(jnp.asarray(v) for v in vals))
    assert got == want
    assert [type(v) for v in got] == [bool, float, int]


def test_dynamic_loss_scaler_sequence_matches_jax():
    """Growth after ``scale_window`` clean steps and halving (to at least
    1) on overflow: the same scale after every step of one seeded overflow
    pattern, including a run of overflows down to the floor."""
    rng = np.random.RandomState(0)
    pattern = list(rng.rand(60) < 0.2) + [True] * 20 + [False] * 12
    js = jamp.DynamicLossScaler(init_scale=2 ** 10, scale_window=5)
    ts = tamp.DynamicLossScaler(init_scale=2 ** 10, scale_window=5)
    for overflow in pattern:
        js.update_scale(bool(overflow))
        ts.update_scale(bool(overflow))
        assert ts.loss_scale == js.loss_scale
    assert ts.loss_scale > 1.0


def _dense_pair():
    jnet = jgluon.nn.Dense(4, in_units=8)
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    tnet = tmx.gluon.nn.Dense(4, in_units=8)
    tmx.convert.load_jax_params(
        tnet, {k: p.data().asnumpy() for k, p in
               jnet._structural_names().items()}, ctx=tmx.cpu())
    return jnet, tnet


def _eager_steps(dtype, poison):
    """Two steps of record -> L2Loss -> amp.scale_loss -> backward ->
    Trainer.step(8) in both packages under ``amp.init(dtype)``, the second
    on a batch with an inf: per package (losses, weights before and after
    the second step, scales, skipped steps)."""
    jamp.init(dtype)
    tamp.init(dtype)
    jnet, tnet = _dense_pair()
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", {"learning_rate": 0.1})
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    jamp.init_trainer(jtr)
    tamp.init_trainer(ttr)
    rng = np.random.RandomState(3)
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    jl, tl = jgluon.loss.L2Loss(), tmx.gluon.loss.L2Loss()
    out = {"jax": {"scales": [], "w": []}, "port": {"scales": [], "w": []}}
    for step in range(2):
        xb = x.copy()
        if poison and step == 1:
            xb[2, 5] = np.inf
        out["jax"]["w"].append(jnet.weight.data().asnumpy().copy())
        out["port"]["w"].append(tnet.weight.detach().numpy().copy())
        with jag.record():
            loss = jl(jnet(jmx.nd.array(xb)), jmx.nd.array(y))
            with jamp.scale_loss(loss, jtr) as scaled:
                scaled.backward()
        jtr.step(8)
        with tag.record():
            loss = tl(tnet(torch.from_numpy(xb)), torch.from_numpy(y))
            with tamp.scale_loss(loss, ttr) as scaled:
                tag.backward(scaled)
        ttr.step(8)
        out["jax"]["scales"].append(jtr._amp_loss_scaler.loss_scale)
        out["port"]["scales"].append(ttr._amp_loss_scaler.loss_scale)
    out["jax"]["w"].append(jnet.weight.data().asnumpy().copy())
    out["port"]["w"].append(tnet.weight.detach().numpy().copy())
    out["jax"]["skipped"] = jtr.skipped_steps
    out["port"]["skipped"] = ttr.skipped_steps
    return out


def test_eager_trainer_fp16_skips_an_overflow_as_jax(amp_off):
    """fp16: a finite step updates both packages' weights alike (within
    1e-6 of max |value|) and keeps the scale; a step whose gradient holds
    an inf is skipped in both, the weights bit-unchanged, the scale
    halved (2^16 -> 2^15), one skipped step counted."""
    out = _eager_steps("float16", poison=True)
    j, t = out["jax"], out["port"]
    assert t["scales"] == j["scales"] == [2.0 ** 16, 2.0 ** 15]
    assert t["skipped"] == j["skipped"] == 1
    np.testing.assert_array_equal(t["w"][2], t["w"][1])
    np.testing.assert_array_equal(j["w"][2], j["w"][1])
    scale = np.abs(j["w"][1]).max()
    assert np.abs(t["w"][1] - j["w"][1]).max() <= 1e-6 * scale
    assert not np.array_equal(t["w"][1], t["w"][0])


def test_eager_trainer_bf16_runs_no_check(amp_off, monkeypatch):
    """bf16: the trainer reads no guard (no fused check, no host read)
    and the poisoned step's update runs in both packages: the weights
    become non-finite and no step counts as skipped."""
    monkeypatch.setattr(tfused, "host_fetch",
                        lambda *a: pytest.fail("a host read in bf16"))
    out = _eager_steps("bfloat16", poison=True)
    j, t = out["jax"], out["port"]
    assert t["skipped"] == j["skipped"] == 0
    assert not np.isfinite(j["w"][2]).all()
    assert not np.isfinite(t["w"][2]).all()


def test_amp_state_and_refusals(amp_off):
    """amp_dtype follows init/reset as in JAX; init with an op list that
    names no registered operator raises; a bad dtype and init_trainer
    before init raise; scale_loss needs init_trainer."""
    assert tamp.amp_dtype() is None
    tamp.init("float16")
    jamp.init("float16")
    assert tamp.amp_dtype() == jamp.amp_dtype() == "float16"
    tamp.reset()
    assert tamp.amp_dtype() is None
    with pytest.raises(MXNetError, match="not registered"):
        tamp.init("bfloat16", fp32_ops=["not_a_real_op_name"])
    tamp.reset()
    with pytest.raises(MXNetError, match="float16 or bfloat16"):
        tamp.init("float64")
    trainer = tmx.gluon.Trainer(
        tmx.gluon.nn.Dense(2, in_units=2).initialize(ctx=tmx.cpu())
        .collect_params(), "sgd")
    with pytest.raises(MXNetError, match="amp.init"):
        tamp.init_trainer(trainer)
    with pytest.raises(MXNetError, match="init_trainer"):
        tamp.scale_loss(torch.ones(2), trainer)


def test_block_cast_and_convert_hybrid_block_match_jax():
    """Block.cast / amp.convert_hybrid_block to bfloat16: every parameter
    and running statistic takes the dtype in both packages, and the
    predict-mode logits on the same bf16 input agree within 2e-2 of max
    |value| (bf16 rounds at other places in the two frameworks)."""
    jnet, tnet = narrow_pair(seed=2, in_shape=(4, 3, 32, 32))
    jnet.cast("bfloat16")
    tamp.convert_hybrid_block(tnet, "bfloat16")
    jdt = {k: str(p.data().dtype) for k, p in jnet._structural_names().items()}
    tdt = {k: str(v.dtype).replace("torch.", "")
           for k, v in tnet.collect_params().items()}
    assert tdt == jdt
    x = np.random.RandomState(5).randn(4, 3, 32, 32).astype(np.float32)
    want = jnet(jmx.nd.array(x).astype("bfloat16")).asnumpy().astype(
        np.float32)
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("kw", [{}, {"sparse_label": False},
                                {"from_logits": True},
                                {"label_smoothing": 0.1}])
def test_softmax_ce_amp_safe_matches_jax(kw):
    """amp_safe is true on the fused sparse path only, in both."""
    assert tmx.gluon.loss.SoftmaxCrossEntropyLoss(**kw).amp_safe == \
        jgluon.loss.SoftmaxCrossEntropyLoss(**kw).amp_safe

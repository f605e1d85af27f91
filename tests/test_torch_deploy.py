"""The port's canary deployment controller (mxnet_tpu_torch/serving/
deploy.py) against the JAX package's on the CPU, over pools of two
in-process replicas of the worker's ``mlp`` (one seeded set of weights
per committed step, both packages reading the same commit root).

- ``DeployConfig``'s validation;
- on one pool, the no-op and the refusals, then a good step promoted,
  with ``pool.reload()`` refused with
  ``DeployInProgress`` mid-canary, every answer stamped
  with the old or the new step and equal to the CPU mlp under it;
- a CRC-valid step with one layer's weights scaled by 1.5 rolled back
  on ``parity``, its pin kept;
- a canary whose heartbeat stops rolled back on ``canary_lost``;
- the same verdicts and the same sequence of transitions as the
  reference, compared by journal record kinds;
- the gate's p99, error-rate, shed-rate, parity and breaker rules as a
  pure check: ``_evaluate`` of both packages fed one stubbed
  ``router.stats()``, never timed.
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from mxnet_tpu import serving as jserving
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.base import MXNetError as TMXNetError

import torch_pool_parity as tp

SERVING = {"jax": jserving, "port": tserving}
ERRORS = {"jax": JMXNetError, "port": TMXNetError}
FAST = dict(canary_k=1, window_s=0.15, rollback_s=10.0, deadline_s=20.0,
            poll_s=0.01)


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_JOURNAL", "off")
    tp.quiet_journals()
    yield
    tp.quiet_journals()


def pool_of(pkg, tmp_path, root):
    store = SERVING[pkg].ParamStore
    pool = tp.local_pool(pkg, str(tmp_path / f"pool-{pkg}"), factory=(
        lambda: tp.server(pkg, store=store(root), reload_poll_s=-1.0)),
        heartbeat_s=0.05, deadline_s=0.3)
    pool.start()
    router = SERVING[pkg].Router(pool, SERVING[pkg].RouterConfig(retries=3))
    return pool, router


def transitions(path):
    """The deploy trail's record kinds, repeated gate evaluations
    collapsed into one (their count depends on timing), without the
    no-op deploys' records."""
    kinds = []
    for r in tp.records(path):
        k = r["kind"]
        if k in ("deploy_start", "canary_up", "gate_eval", "promote",
                 "rollback", "deploy_done") and \
                r.get("result") != "noop" and \
                not (kinds and k == "gate_eval" == kinds[-1]):
            kinds.append(k)
    return kinds


def drive(pkg, pool, router, ctl, step, xs, during=None):
    """``ctl.deploy(step)`` on a thread (and ``during`` on another) while
    this thread sends requests through the router; returns (result,
    [(row, value, step, replica)])."""
    result = {}
    threads = [threading.Thread(
        target=lambda: result.update(ctl.deploy(step)))]
    if during is not None:
        threads.append(threading.Thread(target=during))
    for t in threads:
        t.start()
    seen = []
    i = 0
    while threads[0].is_alive():
        resp = router.call(xs[i % len(xs)], deadline_ms=20000)
        seen.append((i % len(xs), resp.value, resp.params_step,
                     resp.replica))
        i += 1
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    return result, seen


@pytest.mark.parametrize("kw", [{"canary_k": 0}, {"window_s": 0.0},
                                {"promote_after": 0},
                                {"mirror_fraction": 1.5},
                                {"rollback_s": 0.0},
                                {"deadline_s": 1.0, "window_s": 2.0}])
def test_config_validation_alike(kw):
    msgs = []
    for pkg in tp.PKGS:
        with pytest.raises(ERRORS[pkg]) as ei:
            SERVING[pkg].DeployConfig(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def _noop_and_refusals(S, pool, router, root, empty):
    """A deploy of the served step is a no-op; a canary set leaving no
    control arm, an uncommitted step and an empty root are refused."""
    row = [S.DeployController(pool, router, root,
                              S.DeployConfig(**FAST)).deploy(1)]
    for what in (lambda: S.DeployController(
            pool, router, root,
            S.DeployConfig(**{**FAST, "canary_k": 2})).deploy(1),
            lambda: S.DeployController(pool, router, root,
                                       S.DeployConfig(**FAST)).deploy(99),
            lambda: S.DeployController(pool, router, empty,
                                       S.DeployConfig(**FAST)).deploy()):
        with pytest.raises(Exception) as ei:
            what()
        row.append(type(ei.value).__name__)
    assert pool.deploy_owner() is None
    return row


def test_good_step_promoted_reload_refused_mid_canary(tmp_path):
    weights = {1: tp.mlp_arrays(1), 2: tp.mlp_arrays(2)}
    xs = np.random.RandomState(4).randn(6, tp.DIM).astype(np.float32)
    (tmp_path / "empty").mkdir()
    out = {}
    for pkg in tp.PKGS:
        root = str(tmp_path / f"ckpt-{pkg}")
        tp.commit_mlp(root, 1, weights[1])
        path = str(tmp_path / f"{pkg}.jsonl")
        pool, router = pool_of(pkg, tmp_path, root)
        S = SERVING[pkg]
        try:
            refusals = _noop_and_refusals(S, pool, router, root,
                                          str(tmp_path / "empty"))
        except BaseException:
            router.stop()
            pool.stop()
            raise
        tp.journal_to(pkg, path)
        tp.commit_mlp(root, 2, weights[2])   # after the pool serves 1
        # the weights change, so parity mirroring is off: the promotion
        # rides the statistical gates alone
        ctl = S.DeployController(pool, router, root, S.DeployConfig(
            **FAST, promote_after=2, min_samples=3, mirror_fraction=0.0))
        refused = []

        def mid_canary():
            # with one canary of two replicas the served step ties, and
            # the reference's _fleet_step takes the larger: a second
            # deploy of the same step is a no-op before it asks the pool
            tp.wait(lambda: tp.records(path, "canary_up"), timeout_s=10.0,
                    poll_s=0.002)
            for fn in (pool.reload, lambda: ctl.deploy(2)):
                try:
                    refused.append(fn()["result"])
                except S.DeployInProgress as e:
                    refused.append(e.op)

        try:
            result, seen = drive(pkg, pool, router, ctl, 2, xs,
                                 during=mid_canary)
            final = {s.id: s.params_step for s in pool.view()}
            pins = [rep.server.param_store.pinned_step
                    for rep in pool.replicas.values()]
        finally:
            router.stop()
            pool.stop()
            tp.quiet_journals()
        assert result["result"] == "promoted", result
        assert refused == ["reload", "noop"]
        assert set(final.values()) == {2} and pins == [None, None]
        assert {s for _, _, s, _ in seen} <= {1, 2}
        for row, value, step, _ in seen:
            np.testing.assert_allclose(
                value, tp.mlp_forward(xs[row], weights[step]), atol=1e-5)
        out[pkg] = (refusals, result["from_step"], result["to_step"],
                    result["canary"], transitions(path))
    assert out["port"] == out["jax"] == (
        [{"result": "noop", "from_step": 1, "to_step": 1},
         "MXNetError", "ValueError", "MXNetError"], 1, 2, ["r0"],
        ["deploy_start", "canary_up", "gate_eval", "promote",
         "deploy_done"])


def test_skewed_step_rolled_back_on_parity(tmp_path):
    good = tp.mlp_arrays(1)
    skewed = {k: v * np.float32(1.5) if k == "1.weight" else v
              for k, v in good.items()}
    xs = np.random.RandomState(5).randn(6, tp.DIM).astype(np.float32)
    out = {}
    for pkg in tp.PKGS:
        root = str(tmp_path / f"ckpt-{pkg}")
        tp.commit_mlp(root, 1, good)
        path = str(tmp_path / f"{pkg}.jsonl")
        pool, router = pool_of(pkg, tmp_path, root)
        tp.journal_to(pkg, path)
        tp.commit_mlp(root, 2, skewed)       # CRC-valid, wrong answers
        S = SERVING[pkg]
        ctl = S.DeployController(pool, router, root, S.DeployConfig(
            **FAST, promote_after=3, min_samples=3, mirror_fraction=0.5))
        try:
            result, seen = drive(pkg, pool, router, ctl, 2, xs)
            final = {s.id: s.params_step for s in pool.view()}
            pin = pool.replicas["r0"]._pin
            store = pool.replicas["r0"].server.param_store
            polled = store.poll()
        finally:
            router.stop()
            pool.stop()
            tp.quiet_journals()
        assert result["result"] == "rolled_back", result
        assert result["converged"] and (pin, polled) == (1, None)
        assert set(final.values()) == {1}
        assert {r for _, _, s, r in seen if s == 2} <= {"r0"}
        for row, value, step, _ in seen:
            want = good if step == 1 else skewed
            np.testing.assert_allclose(value, tp.mlp_forward(xs[row], want),
                                       atol=1e-5)
        assert tp.records(path, "deploy_mirror_mismatch")
        out[pkg] = (result["reason"], result["canary"], transitions(path))
    assert out["port"] == out["jax"] == ("parity", ["r0"], [
        "deploy_start", "canary_up", "gate_eval", "rollback",
        "deploy_done"])


def test_lost_canary_rolled_back(tmp_path):
    out = {}
    for pkg in tp.PKGS:
        root = str(tmp_path / f"ckpt-{pkg}")
        tp.commit_mlp(root, 1, tp.mlp_arrays(1))
        path = str(tmp_path / f"{pkg}.jsonl")
        pool, router = pool_of(pkg, tmp_path, root)
        tp.journal_to(pkg, path)
        tp.commit_mlp(root, 2, tp.mlp_arrays(2))
        S = SERVING[pkg]
        ctl = S.DeployController(pool, router, root, S.DeployConfig(
            **FAST, promote_after=50, min_samples=10_000,
            mirror_fraction=0.0))
        result = {}
        dep = threading.Thread(target=lambda: result.update(ctl.deploy(2)))
        try:
            dep.start()
            tp.wait(lambda: tp.records(path, "canary_up"))
            pool.replicas["r0"]._hb.stop()   # its beats stop: lost
            dep.join(30)
            assert not dep.is_alive()
            pin = pool.replicas["r0"]._pin
        finally:
            router.stop()
            pool.stop()
            tp.quiet_journals()
        out[pkg] = (result["result"], result["reason"], pin,
                    transitions(path))
    assert out["port"] == out["jax"] == ("rolled_back", "canary_lost", 1, [
        "deploy_start", "canary_up", "gate_eval", "rollback",
        "deploy_done"])


def _router_stats(canary_p99, control_p99, n=40, fails=(0, 0),
                  mismatch=0, shed=0, breaker="closed"):
    return {"requests": 100, "shed": shed, "no_capacity": 0,
            "replicas": {"r0": {"breaker": breaker},
                         "r1": {"breaker": "closed"}},
            "deploy": {"canary_count": n, "control_count": n,
                       "canary_p99_ms": canary_p99,
                       "control_p99_ms": control_p99,
                       "served": {"canary": n - fails[0],
                                  "control": n - fails[1]},
                       "failures": {"canary": fails[0],
                                    "control": fails[1]},
                       "mirrors": 4, "mirror_mismatch": mismatch,
                       "mirror_errors": 0}}


GATES = [
    ("p99 breach", _router_stats(200.0, 50.0), ["p99"]),
    ("p99 under the floor", _router_stats(60.0, 20.0), []),
    ("p99 under the ratio", _router_stats(90.0, 50.0), []),
    ("insufficient", _router_stats(500.0, 50.0, n=5), None),
    ("error rate", _router_stats(10.0, 10.0, fails=(8, 0)),
     ["error_rate"]),
    ("shed rate", _router_stats(10.0, 10.0, shed=30), ["shed_rate"]),
    ("parity", _router_stats(10.0, 10.0, mismatch=1), ["parity"]),
    ("breaker", _router_stats(10.0, 10.0, breaker="open"),
     ["canary_breaker_open"]),
]


@pytest.mark.parametrize("case", range(len(GATES)),
                         ids=[g[0] for g in GATES])
def test_gate_rules_as_a_pure_check(case):
    """``_evaluate`` of both packages on one stubbed router and pool."""
    _, stats, reasons = GATES[case]
    base = {"requests": 0, "shed": 0, "no_capacity": 0}
    pool = SimpleNamespace(view=lambda: [
        SimpleNamespace(id="r0", alive=True),
        SimpleNamespace(id="r1", alive=True)])
    router = SimpleNamespace(stats=lambda: stats)
    got = {}
    for pkg in tp.PKGS:
        S = SERVING[pkg]
        ctl = S.DeployController(pool, router, "/unused", S.DeployConfig(
            min_samples=20, p99_ratio=2.0, p99_floor_ms=50.0))
        got[pkg] = ctl._evaluate({"r0"}, base)
    assert got["port"] == got["jax"]
    verdict = got["port"][0]
    if reasons is None:
        assert verdict == {"verdict": "insufficient", "reasons": []}
    else:
        assert verdict == {"verdict": "breach" if reasons else "pass",
                           "reasons": reasons}

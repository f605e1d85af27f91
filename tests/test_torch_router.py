"""The port's health-routed front door (mxnet_tpu_torch/serving/router.py)
against the JAX package's router on the CPU, over pools of in-process
replicas of the worker's ``mlp`` (one seeded set of weights). Compared by
outcome and by journal event names, never by timing:

- retries and the breaker: a replica failing every request is routed
  around with retries, opens its breaker after ``breaker_k`` failures,
  goes half-open after the cooldown and is re-admitted by one probe;
- hedging (``hedge_ms > 0``): a slow replica's attempt is hedged on the
  other, the hedge wins and the loser is cancelled at dequeue;
- ``decode_call`` moves a stream off a replica whose one slot is held
  (``SlotsExhausted``) onto the free one;
- capacity-floor shedding by priority;
- the deploy tap: canary and control roles, mirrored parity probes;
- ``metrics_text`` renders the router's families (it raised before
  tracing was ported).
"""
import time

import numpy as np
import pytest

from mxnet_tpu.resilience import atomic as jatomic
from mxnet_tpu.serving import Router as JRouter
from mxnet_tpu.serving import RouterConfig as JRouterConfig
from mxnet_tpu.serving import ServerOverloaded as JOverloaded
from mxnet_tpu.serving.decode import DecodeConfig as JDecodeConfig
from mxnet_tpu.serving.decode import TinyLM as JTinyLM
from mxnet_tpu_torch.resilience import atomic as tatomic
from mxnet_tpu_torch.serving import DecodeConfig as TDecodeConfig
from mxnet_tpu_torch.serving import Router as TRouter
from mxnet_tpu_torch.serving import RouterConfig as TRouterConfig
from mxnet_tpu_torch.serving import ServerOverloaded as TOverloaded
from mxnet_tpu_torch.serving import TinyLM as TTinyLM

import torch_pool_parity as tp

ROUTERS = {"jax": (JRouter, JRouterConfig), "port": (TRouter, TRouterConfig)}
ATOMIC = {"jax": jatomic, "port": tatomic}


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_JOURNAL", "off")
    tp.quiet_journals()
    yield
    tp.quiet_journals()


def _router(pkg, pool, **kw):
    cls, cfg = ROUTERS[pkg]
    return cls(pool, cfg(**kw))


class _Broken:
    def __call__(self, padded):
        raise ValueError("injected permanent predictor fault")


def test_retries_breaker_opens_and_halfopen_readmits(tmp_path):
    x = np.random.RandomState(1).randn(tp.DIM).astype(np.float32)
    want = tp.mlp_forward(x)
    outcome = {}
    for pkg in tp.PKGS:
        path = str(tmp_path / f"{pkg}.jsonl")
        tp.journal_to(pkg, path)
        pool = tp.local_pool(pkg, str(tmp_path / pkg)).start()
        router = _router(pkg, pool, retries=2, breaker_k=2,
                         breaker_cooldown_s=0.3)
        r0 = pool.replicas["r0"]
        real_get = r0.server.cache.get
        r0.server.cache.get = lambda key, build: (_Broken(), True)
        try:
            t_end = time.monotonic() + 20
            while router.stats()["replicas"]["r0"]["breaker"] != "open":
                assert time.monotonic() < t_end
                resp = router.call(x, deadline_ms=5000)
                np.testing.assert_allclose(resp.value, want, atol=1e-5)
                assert resp.replica == "r1"
            before = router.stats()["replicas"]["r0"]["attempts"]
            for _ in range(4):
                assert router.call(x).replica == "r1"
            untouched = router.stats()["replicas"]["r0"]["attempts"] == before
            r0.server.cache.get = real_get
            time.sleep(0.4)
            t_end = time.monotonic() + 20
            while router.stats()["replicas"]["r0"]["breaker"] != "closed":
                assert time.monotonic() < t_end
                router.call(x)
            st = router.stats()
            outcome[pkg] = (untouched, st["readmissions"],
                            st["retries"] >= 1, st["breaker_opens"])
        finally:
            r0.server.cache.get = real_get
            router.stop()
            pool.stop()
            tp.quiet_journals()
        outcome[pkg + "_trail"] = [
            (r["frm"], r["to"], r["reason"])
            for r in tp.records(path, "router_breaker")
            if r["replica"] == "r0"]
        outcome[pkg + "_retry"] = bool(tp.records(path, "router_retry"))
    assert outcome["port"] == outcome["jax"] == (True, 1, True, 1)
    assert outcome["port_trail"] == outcome["jax_trail"] == [
        ("closed", "open", "consecutive_failures"),
        ("open", "half_open", "cooldown_elapsed"),
        ("half_open", "closed", "probe_succeeded")]
    assert outcome["port_retry"] and outcome["jax_retry"]


def test_hedging_cancels_the_slow_loser(tmp_path):
    x = np.random.RandomState(2).randn(tp.DIM).astype(np.float32)
    outcome = {}
    for pkg in tp.PKGS:
        path = str(tmp_path / f"{pkg}.jsonl")
        tp.journal_to(pkg, path)
        pool = tp.local_pool(pkg, str(tmp_path / pkg)).start()
        router = _router(pkg, pool, retries=1, hedge_ms=60.0)
        prev = ATOMIC[pkg].set_fault_hook(tp.slow_hook("r0", 0.5))
        try:
            for _ in range(6):
                resp = router.call(x, deadline_ms=5000)
                np.testing.assert_allclose(resp.value, tp.mlp_forward(x),
                                           atol=1e-5)
            st = router.stats()
            time.sleep(0.7)             # the losers reach r0's dequeue
            cancelled = pool.replicas["r0"].server.stats()["cancelled"]
        finally:
            ATOMIC[pkg].set_fault_hook(prev)
            router.stop()
            pool.stop()
            tp.quiet_journals()
        hedges = tp.records(path, "router_hedge")
        outcome[pkg] = (st["hedges"] >= 1, st["hedge_wins"] >= 1,
                        cancelled >= 1, (hedges[0]["primary"],
                                         hedges[0]["hedge"]),
                        bool(tp.records(path, "serving_cancelled")))
    assert outcome["port"] == outcome["jax"] == (True, True, True,
                                                 ("r0", "r1"), True)


def test_decode_call_moves_a_stream_off_a_full_replica(tmp_path):
    outcome = {}
    for pkg in tp.PKGS:
        path = str(tmp_path / f"{pkg}.jsonl")
        tp.journal_to(pkg, path)
        lm, cfg = (JTinyLM, JDecodeConfig) if pkg == "jax" \
            else (TTinyLM, TDecodeConfig)
        model = lm(max_len=20000)

        def factory(pkg=pkg, model=model, cfg=cfg):
            return tp.server(pkg, decode_model=model, decode=cfg(
                slots=1, window_ms=1.0, queue_on_busy=False))

        pool = tp.local_pool(pkg, str(tmp_path / pkg), factory=factory,
                             deadline_s=2.0).start()
        router = _router(pkg, pool, hedge_ms=-1.0, retries=3)
        try:
            pins = {rid: pool.replicas[rid].server.decode_submit(
                [9], max_new_tokens=15000) for rid in ("r0", "r1")}
            tp.wait(lambda: all(pool.replicas[r].server.decoder.occupancy()
                                for r in ("r0", "r1")))
            pins["r1"].cancel()
            with pytest.raises(Exception):
                pins["r1"].result(timeout_s=60)
            tp.wait(lambda: pool.replicas["r1"].server.decoder.occupancy()
                    == 0)
            resp = router.decode_call([2, 7], max_new_tokens=8,
                                      deadline_ms=20000)
            pins["r0"].cancel()
            retries = [r["error"] for r in tp.records(path, "router_retry")]
            outcome[pkg] = (resp.value == model.reference([2, 7], 8),
                            resp.replica, resp.hedged,
                            set(retries) <= {"SlotsExhausted"},
                            tp.records(path, "router_breaker"))
        finally:
            router.stop()
            pool.stop()
            tp.quiet_journals()
    assert outcome["port"] == outcome["jax"] == (True, "r1", False, True, [])


def test_capacity_floor_sheds_lowest_priority_first(tmp_path):
    x = np.arange(tp.DIM, dtype=np.float32) / tp.DIM
    outcome = {}
    for pkg, overloaded in (("jax", JOverloaded), ("port", TOverloaded)):
        pool = tp.local_pool(pkg, str(tmp_path / pkg), heartbeat_s=0.05,
                             deadline_s=0.25).start()
        router = _router(pkg, pool, retries=1, capacity_floor=0.9)
        try:
            first = router.predict(x, priority=1)
            pool.replicas["r1"].stop()
            time.sleep(0.4)
            with pytest.raises(overloaded) as ei:
                router.predict(x, priority=1)
            served = router.predict(x, priority=0)
            outcome[pkg] = (ei.value.tier, router.stats()["shed"])
            np.testing.assert_allclose(first, served, atol=1e-5)
        finally:
            router.stop()
            pool.stop()
    assert outcome["port"] == outcome["jax"] == ("capacity_floor", 1)


def test_deploy_tap_roles_and_mirrors(tmp_path):
    x = np.random.RandomState(3).randn(12, tp.DIM).astype(np.float32)
    outcome = {}
    for pkg in tp.PKGS:
        pool = tp.local_pool(pkg, str(tmp_path / pkg)).start()
        router = _router(pkg, pool, retries=1)
        try:
            router.set_deploy(["r1"], mirror_fraction=1.0)
            roles = [router.call(row).deploy_role for row in x]
            # every control answer is mirrored or, past the in-flight cap
            # of 4, skipped (bounded, never queued)
            tp.wait(lambda: router.deploy_stats()["mirrors"]
                    + router.deploy_stats()["mirror_skipped"]
                    >= roles.count("control"))
            st = router.deploy_stats()
            stats_keys = sorted(router.stats())
            router.clear_deploy()
            outcome[pkg] = (sorted(st), st["served"]["canary"]
                            + st["served"]["control"], st["mirror_mismatch"],
                            st["mirror_errors"], router.deploy_stats(),
                            router.call(x[0]).deploy_role, stats_keys)
            assert set(roles) <= {"canary", "control"}
        finally:
            router.stop()
            pool.stop()
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"][1:6] == (12, 0, 0, None, None)


def test_unported_router_parts_raise(tmp_path):
    pool = tp.local_pool("port", str(tmp_path / "p"), n=1)
    router = TRouter(pool)
    text = router.metrics_text()
    for family in ("mxnet_tpu_router_events", "mxnet_tpu_router_breaker_state",
                   "mxnet_tpu_router_attempts_total"):
        assert f"# TYPE {family} gauge" in text
    assert 'mxnet_tpu_router_events{event="requests"} 0' in text
    assert router.config.default_deadline_ms == 2000.0

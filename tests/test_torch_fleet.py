"""The port's tenant fleet (mxnet_tpu_torch/serving/fleet.py, the
worker's ``--tenants``, serving/report.py and the bf16 host copy of
serving/cache.py) against the JAX package's on the CPU.

The tenants are the worker's ``mlp`` with one seeded set of weights per
tenant in both packages (carried into the port through ``convert``).
Every comparison is by outcome, counters and journal records, never by
timing; the requests come from this one thread.

- a scripted sequence over 3 tenants with ``max_hot_tenants=2``: the
  same answers (1e-5), the same ``tenant_stats()`` counters and the
  same order of ``tenant_*`` journal records, paging and a quarantine
  by shape rejects and by the ``serving_tenant`` seam, then half-open
  probes; ``serving_report`` of each journal equal in both packages;
- the rate budget, class budgets, the deadline floor, unknown and
  tenantless submits, hot add and remove, ``metrics_text``'s families;
- a page-out frees a ``block=`` tenant's tensors and a page-in brings
  the same values back;
- one ``--ctx cpu`` worker process with ``--tenants``, routed by tenant,
  whose quarantined tenant's error comes back as ``TenantQuarantined``
  with the wire's ``retryable``;
- ``serving_report`` on a synthetic journal with a torn tail;
- a bf16 block behind a CPU ``Server`` answers in float32, exactly its
  bf16 outputs (numpy has no bfloat16 here).
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.resilience import atomic as jatomic
from mxnet_tpu.serving.pool import ProcReplica as JProc
from mxnet_tpu.serving.report import serving_report as jreport
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.resilience import atomic as tatomic
from mxnet_tpu_torch.serving.pool import ProcReplica as TProc
from mxnet_tpu_torch.serving.report import serving_report as treport

import torch_pool_parity as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING = {"jax": jserving, "port": tserving}
ATOMIC = {"jax": jatomic, "port": tatomic}
COUNTERS = ("accepted", "served", "shed", "rejected_shape",
            "quarantine_rejects", "errors", "deadline_miss", "reloads",
            "page_ins", "page_outs", "quarantines", "readmissions")


@pytest.fixture(autouse=True)
def quiet(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_JOURNAL", "off")
    tp.quiet_journals()
    yield
    tp.quiet_journals()


@pytest.fixture(scope="module", autouse=True)
def tenants_worker(tmp_path_factory):
    """One ``--ctx cpu`` worker process serving tenants a (the mlp on a
    commit root, step 7) and b (scale), spawned when the module starts:
    it imports torch while the in-process tests run, and
    ``test_proc_worker_fleet_mode_routed_by_tenant`` waits for it.
    ``MXNET_TPU_TENANT_BREAKER_K=1``: one failed batch quarantines."""
    tmp = tmp_path_factory.mktemp("tenants_worker")
    root = str(tmp / "ckpt_a")
    tp.commit_mlp(root, 7, tp.mlp_arrays(4))
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_TPU_JOURNAL="off",
               MXNET_TPU_TENANT_BREAKER_K="1",
               MXNET_TPU_TENANT_COOLDOWN_S="60")
    pool = tserving.ReplicaPool(str(tmp / "pool"), tserving.PoolConfig(
        heartbeat_s=0.1, deadline_s=1.0, spawn_s=60.0))
    pool.add_proc("w0", {"--tenants": f"a=mlp@{root},b=scale",
                         "--ctx": "cpu", "--window-ms": 1.0,
                         "--dim": tp.DIM}, env=env)
    pool.start(wait_ready=False)
    try:
        yield pool
    finally:
        pool.stop()


def fleet(pkg, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("window_ms", 1.0)
    kw.setdefault("reload_poll_s", -1.0)
    cfg = SERVING[pkg].FleetConfig(**kw)
    if pkg == "jax":
        return SERVING[pkg].Fleet(cfg)
    return SERVING[pkg].Fleet(cfg, ctx=tmx.cpu())


def mlp_factory(pkg, seed):
    return lambda: tp.mlp(pkg, tp.mlp_arrays(seed))


def poison(tenant, times):
    """A fault hook (either package's) that raises at the
    ``serving_tenant`` seam of ``tenant`` for its next ``times`` batches."""
    left = [times]

    def hook(point, path=None, nbytes=None, size=None):
        if point == "serving_tenant" and path == tenant and left[0] > 0:
            left[0] -= 1
            raise RuntimeError(f"poisoned predictor of {tenant}")
    return hook


def outcome(fn):
    """fn()'s answer as numpy, or the structured error's (class name,
    tenant, retryable)."""
    try:
        return np.asarray(fn())
    except SERVING["jax"].RequestError as e:
        return (type(e).__name__, e.tenant, e.retryable)
    except SERVING["port"].RequestError as e:
        return (type(e).__name__, e.tenant, e.retryable)


def tenant_trail(path):
    return [(r["kind"], r.get("tenant"), r.get("frm"), r.get("to"),
             r.get("n_params"), r.get("evicted"), r.get("hot"))
            for r in tp.records(path) if r["kind"].startswith("tenant_")]


def _script(pkg, root, journal):
    """The scripted sequence, one submitter: paging across 3 tenants
    with 2 hot slots, tenant c quarantined by shape rejects, tenant b by
    its predictor failing at the ``serving_tenant`` seam, both probed
    back after the cooldown."""
    tp.journal_to(pkg, journal)
    xs = np.random.RandomState(7).randn(12, tp.DIM).astype(np.float32)
    f = fleet(pkg, max_hot_tenants=2, tenant_breaker_k=2,
              tenant_cooldown_s=0.15, dim_buckets={0: (tp.DIM,)})
    f.add_tenant("a", factory=mlp_factory(pkg, 1), ckpt_root=root)
    f.add_tenant("b", factory=mlp_factory(pkg, 2))
    f.add_tenant("c", factory=mlp_factory(pkg, 3), slo="silver")
    f.start()
    got = []
    try:
        for i, name in enumerate("abcacb"):
            got.append(outcome(lambda: f.predict(xs[i], tenant=name)))
        steps = [f.submit(xs[6], tenant=n) for n in "ab"]
        got += [np.asarray(r.result(10.0)) for r in steps]
        got.append([r.params_step for r in steps])
        for _ in range(2):              # c: two shape rejects trip it
            got.append(outcome(lambda: f.predict(
                np.ones(tp.DIM + 1, np.float32), tenant="c")))
        got.append(outcome(lambda: f.predict(xs[7], tenant="c")))
        prev = ATOMIC[pkg].set_fault_hook(poison("b", 2))
        try:                            # b: two failed batches trip it
            for i in (8, 9, 10):
                got.append(outcome(lambda: f.predict(xs[i], tenant="b")))
        finally:
            ATOMIC[pkg].set_fault_hook(prev)
        got.append(outcome(lambda: f.predict(xs[11], tenant="a")))
        time.sleep(0.2)                 # both cooldowns elapse
        for name in "cb":               # the half-open probes
            got.append(outcome(lambda: f.predict(xs[0], tenant=name)))
        stats = f.tenant_stats()
    finally:
        f.stop()
        tp.quiet_journals()
    return got, stats


def test_fleet_script_matches_jax(tmp_path):
    root = str(tmp_path / "ckpt_a")
    step_a = tp.mlp_arrays(11)
    tp.commit_mlp(root, 5, step_a)
    res = {pkg: _script(pkg, root, str(tmp_path / f"{pkg}.jsonl"))
           for pkg in tp.PKGS}
    (gj, sj), (gt, st) = res["jax"], res["port"]
    assert len(gj) == len(gt)
    for j, t in zip(gj, gt):
        if isinstance(j, np.ndarray):
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
        else:
            assert t == j
    xs = np.random.RandomState(7).randn(12, tp.DIM).astype(np.float32)
    np.testing.assert_allclose(gt[0], tp.mlp_forward(xs[0], step_a),
                               atol=1e-5)
    np.testing.assert_allclose(gt[1], tp.mlp_forward(xs[1],
                                                     tp.mlp_arrays(2)),
                               atol=1e-5)
    assert gt[8] == [5, None]
    assert gt[9][0] == gt[10][0] == "RequestError"
    assert gt[11] == ("TenantQuarantined", "c", False)
    assert gt[14] == ("TenantQuarantined", "b", False)
    assert isinstance(gt[-1], np.ndarray) and isinstance(gt[-2], np.ndarray)
    for name in "abc":
        for k in COUNTERS + ("state", "hot", "params_step", "slo",
                             "priority"):
            assert st[name][k] == sj[name][k], (name, k)
    assert st["c"]["quarantines"] == st["b"]["quarantines"] == 1
    assert st["c"]["readmissions"] == st["b"]["readmissions"] == 1
    assert sum(st[n]["page_ins"] for n in "abc") >= 5
    trails = {pkg: tenant_trail(str(tmp_path / f"{pkg}.jsonl"))
              for pkg in tp.PKGS}
    assert trails["port"] == trails["jax"]
    assert ("tenant_quarantine", "b", "half_open", "admitted", None, None,
            None) in trails["port"]
    for pkg in tp.PKGS:
        path = str(tmp_path / f"{pkg}.jsonl")
        rep = treport(path)
        assert rep == jreport(path)
        assert rep["tenants"]["c"]["readmitted"]
        assert rep["tenants"]["a"]["page_ins"] == st["a"]["page_ins"]


def test_rate_budget_sheds_only_its_tenant():
    sheds = {}
    for pkg in tp.PKGS:
        f = fleet(pkg)
        f.add_tenant("greedy", factory=mlp_factory(pkg, 1),
                     slo=SERVING[pkg].SLOClass("capped", rate_rps=0.01,
                                               burst=2))
        f.add_tenant("calm", factory=mlp_factory(pkg, 2))
        f.start()
        x = np.ones(tp.DIM, np.float32)
        try:
            got = [outcome(lambda: f.predict(x, tenant="greedy"))
                   for _ in range(5)]
            for _ in range(3):
                f.predict(x, tenant="calm")
            st = f.tenant_stats()
        finally:
            f.stop()
        sheds[pkg] = ([g if isinstance(g, tuple) else "ok" for g in got],
                      st["greedy"]["shed"], st["calm"]["shed"])
    assert sheds["port"] == sheds["jax"] == (
        ["ok", "ok"] + [("ServerOverloaded", "greedy", True)] * 3, 3, 0)


def test_class_budget_and_deadline_floor():
    res = {}
    for pkg in tp.PKGS:
        f = fleet(pkg, max_queue=16)
        f.add_tenant("gold", factory=mlp_factory(pkg, 1), slo="gold")
        f.add_tenant("bronze", factory=mlp_factory(pkg, 2), slo="bronze")
        f.add_tenant("floored", factory=mlp_factory(pkg, 3),
                     slo=SERVING[pkg].SLOClass("floored",
                                               deadline_floor_ms=5000.0))
        x = np.ones(tp.DIM, np.float32)
        # the worker is not started: requests pile up in the queue
        pending = [f.submit(x, tenant="gold") for _ in range(4)]
        with pytest.raises(SERVING[pkg].ServerOverloaded) as ei:
            f.submit(x, tenant="bronze")      # bronze share: 16/4 = 4
        pending.append(f.submit(x, tenant="gold"))
        floored = f.submit(x, tenant="floored", deadline_ms=1.0)
        time.sleep(0.01)                      # past the asked deadline
        f.start()
        try:
            outs = [np.asarray(p.result(10.0)) for p in pending]
            outs.append(np.asarray(floored.result(10.0)))
            st = f.tenant_stats()
        finally:
            f.stop()
        res[pkg] = ((ei.value.tier, ei.value.tenant, ei.value.limit),
                    st["bronze"]["shed"], st["gold"]["shed"],
                    st["floored"]["deadline_miss"], outs)
    for j, t in zip(res["jax"][:4], res["port"][:4]):
        assert t == j
    assert res["port"][0] == ("class_budget", "bronze", 4)
    np.testing.assert_allclose(np.stack(res["port"][4]),
                               np.stack(res["jax"][4]), atol=1e-5)


def test_unknown_tenantless_and_hot_add_remove(tmp_path):
    res = {}
    for pkg in tp.PKGS:
        path = str(tmp_path / f"{pkg}.jsonl")
        tp.journal_to(pkg, path)
        f = fleet(pkg)
        f.add_tenant("stay", factory=mlp_factory(pkg, 1))
        f.start()
        x = np.ones(tp.DIM, np.float32)
        try:
            got = [outcome(lambda: f.predict(x, tenant="ghost")),
                   outcome(lambda: f.predict(x)),
                   outcome(lambda: f.predict(x, tenant="stay"))]
            f.add_tenant("late", factory=mlp_factory(pkg, 2))   # hot add
            got.append(outcome(lambda: f.predict(x, tenant="late")))
            with pytest.raises(ValueError):
                f.add_tenant("late", factory=mlp_factory(pkg, 2))
            f.remove_tenant("late")
            got.append(outcome(lambda: f.predict(x, tenant="late")))
            got.append(outcome(lambda: f.predict(x, tenant="stay")))
            with pytest.raises(KeyError):
                f.remove_tenant("late")
        finally:
            f.stop()
            tp.quiet_journals()
        res[pkg] = (got, [(r["kind"], r["tenant"])
                          for r in tp.records(path)
                          if r["kind"] in ("tenant_add", "tenant_remove")])
    (gj, kj), (gt, kt) = res["jax"], res["port"]
    assert kt == kj == [("tenant_add", "stay"), ("tenant_add", "late"),
                        ("tenant_remove", "late")]
    for j, t in zip(gj, gt):
        if isinstance(j, np.ndarray):
            np.testing.assert_allclose(t, j, atol=1e-5)
        else:
            assert t == j
    assert gt[0] == ("RequestError", "ghost", True)
    assert gt[1] == ("RequestError", None, False)
    assert gt[4] == ("RequestError", "late", True)


def _families(text):
    lines = [ln for ln in text.splitlines()
             if ln.startswith("mxnet_tpu_serving_tenant")]
    return ({ln.split("{")[0] for ln in lines},
            sorted(ln for ln in lines if "latency" not in ln),
            sorted(ln.rsplit(" ", 1)[0] for ln in lines if "latency" in ln))


def test_metrics_text_tenant_families():
    got = {}
    for pkg in tp.PKGS:
        f = fleet(pkg)
        f.add_tenant("m0", factory=mlp_factory(pkg, 1))
        f.add_tenant("m1", factory=mlp_factory(pkg, 2), slo="silver")
        f.start()
        try:
            f.predict(np.ones(tp.DIM, np.float32), tenant="m0")
            got[pkg] = _families(f.metrics_text())
        finally:
            f.stop()
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"mxnet_tpu_serving_tenant_events",
                              "mxnet_tpu_serving_tenant_state",
                              "mxnet_tpu_serving_tenant_latency_ms"}
    assert 'mxnet_tpu_serving_tenant_events{tenant="m0",event="served"} 1' \
        in got["port"][1]


def test_page_out_frees_a_block_tenant_and_pages_it_back(tmp_path):
    """A ``block=`` tenant's factory keeps its block alive: a page-out
    must still free the block's tensors (their storage, in place) and
    drop its predictors; the page-in restores the same values."""
    path = str(tmp_path / "port.jsonl")
    tp.journal_to("port", path)
    blocks = {n: tp.mlp("port", tp.mlp_arrays(s))
              for n, s in (("a", 1), ("b", 2))}
    f = fleet("port", max_hot_tenants=1)
    for name, blk in blocks.items():
        f.add_tenant(name, block=blk)
    f.start()
    x = np.ones(tp.DIM, np.float32)
    try:
        first = np.asarray(f.predict(x, tenant="a"))
        f.predict(x, tenant="b")                     # pages a out
        assert all(t.numel() == 0
                   for t in blocks["a"].collect_params().values())
        assert len(f.cache) == 1 and f.tenant_stats()["a"]["hot"] is False
        again = np.asarray(f.predict(x, tenant="a"))  # and back in
    finally:
        f.stop()
        tp.quiet_journals()
    np.testing.assert_array_equal(again, first)
    for k, v in tp.mlp_arrays(1).items():
        np.testing.assert_array_equal(
            blocks["a"].collect_params()[k].detach().numpy(), v)
    outs = tp.records(path, "tenant_page_out")
    ins = tp.records(path, "tenant_page_in")
    nbytes = sum(v.nbytes for v in tp.mlp_arrays(1).values())
    assert [r["tenant"] for r in outs] == ["a", "b"]
    assert outs[0]["bytes"] == nbytes and outs[0]["predictors_dropped"] == 1
    assert [(r["tenant"], r["bytes"]) for r in ins] == \
        [("a", 0), ("b", 0), ("a", nbytes)]


def test_raise_remote_rebuilds_tenant_quarantined():
    for retryable in (False, True):
        header = {"ok": False, "error": "TenantQuarantined",
                  "retryable": retryable, "tenant": "a",
                  "reason": "probe in flight", "detail": "x"}
        errs = []
        for proc in (JProc, TProc):
            with pytest.raises(Exception) as ei:
                proc._raise_remote(header)
            errs.append((type(ei.value).__name__, ei.value.tenant,
                         ei.value.reason, ei.value.retryable))
        assert errs[0] == errs[1] == ("TenantQuarantined", "a",
                                      "probe in flight", retryable)


def test_proc_worker_fleet_mode_routed_by_tenant(tenants_worker):
    """The ``--tenants`` worker: routed by tenant, beacons advertising
    both tenants; a's wrong-width request fails its predictor, which
    quarantines it, and its next request comes back as
    ``TenantQuarantined`` with the wire's ``retryable``."""
    pool = tenants_worker
    x = np.random.RandomState(8).randn(tp.DIM).astype(np.float32)
    assert pool.wait_ready()
    router = tserving.Router(pool, tserving.RouterConfig(retries=1))
    try:
        assert set(pool.view()[0].tenants) == {"a", "b"}
        resp = router.call(x, tenant="a")
        assert (resp.replica, resp.params_step) == ("w0", 7)
        np.testing.assert_allclose(resp.value,
                                   tp.mlp_forward(x, tp.mlp_arrays(4)),
                                   atol=1e-5)
        np.testing.assert_allclose(router.call(x, tenant="b").value, x)
        rep = pool.replicas["w0"]
        with pytest.raises(tserving.RequestError) as ei:
            rep.predict(np.ones(tp.DIM - 1, np.float32), 5000, tenant="a")
        assert ei.value.tenant == "a"
        with pytest.raises(tserving.TenantQuarantined) as ei:
            rep.predict(x, 5000, tenant="a")
        assert (ei.value.tenant, ei.value.retryable) == ("a", False)
        with pytest.raises(tserving.RequestError) as ei:
            rep.predict(x, 5000, tenant="ghost")
        assert ei.value.tenant == "ghost"
        np.testing.assert_allclose(rep.predict(x, 5000, tenant="b")[0], x)
    finally:
        router.stop()


def test_serving_report_equal_on_a_torn_journal(tmp_path):
    path = str(tmp_path / "j.jsonl")
    rows = [
        {"kind": "serving_start"},
        {"kind": "tenant_add", "tenant": "a", "slo": "gold"},
        {"kind": "tenant_page_in", "tenant": "a", "cost_ms": 12.5,
         "evicted": [], "hot": ["a"]},
        {"kind": "serving_batch", "tenant": "a", "batch": 3, "delivered":
         2, "bucket": 4, "fill": 0.75, "pad_waste": 0.25, "hits": 1,
         "misses": 1, "tenant_p99_ms": 4.0, "p99_ms": 5.0},
        {"kind": "serving_shed", "tenant": "a", "tier": "rate_budget"},
        {"kind": "serving_deadline_miss", "tenant": "a",
         "stage": "post_batch"},
        {"kind": "tenant_quarantine", "tenant": "a", "frm": "admitted",
         "to": "quarantined", "reason": "shape_reject", "trace_id": "t1"},
        {"kind": "tenant_quarantine", "tenant": "a", "frm": "half_open",
         "to": "admitted", "reason": "probe_succeeded"},
        {"kind": "tenant_page_out", "tenant": "a", "n_params": 4},
        {"kind": "serving_reload", "tenant": "a", "step": 3},
        {"kind": "deploy_start", "trace_id": "t9", "from_step": 1,
         "to_step": 2},
        {"kind": "gate_eval", "n": 1, "verdict": "breach",
         "reasons": ["parity"]},
        {"kind": "deploy_done", "result": "rolled_back", "reason":
         "parity", "rollback_ms": 12.0},
        {"kind": "decode_step", "active": 2, "ts": 1.0},
        {"kind": "aot_prewarm", "loaded": 0, "compiled": 4, "ms": 3.0},
        {"kind": "serving_stop", "stuck": False},
    ]
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps({"ts": 1.0, **row}) + "\n")
        f.write('{"kind": "serving_batch", "batch": 9, "deli')   # torn
    rep = treport(path)
    assert rep == jreport(path)
    assert rep["tenants"]["a"]["readmitted"] and rep["served"] == 2
    assert rep["deploy"]["last"]["result"] == "rolled_back"
    missing = str(tmp_path / "none.jsonl")
    assert treport(missing) == jreport(missing)


def test_bf16_block_served_as_float32():
    """A bf16 block behind a CPU Server: the answers reach the host as
    float32 holding the bf16 outputs exactly (the host copy raised a
    TypeError on bfloat16 before)."""
    from mxnet_tpu_torch.contrib import amp
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Embedding(50, 8), nn.Dense(4, flatten=False, in_units=8))
    net.initialize(ctx=tmx.cpu(), generator=tmx.random.generator(3))
    amp.convert_hybrid_block(net, "bfloat16")
    ids = np.random.RandomState(2).randint(0, 50, (3, 5)).astype(np.int32)
    server = tserving.Server(net, tserving.ServerConfig(
        max_batch=4, window_ms=1.0, dtype="int32"), ctx=tmx.cpu()).start()
    try:
        got = [server.predict(row) for row in ids]
    finally:
        server.stop()
    with torch.inference_mode():
        want = net(torch.from_numpy(ids))
    assert want.dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w.float().numpy())

"""Serving-journal summarizer — stdlib only (counterpart of
``mxnet_tpu/serving/report.py``).

Parses a JSONL diagnostics journal (``MXNET_TPU_JOURNAL=<file>`` during
a serving run) and reduces the records of the last run (everything
after the final ``serving_start``, or the final ``pool_start`` of a
pool run) to the operator signals: shed rate, predictor-cache hit rate,
deadline misses, reload history, and the router, tenant, deploy, decode,
AOT-cache and shard-plan sections when their records are there. Junk or
truncated lines are skipped: a crashed writer's torn tail must not hide
the healthy prefix. The record kinds and the returned dict are the
reference's, ``aot_*`` and ``shard_place`` included, so the two
packages' reports of one journal compare equal.

Importable without torch: it imports nothing but ``json``.
"""
from __future__ import annotations

import json

__all__ = ["serving_report"]

_KINDS = ("serving_start", "serving_stop", "serving_batch", "serving_shed",
          "serving_reject", "serving_deadline_miss", "serving_reload",
          "serving_reload_failed", "serving_stopped_reject",
          "serving_cancelled",
          # the replica-pool tier (serving/pool.py + router.py)
          "pool_start", "pool_stop", "pool_spawn", "pool_drain",
          "pool_restart", "pool_reload", "replica_lost",
          "replica_respawn_exhausted", "router_start", "router_stop",
          "router_retry", "router_hedge", "router_breaker", "router_shed",
          "router_budget_exhausted",
          # the tenant-fleet tier (serving/fleet.py)
          "tenant_add", "tenant_remove", "tenant_quarantine",
          "tenant_page_in", "tenant_page_out",
          # the persistent AOT executable cache (serving/aotcache.py)
          "aot_store", "aot_store_failed", "aot_fallback",
          "aot_prewarm", "aot_gc",
          # the continuous-batching decode engine (serving/decode.py)
          "decode_start", "decode_stop", "decode_warmup", "decode_admit",
          "decode_step", "decode_finish", "decode_cancel",
          "decode_preempt", "decode_deadline_miss", "decode_shed",
          # the tensor-parallel plan (serving/shardplan.py)
          "shard_place",
          # the canary deployment controller (serving/deploy.py)
          "deploy_start", "canary_up", "gate_eval", "promote",
          "rollback", "deploy_done", "deploy_mirror_mismatch",
          "pool_pin")

_DEPLOY_KINDS = ("deploy_start", "canary_up", "gate_eval", "promote",
                 "rollback", "deploy_done", "deploy_mirror_mismatch",
                 "pool_pin")

_AOT_KINDS = ("aot_store", "aot_store_failed", "aot_fallback",
              "aot_prewarm", "aot_gc")

_TENANT_KINDS = ("tenant_add", "tenant_remove", "tenant_quarantine",
                 "tenant_page_in", "tenant_page_out")

_DECODE_KINDS = ("decode_start", "decode_stop", "decode_warmup",
                 "decode_admit", "decode_step", "decode_finish",
                 "decode_cancel", "decode_preempt",
                 "decode_deadline_miss", "decode_shed")

_POOL_KINDS = ("pool_start", "pool_stop", "pool_spawn", "pool_drain",
               "pool_restart", "pool_reload", "replica_lost",
               "replica_respawn_exhausted", "router_start", "router_stop",
               "router_retry", "router_hedge", "router_breaker",
               "router_shed", "router_budget_exhausted")


def _read_records(path):
    records = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue                 # torn tail of a killed writer
                if isinstance(rec, dict) and rec.get("kind") in _KINDS:
                    records.append(rec)
    except OSError as e:
        return None, f"cannot read {path}: {e.strerror or e}"
    return records, None


def _last_run_start(records) -> int:
    """Index where the last run begins (see the caller's comment).

    Known limit: a pool drill that CRASHED (no ``pool_stop``) followed
    by a solo Server run in the same journal file still anchors at the
    crashed drill's ``pool_start`` — a healthy pool run is thousands of
    worker ``serving_batch``/``serving_start`` records with *no* pool-
    kind records between them, so "a serving_start after the last pool
    record" cannot distinguish the solo run without misanchoring the
    healthy fleet case. Use one journal file per run (what every test
    and the bench do) and the question does not arise."""
    def last(kind):
        for i in range(len(records) - 1, -1, -1):
            if records[i]["kind"] == kind:
                return i
        return None

    i_pool = last("pool_start")
    if i_pool is None:
        i_start = last("serving_start")
        return 0 if i_start is None else i_start
    i_stop = last("pool_stop")
    if i_stop is not None and i_stop > i_pool:
        # the pool run closed; a serving_start after the close is a new
        # solo run and wins the anchor
        solo = [i for i in range(i_stop + 1, len(records))
                if records[i]["kind"] == "serving_start"]
        if solo:
            return solo[-1]
    return i_pool


def serving_report(path) -> dict:
    """Summarize the last serving run's journal records (see module
    docstring).  Always returns a dict; ``ok`` is False with an
    ``error`` when the file is unreadable or holds no serving records."""
    records, err = _read_records(path)
    if records is None:
        return {"ok": False, "path": path, "error": err}
    # last run = records after the final pool_start when the pool run is
    # the LAST run (every worker replica contributes its own
    # serving_start — slicing at the last of those would hide the rest
    # of the fleet). A pool run that already closed (pool_stop) followed
    # by a later solo serving_start is a finished drill: anchor at the
    # newer solo run instead of resurrecting the stale fleet records.
    records = records[_last_run_start(records):]
    if not records:
        return {"ok": False, "path": path,
                "error": "no serving records in journal"}

    batches = [r for r in records if r["kind"] == "serving_batch"]
    sheds = sum(1 for r in records if r["kind"] == "serving_shed")
    rejects = sum(1 for r in records if r["kind"] == "serving_reject")
    misses = {"dequeue": 0, "post_batch": 0}
    for r in records:
        if r["kind"] == "serving_deadline_miss":
            misses[r.get("stage", "dequeue")] = \
                misses.get(r.get("stage", "dequeue"), 0) + 1
    reloads = [r for r in records if r["kind"] == "serving_reload"]
    reload_failures = sum(1 for r in records
                          if r["kind"] == "serving_reload_failed")

    # delivered excludes post_batch deadline misses (they are inside
    # `batch` but got an error response); older records without the
    # field fall back to the batch size
    served = sum(int(r.get("delivered", r.get("batch", 0)))
                 for r in batches)
    admitted = sum(int(r.get("batch", 0)) for r in batches) + \
        misses.get("dequeue", 0)
    offered = admitted + sheds
    out = {"ok": True, "path": path,
           "batches": len(batches), "served": served,
           "shed": sheds, "rejected_shape": rejects,
           "shed_rate": round(sheds / offered, 4) if offered else None,
           "deadline_miss": misses,
           "deadline_miss_total": sum(misses.values()),
           "reloads": [{"step": r.get("step"),
                        "prev_step": r.get("prev_step")} for r in reloads],
           "reload_failures": reload_failures}
    if batches:
        last = batches[-1]
        hits, miss = int(last.get("hits", 0)), int(last.get("misses", 0))
        out["compiles"] = miss
        out["cache_hit_rate"] = round(hits / (hits + miss), 4) \
            if hits + miss else None
        out["last_batch"] = {
            k: last.get(k) for k in ("queue_depth", "batch", "bucket",
                                     "fill", "pad_waste", "params_step",
                                     "p50_ms", "p95_ms", "p99_ms")}
        fills = [float(r.get("fill", 0)) for r in batches]
        out["mean_fill"] = round(sum(fills) / len(fills), 4)
        waste = [float(r.get("pad_waste", 0)) for r in batches]
        out["mean_pad_waste"] = round(sum(waste) / len(waste), 4)
    else:
        out["compiles"] = 0
        out["cache_hit_rate"] = None
    stops = [r for r in records if r["kind"] == "serving_stop"]
    out["clean_stop"] = bool(stops) and not stops[-1].get("stuck", False)
    router = _router_section(records)
    if router is not None:
        out["router"] = router
    tenants = _tenant_section(records)
    if tenants is not None:
        out["tenants"] = tenants
    aot = _aot_section(records)
    if aot is not None:
        out["aot"] = aot
    decode = _decode_section(records)
    if decode is not None:
        out["decode"] = decode
    deploy = _deploy_section(records)
    if deploy is not None:
        out["deploy"] = deploy
    placements = [r for r in records if r["kind"] == "shard_place"]
    if placements:
        last_place = placements[-1]
        out["sharding"] = {"mesh": last_place.get("mesh"),
                           "params": last_place.get("params"),
                           "site": last_place.get("site"),
                           "placements": len(placements)}
    return out


def _decode_section(records) -> dict | None:
    """Continuous-batching reduction of the last run: slot-occupancy
    histogram (how full the pool actually ran), steps/s throughput,
    admit/finish/preempt/cancel/shed ledger, and warmup compile counts
    — the operator view of one decode run (docs/serving.md continuous
    batching)."""
    dec = [r for r in records if r["kind"] in _DECODE_KINDS]
    if not dec:
        return None
    count = lambda k: sum(1 for r in dec if r["kind"] == k)  # noqa: E731
    steps = [r for r in dec if r["kind"] == "decode_step"]
    finishes = [r for r in dec if r["kind"] == "decode_finish"]
    # occupancy histogram keyed by ACTIVE slot count: {"3": 41} reads
    # "41 steps ran with 3 slots live" — the fill story for the pool
    occupancy: dict = {}
    for r in steps:
        k = str(int(r.get("active", 0)))
        occupancy[k] = occupancy.get(k, 0) + 1
    span_s = (float(steps[-1].get("ts", 0.0)) -
              float(steps[0].get("ts", 0.0))) if len(steps) > 1 else 0.0
    cancels = {"queued": 0, "active": 0}
    for r in dec:
        if r["kind"] == "decode_cancel":
            stage = str(r.get("stage", "active"))
            cancels[stage] = cancels.get(stage, 0) + 1
    warmups = [r for r in dec if r["kind"] == "decode_warmup"]
    out = {
        "steps": len(steps),
        "steps_per_s": round(len(steps) / span_s, 2) if span_s > 0
        else None,
        "occupancy_hist": occupancy,
        "admitted": count("decode_admit"),
        "finished": len(finishes),
        "tokens_out": sum(int(r.get("generated", 0)) for r in finishes),
        "preempted": count("decode_preempt"),
        "cancelled": cancels,
        "cancelled_total": sum(cancels.values()),
        "deadline_miss_admit": count("decode_deadline_miss"),
        "shed": count("decode_shed"),
        "warmup_programs": sum(int(r.get("programs", 0))
                               for r in warmups),
    }
    if steps:
        last = steps[-1]
        out["last_step"] = {k: last.get(k) for k in
                            ("active", "slots", "occupancy", "step_ms",
                             "queue_depth", "p50_ms", "p95_ms")}
    stops = [r for r in dec if r["kind"] == "decode_stop"]
    if stops:
        out["clean_stop"] = not stops[-1].get("stuck", False)
    return out


def _aot_section(records) -> dict | None:
    """AOT-cache reduction of the last run: stores, fallbacks by
    reason (the corrupt/stale/truncated ledger), prewarm loaded-vs-
    compiled split, and GC evictions — the warm-start story one journal
    tells (docs/serving.md AOT cache)."""
    aot = [r for r in records if r["kind"] in _AOT_KINDS]
    if not aot:
        return None
    fallbacks: dict = {}
    for r in aot:
        if r["kind"] == "aot_fallback":
            reason = str(r.get("reason", "unknown"))
            fallbacks[reason] = fallbacks.get(reason, 0) + 1
    prewarms = [r for r in aot if r["kind"] == "aot_prewarm"]
    return {
        "stores": sum(1 for r in aot if r["kind"] == "aot_store"),
        "store_failures": sum(1 for r in aot
                              if r["kind"] == "aot_store_failed"),
        "fallbacks": fallbacks,
        "fallback_total": sum(fallbacks.values()),
        "prewarmed": {
            "loaded": sum(int(r.get("loaded", 0)) for r in prewarms),
            "compiled": sum(int(r.get("compiled", 0)) for r in prewarms),
            "ms": round(sum(float(r.get("ms", 0.0)) for r in prewarms),
                        2)},
        "gc_evicted": sum(int(r.get("evicted", 0)) for r in aot
                          if r["kind"] == "aot_gc"),
    }


def _tenant_section(records) -> dict | None:
    """Tenant-fleet reduction of the last run: per tenant — traffic
    counts, tenant-classed sheds, the quarantine→half-open→re-admit
    trail in order (with trace ids), paging counts + total page-in cost
    (so paging can be told apart from tail latency), and reload steps.
    The operator view of one tenant-isolation chaos drill
    (docs/serving.md failure matrix)."""
    named = [r for r in records
             if r["kind"] in _TENANT_KINDS or r.get("tenant") is not None]
    if not any(r["kind"] in _TENANT_KINDS for r in records):
        return None
    out: dict = {}

    def row(name):
        if name not in out:
            out[name] = {"batches": 0, "served": 0, "shed": 0,
                         "sheds_by_tier": {}, "rejected_shape": 0,
                         "deadline_miss": 0, "quarantine_trail": [],
                         "readmitted": False, "page_ins": 0,
                         "page_in_cost_ms": 0.0, "page_outs": 0,
                         "reload_steps": [], "removed": False,
                         "last_p99_ms": None}
        return out[name]

    for r in named:
        name = r.get("tenant")
        if name is None:
            continue
        kind = r["kind"]
        t = row(name)
        if kind == "serving_batch":
            t["batches"] += 1
            t["served"] += int(r.get("delivered", r.get("batch", 0)))
            # tenant_p99_ms is THIS tenant's own summary (the record's
            # p99_ms is fleet-wide and would attribute other tenants'
            # tails to this one)
            t["last_p99_ms"] = r.get("tenant_p99_ms")
        elif kind == "serving_shed":
            t["shed"] += 1
            tier = r.get("tier", "queue_full")
            t["sheds_by_tier"][tier] = t["sheds_by_tier"].get(tier, 0) + 1
        elif kind == "serving_reject":
            t["rejected_shape"] += 1
        elif kind == "serving_deadline_miss":
            t["deadline_miss"] += 1
        elif kind == "tenant_quarantine":
            t["quarantine_trail"].append(
                {"frm": r.get("frm"), "to": r.get("to"),
                 "reason": r.get("reason"),
                 "trace_id": r.get("trace_id")})
            if r.get("frm") == "half_open" and r.get("to") == "admitted":
                t["readmitted"] = True
        elif kind == "tenant_page_in":
            t["page_ins"] += 1
            t["page_in_cost_ms"] = round(
                t["page_in_cost_ms"] + float(r.get("cost_ms") or 0.0), 2)
        elif kind == "tenant_page_out":
            t["page_outs"] += 1
        elif kind == "serving_reload":
            t["reload_steps"].append(r.get("step"))
        elif kind == "tenant_remove":
            t["removed"] = True
    return out


def _deploy_section(records) -> dict | None:
    """Canary-deployment reduction of the last run: the full
    deploy_start→canary_up→gate_eval…→promote/rollback→deploy_done
    trail in order (with trace ids — one ``deploy`` span covers it),
    gate-breach/mirror-mismatch counters, and the last deployment's
    outcome.  The operator view of one deploy drill (docs/serving.md,
    canary deployment)."""
    dep = [r for r in records if r["kind"] in _DEPLOY_KINDS]
    if not any(r["kind"] == "deploy_start" for r in dep) \
            and not any(r["kind"] == "deploy_done" for r in dep):
        return None
    count = lambda k: sum(1 for r in dep if r["kind"] == k)  # noqa: E731
    trail = []
    for r in dep:
        if r["kind"] == "pool_pin":
            continue                     # pins are counted, not trailed
        row = {"kind": r["kind"], "trace_id": r.get("trace_id")}
        for k in ("from_step", "to_step", "step", "verdict", "reasons",
                  "reason", "result", "replicas", "n", "canary",
                  "rollback_ms"):
            if r.get(k) is not None:
                row[k] = r.get(k)
        trail.append(row)
    dones = [r for r in dep if r["kind"] == "deploy_done"]
    evals = [r for r in dep if r["kind"] == "gate_eval"]
    out = {
        "deploys": count("deploy_start"),
        "gate_evals": len(evals),
        "gate_breaches": sum(1 for r in evals
                             if r.get("verdict") == "breach"),
        "mirror_mismatches": count("deploy_mirror_mismatch"),
        "promotions": count("promote"),
        "rollbacks": count("rollback"),
        "pins": count("pool_pin"),
        "trail": trail,
    }
    if dones:
        last = dones[-1]
        out["last"] = {k: last.get(k) for k in
                       ("result", "reason", "from_step", "to_step",
                        "canary", "gate_evals", "rollback_ms",
                        "converged", "deploy_ms")
                       if last.get(k) is not None}
    return out


def _router_section(records) -> dict | None:
    """Replica-pool/router reduction of the last run: retry/hedge/shed
    counts, every breaker transition in order, replica losses/restarts
    and half-open re-admissions — the operator view of one chaos drill
    (docs/serving.md failure matrix)."""
    pool = [r for r in records if r["kind"] in _POOL_KINDS]
    if not pool:
        return None
    count = lambda k: sum(1 for r in pool if r["kind"] == k)  # noqa: E731
    transitions = [
        {"replica": r.get("replica"), "frm": r.get("frm"),
         "to": r.get("to"), "reason": r.get("reason"),
         "trace_id": r.get("trace_id")}
        for r in pool if r["kind"] == "router_breaker"]
    sheds: dict = {}
    for r in pool:
        if r["kind"] == "router_shed":
            t = r.get("tier", "unknown")
            sheds[t] = sheds.get(t, 0) + 1
    readmitted = sorted({t["replica"] for t in transitions
                         if t["frm"] == "half_open"
                         and t["to"] == "closed"})
    return {
        "retries": count("router_retry"),
        "hedges": count("router_hedge"),
        "budget_exhausted": count("router_budget_exhausted"),
        "sheds_by_tier": sheds,
        "breaker_transitions": transitions,
        "replicas_lost": [
            {"replica": r.get("replica"), "idle_s": r.get("idle_s")}
            for r in pool if r["kind"] == "replica_lost"],
        "restarts": count("pool_restart"),
        "drains": count("pool_drain"),
        "reload_rolls": sum(1 for r in pool if r["kind"] == "pool_reload"
                            and r.get("phase") == "end"),
        "readmitted": readmitted,
        "respawn_exhausted": count("replica_respawn_exhausted"),
    }

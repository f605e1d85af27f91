"""Stdlib-only summary of the guardrails' journal records (counterpart
of ``mxnet_tpu/guardrails/report.py``).

Reads a JSONL journal (``MXNET_TPU_JOURNAL=<file>``) and summarizes the
training-anomaly records: the skipped steps, the worst consecutive run,
every divergence rollback and any ``TrainingDiverged`` crash. It imports
nothing but the standard library, so it works where the runtime does
not.
"""
from __future__ import annotations

import json

__all__ = ["guard_report"]


def guard_report(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
    except OSError as e:
        return {"ok": False, "path": path,
                "error": f"cannot read journal: {e.strerror or e}"}
    records = 0
    skips = []
    spikes = 0
    rollbacks = []
    diverged = []
    worst_consecutive = 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue                      # torn tail line from a kill
        if not isinstance(rec, dict):
            continue
        records += 1
        kind = rec.get("kind")
        if kind == "nonfinite_grad":
            skips.append(rec)
            worst_consecutive = max(worst_consecutive,
                                    int(rec.get("consecutive", 0) or 0))
        elif kind == "loss_spike":
            spikes += 1
        elif kind == "divergence_rollback":
            rollbacks.append({k: rec.get(k) for k in
                              ("step", "restored_step", "reason",
                               "lr_backoff", "rollback", "consumer")})
        elif kind == "crash" and rec.get("error") == "TrainingDiverged":
            diverged.append({"detail": rec.get("detail"),
                             "phase": rec.get("phase")})
    out = {"ok": True, "path": path, "records": records,
           "skipped_steps": len(skips),
           "worst_consecutive_skips": worst_consecutive,
           "loss_spikes": spikes,
           "rollbacks": rollbacks,
           "diverged_errors": diverged}
    if skips:
        out["first_skip_step"] = skips[0].get("step")
        out["last_skip_step"] = skips[-1].get("step")
        consumers = {}
        for rec in skips:
            c = rec.get("consumer") or "?"
            consumers[c] = consumers.get(c, 0) + 1
        out["skips_by_consumer"] = consumers
    return out

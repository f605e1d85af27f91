"""Hot-reload source: newest *valid* committed checkpoint step
(counterpart of ``mxnet_tpu/serving/reload.py``).

A trainer publishes checkpoints through the directory commit protocol
(``resilience.commit``: stage → CRC manifest → one rename;
``ShardedTrainer.checkpoint`` and ``gluon.Trainer.checkpoint`` write
it); the server polls the same root from the other side.
:class:`ParamStore` hands the serving worker a parameter dict from the
newest committed step that passes CRC validation AND loads
cleanly — a producer SIGTERM'd mid-commit leaves either an invisible
``step-N.tmp`` stage or a manifest that fails validation, so a torn
checkpoint can never reach a response.  Every skipped candidate is
journaled (``ckpt_fallback``), and steps that validated but failed to
parse are remembered so one bad step can't wedge the poll loop.

The dict is applied between batches by ``Server._maybe_reload`` via
``Block.load_dict``, which copies into the live parameters in place: the
predictors' CUDA graphs read the parameters where they live
(serving/cache.py), so a swap captures nothing, and every request rides
the version its batch started with.
"""
from __future__ import annotations

import os
from collections import OrderedDict

from ..base import MXNetError
from ..diagnostics.journal import get_journal
from ..resilience import commit as _commit

__all__ = ["ParamStore"]


def _env_int(name, default):
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


class ParamStore:
    """Poll a commit-protocol checkpoint root for fresh parameters.

    ``params_file``: name of the parameter file inside a committed step
    dir; default picks the first ``*.params`` manifest entry (a
    ``Block.save_parameters`` or ``HybridBlock.export`` artifact —
    ``arg:``/``aux:`` prefixes are handled by ``load_dict``).

    The remembered bad-step set is an LRU bounded by ``max_bad_steps``
    (``MXNET_TPU_SERVING_BAD_STEPS_CAP``, default 64, the reference's
    variable): a long-lived
    server polling a churning commit root must not grow host memory
    one entry per corrupt candidate forever.  Evicting a remembered
    step only costs a re-validation (journaled ``ckpt_fallback`` again)
    if that step ever resurfaces as a candidate."""

    def __init__(self, root, params_file=None, max_bad_steps=None):
        self.root = root
        self.params_file = params_file
        self.loaded_step = None
        self.corrupt_seen = 0          # lifetime count of NEW bad steps
                                       # (the fleet's per-tenant breaker
                                       # reads the delta after poll())
        self.pinned_step = None        # deploy pin: poll() never advances
                                       # past this step while set
        self._bad_steps = OrderedDict()        # step -> None, LRU order
        self._bad_cap = max(int(
            _env_int("MXNET_TPU_SERVING_BAD_STEPS_CAP", 64)
            if max_bad_steps is None else max_bad_steps), 1)

    def _pick_file(self, step, manifest):
        if self.params_file is not None:
            if self.params_file not in manifest["files"]:
                raise MXNetError(
                    f"step {step}: manifest has no {self.params_file!r} "
                    f"(files: {sorted(manifest['files'])})")
            return self.params_file
        for name in sorted(manifest["files"]):
            if name.endswith(".params"):
                return name
        raise MXNetError(f"step {step}: no .params file in manifest "
                         f"(files: {sorted(manifest['files'])})")

    def poll(self):
        """Return ``(step, name→NDArray dict)`` when a step newer than
        the loaded one is available and intact, else None.  Corrupt or
        unparseable candidates are journaled and skipped — never served,
        never fatal."""
        from .. import ndarray as nd
        for step in sorted(_commit.committed_steps(self.root), reverse=True):
            if self.pinned_step is not None and step > self.pinned_step:
                continue             # pinned: newer commits are invisible
            if self.loaded_step is not None and step <= self.loaded_step:
                return None          # newest usable is already serving
            if step in self._bad_steps:
                continue
            try:
                manifest = _commit.validate_step(self.root, step)
                fname = self._pick_file(step, manifest)
                loaded = nd._load_tensors(
                    os.path.join(_commit.step_dir(self.root, step), fname))
                if not isinstance(loaded, dict):
                    raise MXNetError(f"{fname} is not a parameter dict")
            except (ValueError, MXNetError, OSError) as e:
                # ValueError: torn/corrupt per the manifest CRCs;
                # MXNetError: container-level CRC/truncation from nd.load;
                # OSError: the step dir raced a trainer's keep-last-k GC
                # between listing and read — gone is just another skip.
                # Only the first two count as CORRUPTION (corrupt_seen,
                # which the fleet feeds to a tenant breaker): a benign
                # GC race must never quarantine a healthy tenant.
                self._remember_bad(step,
                                   corrupt=not isinstance(e, OSError))
                get_journal().event(
                    "ckpt_fallback", root=self.root, step=step,
                    consumer="serving", error=type(e).__name__,
                    detail=str(e)[:300])
                continue
            self.loaded_step = step
            return step, loaded
        return None

    def _remember_bad(self, step, corrupt=True):
        """LRU-insert one bad step under the cap; an eviction is
        journaled once (dedup note) so the operator can see the memory
        is bounded, not leaking skips silently.  ``corrupt=False``
        remembers the skip without counting it as corruption (GC races,
        architecture drift — they feed no breaker)."""
        if step in self._bad_steps:
            self._bad_steps.move_to_end(step)
        else:
            if corrupt:
                self.corrupt_seen += 1
            self._bad_steps[step] = None
        while len(self._bad_steps) > self._bad_cap:
            evicted, _ = self._bad_steps.popitem(last=False)
            get_journal().event(
                "ckpt_fallback", root=self.root, step=evicted,
                consumer="serving", note="bad-step memory evicted "
                "(LRU cap) — re-journals only if it resurfaces",
                cap=self._bad_cap)

    def pin_step(self, step):
        """Freeze the store at ``step``: :meth:`poll` ignores every
        newer commit until ``pin_step(None)`` unpins.  The deploy
        controller's rollback lever — a rolled-back replica pinned to
        the old step cannot silently re-adopt the bad root on its next
        poll (docs/serving.md, canary deployment).  Pinning does NOT
        load anything by itself; pair with :meth:`load_step` (or let
        ``Server.pin_params`` drive the apply) when the live step must
        change."""
        self.pinned_step = None if step is None else int(step)

    def load_step(self, step):
        """Load exactly ``step`` — validated like :meth:`poll`, but an
        explicit target instead of newest-wins, and downgrades are
        allowed (``step`` may be older than ``loaded_step``).  Raises on
        a torn/missing/unparseable step instead of skipping: the caller
        asked for THIS step, so there is no safe substitute.  On success
        ``loaded_step`` moves to ``step``."""
        from .. import ndarray as nd
        step = int(step)
        manifest = _commit.validate_step(self.root, step)   # ValueError on CRC
        fname = self._pick_file(step, manifest)
        loaded = nd._load_tensors(
            os.path.join(_commit.step_dir(self.root, step), fname))
        if not isinstance(loaded, dict):
            raise MXNetError(f"{fname} is not a parameter dict")
        self.loaded_step = step
        return step, loaded

    def mark_bad(self, step, revert_to=None):
        """Remember ``step`` as unusable and roll ``loaded_step`` back
        to ``revert_to`` — the server's hook for a checkpoint that
        validated but failed to APPLY (architecture drift), keeping the
        bad-step bookkeeping in one place.  Not a CRC corruption: the
        caller already classified (and breaker-fed) this failure, so it
        must not double-count through ``corrupt_seen``."""
        self._remember_bad(step, corrupt=False)
        self.loaded_step = revert_to

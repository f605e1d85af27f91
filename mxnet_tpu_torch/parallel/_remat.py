"""Rematerialization of ``ShardedTrainer``'s differentiated function
(``remat=``; counterpart of ``jax.checkpoint`` around ``loss_of`` in
``mxnet_tpu/parallel/sharded.py``).

The function (the cast, the forward and the loss) runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps
only what the policy saves and runs the forward again inside the
backward for the rest:

- ``"full"`` saves nothing;
- ``"dots"`` saves the outputs of the matmul and convolution ops (JAX's
  ``dots_saveable``: ``dot_general`` and ``conv_general_dilated``) and
  recomputes the rest, through PyTorch's selective checkpointing;
- ``"dots_no_batch"`` saves ``mm`` and ``addmm`` only
  (``dots_with_no_batch_dims_saveable``: ``bmm`` and ``baddbmm`` carry
  batch dimensions);
- a callable is a selective-checkpoint policy of PyTorch's,
  ``(ctx, op, *args, **kwargs) -> CheckpointPolicy``; a JAX policy
  cannot be passed.

The hand-written kernels (K1, K2, K3) launch through ctypes inside
``torch.autograd.Function``\\ s, which no policy sees, so every policy
recomputes them, as JAX's dots policies recompute a ``pallas_call``.

The recompute computes what the first forward computed, bit for bit:
it runs in the first forward's scope (recording, training, inside a
program's capture), which it sets on whichever thread runs the
backward; every dropout draw hands back the bits the first forward drew
(:func:`random.kept_bits`, one uint8 per element, what the mask's
backward keeps anyway), so no generator is read or advanced, which also
keeps the recompute capturable in the step's CUDA graph; and BatchNorm's
fold of its batch statistics into the running ones
(:func:`autograd.aux_update`), whose running mean the moments read as
their shift, is queued by the first forward, skipped by the recompute
and run by the trainer after the backward, once.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import autograd as _autograd
from .. import random as _random
from ..base import MXNetError
from ..gluon import cached_graph as _cg

__all__ = ["resolve_policy", "run"]

_aten = torch.ops.aten
DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
        _aten.baddbmm.default, _aten.convolution.default,
        _aten.cudnn_convolution.default, _aten._scaled_mm.default)
DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)


def resolve_policy(remat):
    """``remat=`` as the trainer keeps it: None, ``"full"``, or a
    selective-checkpoint policy function."""
    if remat is None or (isinstance(remat, str) and remat == "full"):
        return remat
    if isinstance(remat, str) and remat in ("dots", "dots_no_batch"):
        return list(DOTS if remat == "dots" else DOTS_NO_BATCH)
    if callable(remat):
        return remat
    raise MXNetError(f"unknown remat policy {remat!r}; expected None, "
                     "'full', 'dots', 'dots_no_batch' or a torch "
                     "selective-checkpoint policy callable")


def run(fn, policy, *args):
    """``fn(*args)`` under the checkpoint of ``policy`` (from
    :func:`resolve_policy`, not None). Returns (its result, the queued
    auxiliary updates): the caller runs each ``update(*args)`` after the
    backward."""
    kept, queued, scope = [], [], {}

    @contextlib.contextmanager
    def first():
        scope["state"] = _autograd._scope_state()
        scope["depth"] = getattr(_cg._local, "depth", 0)
        with _random.kept_bits(kept), _autograd._aux_updates_queued(queued):
            yield

    @contextlib.contextmanager
    def again():
        depth = getattr(_cg._local, "depth", 0)
        _cg._local.depth = scope["depth"]
        try:
            with _autograd._recompute_scope(scope["state"]), \
                    _random.bits_tape(replay=kept):
                yield
        finally:
            _cg._local.depth = depth

    def contexts():
        if policy == "full":
            return first(), again()
        saving, cached = create_selective_checkpoint_contexts(policy)
        return _both(saving, first()), _both(cached, again())

    out = checkpoint(fn, *args, use_reentrant=False,
                     preserve_rng_state=False, context_fn=contexts)
    return out, queued


@contextlib.contextmanager
def _both(outer, inner):
    with outer, inner:
        yield

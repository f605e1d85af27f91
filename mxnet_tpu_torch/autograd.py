"""Autograd scopes and ``backward`` (counterpart of
``mxnet_tpu/autograd.py``).

PyTorch records the graph itself; the port keeps MXNet's scopes around
it. ``record()`` turns recording on (``torch.enable_grad``) and, by
default, training mode; ``pause()`` turns recording off
(``torch.no_grad``); ``train_mode()`` and ``predict_mode()`` set the mode
alone. Blocks read the mode of the innermost scope (``Block.training``),
so ``record()`` engages dropout in every block's ops, as in MXNet; outside
any scope a block keeps its own mode (predict unless ``.train()``).

:func:`backward` takes heads that are not scalars (their head gradient
defaults to ones, as in MXNet; a tensor's own ``.backward()`` refuses
them) and honours each leaf's ``grad_req``: ``"write"`` (the default)
replaces the leaf's ``.grad``, ``"add"`` adds to it, as Gluon does.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError

__all__ = ["backward", "is_recording", "is_training", "pause",
           "predict_mode", "record", "train_mode"]

_state = threading.local()


def _get(name):
    return getattr(_state, name, None)


class _Scope:
    """Sets recording and/or training for the ``with`` block (None leaves
    one as it was)."""

    def __init__(self, recording, training):
        self._rec = recording
        self._train = training
        self._grad = None

    def __enter__(self):
        self._old = (_get("recording"), _get("training"))
        if self._rec is not None:
            _state.recording = self._rec
            self._grad = torch.set_grad_enabled(self._rec)
            self._grad.__enter__()
        if self._train is not None:
            _state.training = self._train
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training = self._old
        if self._grad is not None:
            self._grad.__exit__(*exc)


def record(train_mode: bool = True):
    """Scope that records the graph and, by default, trains (ref:
    autograd.record)."""
    return _Scope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope that stops recording (ref: autograd.pause)."""
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def is_recording() -> bool:
    return bool(_get("recording"))


def is_training() -> bool:
    return bool(_get("training"))


def aux_update(fn, *args):
    """Run ``fn(*args)``, an in-place update of auxiliary state that a
    forward makes (BatchNorm's fold of its batch statistics): at once;
    in a checkpointed region's first forward, queued for its trainer to
    run after the backward, so the recompute reads the state the first
    forward read (as ``jax.checkpoint`` returns the new state as an
    output); never in the recompute."""
    if _get("recomputing"):
        return
    queue = _get("aux_updates")
    if queue is None:
        fn(*args)
    else:
        queue.append((fn, args))


@contextlib.contextmanager
def _aux_updates_queued(queue):
    """Within the scope, :func:`aux_update` appends to ``queue``."""
    old = _get("aux_updates")
    _state.aux_updates = queue
    try:
        yield queue
    finally:
        _state.aux_updates = old


def _scope_state():
    """This thread's (recording, training), for :func:`_recompute_scope`."""
    return _get("recording"), _get("training")


@contextlib.contextmanager
def _recompute_scope(state):
    """The scope of a recompute, on whichever thread runs the backward:
    recording and training as ``state`` (:func:`_scope_state` of the
    first forward), and :func:`aux_update` a no-op."""
    old = _get("recording"), _get("training"), _get("recomputing")
    (_state.recording, _state.training), _state.recomputing = state, True
    try:
        yield
    finally:
        _state.recording, _state.training, _state.recomputing = old


def scope_training():
    """The training mode the innermost scope set, or None outside every
    scope (what ``Block.training`` reads)."""
    return _get("training")


def _leaves(heads):
    """The leaf tensors whose gradients a backward from ``heads`` fills."""
    seen, out = set(), [h for h in heads if h.grad_fn is None]
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)     # an AccumulateGrad node
        if var is not None:
            out.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return out


def _tensor(x):
    """An NDArray head (or head gradient) as its tensor."""
    return getattr(x, "_data", x)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (a tensor or an NDArray, or a list) into
    the ``.grad`` of every leaf they were computed from (ref:
    autograd.backward). A head
    without a head gradient gets ones of its shape. ``grad_req`` (an
    attribute of the leaf, ``"write"`` unless set) decides whether the
    leaf's gradient is replaced or added to. ``train_mode`` is accepted
    (ref: autograd.backward); the recorded ops already ran in their
    mode."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    heads = [_tensor(h) for h in heads]
    head_grads = [None] * len(heads) if head_grads is None \
        else [None if g is None else _tensor(g) for g in head_grads]
    pairs = [(h, torch.ones_like(h) if g is None else g)
             for h, g in zip(heads, head_grads) if h.requires_grad]
    if not pairs:
        raise MXNetError("backward: no recorded graph reaches these heads "
                         "(compute them inside autograd.record() from "
                         "parameters that require grad)")
    for leaf in _leaves([h for h, _ in pairs]):
        if getattr(leaf, "grad_req", "write") == "write":
            leaf.grad = None
    torch.autograd.backward([h for h, _ in pairs], [g for _, g in pairs],
                            retain_graph=retain_graph)

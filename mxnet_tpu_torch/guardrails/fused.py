"""In-step guard math on tensors (counterpart of
``mxnet_tpu/guardrails/fused.py``).

Everything here is device-side tensor work, with no host sync, so that
it runs inside a training step's CUDA graph as it runs inside the JAX
package's jitted step:

- :func:`guard_stats` folds one squared-sum reduction over every
  gradient into the step. Its square root is the global gradient norm,
  and a NaN or Inf anywhere poisons the sum, so ``isfinite(sum)`` is the
  non-finite flag.
- :func:`select` is skip-step as data flow: ``where(finite, new, old)``
  per tensor, so a skipped step leaves every value bit-unchanged.
- :func:`init_guard_state` / :func:`update_guard_state` carry (total
  skips, consecutive skips) as two int32 device scalars.
- :func:`host_fetch` is the device-to-host read of guard values: a copy
  of each value it is given, with no device work. The trainers give it
  one tensor, a step's or a window's (loss, flag, norm) rows stacked on
  the device (inside the step's graph on the card), so a step reads
  once.
- :func:`clip_scale` is the global-norm clip factor, folded into the
  update's rescale.
"""
from __future__ import annotations

import torch

__all__ = ["clip_scale", "guard_stats", "host_fetch", "init_guard_state",
           "select", "update_guard_state"]


def guard_stats(grads, loss=None):
    """``(finite, global_norm)`` over every gradient (and ``loss``, when
    given): a bool 0-d tensor that is True iff every element is finite,
    and the fp32 global L2 norm. Each gradient's squared norm is taken in
    fp32; a finite gradient whose square overflows fp32 reads as
    non-finite, as in the JAX package."""
    grads = list(grads)
    if grads:
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                             for g in grads])
        total = torch.sum(norms * norms)
    else:
        total = torch.zeros((), dtype=torch.float32)
    finite = torch.isfinite(total)
    if loss is not None:
        finite = torch.logical_and(
            finite, torch.isfinite(torch.as_tensor(loss).float()))
    return finite, torch.sqrt(total)


def clip_scale(global_norm, clip_norm, eps=1e-8):
    """Global-norm clip factor ``min(1, clip / (norm + eps))``; 1 for a
    non-finite norm (the skip path owns that case)."""
    s = torch.clamp(clip_norm / (global_norm + eps), max=1.0)
    return torch.where(torch.isfinite(global_norm), s,
                       torch.ones((), dtype=torch.float32,
                                  device=global_norm.device))


def select(finite, new, old):
    """Skip-step selection: ``where(finite, a, b)`` over two matching
    lists (or tuples) of tensors."""
    return type(new)(torch.where(finite, a, b) for a, b in zip(new, old))


def init_guard_state(device="cpu"):
    """Fresh counters ``(total_skips, consecutive_skips)``: int32 zeros."""
    return (torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def update_guard_state(gstate, finite):
    """Fold one step's flag into the counters (device-side)."""
    skips, consec = gstate
    bad = torch.where(finite, 0, 1).to(torch.int32)
    return (skips + bad,
            torch.where(finite, 0, consec + 1).to(torch.int32))


def host_fetch(*vals):
    """The device-to-host read of guard values: each of the tensors or
    numbers ``vals`` copied to the host as it is (one copy each, with no
    work on the device: a graph replay stays the only launch of a step),
    and returned by dtype as Python bools, ints and floats; a tensor of
    more than 0 dimensions as a flat list of them."""
    out = []
    for v in vals:
        t = torch.as_tensor(v).detach()
        kind = bool if t.dtype == torch.bool else (
            float if t.is_floating_point() else int)
        got = [kind(h) for h in t.reshape(-1).cpu().double().tolist()]
        out.append(got[0] if t.ndim == 0 else got)
    return out

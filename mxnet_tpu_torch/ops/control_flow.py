"""Control-flow operators ``foreach``, ``while_loop`` and ``cond``
(counterpart of ``mxnet_tpu/ops/control_flow.py``, ref
``python/mxnet/ndarray/contrib.py``, MXNet 1.5).

They take Python callables, so they bypass the registry and live in
``nd.contrib``. Their arrays are NDArrays or tensors (a block's
``forward`` with ``F = mx.nd``); the callables get, and the results are,
arrays of the kind passed in. Two paths, as in the JAX package:

- **eager**: the Python loop, each step's ops recorded by autograd on
  their own; ``while_loop`` and ``cond`` read the predicate on the host.
- **program** (:func:`program_path`): inside a hybridized block's
  program (captured on the card, run eagerly on the CPU) and while the
  current stream captures a CUDA graph, where the JAX package traces.
  A capture cannot read a device predicate on the host, so
  ``while_loop`` runs ``max_iterations`` masked steps (a step after the
  predicate failed keeps the loop variables and outputs zeros) and
  ``cond`` evaluates both branches and selects with ``where``. The
  results equal the eager path's. ``MXNET_COND_IMPL=lax_cond`` has no
  counterpart here: ``cond`` is always predicated inside a program.

``foreach`` unrolls its loop on both paths (a graph holds every step).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..kernels._common import stream_capturing

__all__ = ["cond", "foreach", "program_path", "while_loop"]


def program_path() -> bool:
    """Whether control flow takes the program path here (see the module
    docstring)."""
    from ..gluon.cached_graph import in_program
    return in_program() or stream_capturing()


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _nd_class():
    from ..ndarray.ndarray import NDArray
    return NDArray


def _t(x):
    """An array's tensor (NDArray or tensor)."""
    return x._data if isinstance(x, _nd_class()) else x


def _like(t, nd):
    return _nd_class()(t) if nd else t


def _is_nd(arrays):
    return any(isinstance(a, _nd_class()) for a in arrays)


def _truth(x) -> bool:
    """A one-element predicate read on the host (the eager path)."""
    if isinstance(x, (bool, int, float)):
        return bool(x)
    return bool(_t(x).detach().reshape(()).item())


def foreach(body, data, init_states, name="foreach"):
    """Run ``body`` over axis 0 of ``data`` (ref: contrib.foreach).

    ``body(data_slice, states) -> (outputs, new_states)``; returns (the
    outputs stacked along a new axis 0, the final states). ``data`` and
    ``init_states`` are one array or a list each, scanned in lockstep."""
    data_list = _as_list(data)
    states = _as_list(init_states)
    single_data = not isinstance(data, (list, tuple))
    single_state = not isinstance(init_states, (list, tuple))
    if not data_list:
        raise MXNetError("foreach: data must hold at least one array")
    length = data_list[0].shape[0]
    for d in data_list:
        if d.shape[0] != length:
            raise MXNetError("foreach: all data arrays must share axis-0 "
                             f"length, got {d.shape[0]} != {length}")
    nd = _is_nd(data_list + states)
    single_out = True
    out_steps = None
    for i in range(length):
        slices = [_like(_t(d)[i], nd) for d in data_list]
        outs, states = body(slices[0] if single_data else slices,
                            states[0] if single_state else states)
        single_out = not isinstance(outs, (list, tuple))
        outs, states = _as_list(outs), _as_list(states)
        if out_steps is None:
            out_steps = [[] for _ in outs]
        for acc, o in zip(out_steps, outs):
            acc.append(_t(o))
    out_nd = [_like(torch.stack(acc, 0), nd) for acc in out_steps or []]
    outs_r = out_nd[0] if single_out and len(out_nd) == 1 else out_nd
    sts_r = states[0] if single_state and len(states) == 1 else states
    return outs_r, sts_r


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """Run ``func`` while ``cond`` holds, at most ``max_iterations`` times
    (ref: contrib.while_loop).

    ``cond(*loop_vars)`` gives a one-element predicate; ``func(*loop_vars)
    -> (step_outputs, new_loop_vars)``. Returns (the outputs stacked along
    axis 0, ``max_iterations`` rows, the rows past the executed steps
    zeros in the outputs' dtype, the reference's padding; the final loop
    variables). The program path requires ``max_iterations``."""
    lvs = _as_list(loop_vars)
    single = not isinstance(loop_vars, (list, tuple))
    nd = _is_nd(lvs)
    if program_path():
        out_nd, lvs = _while_masked(cond, func, lvs, max_iterations, nd)
    else:
        out_nd, lvs = _while_eager(cond, func, lvs, max_iterations, nd)
    outs_r = out_nd[0] if len(out_nd) == 1 else out_nd
    sts_r = lvs[0] if single and len(lvs) == 1 else lvs
    return outs_r, sts_r


def _while_eager(cond, func, lvs, max_iterations, nd):
    steps = 0
    out_steps = None
    while (max_iterations is None or steps < max_iterations) \
            and _truth(cond(*lvs)):
        outs, lvs = func(*lvs)
        outs, lvs = _as_list(outs), _as_list(lvs)
        if out_steps is None:
            out_steps = [[] for _ in outs]
        for acc, o in zip(out_steps, outs):
            acc.append(_t(o))
        steps += 1
    if out_steps is None:
        # no step ran: the outputs' shapes and dtypes from one call of
        # func, not recorded and thrown away (the JAX package traces it)
        with torch.no_grad():
            probe = _as_list(func(*lvs)[0])
        out_steps = [[] for _ in probe]
        avals = [(_t(o).shape, _t(o).dtype, _t(o).device) for o in probe]
    else:
        avals = [(acc[0].shape, acc[0].dtype, acc[0].device)
                 for acc in out_steps]
    pad_to = max_iterations if max_iterations is not None else steps
    out_nd = []
    for acc, (shape, dtype, device) in zip(out_steps, avals):
        rows = acc + [torch.zeros(shape, dtype=dtype, device=device)] \
            * (pad_to - len(acc))
        out = torch.stack(rows, 0) if rows else \
            torch.zeros((0, *shape), dtype=dtype, device=device)
        out_nd.append(_like(out, nd))
    return out_nd, lvs


def _while_masked(cond, func, lvs, max_iterations, nd):
    if max_iterations is None:
        raise MXNetError("while_loop: max_iterations is required inside a "
                         "hybridized block's program or a CUDA-graph capture "
                         "(no host read of the predicate; the reference's "
                         "symbolic mode requires it too)")
    first = _t(lvs[0]) if lvs else None
    device = first.device if first is not None else None
    done = torch.zeros((), dtype=torch.bool, device=device)
    out_steps = None
    for _ in range(int(max_iterations)):
        keep = torch.logical_and(
            torch.logical_not(done),
            _t(cond(*lvs)).reshape(()).to(torch.bool))
        outs, new = func(*lvs)
        outs, new = _as_list(outs), _as_list(new)
        lvs = [_like(torch.where(keep, _t(n), _t(c)), nd)
               for n, c in zip(new, lvs)]
        if out_steps is None:
            out_steps = [[] for _ in outs]
        for acc, o in zip(out_steps, outs):
            o = _t(o)
            acc.append(torch.where(keep, o, torch.zeros_like(o)))
        done = torch.logical_or(done, torch.logical_not(keep))
    out_nd = [_like(torch.stack(acc, 0), nd) for acc in out_steps or []]
    return out_nd, lvs


def cond(pred, then_func, else_func, name="cond"):
    """Branch on a one-element predicate (ref: contrib.cond).
    ``then_func``/``else_func`` are thunks returning an array or a list
    of arrays of matching shapes."""
    if not program_path():
        return (then_func if _truth(pred) else else_func)()
    then_out = _as_list(then_func())
    else_out = _as_list(else_func())
    if len(then_out) != len(else_out):
        raise MXNetError("cond: branches must return the same number of "
                         "outputs")
    p = _t(pred).reshape(()).to(torch.bool)
    res = [_like(torch.where(p, _t(a), _t(b)), isinstance(a, _nd_class()))
           for a, b in zip(then_out, else_out)]
    return res[0] if len(res) == 1 else res

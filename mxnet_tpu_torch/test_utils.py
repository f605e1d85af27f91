"""Test utilities (counterpart of ``mxnet_tpu/test_utils.py``, ref
``python/mxnet/test_utils.py``): dtype-aware ``assert_almost_equal``,
central finite differences (``check_numeric_gradient``) and
``check_consistency`` across contexts (the reference's CPU-vs-GPU
check: here the CPU against the card)."""
from __future__ import annotations

import numpy as np
import torch

from .context import Context, cpu, current_context, gpu
from .ndarray import NDArray, array

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "same", "rand_ndarray", "rand_shape_2d",
           "rand_shape_3d", "rand_shape_nd", "check_numeric_gradient",
           "check_consistency", "default_dtype", "list_contexts"]

_default_ctx = [None]

# dtype-aware default tolerances (ref: test_utils.py assert_almost_equal)
_RTOL = {np.dtype(np.float16): 1e-2, np.dtype(np.float32): 1e-4,
         np.dtype(np.float64): 1e-6}
_ATOL = {np.dtype(np.float16): 1e-3, np.dtype(np.float32): 1e-5,
         np.dtype(np.float64): 1e-7}


def default_context() -> Context:
    return _default_ctx[0] or current_context()


def set_default_context(ctx: Context):
    _default_ctx[0] = ctx


def default_dtype():
    return np.float32


def list_contexts():
    """The CPU, and the card when there is one."""
    return [cpu()] + ([gpu()] if torch.cuda.is_available() else [])


def _as_np(a):
    if isinstance(a, NDArray) or hasattr(a, "asnumpy"):
        return a.asnumpy()
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy() \
            if a.dtype == torch.bfloat16 else a.detach().cpu().numpy()
    return np.asarray(a)


def same(a, b) -> bool:
    return np.array_equal(_as_np(a), _as_np(b))


def almost_equal(a, b, rtol=None, atol=None) -> bool:
    a, b = _as_np(a), _as_np(b)
    rtol = rtol if rtol is not None else _RTOL.get(a.dtype, 1e-4)
    atol = atol if atol is not None else _ATOL.get(a.dtype, 1e-5)
    return np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    a_np, b_np = _as_np(a), _as_np(b)
    rtol = rtol if rtol is not None else _RTOL.get(a_np.dtype, 1e-4)
    atol = atol if atol is not None else _ATOL.get(a_np.dtype, 1e-5)
    np.testing.assert_allclose(a_np.astype(np.float64),
                               b_np.astype(np.float64), rtol=rtol,
                               atol=atol, err_msg=f"{names[0]} vs {names[1]}")


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None,
                 scale=1.0):
    """Uniform values in [-scale, scale] (numpy's global generator); a
    ``stype`` of "csr" or "row_sparse" keeps a ``density`` share of the
    values (0.5 by default) in that storage."""
    arr = np.random.uniform(-scale, scale, size=shape)
    if stype != "default":
        keep = np.random.uniform(size=shape) < (0.5 if density is None
                                                else density)
        arr = arr * keep
    out = array(arr.astype(np.dtype(dtype or np.float32)),
                ctx=ctx if ctx is not None else default_context())
    return out if stype == "default" else out.tostype(stype)


def rand_shape_2d(dim0=10, dim1=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (np.random.randint(1, dim0 + 1), np.random.randint(1, dim1 + 1),
            np.random.randint(1, dim2 + 1))


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def numeric_grad(executor_fn, inputs, eps=1e-4):
    """Central finite differences of ``sum(f)`` with respect to each input
    (ref: test_utils.py numeric_grad)."""
    grads = []
    for i, x in enumerate(inputs):
        x_np = x.asnumpy().astype(np.float64)
        g = np.zeros_like(x_np)
        flat, gflat = x_np.ravel(), g.ravel()

        def at(values):
            return [array(values.astype(np.float32), ctx=x.ctx) if k == i
                    else inputs[k] for k in range(len(inputs))]
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            plus = float(np.sum(_as_np(executor_fn(at(x_np)))))
            flat[j] = orig - eps
            minus = float(np.sum(_as_np(executor_fn(at(x_np)))))
            flat[j] = orig
            gflat[j] = (plus - minus) / (2 * eps)
        grads.append(g)
    return grads


def check_numeric_gradient(fn, inputs, rtol=1e-2, atol=1e-3, eps=1e-3):
    """Autograd's gradients of ``sum(fn(*inputs))`` against central finite
    differences (ref: mx.test_utils.check_numeric_gradient); the numeric
    pass runs in the recorded pass's training mode."""
    from . import autograd
    inputs = [x if isinstance(x, NDArray) else array(x, ctx=default_context())
              for x in inputs]
    for x in inputs:
        x.attach_grad()
    with autograd.record():
        out = fn(*inputs)
        loss = out.sum() if isinstance(out, NDArray) else \
            sum(o.sum() for o in out)
    loss.backward()
    analytic = [x.grad.asnumpy() for x in inputs]

    def run(xs):
        with autograd.pause(train_mode=True):
            out2 = fn(*xs)
        return out2 if isinstance(out2, NDArray) else \
            out2[0] + sum(out2[1:], 0 * out2[0])

    numeric = numeric_grad(run, inputs, eps=eps)
    for i, (a, n) in enumerate(zip(analytic, numeric)):
        np.testing.assert_allclose(a, n, rtol=rtol, atol=atol,
                                   err_msg=f"gradient mismatch on input {i}")


def check_consistency(fn, inputs, ctx_list=None, rtol=1e-4, atol=1e-5):
    """``fn`` on each context must agree (ref: the reference's CPU-vs-GPU
    ``check_consistency``); returns the first context's outputs."""
    ctx_list = ctx_list or list_contexts()
    baseline = None
    for ctx in ctx_list:
        out = fn(*[x.as_in_context(ctx) for x in inputs])
        outs = out if isinstance(out, (list, tuple)) else [out]
        if baseline is None:
            baseline = [o.asnumpy() for o in outs]
            continue
        for b, o in zip(baseline, outs):
            np.testing.assert_allclose(b, o.asnumpy(), rtol=rtol, atol=atol,
                                       err_msg=f"inconsistent on {ctx}")
    return baseline

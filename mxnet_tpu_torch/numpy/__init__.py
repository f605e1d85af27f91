"""``mx.np`` — the NumPy-semantics array namespace (counterpart of
``mxnet_tpu/numpy/__init__.py``, ref ``python/mxnet/numpy/``).

Every function of the JAX package's list (:data:`FUNCS`, its ``_FUNCS``
less the names its jnp lacks) takes and returns NDArrays, with NumPy's
signature and semantics, computed by PyTorch on the arrays' device and
recorded by autograd inside ``autograd.record()`` as ``mx.nd`` is. The
results follow the JAX package's types, which runs with 64-bit types
off: an index or a count is int32 (torch gives int64), a 64-bit float
becomes float32, an integer or boolean reduction that NumPy widens is
int32. Where torch's function differs from NumPy's it is not used:
``median`` averages the two middle values (torch returns the lower),
``std`` and ``var`` take ``ddof`` (torch's default correction is 1), and
the set operations, ``partition``, ``interp``, ``unwrap``, ``trim_zeros``
and ``histogram`` (which torch does not run on CUDA) are written here
from sorts, ``searchsorted`` and scatters. ``linalg``, ``fft`` and
``random`` are sub-namespaces; ``apply_along_axis``, ``apply_over_axes``
and ``piecewise`` call an ``mx.np`` function of the caller's.

Arrays are created on the ``ctx`` argument's device, else the current
context's (``cuda:0`` unless the caller asks for the CPU).
"""
from __future__ import annotations

import builtins
import math
import sys
import threading
import types

import numpy as onp
import torch

from .. import _dispatch
from .. import autograd as _autograd
from .. import random as _random
from ..base import MXNetError, as_torch_dtype
from ..context import current_context
from ..ndarray.ndarray import NDArray

__all__ = ["ndarray", "array", "asarray", "FUNCS", "linalg", "fft",
           "random", "apply_along_axis", "apply_over_axes", "piecewise"]

ndarray = NDArray
float16 = onp.float16
float32 = onp.float32
float64 = onp.float64
int8 = onp.int8
int32 = onp.int32
int64 = onp.int64
uint8 = onp.uint8
bool_ = onp.bool_
pi = onp.pi
inf = onp.inf
nan = onp.nan
newaxis = None

# the JAX package's _FUNCS that jax.numpy has ("trapz" it lacks)
FUNCS = (
    "zeros", "ones", "empty", "full", "arange", "eye", "identity",
    "linspace", "logspace", "meshgrid", "tril", "triu",
    "zeros_like", "ones_like", "full_like", "empty_like",
    "reshape", "ravel", "transpose", "swapaxes", "moveaxis", "rollaxis",
    "concatenate", "stack", "vstack", "hstack", "dstack", "column_stack",
    "split", "array_split", "hsplit", "vsplit", "dsplit", "tile", "repeat",
    "flip", "fliplr", "flipud", "roll", "rot90", "expand_dims", "squeeze",
    "broadcast_to", "broadcast_arrays", "atleast_1d", "atleast_2d",
    "atleast_3d", "pad", "append", "delete", "insert", "unique",
    "add", "subtract", "multiply", "divide", "true_divide", "floor_divide",
    "mod", "remainder", "power", "float_power", "negative", "positive",
    "absolute", "abs", "fabs", "sign", "rint", "exp", "expm1", "exp2",
    "log", "log2", "log10", "log1p", "sqrt", "cbrt", "square", "reciprocal",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2", "sinh",
    "cosh", "tanh", "arcsinh", "arccosh", "arctanh", "degrees", "radians",
    "deg2rad", "rad2deg", "hypot", "maximum", "minimum", "fmax", "fmin",
    "clip", "floor", "ceil", "trunc", "around", "round",
    "nan_to_num", "interp", "heaviside", "gcd", "lcm", "ldexp",
    "sum", "prod", "cumsum", "cumprod", "max", "min", "amax", "amin",
    "nanmax", "nanmin", "nansum", "nanprod", "mean", "std", "var",
    "median", "average", "nanmean", "nanstd", "nanvar", "ptp",
    "percentile", "quantile", "count_nonzero",
    "dot", "vdot", "inner", "outer", "matmul", "tensordot", "einsum",
    "kron", "cross", "trace", "diagonal", "diag", "diagflat",
    "equal", "not_equal", "less", "less_equal", "greater", "greater_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not", "isfinite",
    "isinf", "isnan", "isneginf", "isposinf", "isclose", "allclose",
    "array_equal", "where", "all", "any",
    "sort", "argsort", "argmax", "argmin", "nanargmax", "nanargmin",
    "searchsorted", "partition", "argpartition", "nonzero", "flatnonzero",
    "bincount", "digitize", "histogram", "take", "take_along_axis",
    "choose", "compress", "extract", "indices", "unravel_index",
    "ravel_multi_index", "tril_indices", "triu_indices",
    "bitwise_and", "bitwise_or", "bitwise_xor", "invert", "left_shift",
    "right_shift",
    "copysign", "signbit", "frexp", "modf", "divmod", "gradient", "diff",
    "ediff1d", "convolve", "correlate", "real", "imag", "conj",
    "angle", "iscomplexobj", "isrealobj", "shape", "size", "ndim",
    "result_type", "can_cast", "promote_types", "vander", "i0", "sinc",
    "unwrap", "cov", "corrcoef", "union1d", "intersect1d", "setdiff1d",
    "setxor1d", "isin", "select", "resize", "trim_zeros", "diag_indices",
    "diag_indices_from", "ix_", "spacing", "nextafter", "fmod",
    "logaddexp", "logaddexp2", "nancumsum", "nancumprod", "nanmedian",
    "nanpercentile", "nanquantile",
)

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}
_local = threading.local()


# -- calling convention ------------------------------------------------------
def _device():
    """The device of the call in progress (its first array's, else the
    ``ctx`` argument's or the current context's)."""
    return getattr(_local, "device", None) or _dispatch.as_device(
        current_context())


def _a(x, dtype=None):
    """An operand as a tensor on the call's device: tensors stay, numpy
    arrays, lists and Python numbers become 32-bit tensors (as
    ``jnp.asarray`` makes them with 64-bit types off)."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = _dispatch.to_tensor(x, _device())
    return x if dtype is None else x.to(dtype)


def _float(x):
    """``x`` as a floating tensor (NumPy's inexact promotion: an integer
    or boolean array becomes float32)."""
    x = _a(x)
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


def _unbox(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)) and builtins.any(
            isinstance(e, NDArray) for e in x):
        return type(x)(_unbox(e) for e in x)
    return x


def _box(o):
    if isinstance(o, torch.Tensor):
        if o.is_complex():
            o = o.resolve_conj()
        return NDArray(o.to(_NARROW[o.dtype]) if o.dtype in _NARROW else o)
    if isinstance(o, (list, tuple)) and builtins.any(
            isinstance(e, torch.Tensor) for e in o):
        return tuple(_box(e) for e in o)
    return o


def _first_device(args, kwargs):
    for x in (*args, *kwargs.values()):
        if isinstance(x, NDArray):
            return x._data.device
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (list, tuple)):
            for e in x:
                if isinstance(e, (NDArray, torch.Tensor)):
                    return _unbox(e).device
    return None


def _call(fn, *args, ctx=None, **kwargs):
    """Run ``fn`` (a function of tensors) on ``args``: NDArrays (at the
    top level and one level inside lists) become their tensors, the
    result's tensors NDArrays of the JAX package's types. Recorded
    inside ``autograd.record()``, as an ``mx.nd`` operator is."""
    device = _first_device(args, kwargs)
    if device is None:
        device = _dispatch.as_device(ctx if ctx is not None
                                     else current_context())
    old = getattr(_local, "device", None)
    _local.device = device
    try:
        with torch.set_grad_enabled(_autograd.is_recording()):
            out = fn(*[_unbox(a) for a in args],
                     **{k: _unbox(v) for k, v in kwargs.items()})
    finally:
        _local.device = old
    return _box(out)


def _make(name, impl):
    def wrapper(*args, **kwargs):
        if kwargs.get("dtype") is not None:
            kwargs["dtype"] = as_torch_dtype(kwargs["dtype"])
        return _call(impl, *args, **kwargs)
    wrapper.__name__ = name
    wrapper.__qualname__ = name
    wrapper.__doc__ = (f"numpy.{name} on NDArrays (NumPy semantics, the JAX "
                       "package's result types)")
    return wrapper


def _dt(dtype, default=None):
    return default if dtype is None else as_torch_dtype(dtype)


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, int):
        return (axis % ndim if ndim else 0,)
    return tuple(a % ndim for a in axis)


def _shape(s):
    return (int(s),) if isinstance(s, (int, onp.integer)) else \
        tuple(int(d) for d in s)


# -- creation ----------------------------------------------------------------
def _weak_dtype(value):
    """The dtype ``jnp.full`` gives a Python fill value (int32, float32,
    bool) or an array's own."""
    if isinstance(value, torch.Tensor):
        return value.dtype
    if isinstance(value, bool):
        return torch.bool
    if isinstance(value, int):
        return torch.int32
    if isinstance(value, complex):
        return torch.complex64
    return _a(value).dtype


def _zeros(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype, torch.float32),
                       device=_device())


def _ones(shape, dtype=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype, torch.float32),
                      device=_device())


def _full(shape, fill_value, dtype=None):
    fill = _a(fill_value)
    dt = _dt(dtype, _weak_dtype(fill_value))
    return torch.broadcast_to(fill.to(dt), _shape(shape)).clone()


def _arange(start, stop=None, step=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    step = 1 if step is None else step
    ints = builtins.all(isinstance(v, (int, onp.integer))
                        for v in (start, stop, step))
    dt = _dt(dtype, torch.int32 if ints else torch.float32)
    if ints or not dt.is_floating_point:
        return torch.arange(start, stop, step, dtype=dt, device=_device())
    # NumPy's length, values start + i * step computed in the dtype
    n = builtins.max(0, math.ceil((stop - start) / step))
    return (torch.arange(n, device=_device(), dtype=torch.float64) * step
            + start).to(dt)


def _eye(N, M=None, k=0, dtype=None):
    out = torch.zeros((N, N if M is None else M),
                      dtype=_dt(dtype, torch.float32), device=_device())
    out.diagonal(k).fill_(1)
    return out


def _linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
              axis=0):
    start, stop = _float(start), _float(stop)
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else torch.full_like(
        stop - start, float("nan"))
    i = torch.arange(num, device=start.device, dtype=start.dtype)
    shape = (num,) + (1,) * start.ndim
    out = start + i.reshape(shape) * step
    if endpoint and num > 1:
        out[-1] = stop
    out = torch.moveaxis(out, 0, axis).to(_dt(dtype, out.dtype))
    return (out, step) if retstep else out


def _logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
              axis=0):
    y = _linspace(start, stop, num, endpoint, axis=axis)
    return torch.pow(_float(base), y).to(_dt(dtype, y.dtype))


def _meshgrid(*xi, copy=True, sparse=False, indexing="xy"):
    return list(torch.meshgrid(*[_a(x) for x in xi], indexing=indexing))


def _like(a, dtype, shape, fn):
    a = _a(a)
    return fn(a.shape if shape is None else _shape(shape),
              dtype=_dt(dtype, a.dtype), device=a.device)


def _full_like(a, fill_value, dtype=None, shape=None):
    a = _a(a)
    dt = _dt(dtype, a.dtype)
    return torch.broadcast_to(_a(fill_value).to(dt),
                              a.shape if shape is None else _shape(shape)) \
        .clone()


# -- manipulation ------------------------------------------------------------
def _split_points(n, indices_or_sections, even):
    if isinstance(indices_or_sections, (int, onp.integer)):
        k = int(indices_or_sections)
        if even:
            if n % k:
                raise MXNetError("array split does not result in an equal "
                                 "division")
            return [n // k * i for i in range(1, k)]
        base, extra = builtins.divmod(n, k)
        sizes = [base + 1] * extra + [base] * (k - extra)
        return list(onp.cumsum(sizes)[:-1])
    return [int(i) for i in indices_or_sections]


def _split(ary, indices_or_sections, axis=0, even=True):
    a = _a(ary)
    axis = axis % a.ndim
    n = a.shape[axis]
    pts = [builtins.min(builtins.max(p if p >= 0 else p + n, 0), n)
           for p in _split_points(n, indices_or_sections, even)]
    out, lo = [], 0
    for p in pts + [n]:
        out.append(a.narrow(axis, lo, builtins.max(p - lo, 0)))
        lo = builtins.max(lo, p)
    return out


def _atleast(n):
    def fn(*arys):
        outs = []
        for x in arys:
            x = _a(x)
            if x.ndim < n:
                if n == 3 and x.ndim == 2:
                    x = x[..., None]
                elif n == 3 and x.ndim == 1:
                    x = x[None, :, None]
                else:
                    x = x.reshape((1,) * (n - x.ndim) + tuple(x.shape))
            outs.append(x)
        return outs[0] if len(outs) == 1 else outs
    return fn


def _pad(array, pad_width, mode="constant", constant_values=0, **kwargs):
    a = _a(array)
    pw = onp.broadcast_to(onp.asarray(pad_width, dtype=onp.int64),
                          (a.ndim, 2))
    flat = [int(v) for pair in pw[::-1] for v in pair]
    if mode == "constant":
        return torch.nn.functional.pad(a, flat, value=float(constant_values))
    if mode == "edge":
        mode = "replicate"
    x = a.reshape(1, 1, *a.shape) if a.ndim <= 3 else a
    return torch.nn.functional.pad(x.float() if not x.is_floating_point()
                                   else x, flat, mode=mode) \
        .reshape([s + int(p.sum()) for s, p in zip(a.shape, pw)]) \
        .to(a.dtype)


def _append(arr, values, axis=None):
    arr, values = _a(arr), _a(values)
    if axis is None:
        return torch.cat([arr.reshape(-1), values.reshape(-1)]
                         if arr.dtype == values.dtype else
                         [t.reshape(-1).to(torch.promote_types(
                             arr.dtype, values.dtype)) for t in (arr, values)])
    dt = torch.promote_types(arr.dtype, values.dtype)
    return torch.cat([arr.to(dt), values.to(dt)], dim=axis)


def _delete(arr, obj, axis=None):
    a = _a(arr)
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    idx = onp.arange(n)[obj] if isinstance(obj, slice) else \
        onp.asarray(obj.cpu() if isinstance(obj, torch.Tensor) else obj)
    keep = onp.ones(n, bool)
    keep[onp.asarray(idx, dtype=onp.int64) % n if n else idx] = False
    return a.index_select(axis, torch.as_tensor(onp.nonzero(keep)[0],
                                                device=a.device))


def _insert(arr, obj, values, axis=None):
    a = _a(arr)
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis = axis % a.ndim
    n = a.shape[axis]
    v = _a(values).to(a.dtype)
    v = v.reshape((1,) * (a.ndim - v.ndim) + tuple(v.shape))
    if isinstance(obj, (int, onp.integer)):
        # NumPy: the values' first axis becomes ``axis``, one block of
        # slices before position obj
        v = torch.moveaxis(v, 0, axis)
        pos = int(obj) + n if obj < 0 else int(obj)
        shape = list(a.shape)
        shape[axis] = v.shape[axis]
        return torch.cat([a.narrow(axis, 0, pos), torch.broadcast_to(v, shape),
                          a.narrow(axis, pos, n - pos)], dim=axis)
    pos = onp.asarray(obj.cpu() if isinstance(obj, torch.Tensor) else obj,
                      dtype=onp.int64).reshape(-1)
    pos = onp.where(pos < 0, pos + n, pos)
    m = len(pos)
    shape = list(a.shape)
    shape[axis] = m
    v = torch.broadcast_to(v, shape)
    # each value goes before its original position, in a stable order
    order = onp.argsort(pos, kind="stable")
    new_pos = pos[order] + onp.arange(m)
    is_new = onp.zeros(n + m, bool)
    is_new[new_pos] = True
    shape[axis] = n + m
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    dev = a.device
    out.index_copy_(axis, torch.as_tensor(onp.nonzero(~is_new)[0],
                                          device=dev), a)
    out.index_copy_(axis, torch.as_tensor(new_pos, device=dev),
                    v.index_select(axis, torch.as_tensor(order, device=dev)))
    return out


def _unique(ar, return_index=False, return_inverse=False,
            return_counts=False, axis=None, **kwargs):
    a = _a(ar)
    shape = a.shape
    if axis is None:
        a = a.reshape(-1)
        if a.numel() == 0:
            vals = a
            inv = counts = first = torch.zeros(0, dtype=torch.int64,
                                               device=a.device)
        else:
            order = torch.argsort(a, stable=True)
            s = a[order]
            new = torch.ones_like(s, dtype=torch.bool)
            new[1:] = s[1:] != s[:-1]
            if s.is_floating_point():     # equal_nan: NaNs are one value
                new[1:] &= ~(torch.isnan(s[1:]) & torch.isnan(s[:-1]))
            group = torch.cumsum(new.to(torch.int64), 0) - 1
            vals = s[new]
            first = order[new]
            inv = torch.empty_like(group).scatter_(0, order, group) \
                .reshape(shape)
            counts = torch.bincount(group, minlength=vals.numel())
    else:
        vals, inv, counts = torch.unique(a, return_inverse=True,
                                         return_counts=True, dim=axis)
        n = a.shape[axis]
        first = torch.full((vals.shape[axis],), n, dtype=torch.int64,
                           device=a.device).scatter_reduce(
            0, inv, torch.arange(n, device=a.device), "amin")
    out = [vals]
    if return_index:
        out.append(first)
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


# -- math ----------------------------------------------------------------------
def _binary(fn):
    return lambda x1, x2, **kw: fn(_a(x1), _a(x2))


def _unary(fn, inexact=False):
    def run(x, **kw):
        return fn(_float(x) if inexact else _a(x))
    return run


def _cbrt(x):
    x = _float(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _clip(a, a_min=None, a_max=None, **kw):
    a = _a(a)
    lo = None if a_min is None else _a(a_min)
    hi = None if a_max is None else _a(a_max)
    out = a
    if lo is not None:
        out = torch.maximum(out, lo.to(out.dtype))
    if hi is not None:
        out = torch.minimum(out, hi.to(out.dtype))
    return out


def _round(a, decimals=0, **kw):
    a = _a(a)
    if not a.is_floating_point():
        return a
    return torch.round(a, decimals=decimals) if decimals else torch.round(a)


def _nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    x = _a(x)
    if not x.is_floating_point():
        return x
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def _interp(x, xp, fp, left=None, right=None, period=None):
    x, xp, fp = _float(x), _float(xp), _float(fp)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.numel() - 1)
    x0, x1 = xp[i - 1], xp[i]
    y0, y1 = fp[i - 1], fp[i]
    dx = x1 - x0
    t = (x - x0) / torch.where(dx == 0, torch.ones_like(dx), dx)
    out = torch.where(dx == 0, y0, y0 + t * (y1 - y0))
    out = torch.where(x < xp[0], fp[0] if left is None else _a(left).to(
        out.dtype), out)
    out = torch.where(x > xp[-1], fp[-1] if right is None else _a(right).to(
        out.dtype), out)
    return out


def _heaviside(x1, x2):
    x1, x2 = _float(x1), _float(x2)
    dt = torch.promote_types(x1.dtype, x2.dtype)
    return torch.heaviside(x1.to(dt), x2.to(dt))


def _ldexp(x1, x2):
    x1 = _float(x1)
    return x1 * torch.pow(torch.tensor(2.0, dtype=x1.dtype,
                                       device=x1.device), _a(x2).to(x1.dtype))


# -- reductions ----------------------------------------------------------------
def _red_dtype(a, dtype):
    """NumPy's accumulation dtype for sum/prod: a bool or narrow integer
    array sums in int32 (JAX with 64-bit types off)."""
    if dtype is not None:
        return as_torch_dtype(dtype)
    if a.dtype == torch.bool or (not a.is_floating_point()
                                 and not a.is_complex()):
        return torch.int32 if a.dtype not in (torch.uint32, torch.uint64) \
            else a.dtype
    return a.dtype


def _sum(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
         where=None):
    a = _a(a)
    dt = _red_dtype(a, dtype)
    if where is not None:
        a = torch.where(_a(where), a, torch.zeros((), dtype=a.dtype,
                                                  device=a.device))
    r = torch.sum(a.to(torch.int64) if not dt.is_floating_point
                  and not dt.is_complex else a.to(dt),
                  dim=_axes(axis, a.ndim), keepdim=keepdims) if a.ndim \
        else a.to(dt)
    if initial is not None:
        r = r + initial
    return r.to(dt)


def _prod(a, axis=None, dtype=None, out=None, keepdims=False, initial=None,
          where=None):
    a = _a(a)
    dt = _red_dtype(a, dtype)
    x = a.to(torch.int64) if not dt.is_floating_point and not dt.is_complex \
        else a.to(dt)
    if where is not None:
        x = torch.where(_a(where), x, torch.ones((), dtype=x.dtype,
                                                 device=x.device))
    for ax in sorted(_axes(axis, a.ndim), reverse=True):
        x = torch.prod(x, dim=ax, keepdim=keepdims)
    if initial is not None:
        x = x * initial
    return x.to(dt)


def _cum(fn):
    def run(a, axis=None, dtype=None, out=None):
        a = _a(a)
        dt = _red_dtype(a, dtype)
        if axis is None:
            a, axis = a.reshape(-1), 0
        x = a.to(torch.int64) if not dt.is_floating_point \
            and not dt.is_complex else a.to(dt)
        return fn(x, dim=axis).to(dt)
    return run


def _nan_fill(fill):
    def run(a):
        a = _a(a)
        return torch.where(torch.isnan(a), torch.as_tensor(
            fill, dtype=a.dtype, device=a.device), a) \
            if a.is_floating_point() else a
    return run


def _amax(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    a = _a(a)
    r = torch.amax(a, dim=_axes(axis, a.ndim), keepdim=keepdims) if a.ndim \
        else a
    return r if initial is None else torch.maximum(r, _a(initial).to(r.dtype))


def _amin(a, axis=None, out=None, keepdims=False, initial=None, where=None):
    a = _a(a)
    r = torch.amin(a, dim=_axes(axis, a.ndim), keepdim=keepdims) if a.ndim \
        else a
    return r if initial is None else torch.minimum(r, _a(initial).to(r.dtype))


def _nan_extreme(reduce, fill):
    """nanmax/nanmin: ``reduce`` over the values with NaN as ``fill``, NaN
    where a slice holds nothing else."""
    def run(a, axis=None, out=None, keepdims=False, **kw):
        a = _a(a)
        r = reduce(_nan_fill(fill)(a), axis, keepdims=keepdims)
        if a.is_floating_point():
            alln = torch.all(torch.isnan(a), dim=_axes(axis, a.ndim),
                             keepdim=keepdims) if a.ndim else torch.isnan(a)
            r = torch.where(alln, torch.full_like(r, math.nan), r)
        return r
    return run


_nanmax = _nan_extreme(lambda a, axis, keepdims: _amax(a, axis,
                                                       keepdims=keepdims),
                       -math.inf)
_nanmin = _nan_extreme(lambda a, axis, keepdims: _amin(a, axis,
                                                       keepdims=keepdims),
                       math.inf)


def _mean(a, axis=None, dtype=None, out=None, keepdims=False, where=None):
    a = _float(a)
    r = torch.mean(a, dim=_axes(axis, a.ndim), keepdim=keepdims) if a.ndim \
        else a
    return r if dtype is None else r.to(as_torch_dtype(dtype))


def _var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
         **kw):
    a = _float(a)
    if not a.ndim:
        return torch.zeros_like(a)
    return torch.var(a, dim=_axes(axis, a.ndim), correction=ddof,
                     keepdim=keepdims)


def _std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, **kw):
    return torch.sqrt(_var(a, axis, dtype, out, ddof, keepdims))


def _quantiles(fn):
    """NumPy's quantile over one or several axes with ``fn``
    (``torch.quantile`` or ``torch.nanquantile``), q a scalar or 1-D."""
    def run(a, q, axis=None, out=None, overwrite_input=False,
            method="linear", keepdims=False, **kw):
        a = _float(a)
        qt = _a(q).to(a.dtype)
        axes = _axes(axis, a.ndim)
        rest = [d for d in range(a.ndim) if d not in axes]
        x = a.permute(*rest, *axes).reshape(*[a.shape[d] for d in rest], -1)
        r = fn(x, qt, dim=-1, interpolation=method)
        if keepdims:
            shape = [1 if d in axes else a.shape[d] for d in range(a.ndim)]
            r = r.reshape(qt.shape + tuple(shape))
        return r
    return run


_quantile = _quantiles(torch.quantile)
_nan_quantile = _quantiles(torch.nanquantile)


def _percentile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False, **kw):
    return _quantile(a, _float(q) / 100, axis, method=method,
                     keepdims=keepdims)


def _median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return _quantile(a, 0.5, axis, keepdims=keepdims)


def _nanmedian(a, axis=None, out=None, overwrite_input=False,
               keepdims=False):
    return _nan_quantile(a, 0.5, axis, keepdims=keepdims)


def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _float(a)
    if weights is None:
        avg = _mean(a, axis, keepdims=keepdims)
        scl = torch.full_like(avg, a.numel() / builtins.max(avg.numel(), 1))
    else:
        w = _a(weights).to(a.dtype)
        if w.shape != a.shape:
            shape = [1] * a.ndim
            shape[axis % a.ndim] = w.shape[0]
            w = w.reshape(shape)
        dims = _axes(axis, a.ndim)
        scl = torch.broadcast_to(w, a.shape).sum(dim=dims, keepdim=keepdims)
        avg = (a * w).sum(dim=dims, keepdim=keepdims) / scl
    return (avg, scl) if returned else avg


def _nanmean(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
    a = _float(a)
    return torch.nanmean(a, dim=_axes(axis, a.ndim), keepdim=keepdims)


def _nanvar(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            **kw):
    a = _float(a)
    dims = _axes(axis, a.ndim)
    ok = ~torch.isnan(a)
    n = ok.sum(dim=dims, keepdim=True).to(a.dtype)
    m = torch.nansum(a, dim=dims, keepdim=True) / n
    d = torch.where(ok, a - m, torch.zeros_like(a))
    r = (d * d).sum(dim=dims, keepdim=True) / (n - ddof)
    return r if keepdims else r.reshape([s for i, s in enumerate(r.shape)
                                         if i not in dims])


def _nanstd(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            **kw):
    return torch.sqrt(_nanvar(a, axis, ddof=ddof, keepdims=keepdims))


def _count_nonzero(a, axis=None, keepdims=False):
    a = _a(a)
    return (a != 0).sum(dim=_axes(axis, a.ndim), keepdim=keepdims) \
        .to(torch.int32)


# -- products ------------------------------------------------------------------
def _promote(*xs):
    xs = [_a(x) for x in xs]
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _dot(a, b, out=None):
    a, b = _promote(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 2]))


def _inner(a, b):
    a, b = _promote(a, b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.ndim - 1], [b.ndim - 1]))


def _tensordot(a, b, axes=2):
    a, b = _promote(a, b)
    if isinstance(axes, (int, onp.integer)):
        return torch.tensordot(a, b, dims=int(axes))
    return torch.tensordot(a, b, dims=[list(onp.atleast_1d(axes[0])),
                                       list(onp.atleast_1d(axes[1]))])


def _einsum(subscripts, *operands, **kw):
    return torch.einsum(subscripts, *_promote(*operands))


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = _promote(a, b)
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = torch.moveaxis(a, axisa, -1), torch.moveaxis(b, axisb, -1)
    if a.shape[-1] == 2:
        a = torch.nn.functional.pad(a, (0, 1))
    if b.shape[-1] == 2:
        b = torch.nn.functional.pad(b, (0, 1))
    c = torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)
    return torch.moveaxis(c, -1, axisc)


def _trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    a = _a(a)
    d = torch.diagonal(a, offset, axis1, axis2)
    return _sum(d, -1, dtype)


def _diag(v, k=0):
    v = _a(v)
    if v.ndim not in (1, 2):
        raise MXNetError("diag: input must be 1-D or 2-D")
    return torch.diag(v, k)


# -- comparison, logic ---------------------------------------------------------
def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _promote(_float(a), _float(b))
    return torch.isclose(*torch.broadcast_tensors(a, b), rtol=rtol,
                         atol=atol, equal_nan=equal_nan)


def _array_equal(a1, a2, equal_nan=False):
    a1, a2 = _a(a1), _a(a2)
    if a1.shape != a2.shape:
        return torch.tensor(False, device=a1.device)
    eq = a1 == a2
    if equal_nan and a1.is_floating_point():
        eq = eq | (torch.isnan(a1) & torch.isnan(a2))
    return torch.all(eq)


def _where(condition, x=None, y=None):
    c = _a(condition)
    if x is None and y is None:
        return _nonzero(c)
    x, y = _promote(x, y)
    return torch.where(c.to(torch.bool), x, y)


def _all(a, axis=None, out=None, keepdims=False, **kw):
    a = _a(a)
    return torch.all(a.bool(), dim=_axes(axis, a.ndim), keepdim=keepdims) \
        if a.ndim else a.bool()


def _any(a, axis=None, out=None, keepdims=False, **kw):
    a = _a(a)
    return torch.any(a.bool(), dim=_axes(axis, a.ndim), keepdim=keepdims) \
        if a.ndim else a.bool()


# -- sorting, searching, counting ---------------------------------------------
def _sort(a, axis=-1, kind=None, order=None, **kw):
    a = _a(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True)[0]


def _argsort(a, axis=-1, kind=None, order=None, **kw):
    a = _a(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.argsort(a, dim=axis, stable=True)


def _argext(fn):
    def run(a, axis=None, out=None, keepdims=False):
        a = _a(a)
        if axis is None:
            r = fn(a.reshape(-1))
            return r.reshape((1,) * a.ndim) if keepdims else r
        return fn(a, dim=axis, keepdim=keepdims)
    return run


def _searchsorted(a, v, side="left", sorter=None):
    a = _a(a)
    if sorter is not None:
        a = a[_a(sorter).long()]
    v = _a(v)
    a, v = _promote(a, v)
    return torch.searchsorted(a, v, right=side == "right")


def _top(x, k):
    """``lax.top_k``: the k largest along the last axis, ties in index
    order (a stable descending sort)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _partition(a, kth, axis=-1):
    """jnp.partition: the kth + 1 smallest ascending, then the rest
    descending."""
    a = _a(a)
    x = a.swapaxes(axis, -1)
    n = x.shape[-1]
    kth = kth % n
    bottom = -_top(-x, kth + 1)[0]
    top = _top(x, n - kth - 1)[0]
    return torch.cat([bottom, top], dim=-1).swapaxes(-1, axis)


def _argpartition(a, kth, axis=-1):
    """jnp.argpartition: the indices :func:`_partition` orders by, the
    rest in index order."""
    a = _a(a)
    x = a.swapaxes(axis, -1)
    n = x.shape[-1]
    kth = kth % n
    bottom = _top(-x, kth + 1)[1]
    proxy = torch.ones_like(x, dtype=torch.float32).scatter(-1, bottom, 0.0)
    top = _top(proxy, n - kth - 1)[1]
    return torch.cat([bottom, top], dim=-1).swapaxes(-1, axis)


def _nonzero(a):
    a = _a(a)
    return tuple(torch.nonzero(a.reshape(1) if a.ndim == 0 else a,
                               as_tuple=True))


def _bincount(x, weights=None, minlength=0, length=None):
    x = _a(x).long()
    out = torch.bincount(x, None if weights is None else _a(weights),
                         minlength=minlength)
    return out if weights is None else out.to(
        torch.promote_types(_a(weights).dtype, torch.float32))


def _digitize(x, bins, right=False):
    x, bins = _promote(x, bins)
    if bins.numel() > 1 and bool(bins[-1] < bins[0]):
        return bins.numel() - torch.searchsorted(bins.flip(0), x,
                                                 right=not right)
    return torch.searchsorted(bins, x, right=not right)


def _histogram(a, bins=10, range=None, weights=None, density=None):
    a = _float(a)
    w = torch.ones_like(a) if weights is None else _float(weights)
    if isinstance(bins, (int, onp.integer)):
        lo, hi = (a.min(), a.max()) if range is None else (
            _a(range[0]).to(a.dtype), _a(range[1]).to(a.dtype))
        lo, hi = torch.as_tensor(lo, dtype=a.dtype), \
            torch.as_tensor(hi, dtype=a.dtype)
        same = lo == hi
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                              hi)
        edges = _linspace(lo, hi, int(bins) + 1)
    else:
        edges = _float(bins)
    idx = torch.searchsorted(edges, a.reshape(-1), right=True)
    idx = torch.where(a.reshape(-1) == edges[-1], edges.numel() - 1, idx)
    counts = torch.zeros(edges.numel(), dtype=w.dtype, device=a.device) \
        .index_add_(0, idx, w.reshape(-1))[1:]
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    return counts, edges


def _take(a, indices, axis=None, out=None, mode=None, **kw):
    a = _a(a)
    idx = _a(indices).long()
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    if mode in (None, "fill"):
        # jnp's default: an index out of range gives NaN (0 for integers)
        inside = (idx >= -n) & (idx < n)
        safe = torch.where(idx < 0, idx + n, idx).clamp(0, builtins.max(n - 1,
                                                                        0))
        out = torch.index_select(a, axis, safe.reshape(-1)).reshape(
            a.shape[:axis] + idx.shape + a.shape[axis + 1:])
        fill = math.nan if a.is_floating_point() else 0
        mshape = (1,) * axis + tuple(idx.shape) + (1,) * (a.ndim - axis - 1)
        return torch.where(inside.reshape(mshape), out,
                           torch.full((), fill, dtype=a.dtype,
                                      device=a.device))
    idx = idx % n if mode == "wrap" else idx.clamp(0, n - 1)
    return torch.index_select(a, axis, idx.reshape(-1)).reshape(
        a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def _take_along_axis(arr, indices, axis, **kw):
    arr, idx = _a(arr), _a(indices).long()
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    n = arr.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    shape = list(torch.broadcast_shapes(
        tuple(s if i != axis else 1 for i, s in enumerate(arr.shape)),
        tuple(s if i != axis else 1 for i, s in enumerate(idx.shape))))
    a_shape, i_shape = list(shape), list(shape)
    a_shape[axis], i_shape[axis] = arr.shape[axis], idx.shape[axis]
    return torch.gather(arr.expand(a_shape), axis, idx.expand(i_shape))


def _choose(a, choices, out=None, mode="raise"):
    a = _a(a).long()
    cs = torch.stack(torch.broadcast_tensors(*_promote(*choices)))
    n = cs.shape[0]
    a = a % n if mode == "wrap" else a.clamp(0, n - 1)
    cs, a = torch.broadcast_tensors(cs, a.unsqueeze(0))
    return torch.gather(cs, 0, a[:1]).squeeze(0)


def _compress(condition, a, axis=None, out=None, **kw):
    a = _a(a)
    c = _a(condition).bool().reshape(-1)
    if axis is None:
        a, axis = a.reshape(-1), 0
    c = c[:a.shape[axis]]
    idx = torch.nonzero(c).reshape(-1)
    return torch.index_select(a, axis, idx)


def _extract(condition, arr, **kw):
    return _a(arr).reshape(-1)[_a(condition).bool().reshape(-1)]


def _indices(dimensions, dtype=None, sparse=False):
    grids = torch.meshgrid(*[torch.arange(d, device=_device())
                             for d in dimensions], indexing="ij")
    dt = _dt(dtype, torch.int32)
    if sparse:
        return tuple(g.to(dt) for g in grids)
    return torch.stack(grids).to(dt)


def _unravel_index(indices, shape):
    idx = _a(indices).long()
    out = []
    for d in reversed(_shape(shape)):
        out.append(idx % d)
        idx = torch.div(idx, d, rounding_mode="floor")
    return tuple(reversed(out))


def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    idx = [_a(i).long() for i in multi_index]
    flat = torch.zeros_like(idx[0])
    for i, d in zip(idx, _shape(dims)):
        flat = flat * d + (i % d if mode == "wrap" else i.clamp(0, d - 1))
    return flat


def _tri_indices(upper):
    def run(n, k=0, m=None):
        m = n if m is None else m
        fn = torch.triu_indices if upper else torch.tril_indices
        r = fn(n, m, k, device=_device())
        return r[0], r[1]
    return run


# -- misc ----------------------------------------------------------------------
def _frexp(x):
    m, e = torch.frexp(_float(x))
    return m, e.to(torch.int32)


def _modf(x, out=None):
    x = _float(x)
    i = torch.trunc(x)
    return x - i, i


def _divmod(x1, x2, out=None):
    x1, x2 = _promote(x1, x2)
    return torch.floor_divide(x1, x2), torch.remainder(x1, x2)


def _diff(a, n=1, axis=-1, prepend=None, append=None):
    a = _a(a)

    def edge(e):
        e = _a(e).to(a.dtype)
        if e.ndim == 0:
            shape = list(a.shape)
            shape[axis] = 1
            e = torch.broadcast_to(e, shape)
        return e

    parts = ([edge(prepend)] if prepend is not None else []) + [a] + \
        ([edge(append)] if append is not None else [])
    if len(parts) > 1:
        a = torch.cat(parts, dim=axis)
    for _ in range(n):
        m = a.shape[axis] - 1
        a = torch.ne(a.narrow(axis, 1, m), a.narrow(axis, 0, m)) \
            if a.dtype == torch.bool else torch.diff(a, dim=axis)
    return a


def _ediff1d(ary, to_end=None, to_begin=None):
    a = _a(ary).reshape(-1)
    d = a[1:] - a[:-1]
    parts = ([_a(to_begin).reshape(-1).to(d.dtype)] if to_begin is not None
             else []) + [d] + ([_a(to_end).reshape(-1).to(d.dtype)]
                               if to_end is not None else [])
    return torch.cat(parts)


def _gradient(f, *varargs, axis=None, edge_order=1):
    f = _float(f)
    axes = _axes(axis, f.ndim)
    outs = []
    for i, ax in enumerate(axes):
        h = float(varargs[i] if len(varargs) > 1 else varargs[0]) \
            if varargs else 1.0
        n = f.shape[ax]
        inner = (f.narrow(ax, 2, n - 2) - f.narrow(ax, 0, n - 2)) / (2 * h)
        first = (f.narrow(ax, 1, 1) - f.narrow(ax, 0, 1)) / h
        last = (f.narrow(ax, n - 1, 1) - f.narrow(ax, n - 2, 1)) / h
        outs.append(torch.cat([first, inner, last], dim=ax))
    return outs[0] if len(outs) == 1 else outs


def _convolve(a, v, mode="full", precision=None, **kw):
    a, v = _promote(_float(a), _float(v))
    if a.numel() < v.numel():
        a, v = v, a
    return _correlate(a, v.flip(0), mode)


def _correlate(a, v, mode="valid", precision=None, **kw):
    a, v = _promote(_float(a), _float(v))
    n, m = a.numel(), v.numel()
    if mode == "valid":
        pad = (0, 0)
    elif mode == "same":
        pad = (m // 2, m - 1 - m // 2)
    else:
        pad = (m - 1, m - 1)
    x = torch.nn.functional.pad(a.reshape(1, 1, n), pad)
    out = torch.nn.functional.conv1d(x, v.reshape(1, 1, m)).reshape(-1)
    if mode == "same" and n < m:
        out = out[:builtins.max(n, m)]
    return out


def _real(val):
    v = _a(val)
    return v.real if v.is_complex() else v


def _imag(val):
    v = _a(val)
    return v.imag if v.is_complex() else torch.zeros_like(v)


def _conj(x, out=None):
    x = _a(x)
    return torch.conj_physical(x) if x.is_complex() else x


def _angle(z, deg=False):
    z = _a(z)
    r = torch.angle(z) if z.is_complex() or z.is_floating_point() else \
        torch.angle(z.float())
    return torch.rad2deg(r) if deg else r


def _dtype_of(x):
    if isinstance(x, torch.Tensor):
        return onp.dtype(str(x.dtype).replace("torch.", "")) \
            if x.dtype != torch.bfloat16 else onp.dtype("float32")
    return onp.asarray(x).dtype


def _narrow_np(dt):
    dt = onp.dtype(dt)
    return {onp.dtype(onp.float64): onp.dtype(onp.float32),
            onp.dtype(onp.int64): onp.dtype(onp.int32),
            onp.dtype(onp.uint64): onp.dtype(onp.uint32),
            onp.dtype(onp.complex128): onp.dtype(onp.complex64)}.get(dt, dt)


def _result_type(*arrays_and_dtypes):
    return _narrow_np(onp.result_type(*[
        _dtype_of(x) if isinstance(x, torch.Tensor) else x
        for x in arrays_and_dtypes]))


def _vander(x, N=None, increasing=False):
    x = _a(x)
    n = x.numel() if N is None else N
    p = torch.arange(n, device=x.device)
    if not increasing:
        p = p.flip(0)
    return x.reshape(-1, 1) ** p.to(x.dtype if x.is_floating_point()
                                    else torch.int64)


def _sinc(x):
    x = _float(x)
    y = math.pi * torch.where(x == 0, torch.full_like(x, 1e-20), x)
    return torch.where(x == 0, torch.ones_like(x), torch.sin(y) / y)


def _unwrap(p, discont=None, axis=-1, period=2 * math.pi):
    p = _float(p)
    if p.shape[axis] == 0:
        return p
    discont = period / 2 if discont is None else discont
    interval = period / 2
    dd = torch.diff(p, dim=axis)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0),
                        torch.full_like(ddmod, interval), ddmod)
    correct = torch.where(torch.abs(dd) < discont, torch.zeros_like(dd),
                          ddmod - dd)
    n = p.shape[axis]
    return torch.cat([p.narrow(axis, 0, 1),
                      p.narrow(axis, 1, n - 1) + torch.cumsum(correct, axis)],
                     dim=axis)


def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None):
    x = _float(m)
    if x.ndim == 1:
        x = x.reshape(1, -1)
    if not rowvar and x.shape[0] != 1:
        x = x.T
    if y is not None:
        yy = _float(y)
        if yy.ndim == 1:
            yy = yy.reshape(1, -1)
        if not rowvar and yy.shape[0] != 1:
            yy = yy.T
        x = torch.cat([x, yy.to(x.dtype)], dim=0)
    if ddof is None:
        ddof = 0 if bias else 1
    c = torch.cov(x, correction=ddof,
                  fweights=None if fweights is None else _a(fweights),
                  aweights=None if aweights is None else _a(aweights))
    return c.squeeze() if c.ndim else c


def _corrcoef(x, y=None, rowvar=True):
    c = _cov(x, y, rowvar)
    if c.ndim == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c))
    return torch.clamp(c / d[:, None] / d[None, :], -1, 1)


def _unique1d(a):
    return _unique(_a(a).reshape(-1))


def _union1d(ar1, ar2, **kw):
    return _unique1d(torch.cat(_promote(_a(ar1).reshape(-1),
                                        _a(ar2).reshape(-1))))


def _isin_sorted(x, table):
    """Membership of ``x`` in the sorted 1-D ``table``."""
    if table.numel() == 0:
        return torch.zeros_like(x, dtype=torch.bool)
    i = torch.searchsorted(table, x).clamp(max=table.numel() - 1)
    return table[i] == x


def _intersect1d(ar1, ar2, assume_unique=False, return_indices=False, **kw):
    a1, a2 = _promote(_a(ar1).reshape(-1), _a(ar2).reshape(-1))
    if return_indices:
        u1, i1 = _unique(a1, return_index=True)
        u2, i2 = _unique(a2, return_index=True)
        mask = _isin_sorted(u1, u2)
        common = u1[mask]
        return common, i1[mask], i2[torch.searchsorted(u2, common)]
    u1, u2 = _unique1d(a1), _unique1d(a2)
    return u1[_isin_sorted(u1, u2)]


def _setdiff1d(ar1, ar2, assume_unique=False, **kw):
    a1, a2 = _a(ar1).reshape(-1), _a(ar2).reshape(-1)
    u1 = _unique1d(a1)
    u2 = _unique1d(a2).to(u1.dtype)
    return u1[~_isin_sorted(u1, u2)]


def _setxor1d(ar1, ar2, assume_unique=False, **kw):
    a1, a2 = _promote(_a(ar1).reshape(-1), _a(ar2).reshape(-1))
    u1, u2 = _unique1d(a1), _unique1d(a2)
    return torch.sort(torch.cat([u1[~_isin_sorted(u1, u2)],
                                 u2[~_isin_sorted(u2, u1)]]))[0]


def _isin(element, test_elements, assume_unique=False, invert=False, **kw):
    e, t = _promote(element, test_elements)
    r = torch.isin(e, t)
    return ~r if invert else r


def _select(condlist, choicelist, default=0):
    choices = _promote(*choicelist)
    out = torch.broadcast_to(_a(default).to(choices[0].dtype),
                             torch.broadcast_shapes(*[c.shape
                                                      for c in choices]))
    for c, v in reversed(list(zip(condlist, choices))):
        out = torch.where(_a(c).bool(), v, out)
    return out


def _resize(a, new_shape):
    a = _a(a).reshape(-1)
    shape = _shape(new_shape)
    n = math.prod(shape)
    if a.numel() == 0 or n == 0:
        return torch.zeros(shape, dtype=a.dtype, device=a.device)
    reps = -(-n // a.numel())
    return a.repeat(reps)[:n].reshape(shape)


def _trim_zeros(filt, trim="fb", axis=None):
    f = _a(filt)
    axes = _axes(axis, f.ndim)
    trim = trim.lower()
    index = []
    for ax in range(f.ndim):
        if ax not in axes:
            index.append(slice(None))
            continue
        other = [i for i in range(f.ndim) if i != ax]
        mask = (f != 0).any(dim=other) if other else (f != 0)
        nz = torch.nonzero(mask).reshape(-1)
        if nz.numel() == 0:
            index.append(slice(0, 0))
            continue
        start = int(nz[0]) if "f" in trim else None
        stop = int(nz[-1]) + 1 if "b" in trim else None
        index.append(slice(start, stop))
    return f[tuple(index)]


def _diag_indices(n, ndim=2):
    i = torch.arange(n, device=_device(), dtype=torch.int32)
    return (i,) * ndim


def _diag_indices_from(arr):
    a = _a(arr)
    return _diag_indices(a.shape[0], a.ndim)


def _ix_(*args):
    n = len(args)
    out = []
    for k, x in enumerate(args):
        x = _a(x)
        if x.dtype == torch.bool:
            x = torch.nonzero(x).reshape(-1)
        out.append(x.reshape((1,) * k + (-1,) + (1,) * (n - k - 1)))
    return tuple(out)


def _spacing(x):
    x = _float(x)
    return torch.nextafter(x, torch.where(x < 0, torch.full_like(x, -math.inf),
                                          torch.full_like(x, math.inf))) - x


def _logaddexp2(x1, x2):
    x1, x2 = _promote(_float(x1), _float(x2))
    return torch.logaddexp2(x1, x2)


def _nancum(fn, fill):
    cum = _cum(fn)

    def run(a, axis=None, dtype=None, out=None):
        return cum(_nan_fill(fill)(a), axis, dtype)
    return run


def _tril(m, k=0):
    return torch.tril(_a(m), k)


def _triu(m, k=0):
    return torch.triu(_a(m), k)


def _rollaxis(a, axis, start=0):
    a = _a(a)
    n = a.ndim
    axis, start = axis % n, start % (n + 1) if start < 0 else start
    if axis < start:
        start -= 1
    return torch.moveaxis(a, axis, start)


def _reshape(a, newshape=None, order="C", shape=None):
    s = newshape if newshape is not None else shape
    return torch.reshape(_a(a), _shape(s))


def _transpose(a, axes=None):
    a = _a(a)
    return a.permute(*(reversed(range(a.ndim)) if axes is None else axes))


def _repeat(a, repeats, axis=None, **kw):
    a = _a(a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    r = repeats if isinstance(repeats, (int, onp.integer)) else \
        _a(repeats).long()
    return torch.repeat_interleave(a, r, dim=axis)


def _tile(A, reps):
    a = _a(A)
    reps = _shape(reps)
    if len(reps) < a.ndim:
        reps = (1,) * (a.ndim - len(reps)) + reps
    return a.reshape((1,) * (len(reps) - a.ndim) + tuple(a.shape)) \
        .repeat(*reps)


def _flip(m, axis=None):
    m = _a(m)
    return torch.flip(m, _axes(axis, m.ndim))


def _roll(a, shift, axis=None):
    a = _a(a)
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


def _expand_dims(a, axis):
    a = _a(a)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    n = a.ndim + len(axes)
    for ax in sorted(x % n for x in axes):
        a = a.unsqueeze(ax)
    return a


def _squeeze(a, axis=None):
    a = _a(a)
    if axis is None:
        return a.squeeze()
    for ax in sorted(_axes(axis, a.ndim), reverse=True):
        a = a.squeeze(ax)
    return a


def _concat(arrays, axis=0, dtype=None, **kw):
    xs = _promote(*arrays)
    if axis is None:
        xs, axis = [x.reshape(-1) for x in xs], 0
    out = torch.cat(xs, dim=axis)
    return out if dtype is None else out.to(as_torch_dtype(dtype))


def _stack(arrays, axis=0, out=None, dtype=None):
    out = torch.stack(_promote(*arrays), dim=axis)
    return out if dtype is None else out.to(as_torch_dtype(dtype))


def _vstack(tup, dtype=None):
    return _concat([_atleast(2)(x) for x in tup], 0, dtype)


def _hstack(tup, dtype=None):
    xs = [_atleast(1)(x) for x in tup]
    return _concat(xs, 0 if xs[0].ndim == 1 else 1, dtype)


def _dstack(tup, dtype=None):
    return _concat([_atleast(3)(x) for x in tup], 2, dtype)


def _column_stack(tup):
    return _concat([_a(x).reshape(-1, 1) if _a(x).ndim < 2 else _a(x)
                    for x in tup], 1)


def _broadcast_to(array, shape):
    return torch.broadcast_to(_a(array), _shape(shape)).clone()


def _broadcast_arrays(*args):
    return [t.clone() for t in torch.broadcast_tensors(*[_a(x)
                                                         for x in args])]


def _abs(x, **kw):
    return torch.abs(_a(x))


def _fabs(x, **kw):
    return torch.abs(_float(x))


def _power(x1, x2, **kw):
    return torch.pow(*_promote(x1, x2))


def _float_power(x1, x2, **kw):
    x1, x2 = _promote(_float(x1), _float(x2))
    return torch.pow(x1, x2)


def _true_divide(x1, x2, **kw):
    return torch.true_divide(_a(x1), _a(x2))


_IMPL = {
    "zeros": _zeros, "ones": _ones, "empty": _zeros, "full": _full,
    "arange": _arange, "eye": _eye,
    "identity": lambda n, dtype=None: _eye(n, dtype=dtype),
    "linspace": _linspace, "logspace": _logspace, "meshgrid": _meshgrid,
    "tril": _tril, "triu": _triu,
    "zeros_like": lambda a, dtype=None, shape=None: _like(a, dtype, shape,
                                                          torch.zeros),
    "ones_like": lambda a, dtype=None, shape=None: _like(a, dtype, shape,
                                                         torch.ones),
    "empty_like": lambda a, dtype=None, shape=None: _like(a, dtype, shape,
                                                          torch.zeros),
    "full_like": _full_like,
    "reshape": _reshape,
    "ravel": lambda a, order="C": _a(a).reshape(-1),
    "transpose": _transpose,
    "swapaxes": lambda a, axis1, axis2: torch.swapaxes(_a(a), axis1, axis2),
    "moveaxis": lambda a, source, destination: torch.moveaxis(
        _a(a), source, destination),
    "rollaxis": _rollaxis, "concatenate": _concat, "stack": _stack,
    "vstack": _vstack, "hstack": _hstack, "dstack": _dstack,
    "column_stack": _column_stack,
    "split": lambda ary, indices_or_sections, axis=0: _split(
        ary, indices_or_sections, axis, True),
    "array_split": lambda ary, indices_or_sections, axis=0: _split(
        ary, indices_or_sections, axis, False),
    "hsplit": lambda ary, s: _split(ary, s, 1 if _a(ary).ndim > 1 else 0),
    "vsplit": lambda ary, s: _split(ary, s, 0),
    "dsplit": lambda ary, s: _split(ary, s, 2),
    "tile": _tile, "repeat": _repeat, "flip": _flip,
    "fliplr": lambda m: torch.flip(_a(m), (1,)),
    "flipud": lambda m: torch.flip(_a(m), (0,)),
    "roll": _roll,
    "rot90": lambda m, k=1, axes=(0, 1): torch.rot90(_a(m), k, axes),
    "expand_dims": _expand_dims, "squeeze": _squeeze,
    "broadcast_to": _broadcast_to, "broadcast_arrays": _broadcast_arrays,
    "atleast_1d": _atleast(1), "atleast_2d": _atleast(2),
    "atleast_3d": _atleast(3), "pad": _pad, "append": _append,
    "delete": _delete, "insert": _insert, "unique": _unique,
    "add": _binary(torch.add), "subtract": _binary(torch.subtract),
    "multiply": _binary(torch.multiply), "divide": _true_divide,
    "true_divide": _true_divide,
    "floor_divide": _binary(torch.floor_divide),
    "mod": _binary(torch.remainder), "remainder": _binary(torch.remainder),
    "fmod": _binary(torch.fmod), "power": _power,
    "float_power": _float_power, "negative": _unary(torch.negative),
    "positive": _unary(lambda x: x.clone()), "absolute": _abs, "abs": _abs,
    "fabs": _fabs, "sign": _unary(torch.sign), "rint": _unary(torch.round),
    "exp": _unary(torch.exp, True), "expm1": _unary(torch.expm1, True),
    "exp2": _unary(torch.exp2, True), "log": _unary(torch.log, True),
    "log2": _unary(torch.log2, True), "log10": _unary(torch.log10, True),
    "log1p": _unary(torch.log1p, True), "sqrt": _unary(torch.sqrt, True),
    "cbrt": _cbrt, "square": _unary(torch.square),
    "reciprocal": _unary(torch.reciprocal, True),
    "sin": _unary(torch.sin, True), "cos": _unary(torch.cos, True),
    "tan": _unary(torch.tan, True), "arcsin": _unary(torch.arcsin, True),
    "arccos": _unary(torch.arccos, True),
    "arctan": _unary(torch.arctan, True),
    "arctan2": lambda x1, x2, **kw: torch.arctan2(*_promote(_float(x1),
                                                             _float(x2))),
    "sinh": _unary(torch.sinh, True), "cosh": _unary(torch.cosh, True),
    "tanh": _unary(torch.tanh, True), "arcsinh": _unary(torch.arcsinh, True),
    "arccosh": _unary(torch.arccosh, True),
    "arctanh": _unary(torch.arctanh, True),
    "degrees": _unary(torch.rad2deg, True),
    "radians": _unary(torch.deg2rad, True),
    "deg2rad": _unary(torch.deg2rad, True),
    "rad2deg": _unary(torch.rad2deg, True),
    "hypot": lambda x1, x2, **kw: torch.hypot(*_promote(_float(x1),
                                                         _float(x2))),
    "maximum": lambda x1, x2, **kw: torch.maximum(*_promote(x1, x2)),
    "minimum": lambda x1, x2, **kw: torch.minimum(*_promote(x1, x2)),
    "fmax": lambda x1, x2, **kw: torch.fmax(*_promote(x1, x2)),
    "fmin": lambda x1, x2, **kw: torch.fmin(*_promote(x1, x2)),
    "clip": _clip, "floor": _unary(torch.floor), "ceil": _unary(torch.ceil),
    "trunc": _unary(torch.trunc), "around": _round, "round": _round,
    "nan_to_num": _nan_to_num, "interp": _interp, "heaviside": _heaviside,
    "gcd": lambda x1, x2: torch.gcd(*_promote(x1, x2)),
    "lcm": lambda x1, x2: torch.lcm(*_promote(x1, x2)),
    "ldexp": _ldexp,
    "sum": _sum, "prod": _prod, "cumsum": _cum(torch.cumsum),
    "cumprod": _cum(torch.cumprod), "max": _amax, "min": _amin,
    "amax": _amax, "amin": _amin, "nanmax": _nanmax, "nanmin": _nanmin,
    "nansum": lambda a, axis=None, dtype=None, out=None, keepdims=False,
    **kw: _sum(_nan_fill(0)(a), axis, dtype, keepdims=keepdims),
    "nanprod": lambda a, axis=None, dtype=None, out=None, keepdims=False,
    **kw: _prod(_nan_fill(1)(a), axis, dtype, keepdims=keepdims),
    "mean": _mean, "std": _std, "var": _var, "median": _median,
    "average": _average, "nanmean": _nanmean, "nanstd": _nanstd,
    "nanvar": _nanvar,
    "ptp": lambda a, axis=None, out=None, keepdims=False: _amax(
        a, axis, keepdims=keepdims) - _amin(a, axis, keepdims=keepdims),
    "percentile": _percentile, "quantile": _quantile,
    "count_nonzero": _count_nonzero,
    "dot": _dot,
    "vdot": lambda a, b: torch.sum(_conj(_promote(a, b)[0]).reshape(-1)
                                   * _promote(a, b)[1].reshape(-1)),
    "inner": _inner,
    "outer": lambda a, b, out=None: torch.outer(*_promote(
        _a(a).reshape(-1), _a(b).reshape(-1))),
    "matmul": lambda a, b, **kw: torch.matmul(*_promote(a, b)),
    "tensordot": _tensordot, "einsum": _einsum,
    "kron": lambda a, b: torch.kron(*_promote(a, b)),
    "cross": _cross, "trace": _trace,
    "diagonal": lambda a, offset=0, axis1=0, axis2=1: torch.diagonal(
        _a(a), offset, axis1, axis2),
    "diag": _diag,
    "diagflat": lambda v, k=0: torch.diagflat(_a(v), k),
    "equal": lambda x1, x2, **kw: torch.eq(*_promote(x1, x2)),
    "not_equal": lambda x1, x2, **kw: torch.ne(*_promote(x1, x2)),
    "less": lambda x1, x2, **kw: torch.lt(*_promote(x1, x2)),
    "less_equal": lambda x1, x2, **kw: torch.le(*_promote(x1, x2)),
    "greater": lambda x1, x2, **kw: torch.gt(*_promote(x1, x2)),
    "greater_equal": lambda x1, x2, **kw: torch.ge(*_promote(x1, x2)),
    "logical_and": _binary(torch.logical_and),
    "logical_or": _binary(torch.logical_or),
    "logical_xor": _binary(torch.logical_xor),
    "logical_not": _unary(torch.logical_not),
    "isfinite": _unary(torch.isfinite), "isinf": _unary(torch.isinf),
    "isnan": _unary(torch.isnan), "isneginf": _unary(torch.isneginf),
    "isposinf": _unary(torch.isposinf), "isclose": _isclose,
    "allclose": lambda a, b, rtol=1e-05, atol=1e-08, equal_nan=False:
    torch.all(_isclose(a, b, rtol, atol, equal_nan)),
    "array_equal": _array_equal, "where": _where, "all": _all, "any": _any,
    "sort": _sort, "argsort": _argsort,
    "argmax": _argext(torch.argmax), "argmin": _argext(torch.argmin),
    "nanargmax": lambda a, axis=None, out=None, keepdims=False:
    _argext(torch.argmax)(_nan_fill(-math.inf)(a), axis, keepdims=keepdims),
    "nanargmin": lambda a, axis=None, out=None, keepdims=False:
    _argext(torch.argmin)(_nan_fill(math.inf)(a), axis, keepdims=keepdims),
    "searchsorted": _searchsorted, "partition": _partition,
    "argpartition": _argpartition, "nonzero": _nonzero,
    "flatnonzero": lambda a: torch.nonzero(_a(a).reshape(-1)).reshape(-1),
    "bincount": _bincount, "digitize": _digitize, "histogram": _histogram,
    "take": _take, "take_along_axis": _take_along_axis, "choose": _choose,
    "compress": _compress, "extract": _extract, "indices": _indices,
    "unravel_index": _unravel_index,
    "ravel_multi_index": _ravel_multi_index,
    "tril_indices": _tri_indices(False), "triu_indices": _tri_indices(True),
    "bitwise_and": _binary(torch.bitwise_and),
    "bitwise_or": _binary(torch.bitwise_or),
    "bitwise_xor": _binary(torch.bitwise_xor),
    "invert": _unary(torch.bitwise_not),
    "left_shift": _binary(torch.bitwise_left_shift),
    "right_shift": _binary(torch.bitwise_right_shift),
    "copysign": lambda x1, x2, **kw: torch.copysign(*_promote(_float(x1),
                                                               _float(x2))),
    "signbit": _unary(torch.signbit), "frexp": _frexp, "modf": _modf,
    "divmod": _divmod, "gradient": _gradient, "diff": _diff,
    "ediff1d": _ediff1d, "convolve": _convolve, "correlate": _correlate,
    "real": _real, "imag": _imag, "conj": _conj, "angle": _angle,
    "iscomplexobj": lambda x: bool(_a(x).is_complex()),
    "isrealobj": lambda x: not _a(x).is_complex(),
    "shape": lambda a: tuple(_a(a).shape),
    "size": lambda a, axis=None: _a(a).numel() if axis is None
    else _a(a).shape[axis],
    "ndim": lambda a: _a(a).ndim,
    "result_type": _result_type,
    "can_cast": lambda from_, to, casting="safe": bool(onp.can_cast(
        _dtype_of(from_) if isinstance(from_, torch.Tensor) else from_, to,
        casting)),
    "promote_types": lambda type1, type2: _narrow_np(
        onp.promote_types(type1, type2)),
    "vander": _vander, "i0": _unary(torch.special.i0, True), "sinc": _sinc,
    "unwrap": _unwrap, "cov": _cov, "corrcoef": _corrcoef,
    "union1d": _union1d, "intersect1d": _intersect1d,
    "setdiff1d": _setdiff1d, "setxor1d": _setxor1d, "isin": _isin,
    "select": _select, "resize": _resize, "trim_zeros": _trim_zeros,
    "diag_indices": _diag_indices, "diag_indices_from": _diag_indices_from,
    "ix_": _ix_, "spacing": _spacing,
    "nextafter": lambda x1, x2, **kw: torch.nextafter(*_promote(
        _float(x1), _float(x2))),
    "logaddexp": lambda x1, x2, **kw: torch.logaddexp(*_promote(
        _float(x1), _float(x2))),
    "logaddexp2": _logaddexp2,
    "nancumsum": _nancum(torch.cumsum, 0),
    "nancumprod": _nancum(torch.cumprod, 1),
    "nanmedian": _nanmedian,
    "nanpercentile": lambda a, q, axis=None, out=None,
    overwrite_input=False, method="linear", keepdims=False, **kw:
    _nan_quantile(a, _float(q) / 100, axis, method=method,
                  keepdims=keepdims),
    "nanquantile": _nan_quantile,
}
assert set(_IMPL) == set(FUNCS), set(FUNCS) ^ set(_IMPL)

_this = sys.modules[__name__]
for _name in FUNCS:
    setattr(_this, _name, _make(_name, _IMPL[_name]))
__all__ += list(FUNCS)


def _boxing(fn):
    """A user's ``mx.np`` callback called on tensors: its arguments
    boxed, its result unboxed."""
    def run(*arrays):
        out = fn(*[NDArray(a) for a in arrays])
        return out._data if isinstance(out, NDArray) else out
    return run


def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    """numpy.apply_along_axis over an ``mx.np`` callback (one call per
    1-D slice)."""
    def run(a):
        x = torch.moveaxis(a, axis, -1)
        rows = x.reshape(-1, x.shape[-1])
        fn = _boxing(lambda v: func1d(v, *args, **kwargs))
        outs = torch.stack([_a(fn(r)) for r in rows])
        out = outs.reshape(*x.shape[:-1], *outs.shape[1:])
        return torch.moveaxis(out, x.ndim - 1, axis) if outs.ndim > 1 \
            else out
    return _call(run, arr)


def apply_over_axes(func, a, axes):
    """numpy.apply_over_axes; ``func(arr, axis)`` takes and returns
    ``mx.np`` arrays."""
    def run(x):
        for ax in ([axes] if isinstance(axes, int) else axes):
            out = func(NDArray(x), ax)
            out = out._data if isinstance(out, NDArray) else _a(out)
            x = out if out.ndim == x.ndim else out.unsqueeze(ax)
        return x
    return _call(run, a)


def piecewise(x, condlist, funclist, *args, **kw):
    """numpy.piecewise; ``funclist`` entries are numbers or ``mx.np``
    callables."""
    def run(xs, conds):
        conds = [_a(c).bool() for c in (conds if isinstance(conds, (list,
                                                                   tuple))
                                        else [conds])]
        if len(funclist) == len(conds) + 1:
            conds.append(~torch.stack(conds).any(0))
        out = torch.zeros_like(xs)
        for c, f in zip(conds, funclist):
            v = _a(_boxing(f)(xs)).to(xs.dtype) if callable(f) else \
                torch.full_like(xs, f)
            out = torch.where(c, v, out)
        return out
    return _call(run, x, condlist)


def array(obj, dtype=None, ctx=None):
    """mx.np.array — from nested lists, numpy arrays or NDArrays, on
    ``ctx`` (the current context when None)."""
    if isinstance(obj, NDArray):
        t = obj._data
        if ctx is not None:
            t = t.to(_dispatch.as_device(ctx))
        return NDArray(t if dtype is None else t.to(as_torch_dtype(dtype)))
    device = _dispatch.as_device(ctx if ctx is not None
                                 else current_context())
    t = _dispatch.to_tensor(obj, device)
    return NDArray(t if dtype is None else t.to(as_torch_dtype(dtype)))


asarray = array

from . import fft, linalg, random  # noqa: E402

"""Tensor operators (counterpart of ``mxnet_tpu/ops/tensor.py``):
reductions, shapes, indexing, ordering and linalg, registered under the
JAX package's 82 names. Products and ``_linalg_*`` are plain PyTorch
calls (cuBLAS, cuSOLVER on the card), as the JAX package leaves them to
XLA; no TPU kernel is among them. Out-of-range indices follow the JAX
package (clamp, wrap, drop or a NaN row), never a device-side assert,
which would poison a server's CUDA context."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, jax_dtype

__all__ = ["argmax", "argmin", "argsort", "batch_dot", "batch_take",
           "broadcast_axis", "broadcast_like", "broadcast_to", "clip",
           "concat", "depth_to_space", "diag", "dot", "expand_dims",
           "flatten", "gather_nd", "khatri_rao", "linalg_extractdiag",
           "linalg_extracttrian", "linalg_gemm2", "linalg_makediag",
           "linalg_maketrian", "linalg_syrk", "linalg_trmm", "linalg_trsm",
           "log_softmax", "logsumexp", "moveaxis", "norm", "one_hot", "pad",
           "pick", "reduce", "repeat", "reshape", "reshape_like", "reverse",
           "scatter_nd", "shifted_expsum", "slice_axis", "slice_like",
           "slice_nd", "sort", "space_to_depth", "split", "squeeze", "stack",
           "swapaxes", "take", "tile", "topk", "transpose", "where"]


def flatten(x):
    """ref: Flatten — (N, d1, d2, ...) → (N, d1*d2*...)."""
    return x.reshape(x.shape[0], -1)


def expand_dims(x, axis=0):
    """ref: expand_dims."""
    return torch.unsqueeze(x, axis)


def squeeze(x, axis=None):
    """ref: squeeze — drop ``axis`` (an int or a tuple), or every axis of
    size 1."""
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(axis) if isinstance(axis, (list, tuple))
                         else axis)


def broadcast_like(x, like):
    """ref: broadcast_like — ``x`` broadcast to ``like``'s shape."""
    return torch.broadcast_to(x, like.shape)


def slice_like(x, like, axes=None):
    """ref: slice_like — the leading ``like.shape[a]`` entries of ``x``
    along each of ``axes`` (all axes when None)."""
    axes = axes if axes is not None else tuple(range(x.ndim))
    idx = [slice(None)] * x.ndim
    for a in axes:
        idx[a] = slice(0, like.shape[a])
    return x[tuple(idx)]


def shifted_expsum(x, axis=-1):
    """The numerically stable exp-sum core: ``(m, shifted, se32)`` with
    ``m = max(x)`` (no gradient), ``shifted = x - m`` in ``x``'s dtype
    and ``se32 = sum(exp(shifted))`` accumulated in at least fp32. One
    definition backs the short-sequence attention softmax, as in the JAX
    package."""
    acc = torch.promote_types(x.dtype, torch.float32)   # fp64 stays fp64
    m = torch.amax(x, dim=axis, keepdim=True).detach()
    shifted = x - m
    se32 = torch.sum(torch.exp(shifted).to(acc), dim=axis, keepdim=True)
    return m, shifted, se32


def logsumexp(x, axis=-1, keepdims=False):
    """ref: logsumexp — ``max + log(sum(exp(x - max)))`` with the sum in
    at least fp32 (the result is fp32 for lower-precision inputs); its
    gradient is the softmax. Backs the fused sparse softmax-CE loss."""
    m, _, se32 = shifted_expsum(x, axis=axis)
    out = m.to(se32.dtype) + torch.log(se32)
    return out if keepdims else torch.squeeze(out, axis)


def log_softmax(x, axis=-1):
    """ref: log_softmax — ``(x - max) - log(sum(exp(x - max)))``, the sum
    in at least fp32, the result in ``x``'s dtype."""
    _, shifted, se32 = shifted_expsum(x, axis=axis)
    return shifted - torch.log(se32).to(x.dtype)


def pick(x, index, axis=-1, keepdims=False):
    """ref: pick — one element per row along ``axis`` at ``index`` (cast
    to int32, clipped into the axis, as the JAX op clips)."""
    n = x.shape[axis]
    idx = index.to(torch.int32).long().clamp(0, n - 1).unsqueeze(axis)
    picked = torch.gather(x, axis, idx)
    return picked if keepdims else torch.squeeze(picked, axis)


def gather_nd(data, indices):
    """ref: gather_nd — ``indices`` (M, ...) index the leading M axes of
    ``data``. As in the JAX package, a negative index counts from the end
    and an index still outside the axis is clamped to it."""
    idx = []
    for i in range(indices.shape[0]):
        n = data.shape[i]
        ix = indices[i].to(torch.int32).long()
        ix = torch.where(ix < 0, ix + n, ix)
        idx.append(ix.clamp(0, n - 1))
    return data[tuple(idx)]


def stack(*args, axis=0):
    """ref: stack."""
    return torch.stack(args, dim=axis)


def concat(*args, dim=1, num_args=None):
    """ref: Concat — join along ``dim``."""
    return torch.cat(args, dim=dim)


def swapaxes(x, dim1=0, dim2=0):
    """ref: SwapAxis."""
    return torch.swapaxes(x, dim1, dim2)


def slice_axis(x, axis=0, begin=0, end=None):
    """ref: slice_axis — ``x[begin:end]`` along ``axis``."""
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


def reshape(x, shape=None, reverse=False):
    """ref: Reshape with MXNet's special codes, as the JAX op reads them:
    0 copies a dimension, -1 infers one, -2 copies the rest, -3 merges
    two, -4 splits one into the next two numbers (either may be -1);
    ``reverse`` reads both shapes from the right."""
    src = list(x.shape)
    shape = list(shape)
    if reverse:
        src, shape = src[::-1], shape[::-1]
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(int(s))
            i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return torch.reshape(x, tuple(out))


def reshape_like(lhs, rhs):
    """ref: reshape_like — ``lhs`` in ``rhs``'s shape."""
    return lhs.reshape(rhs.shape)


_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


def pad(x, mode="constant", pad_width=None, constant_value=0.0):
    """ref: Pad — ``pad_width`` is MXNet's flat (before, after) pair per
    axis. ``constant`` pads any axis; ``edge`` and ``reflect`` pad at most
    the last three axes of a 2-D to 5-D input and none of its first two
    (PyTorch's replicate and reflect modes), as MXNet's op requires."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(x.ndim)]
    flat = [v for lo_hi in reversed(pw) for v in lo_hi]
    if mode == "constant":
        return F.pad(x, flat, value=constant_value)
    if mode not in _PAD_MODES:
        raise MXNetError(f"Pad: unknown mode {mode!r}")
    padded = [i for i, p in enumerate(pw) if p != (0, 0)]
    if not padded:
        return x
    if x.ndim not in (3, 4, 5) or padded[0] < 2:
        raise MXNetError(f"Pad: mode {mode!r} pads the axes past the first "
                         f"two of a 3-D to 5-D input; got pad_width "
                         f"{tuple(pad_width)} for a {x.ndim}-D input")
    return F.pad(x, flat[:2 * (x.ndim - 2)], mode=_PAD_MODES[mode])


# ---------------------------------------------------------------------------
# The registry's names (ref: src/operator/tensor/): reductions, shapes,
# indexing, ordering and linalg, each as the JAX op computes it.
# ---------------------------------------------------------------------------
def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        return None
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a % ndim for a in axis)
    if exclude:
        axis = tuple(a for a in range(ndim) if a not in axis)
    return axis


def _int32_sum(out, x):
    """PyTorch sums integers into int64; ``jnp`` into int32 (x64 off)."""
    if out.dtype == torch.int64 and x.dtype != torch.int64:
        return out.to(torch.int32)
    return out


def _prod(x, dim, keepdim):
    """``torch.prod`` over several axes (it takes one)."""
    for a in sorted(dim, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


def _mean(x, dim, keepdim):
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x, dim=dim, keepdim=keepdim)


_REDUCERS = {"sum": torch.sum, "mean": _mean, "prod": _prod,
             "max": torch.amax, "min": torch.amin, "nansum": torch.nansum,
             "nanprod": _nanprod}


def reduce(x, kind, axis=None, keepdims=False, exclude=False):
    """ref: the reductions ``sum``, ``mean``, ``prod``, ``max``, ``min``,
    ``nansum``, ``nanprod`` over ``axis`` (an int or a tuple; every axis
    when None), or every axis but ``axis`` with ``exclude``. No axis left
    to reduce returns ``x`` as ``jnp`` does (``torch.sum`` would reduce
    all)."""
    ax = _norm_axis(axis, x.ndim, exclude)
    if ax is None:
        ax = tuple(range(x.ndim))
    if not ax:
        return x
    return _int32_sum(_REDUCERS[kind](x, dim=ax, keepdim=keepdims), x)


def argmax(x, axis=None, keepdims=False, _fn=torch.argmax):
    """ref: argmax — the index as float32, as MXNet returns it."""
    if axis is None:
        return _fn(x).float()
    return _fn(x, dim=axis, keepdim=keepdims).float()


def argmin(x, axis=None, keepdims=False):
    """ref: argmin — the index as float32."""
    return argmax(x, axis, keepdims, _fn=torch.argmin)


def norm(x, ord=2, axis=None, keepdims=False):
    """ref: norm — L1 (``ord=1``) or L2 over ``axis`` (all when None)."""
    ax = _norm_axis(axis, x.ndim)
    ax = tuple(range(x.ndim)) if ax is None else ax
    if ord == 1:
        return torch.sum(torch.abs(x), dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=keepdims))


def transpose(x, axes=None):
    """ref: transpose — reversed axes when ``axes`` is None."""
    return x.permute(tuple(axes) if axes else tuple(reversed(range(x.ndim))))


def moveaxis(x, source=None, destination=None):
    """ref: moveaxis."""
    return torch.movedim(x, tuple(source), tuple(destination))


def reverse(x, axis=None):
    """ref: reverse / flip along ``axis`` (a tuple)."""
    return torch.flip(x, tuple(axis))


def tile(x, reps=None):
    """ref: tile (numpy semantics)."""
    return torch.tile(x, tuple(reps))


def repeat(x, repeats=1, axis=None):
    """ref: repeat — over the flattened array when ``axis`` is None."""
    return torch.repeat_interleave(x, repeats, dim=axis)


def clip(x, a_min=None, a_max=None):
    """ref: clip."""
    return torch.clamp(x, a_min, a_max)


def broadcast_to(x, shape=None):
    """ref: broadcast_to — a 0 in ``shape`` keeps that axis."""
    shape = tuple(x.shape[i] if s == 0 else int(s)
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


def broadcast_axis(x, axis=(), size=()):
    """ref: broadcast_axis — each of ``axis`` (size 1) to its ``size``."""
    shape = list(x.shape)
    for a, s in zip(axis, size):
        shape[a] = int(s)
    return torch.broadcast_to(x, tuple(shape))


def slice_nd(x, begin=None, end=None, step=None):
    """ref: slice — ``x[b:e:s]`` per leading axis; entries may be None,
    and a negative step walks backwards (PyTorch's slicing takes none,
    so those axes gather)."""
    step = step or (1,) * len(begin)
    basic = []
    for b, e, s in zip(begin, end, step):
        basic.append(slice(b, e, s if s else 1))
    if all((s.step or 1) > 0 for s in basic):
        return x[tuple(basic)]
    for axis, sl in enumerate(basic):
        idx = torch.arange(*sl.indices(x.shape[axis]), device=x.device)
        x = torch.index_select(x, axis, idx)
    return x


def _wrap_index(indices, n, mode):
    ix = indices.to(torch.int32).long()
    if mode == "wrap":
        return torch.remainder(ix, n)
    return ix.clamp(0, n - 1)                 # "clip", and "raise" as clip


def take(a, indices, axis=0, mode="clip"):
    """ref: Take — rows of ``a`` along ``axis`` at ``indices`` (cast to
    int32). ``clip`` clamps every index into the axis (a negative one to
    0), ``wrap`` takes it modulo the axis, as ``jnp.take``: never a
    device-side assert."""
    axis = axis % a.ndim
    ix = _wrap_index(indices, a.shape[axis], mode)
    out = torch.index_select(a, axis, ix.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(indices.shape)
                       + tuple(a.shape[axis + 1:]))


def batch_take(a, indices):
    """ref: batch_take — ``out[i] = a[i, indices[i]]`` over the rows of
    the last axis."""
    return pick(a.reshape(-1, a.shape[-1]), indices.reshape(-1), axis=-1)


def scatter_nd(data, indices, shape=None):
    """ref: scatter_nd — zeros of ``shape`` with ``data`` at ``indices``
    (M, ...). A negative index counts from the end; an update outside
    the array is dropped, as JAX's scatter drops it."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    ix = indices.to(torch.int32).long()
    keep = torch.ones(ix.shape[1:], dtype=torch.bool, device=ix.device)
    idx = []
    for i in range(ix.shape[0]):
        n = out.shape[i]
        k = torch.where(ix[i] < 0, ix[i] + n, ix[i])
        keep = keep & (k >= 0) & (k < n)
        idx.append(k)
    idx = tuple(k[keep] for k in idx)
    return out.index_put(idx, data[keep])


def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32"):
    """ref: one_hot — an index outside [0, depth) gives a row of
    ``off_value``, as ``jax.nn.one_hot``."""
    ix = indices.to(torch.int32).long()
    oh = (ix.unsqueeze(-1) == torch.arange(depth, device=ix.device)).float()
    return (oh * (on_value - off_value) + off_value).to(jax_dtype(dtype))


def where(cond, x, y):
    """ref: where — ``x`` where ``cond`` is non-zero, else ``y``."""
    return torch.where(cond != 0, x, y)


def split(x, num_outputs=1, axis=1, squeeze_axis=False):
    """ref: SliceChannel — ``num_outputs`` equal parts along ``axis``."""
    size = x.shape[axis]
    if size % num_outputs:
        raise MXNetError(f"SliceChannel: axis {axis} of size {size} does not "
                         f"split into {num_outputs} equal parts")
    parts = list(torch.split(x, size // num_outputs, dim=axis))
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


def space_to_depth(x, block_size=1):
    """ref: space_to_depth (NCHW, the reference's channel order)."""
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


def depth_to_space(x, block_size=1):
    """ref: depth_to_space (NCHW)."""
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


def sort(x, axis=-1, is_ascend=True):
    """ref: sort."""
    out = torch.sort(x, dim=axis).values
    return out if is_ascend else torch.flip(out, (axis,))


def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    """ref: argsort — stable ascending order, flipped for descending, as
    the JAX op; indices in ``dtype``."""
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(jax_dtype(dtype))


def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """ref: topk — the ``k`` largest (smallest with ``is_ascend``) along
    ``axis``, sorted; ``ret_typ`` "value", "indices" (in ``dtype``),
    "mask" (1 at the top-k positions, in ``x``'s dtype) or "both"."""
    vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                           sorted=True)
    if ret_typ == "value":
        return vals
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, idx, 1)
    idx = idx.to(jax_dtype(dtype))
    return idx if ret_typ == "indices" else (vals, idx)


def dot(a, b, transpose_a=False, transpose_b=False):
    """ref: dot — contracts the last axis of ``a`` with the first of
    ``b`` (after the transposes), a plain product."""
    if transpose_a and a.ndim >= 2:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b and b.ndim >= 2:
        b = torch.swapaxes(b, -1, -2)
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    """ref: batch_dot — batched matmul."""
    if transpose_a:
        a = torch.swapaxes(a, -1, -2)
    if transpose_b:
        b = torch.swapaxes(b, -1, -2)
    return torch.matmul(a, b)


def _tri(a, lower):
    return torch.tril(a) if lower else torch.triu(a)


def linalg_gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0):
    """ref: linalg_gemm2 — ``alpha * op(a) @ op(b)``."""
    return alpha * batch_dot(a, b, transpose_a, transpose_b)


def linalg_trsm(a, b, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """ref: linalg_trsm — solves ``op(A) X = alpha B`` (``X op(A) =
    alpha B`` with ``rightside``), ``A`` triangular (only its ``lower``
    or upper triangle read)."""
    tri = _tri(a, lower)
    upper = not lower
    if transpose:
        tri, upper = torch.swapaxes(tri, -1, -2), lower
    return torch.linalg.solve_triangular(tri, alpha * b, upper=upper,
                                         left=not rightside)


def linalg_trmm(a, b, transpose=False, rightside=False, lower=True,
                alpha=1.0):
    """ref: linalg_trmm — ``alpha * op(tri(A)) @ B`` (``B @ op(tri(A))``
    with ``rightside``)."""
    tri = _tri(a, lower)
    if transpose:
        tri = torch.swapaxes(tri, -1, -2)
    return alpha * (torch.matmul(b, tri) if rightside
                    else torch.matmul(tri, b))


def linalg_syrk(a, transpose=False, alpha=1.0):
    """ref: linalg_syrk — ``alpha * A^T A`` (transpose) or ``A A^T``."""
    at = torch.swapaxes(a, -1, -2)
    return alpha * (torch.matmul(at, a) if transpose else torch.matmul(a, at))


def linalg_makediag(a, offset=0):
    """ref: linalg_makediag — (..., n) → (..., n+|o|, n+|o|) with the
    vector on diagonal ``offset``."""
    n = a.shape[-1]
    m = n + abs(offset)
    out = torch.zeros(tuple(a.shape[:-1]) + (m, m), dtype=a.dtype,
                      device=a.device)
    rows = torch.arange(n, device=a.device) + max(-offset, 0)
    cols = torch.arange(n, device=a.device) + max(offset, 0)
    out[..., rows, cols] = a
    return out


def linalg_extractdiag(a, offset=0):
    """ref: linalg_extractdiag."""
    return torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)


def _trian_indices(n, offset, lower, device):
    if offset < 0 or (offset == 0 and lower):
        return torch.tril_indices(n, n, offset, device=device)
    return torch.triu_indices(n, n, offset, device=device)


def linalg_maketrian(a, offset=0, lower=True):
    """ref: linalg_maketrian — a row-major packed triangle to a matrix;
    the sign of ``offset`` picks the triangle, ``lower`` only at 0, as
    the reference's CopyTrians."""
    m = a.shape[-1]
    k = int((math.sqrt(8 * m + 1) - 1) // 2)
    n = k + abs(offset)
    rows, cols = _trian_indices(n, offset, lower, a.device)
    out = torch.zeros(tuple(a.shape[:-1]) + (n, n), dtype=a.dtype,
                      device=a.device)
    out[..., rows, cols] = a
    return out


def linalg_extracttrian(a, offset=0, lower=True):
    """ref: linalg_extracttrian — the triangle packed row-major."""
    rows, cols = _trian_indices(a.shape[-1], offset, lower, a.device)
    return a[..., rows, cols]


def khatri_rao(*mats):
    """ref: khatri_rao — row-wise Khatri-Rao product."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, :, None] * m[:, None, :]).reshape(out.shape[0], -1)
    return out


def diag(x, k=0):
    """ref: diag — a matrix from a vector, else the ``k``-th diagonal."""
    if x.ndim == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


def _register_all():
    from .registry import OpParam, register

    reduce_params = [OpParam("axis", tuple, None),
                     OpParam("keepdims", bool, False),
                     OpParam("exclude", bool, False)]
    for kind in _REDUCERS:
        register(kind, params=reduce_params,
                 doc=f"{kind} over axes (ref: broadcast_reduce_op_value.cc)")(
            (lambda k: lambda x, **p: reduce(x, k, **p))(kind))
    index_params = [OpParam("axis", int, None),
                    OpParam("keepdims", bool, False)]
    register("argmax", differentiable=False, params=index_params)(argmax)
    register("argmin", differentiable=False, params=index_params)(argmin)
    register("norm", params=[OpParam("ord", int, 2),
                             OpParam("axis", tuple, None),
                             OpParam("keepdims", bool, False)])(norm)
    register("Reshape", aliases=["reshape"],
             params=[OpParam("shape", tuple, None, required=True),
                     OpParam("reverse", bool, False)],
             doc="Reshape with MXNet's codes 0, -1, -2, -3, -4")(reshape)
    register("transpose", params=[OpParam("axes", tuple, None)])(transpose)
    register("SwapAxis", aliases=["swapaxes"],
             params=[OpParam("dim1", int, 0), OpParam("dim2", int, 0)])(
        swapaxes)
    register("moveaxis",
             params=[OpParam("source", tuple, None, required=True),
                     OpParam("destination", tuple, None, required=True)])(
        moveaxis)
    register("expand_dims",
             params=[OpParam("axis", int, 0, required=True)])(expand_dims)
    register("squeeze", params=[OpParam("axis", tuple, None)])(squeeze)
    register("Flatten", aliases=["flatten"])(
        lambda x: x.reshape(x.shape[0], math.prod(x.shape[1:])))
    register("reverse", aliases=["flip"],
             params=[OpParam("axis", tuple, None, required=True)])(reverse)
    register("tile", params=[OpParam("reps", tuple, None, required=True)])(
        tile)
    register("repeat", params=[OpParam("repeats", int, 1, required=True),
                               OpParam("axis", int, None)])(repeat)
    register("Pad", aliases=["pad"],
             params=[OpParam("mode", str, "constant"),
                     OpParam("pad_width", tuple, None, required=True),
                     OpParam("constant_value", float, 0.0)])(pad)
    register("clip", params=[OpParam("a_min", float, None, required=True),
                             OpParam("a_max", float, None, required=True)])(
        clip)
    register("broadcast_to",
             params=[OpParam("shape", tuple, None, required=True)])(
        broadcast_to)
    register("broadcast_like", num_inputs=2)(broadcast_like)
    register("broadcast_axis", aliases=["broadcast_axes"],
             params=[OpParam("axis", tuple, ()), OpParam("size", tuple, ())])(
        broadcast_axis)
    register("slice", params=[OpParam("begin", tuple, None, required=True),
                              OpParam("end", tuple, None, required=True),
                              OpParam("step", tuple, None)])(slice_nd)
    register("slice_axis",
             params=[OpParam("axis", int, 0, required=True),
                     OpParam("begin", int, 0, required=True),
                     OpParam("end", int, None, required=True)])(slice_axis)
    register("slice_like", num_inputs=2,
             params=[OpParam("axes", tuple, None)])(slice_like)
    register("logsumexp", params=[OpParam("axis", int, -1),
                                  OpParam("keepdims", bool, False)])(logsumexp)
    register("take", num_inputs=2, params=[OpParam("axis", int, 0),
                                           OpParam("mode", str, "clip")])(take)
    register("batch_take", num_inputs=2)(batch_take)
    register("pick", num_inputs=2,
             params=[OpParam("axis", int, -1), OpParam("keepdims", bool, False),
                     OpParam("mode", str, "clip")])(
        lambda x, index, axis=-1, keepdims=False, mode="clip":
        pick(x, index, axis, keepdims))
    register("gather_nd", num_inputs=2)(gather_nd)
    register("scatter_nd", num_inputs=2,
             params=[OpParam("shape", tuple, None, required=True)])(scatter_nd)
    register("one_hot", differentiable=False,
             params=[OpParam("depth", int, None, required=True),
                     OpParam("on_value", float, 1.0),
                     OpParam("off_value", float, 0.0),
                     OpParam("dtype", str, "float32")])(one_hot)
    register("where", num_inputs=3)(where)
    register("Concat", aliases=["concat"], num_inputs=-1,
             params=[OpParam("dim", int, 1), OpParam("num_args", int, None)])(
        concat)
    register("stack", num_inputs=-1,
             params=[OpParam("axis", int, 0), OpParam("num_args", int, None)])(
        lambda *args, axis=0, num_args=None: stack(*args, axis=axis))
    register("SliceChannel", aliases=["split"],
             num_outputs=lambda p: int(p.get("num_outputs", 1)),
             params=[OpParam("num_outputs", int, 1, required=True),
                     OpParam("axis", int, 1),
                     OpParam("squeeze_axis", bool, False)])(split)
    block = [OpParam("block_size", int, 1, required=True)]
    register("space_to_depth", params=block)(space_to_depth)
    register("depth_to_space", params=block)(depth_to_space)
    register("sort", params=[OpParam("axis", int, -1),
                             OpParam("is_ascend", bool, True)])(sort)
    register("argsort", differentiable=False,
             params=[OpParam("axis", int, -1), OpParam("is_ascend", bool, True),
                     OpParam("dtype", str, "float32")])(argsort)
    register("topk", differentiable=False,
             num_outputs=lambda p: 2 if p.get("ret_typ") == "both" else 1,
             params=[OpParam("axis", int, -1), OpParam("k", int, 1),
                     OpParam("ret_typ", str, "indices"),
                     OpParam("is_ascend", bool, False),
                     OpParam("dtype", str, "float32")])(topk)
    flags = [OpParam("transpose_a", bool, False),
             OpParam("transpose_b", bool, False)]
    register("dot", num_inputs=2, params=flags)(dot)
    register("batch_dot", num_inputs=2, params=flags)(batch_dot)
    register("_linalg_gemm2", aliases=["linalg_gemm2"], num_inputs=2,
             params=flags + [OpParam("alpha", float, 1.0)])(linalg_gemm2)
    register("_linalg_potrf", aliases=["linalg_potrf"],
             doc="Cholesky factor (ref: la_op.cc linalg_potrf)")(
        torch.linalg.cholesky)
    tri = [OpParam("transpose", bool, False),
           OpParam("rightside", bool, False), OpParam("lower", bool, True),
           OpParam("alpha", float, 1.0)]
    register("_linalg_trsm", aliases=["linalg_trsm"], num_inputs=2,
             params=tri)(linalg_trsm)
    register("_linalg_trmm", aliases=["linalg_trmm"], num_inputs=2,
             params=tri)(linalg_trmm)
    register("_linalg_syrk", aliases=["linalg_syrk"],
             params=[OpParam("transpose", bool, False),
                     OpParam("alpha", float, 1.0)])(linalg_syrk)
    register("_linalg_inverse", aliases=["linalg_inverse"])(torch.linalg.inv)
    register("_linalg_det", aliases=["linalg_det"])(torch.linalg.det)
    register("_linalg_slogdet", aliases=["linalg_slogdet"], num_outputs=2)(
        lambda a: tuple(torch.linalg.slogdet(a)))
    offset = [OpParam("offset", int, 0)]
    register("_linalg_makediag", aliases=["linalg_makediag"], params=offset)(
        linalg_makediag)
    register("_linalg_extractdiag", aliases=["linalg_extractdiag"],
             params=offset)(linalg_extractdiag)
    trian = offset + [OpParam("lower", bool, True)]
    register("_linalg_maketrian", aliases=["linalg_maketrian"],
             params=trian)(linalg_maketrian)
    register("_linalg_extracttrian", aliases=["linalg_extracttrian"],
             params=trian)(linalg_extracttrian)
    register("khatri_rao", num_inputs=-1)(khatri_rao)
    register("diag", params=[OpParam("k", int, 0)])(diag)
    register("embedding_like_dot", num_inputs=2, doc="a @ b^T")(
        lambda a, b: torch.matmul(a, torch.swapaxes(b, -1, -2)))
    register("reshape_like", num_inputs=2)(reshape_like)


_register_all()

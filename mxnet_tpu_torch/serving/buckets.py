"""Bucket grid — the shape discretization of the serving batcher.

A copy of ``mxnet_tpu/serving/buckets.py`` (the port imports nothing of
the JAX package). There, the grid bounds XLA compiles; in the port it
bounds the number of padded shapes, and so of cached predictors and of
distinct kernel shapes, that traffic can produce.  The grid maps every
admissible request shape onto a small lattice of padded shapes:

- the **batch axis** (number of coalesced requests) rounds up to the
  smallest configured batch bucket;
- each **bucketed feature axis** rounds up to the smallest configured
  size for that axis; unbucketed axes must match exactly across requests
  and each distinct size gets its own predictor — fixed-dim models
  (an MLP's feature width) simply leave them unbucketed;
- a shape that exceeds the largest bucket on any axis is **rejected** at
  admission (structured error).

The number of distinct padded shapes is then bounded by
``grid_bound()`` = |batch buckets| x prod(|axis buckets|) per distinct
unbucketed-dims signature — bounded by configuration, never by traffic.

Autoregressive decode gets its own one-cell lattice
(:meth:`BucketGrid.for_decode`): a decode step is always ``(slots,
step_width)``.

Stdlib-only: the grid is pure shape math.
"""
from __future__ import annotations

__all__ = ["BucketGrid"]


def _pow2_buckets(max_value):
    out, b = [], 1
    while b < max_value:
        out.append(b)
        b *= 2
    out.append(int(max_value))
    return out


class BucketGrid:
    """The serving shape lattice (see module docstring).

    ``batch_buckets``: ascending sizes for the coalesced-batch axis
    (default: powers of two up to ``max_batch``).
    ``dim_buckets``: {feature-axis-index: ascending sizes} for axes whose
    request sizes vary (axis 0 = first axis *after* the batch axis).
    """

    def __init__(self, max_batch=8, batch_buckets=None, dim_buckets=None):
        if batch_buckets is None:
            batch_buckets = _pow2_buckets(int(max_batch))
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError(f"batch_buckets must be positive ints, got "
                             f"{self.batch_buckets}")
        self.dim_buckets = {}
        for axis, sizes in (dim_buckets or {}).items():
            sizes = tuple(sorted({int(s) for s in sizes}))
            if not sizes or sizes[0] < 1 or int(axis) < 0:
                raise ValueError(f"dim_buckets[{axis}] must be positive "
                                 f"ints, got {sizes}")
            self.dim_buckets[int(axis)] = sizes

    @classmethod
    def for_decode(cls, slots, step_width=1):
        """The dedicated decode-step lattice: ONE cell, ``(slots,
        step_width)``.  A ``(slots, 1)`` step tensor snaps to itself —
        never to the smallest prefill bucket — and ``grid_bound() == 1``
        makes 'decode steps never compile outside the lattice' a
        checkable invariant rather than a hope."""
        if int(slots) < 1 or int(step_width) < 1:
            raise ValueError(f"decode grid needs slots >= 1 and "
                             f"step_width >= 1, got ({slots}, {step_width})")
        return cls(max_batch=int(slots), batch_buckets=(int(slots),),
                   dim_buckets={0: (int(step_width),)})

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    @staticmethod
    def _round_up(buckets, n):
        for b in buckets:
            if n <= b:
                return b
        return None

    def batch_bucket(self, n: int):
        """Smallest batch bucket >= n, or None when n exceeds the grid."""
        return self._round_up(self.batch_buckets, int(n))

    def feature_key(self, shape):
        """Bucketed feature shape (without the batch axis) a request of
        ``shape`` pads to, or None when any bucketed axis exceeds its
        largest bucket (the admission-reject signal)."""
        out = []
        for i, s in enumerate(shape):
            buckets = self.dim_buckets.get(i)
            if buckets is None:
                out.append(int(s))
                continue
            b = self._round_up(buckets, int(s))
            if b is None:
                return None
            out.append(b)
        return tuple(out)

    def grid_bound(self) -> int:
        """Upper bound on distinct compiled shapes per unbucketed-dims
        signature: |batch buckets| x prod(|axis buckets|)."""
        bound = len(self.batch_buckets)
        for sizes in self.dim_buckets.values():
            bound *= len(sizes)
        return bound

    @staticmethod
    def pad_waste(n_real, batch_bucket, real_shapes, padded_shape) -> float:
        """Fraction of the padded batch's elements that are padding —
        the journal's per-batch HBM-waste signal."""
        padded_elems = batch_bucket
        for d in padded_shape:
            padded_elems *= d
        real_elems = 0
        for shape in real_shapes:
            e = 1
            for d in shape:
                e *= d
            real_elems += e
        if padded_elems <= 0:
            return 0.0
        return round(1.0 - real_elems / padded_elems, 4)

    def __repr__(self):
        return (f"BucketGrid(batch={list(self.batch_buckets)}, "
                f"dims={self.dim_buckets}, bound={self.grid_bound()})")

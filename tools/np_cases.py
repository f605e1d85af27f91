"""The case table of the ``mx.np`` / ``mx.npx`` checks: for each name, a
maker of seeded arguments (numpy arrays stand for ``mx.np`` arrays, a
list of them for a sequence of arrays, anything else is passed as it is)
and the tolerance.

``tests/test_torch_np.py`` holds the port against the JAX package on the
CPU with it, and ``chip_smoke.py`` phase 29 (d) holds the card against
the CPU with it. Tolerances as in ``nd_op_cases``: ``"exact"`` (values
and dtype), ``"arith"`` (1e-6 of max |value|), ``"rel"`` (1e-5 relative
with an absolute floor of 1e-5 of max |value|), or a looser float with
its reason. Every comparison checks the dtype. numpy only: this module
runs where JAX is not installed.
"""
import zlib

import numpy as np

__all__ = ["CASES", "EAGER", "LINALG_FACTORS", "NPX_CASES", "args_of",
           "check", "rng_for"]


def rng_for(name):
    return np.random.RandomState(zlib.crc32(name.encode()))


def f(rng, *shape, lo=None, hi=None):
    if lo is None:
        return rng.randn(*shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def i32(rng, *shape, lo=0, hi=10):
    return rng.randint(lo, hi, shape).astype(np.int32)


_POS = dict(lo=0.5, hi=2.0)
_UNIT = dict(lo=-0.9, hi=0.9)
_UNARY = {
    "exact": ["negative", "positive", "absolute", "abs", "fabs", "sign",
              "rint", "square", "floor", "ceil", "trunc", "around", "round",
              "isfinite", "isinf", "isnan", "isneginf", "isposinf",
              "signbit", "logical_not", "real", "conj", "ravel",
              "flatnonzero", "nonzero", "atleast_1d", "atleast_2d",
              "atleast_3d", "argmax", "argmin", "nanargmax", "nanargmin",
              "sort", "argsort", "max", "min", "amax", "amin", "nanmax",
              "nanmin", "count_nonzero", "all", "any", "diag", "diagflat",
              "fliplr", "flipud", "tril", "triu", "transpose",
              "nan_to_num", "imag", "ptp", "diff", "ediff1d"],
    "rel": ["exp", "expm1", "exp2", "log", "log2", "log10", "log1p", "sqrt",
            "cbrt", "reciprocal", "sin", "cos", "tan", "arcsin", "arccos",
            "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh",
            "arctanh", "degrees", "radians", "deg2rad", "rad2deg", "sum",
            "prod", "cumsum", "cumprod", "nansum", "nanprod", "mean", "std",
            "var", "median", "average", "nanmean", "nanstd", "nanvar",
            "nancumsum", "nancumprod", "nanmedian", "trace", "i0", "sinc",
            "unwrap", "cov", "corrcoef", "spacing", "angle", "gradient"],
}
_DOMAIN = {"log": _POS, "log2": _POS, "log10": _POS, "sqrt": _POS,
           "reciprocal": _POS, "log1p": dict(lo=-0.5, hi=2.0),
           "arcsin": _UNIT, "arccos": _UNIT, "arctanh": _UNIT,
           "arccosh": dict(lo=1.1, hi=3.0), "prod": dict(lo=0.5, hi=1.5),
           "cumprod": dict(lo=0.5, hi=1.5), "nanprod": dict(lo=0.5, hi=1.5),
           "nancumprod": dict(lo=0.5, hi=1.5)}
_WITH_NAN = {"nanmax", "nanmin", "nansum", "nanprod", "nanmean", "nanstd",
             "nanvar", "nancumsum", "nancumprod", "nanmedian", "nanargmax",
             "nanargmin", "nan_to_num", "isnan", "isfinite"}
_SQUARE = {"diag", "trace", "tril", "triu", "cov", "corrcoef", "diagflat"}

CASES = {}


def _unary_case(name):
    dom = _DOMAIN.get(name, {})

    def make(rng):
        x = f(rng, 4, 4 if name in _SQUARE else 5, **dom)
        if name in _WITH_NAN:
            x[1, 2] = np.nan
        if name in ("nonzero", "flatnonzero", "count_nonzero", "all",
                    "any"):
            x[x < 0.3] = 0
        if name in ("diag", "diagflat", "ediff1d"):
            x = x[0]
        return [x], {}
    return make


for _tol, _names in _UNARY.items():
    for _n in _names:
        CASES[_n] = (_unary_case(_n), _tol)

_BINARY = {
    "arith": ["add", "subtract", "multiply", "divide", "true_divide",
              "maximum", "minimum", "fmax", "fmin", "copysign"],
    "exact": ["equal", "not_equal", "less", "less_equal", "greater",
              "greater_equal", "logical_and", "logical_or", "logical_xor",
              "floor_divide", "mod", "remainder", "fmod", "heaviside"],
    "rel": ["power", "float_power", "arctan2", "hypot", "logaddexp",
            "logaddexp2", "nextafter", "ldexp"],
}
for _tol, _names in _BINARY.items():
    for _n in _names:
        def _mk(rng, _n=_n):
            a = f(rng, 3, 4, lo=0.5, hi=2.0) if _n in ("power",
                                                        "float_power") \
                else f(rng, 3, 4)
            b = f(rng, 3, 4)
            if _n in ("floor_divide", "mod", "remainder", "fmod"):
                a, b = np.round(a * 10), np.round(b * 3) + 0.5
            if _n == "ldexp":
                b = i32(rng, 3, 4, lo=-3, hi=4)
            if _n in ("logical_and", "logical_or", "logical_xor"):
                a, b = a > 0, b > 0
            if _n == "heaviside":
                a[0, 0] = 0.0
            return [a, b], {}
        CASES[_n] = (_mk, _tol)

_INT_BINARY = ["gcd", "lcm", "bitwise_and", "bitwise_or", "bitwise_xor",
               "left_shift", "right_shift"]
for _n in _INT_BINARY:
    CASES[_n] = (lambda rng: ([i32(rng, 3, 4, lo=1, hi=30),
                               i32(rng, 3, 4, lo=1, hi=5)], {}), "exact")
CASES["invert"] = (lambda rng: ([i32(rng, 3, 4, lo=-20, hi=20)], {}),
                   "exact")


def _add(name, fn, tol="exact"):
    CASES[name] = (fn, tol)


# creation
_add("zeros", lambda r: ([(2, 3)], {}))
_add("ones", lambda r: ([(2, 3)], {"dtype": "int32"}))
_add("empty", lambda r: ([(2, 3)], {}))
_add("full", lambda r: ([(2, 3), 7], {}))
_add("arange", lambda r: ([2, 11, 3], {}))
_add("eye", lambda r: ([3, 4, 1], {}))
_add("identity", lambda r: ([3], {}))
_add("linspace", lambda r: ([0.0, 1.0, 7], {}), "rel")
_add("logspace", lambda r: ([0.0, 2.0, 5], {}), "rel")
_add("meshgrid", lambda r: ([f(r, 3), f(r, 2)], {}))
_add("zeros_like", lambda r: ([f(r, 2, 3)], {}))
_add("ones_like", lambda r: ([i32(r, 2, 3)], {}))
_add("full_like", lambda r: ([f(r, 2, 3), 2.5], {}))
_add("empty_like", lambda r: ([f(r, 2, 3)], {}))
# manipulation
_add("reshape", lambda r: ([f(r, 2, 6), (3, 4)], {}))
_add("swapaxes", lambda r: ([f(r, 2, 3, 4), 0, 2], {}))
_add("moveaxis", lambda r: ([f(r, 2, 3, 4), 0, -1], {}))
_add("rollaxis", lambda r: ([f(r, 2, 3, 4), 2], {}))
_add("concatenate", lambda r: ([[f(r, 2, 3), f(r, 1, 3)]], {}))
_add("stack", lambda r: ([[f(r, 2, 3), f(r, 2, 3)]], {"axis": 1}))
_add("vstack", lambda r: ([[f(r, 3), f(r, 3)]], {}))
_add("hstack", lambda r: ([[f(r, 2, 3), f(r, 2, 1)]], {}))
_add("dstack", lambda r: ([[f(r, 2, 3), f(r, 2, 3)]], {}))
_add("column_stack", lambda r: ([[f(r, 3), f(r, 3)]], {}))
_add("split", lambda r: ([f(r, 6, 2), 3], {}))
_add("array_split", lambda r: ([f(r, 7, 2), 3], {}))
_add("hsplit", lambda r: ([f(r, 2, 4), 2], {}))
_add("vsplit", lambda r: ([f(r, 4, 2), [1, 3]], {}))
_add("dsplit", lambda r: ([f(r, 2, 2, 4), 2], {}))
_add("tile", lambda r: ([f(r, 2, 3), (2, 1, 2)], {}))
_add("repeat", lambda r: ([f(r, 2, 3), 2], {"axis": 1}))
_add("flip", lambda r: ([f(r, 2, 3)], {"axis": 1}))
_add("roll", lambda r: ([f(r, 3, 4), 2], {"axis": 1}))
_add("rot90", lambda r: ([f(r, 3, 4)], {}))
_add("expand_dims", lambda r: ([f(r, 3, 4), (0, 2)], {}))
_add("squeeze", lambda r: ([f(r, 3, 1, 4)], {}))
_add("broadcast_to", lambda r: ([f(r, 1, 4), (3, 4)], {}))
_add("broadcast_arrays", lambda r: ([f(r, 1, 4), f(r, 3, 1)], {}))
_add("pad", lambda r: ([f(r, 2, 3), ((1, 0), (2, 1))], {}))
_add("append", lambda r: ([f(r, 2, 3), f(r, 1, 3)], {"axis": 0}))
_add("delete", lambda r: ([f(r, 3, 4), np.int32([0, 2])], {"axis": 1}))
_add("insert", lambda r: ([f(r, 3, 4), 1, 5.0], {"axis": 1}))
_add("unique", lambda r: ([i32(r, 12, hi=6)], {"return_index": True,
                                                "return_inverse": True,
                                                "return_counts": True}))
# math with arguments
_add("clip", lambda r: ([f(r, 3, 4), -0.5, 0.5], {}))
_add("interp", lambda r: ([f(r, 6, lo=0, hi=4), np.float32([0, 1, 2, 3]),
                           f(r, 4)], {}), "rel")
# reductions with arguments
_add("percentile", lambda r: ([f(r, 4, 5), 30.0], {"axis": 1}), "rel")
_add("quantile", lambda r: ([f(r, 4, 5), np.float32([0.2, 0.7])], {}),
     "rel")
_add("nanpercentile", lambda r: ([np.where(f(r, 4, 5) > 1.2, np.nan,
                                           f(r, 4, 5)), 40.0], {"axis": 0}),
     "rel")
_add("nanquantile", lambda r: ([np.where(f(r, 4, 5) > 1.2, np.nan,
                                         f(r, 4, 5)), 0.5], {}), "rel")
# products
_add("dot", lambda r: ([f(r, 3, 4), f(r, 4, 2)], {}), "rel")
_add("vdot", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {}), "rel")
_add("inner", lambda r: ([f(r, 3, 4), f(r, 2, 4)], {}), "rel")
_add("outer", lambda r: ([f(r, 3), f(r, 4)], {}), "rel")
_add("matmul", lambda r: ([f(r, 2, 3, 4), f(r, 4, 5)], {}), "rel")
_add("tensordot", lambda r: ([f(r, 2, 3, 4), f(r, 3, 4, 5)], {}), "rel")
_add("einsum", lambda r: (["ij,jk->ik", f(r, 3, 4), f(r, 4, 2)], {}),
     "rel")
_add("kron", lambda r: ([f(r, 2, 2), f(r, 2, 3)], {}), "rel")
_add("cross", lambda r: ([f(r, 4, 3), f(r, 4, 3)], {}), "rel")
_add("diagonal", lambda r: ([f(r, 3, 4, 5)], {"axis1": 1, "axis2": 2}))
# comparison
_add("isclose", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {"atol": 1.0}))
_add("allclose", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {"atol": 5.0}))
_add("array_equal", lambda r: ([f(r, 3, 4), f(r, 3, 4)], {}))
_add("where", lambda r: ([f(r, 3, 4) > 0, f(r, 3, 4), f(r, 3, 4)], {}))
# searching, counting
_add("searchsorted", lambda r: ([np.sort(f(r, 8)), f(r, 5)],
                                {"side": "right"}))
_add("partition", lambda r: ([f(r, 3, 7), 2], {}))
_add("argpartition", lambda r: ([f(r, 3, 7), 2], {}))
_add("bincount", lambda r: ([i32(r, 20, hi=7)], {"minlength": 9}))
_add("digitize", lambda r: ([f(r, 10), np.float32([-1, 0, 0.5, 1])], {}))
_add("histogram", lambda r: ([f(r, 50)], {"bins": 6}), "rel")
_add("take", lambda r: ([f(r, 3, 5), np.int32([0, 4, 2])], {"axis": 1}))
_add("take_along_axis", lambda r: ([f(r, 3, 5), i32(r, 3, 2, hi=5)],
                                   {"axis": 1}))
_add("choose", lambda r: ([i32(r, 3, 4, hi=3), [f(r, 3, 4), f(r, 3, 4),
                                                 f(r, 3, 4)]],
                          {"mode": "clip"}))
_add("compress", lambda r: ([np.array([True, False, True]), f(r, 3, 4)],
                            {"axis": 0}))
_add("extract", lambda r: ([f(r, 3, 4) > 0, f(r, 3, 4)], {}))
_add("indices", lambda r: ([(2, 3)], {}))
_add("unravel_index", lambda r: ([np.int32([1, 5, 11]), (3, 4)], {}))
_add("ravel_multi_index", lambda r: ([[np.int32([0, 1, 2]),
                                       np.int32([3, 0, 1])], (3, 4)],
                                     {"mode": "clip"}))
_add("tril_indices", lambda r: ([4, 1], {}))
_add("triu_indices", lambda r: ([4, -1], {}))
# misc
_add("frexp", lambda r: ([f(r, 3, 4) * 10], {}))
_add("modf", lambda r: ([f(r, 3, 4) * 10], {}), "arith")
_add("divmod", lambda r: ([np.round(f(r, 3, 4) * 10),
                           np.round(f(r, 3, 4) * 3) + 0.5], {}))
_add("convolve", lambda r: ([f(r, 7), f(r, 3)], {}), "rel")
_add("correlate", lambda r: ([f(r, 7), f(r, 3)], {"mode": "same"}), "rel")
_add("iscomplexobj", lambda r: ([f(r, 3)], {}))
_add("isrealobj", lambda r: ([f(r, 3)], {}))
_add("shape", lambda r: ([f(r, 3, 2)], {}))
_add("size", lambda r: ([f(r, 3, 2)], {}))
_add("ndim", lambda r: ([f(r, 3, 2)], {}))
_add("result_type", lambda r: ([np.float32, np.int32], {}))
_add("can_cast", lambda r: ([np.int32, np.float32], {}))
_add("promote_types", lambda r: ([np.int32, np.float32], {}))
_add("vander", lambda r: ([f(r, 4)], {"N": 3}), "rel")
_add("union1d", lambda r: ([i32(r, 6), i32(r, 5)], {}))
_add("intersect1d", lambda r: ([i32(r, 8), i32(r, 8)], {}))
_add("setdiff1d", lambda r: ([i32(r, 8), i32(r, 4)], {}))
_add("setxor1d", lambda r: ([i32(r, 8), i32(r, 6)], {}))
_add("isin", lambda r: ([i32(r, 3, 4), np.int32([1, 3, 5])], {}))
_add("select", lambda r: ([[f(r, 3, 4) > 0.5, f(r, 3, 4) < -0.5],
                           [f(r, 3, 4), f(r, 3, 4)]], {"default": -9.0}))
_add("resize", lambda r: ([f(r, 2, 3), 8], {}))
_add("trim_zeros", lambda r: ([np.float32([0, 0, 1, 2, 0, 3, 0])], {}))
_add("diag_indices", lambda r: ([3], {}))
_add("diag_indices_from", lambda r: ([f(r, 3, 3)], {}))
_add("ix_", lambda r: ([np.int32([0, 2]), np.int32([1, 2, 3])], {}))

_LINALG = {
    "norm": (lambda r: ([f(r, 3, 4)], {}), "rel"),
    "inv": (lambda r: ([_spd(r)], {}), 1e-4),     # condition number
    "det": (lambda r: ([_spd(r)], {}), "rel"),
    "slogdet": (lambda r: ([_spd(r)], {}), "rel"),
    "cholesky": (lambda r: ([_spd(r)], {}), "rel"),
    "solve": (lambda r: ([_spd(r), f(r, 2, 3, 2)], {}), 1e-4),
    "matrix_rank": (lambda r: ([f(r, 4, 3)], {}), "exact"),
    "matrix_power": (lambda r: ([f(r, 3, 3), 3], {}), "rel"),
    "pinv": (lambda r: ([f(r, 4, 3)], {}), 1e-4),   # an SVD's rounding
    "eigvalsh": (lambda r: ([_spd(r)], {}), 1e-4),
    "multi_dot": (lambda r: ([[f(r, 3, 4), f(r, 4, 5), f(r, 5, 2)]], {}),
                  "rel"),
    "tensorinv": (lambda r: ([_spd(r, 4, 1).reshape(4, 2, 2)],
                             {"ind": 1}), 1e-4),
    "tensorsolve": (lambda r: ([_spd(r, 6, 1).reshape(6, 2, 3),
                                f(r, 6)], {}), 1e-4),
    "lstsq": (lambda r: ([f(r, 6, 3), f(r, 6, 2)], {}), 1e-4),
}
# results fixed only up to signs or order: compared through what they
# determine (``LINALG_DERIVED`` in the test and phase 29)
LINALG_FACTORS = {
    "qr": lambda r: ([f(r, 4, 3)], {}),
    "svd": lambda r: ([f(r, 4, 3)], {"full_matrices": False}),
    "eigh": lambda r: ([_spd(r)], {}),
    "eig": lambda r: ([_spd(r)[0]], {}),
    "eigvals": lambda r: ([_spd(r)[0]], {}),
}
_FFT = {
    "fft": (lambda r: ([f(r, 3, 8)], {}), 1e-4),
    "ifft": (lambda r: ([f(r, 3, 8)], {}), 1e-4),
    "rfft": (lambda r: ([f(r, 3, 8)], {}), 1e-4),
    "irfft": (lambda r: ([f(r, 3, 8)], {}), 1e-4),
    "fft2": (lambda r: ([f(r, 4, 8)], {}), 1e-4),
    "ifft2": (lambda r: ([f(r, 4, 8)], {}), 1e-4),
    "fftn": (lambda r: ([f(r, 2, 4, 4)], {}), 1e-4),
    "ifftn": (lambda r: ([f(r, 2, 4, 4)], {}), 1e-4),
    "fftfreq": (lambda r: ([8, 0.5], {}), "rel"),
    "rfftfreq": (lambda r: ([8, 0.5], {}), "rel"),
    "fftshift": (lambda r: ([f(r, 3, 8)], {}), "exact"),
    "ifftshift": (lambda r: ([f(r, 3, 8)], {}), "exact"),
}
for _n, _v in _LINALG.items():
    CASES[f"linalg.{_n}"] = _v
for _n, _v in _FFT.items():
    CASES[f"fft.{_n}"] = _v


def _spd(rng, n=3, batch=2):
    a = rng.randn(batch, n, n).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32))


# mx.npx: the functions over the registry ops, and the pure ones
NPX_CASES = {
    "softmax": (lambda r: ([f(r, 3, 5)], {}), "rel"),
    "log_softmax": (lambda r: ([f(r, 3, 5)], {}), "rel"),
    "relu": (lambda r: ([f(r, 3, 5)], {}), "exact"),
    "sigmoid": (lambda r: ([f(r, 3, 5)], {}), "rel"),
    "gelu": (lambda r: ([f(r, 3, 5)], {}), "rel"),
    "leaky_relu": (lambda r: ([f(r, 3, 5)], {"slope": 0.2}), "arith"),
    "one_hot": (lambda r: ([np.int32([0, 2, 4, 7])], {"depth": 5}),
                "exact"),
    "pick": (lambda r: ([f(r, 3, 5), np.float32([0, 4, 2])], {}), "exact"),
    "topk": (lambda r: ([f(r, 3, 5)], {"k": 2}), "exact"),
    "batch_dot": (lambda r: ([f(r, 2, 3, 4), f(r, 2, 4, 5)], {}), "rel"),
    "gather_nd": (lambda r: ([f(r, 3, 4), np.int32([[0, 2], [1, 3]])], {}),
                  "exact"),
    "reshape_like": (lambda r: ([f(r, 2, 6), f(r, 3, 4)], {}), "exact"),
    "broadcast_like": (lambda r: ([f(r, 1, 4), f(r, 3, 4)], {}), "exact"),
    "arange_like": (lambda r: ([f(r, 3, 4)], {"axis": 1}), "exact"),
    "sequence_mask": (lambda r: ([f(r, 4, 2, 3), np.float32([2, 3])],
                                 {"use_sequence_length": True}), "exact"),
    "smooth_l1": (lambda r: ([f(r, 3, 4)], {}), "rel"),
    "slice": (lambda r: ([f(r, 4, 5), (1, 0), (3, 4)], {}), "exact"),
    "slice_like": (lambda r: ([f(r, 4, 5), f(r, 2, 3)], {}), "exact"),
    "activation": (lambda r: ([f(r, 3, 4)], {"act_type": "tanh"}), "rel"),
    "cast": (lambda r: ([f(r, 3, 4)], {"dtype": "float16"}), "exact"),
    "erf": (lambda r: ([f(r, 3, 4)], {}), "rel"),
    "erfinv": (lambda r: ([f(r, 3, 4, lo=-0.9, hi=0.9)], {}), 1e-4),
    "gamma": (lambda r: ([f(r, 3, 4, lo=0.5, hi=3)], {}), "rel"),
    "gammaln": (lambda r: ([f(r, 3, 4, lo=0.5, hi=3)], {}), "rel"),
    "fully_connected": (lambda r: ([f(r, 2, 3), f(r, 4, 3), f(r, 4)], {}),
                        "rel"),
    "embedding": (lambda r: ([np.float32([[0, 2], [1, 1]]), f(r, 3, 4)],
                             {}), "exact"),
    "layer_norm": (lambda r: ([f(r, 2, 5), f(r, 5), f(r, 5)], {}), "rel"),
    "group_norm": (lambda r: ([f(r, 2, 4, 3), f(r, 4), f(r, 4)],
                              {"num_groups": 2}), 1e-4),
    "instance_norm": (lambda r: ([f(r, 2, 3, 4), f(r, 3), f(r, 3)], {}),
                      1e-4),
    "convolution": (lambda r: ([f(r, 1, 2, 5, 5), f(r, 3, 2, 3, 3)],
                               {"kernel": (3, 3), "num_filter": 3}), 1e-4),
    "deconvolution": (lambda r: ([f(r, 1, 2, 4, 4), f(r, 2, 3, 3, 3)],
                                 {"kernel": (3, 3), "num_filter": 3}),
                      1e-4),
    "pooling": (lambda r: ([f(r, 1, 2, 4, 4)],
                           {"kernel": (2, 2), "pool_type": "max",
                            "stride": (2, 2)}), "exact"),
}

# data-dependent output shapes, or results that are not arrays: the JAX
# side runs these eagerly
EAGER = {"unique", "nonzero", "flatnonzero", "union1d", "intersect1d",
         "setdiff1d", "setxor1d", "trim_zeros", "extract", "compress",
         "delete", "bincount", "iscomplexobj", "isrealobj",
         "shape", "size", "ndim", "result_type", "can_cast",
         "promote_types"}


def args_of(case_args, convert):
    """The case's arguments with each numpy array (and each array in a
    list) passed through ``convert``."""
    def one(a):
        if isinstance(a, np.ndarray):
            return convert(a)
        if isinstance(a, list) and a and all(isinstance(e, np.ndarray)
                                             for e in a):
            return [convert(e) for e in a]
        return a
    return [one(a) for a in case_args]


def _np(x):
    """A result as numpy (``asnumpy`` of an array; bfloat16 arrives as
    float32 already)."""
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return x


def check(got, want, tol, name):
    """Hold one result (possibly a tuple) against another: the same
    structure, shapes and dtypes, and values within ``tol``."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), \
            (name, type(got), len(got) if isinstance(got, (tuple, list))
             else None, len(want))
        for g, w in zip(got, want):
            check(g, w, tol, name)
        return
    got, want = _np(got), _np(want)
    if not isinstance(want, np.ndarray):
        if isinstance(want, np.dtype) or isinstance(got, np.dtype):
            assert np.dtype(got) == np.dtype(want), (name, got, want)
        else:
            assert got == want, (name, got, want)
        return
    got = np.asarray(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    if tol == "exact" or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    g, w = got.astype(np.complex128 if got.dtype.kind == "c"
                      else np.float64), want.astype(
        np.complex128 if want.dtype.kind == "c" else np.float64)
    finite = np.isfinite(w)
    scale = float(np.max(np.abs(w[finite]))) if finite.any() else 0.0
    rtol = 1e-6 if tol == "arith" else (1e-5 if tol == "rel" else tol)
    atol = rtol * scale
    np.testing.assert_allclose(g, w, rtol=0 if tol == "arith" else rtol,
                               atol=atol, equal_nan=True, err_msg=name)

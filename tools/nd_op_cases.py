"""The case table of the ``mx.nd`` operator checks: for each primary
operator name, a maker of seeded numpy inputs, the parameters, and the
tolerance; and the samplers' inputs, parameters and supports.

``tests/test_torch_nd_ops.py`` holds the port against the JAX package on
the CPU with it, and ``chip_smoke.py`` phase 28 holds the card against
the CPU with it. Tolerances: ``"exact"`` (values and dtype) for ops that
only move, select or compare values; ``"arith"`` (1e-6 of max |value|)
for elementwise arithmetic; ``"rel"`` (1e-5 relative, with an absolute
floor of 1e-5 of max |value|) for reductions, transcendental functions
and linalg; a float is a looser relative tolerance, its reason beside
it. numpy only: this module runs where JAX is not installed.
"""
import zlib

import numpy as np

__all__ = ["CASES", "N_DRAWS", "RANDOM", "SAMPLER_MOMENTS", "check",
           "draw_sampler", "f32", "f32_maker", "moments_ok", "nd_fn",
           "rng_for", "seq_inputs", "spec"]


def rng_for(name):
    return np.random.RandomState(zlib.crc32(name.encode()))


def f32(rng, *shape, lo=None, hi=None):
    """Seeded float32 normals, or uniforms in [lo, hi)."""
    if lo is None:
        return rng.randn(*shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _spd(rng, n=3, batch=2):
    a = rng.randn(batch, n, n).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32))


# -- case table: primary name -> (input maker, params, tolerance) -----------
# tolerance: "exact", "arith" (1e-6 of max |value|), "rel" (1e-5), or a
# float (relative, with the reason beside it)
_POS = dict(lo=0.5, hi=2.0)
_UNIT = dict(lo=-0.9, hi=0.9)
UNARY_DOMAIN = {
    "log": _POS, "log2": _POS, "log10": _POS, "sqrt": _POS, "rsqrt": _POS,
    "gamma": _POS, "gammaln": _POS, "reciprocal": _POS, "rcbrt": _POS,
    "log1p": dict(lo=-0.5, hi=2.0), "arcsin": _UNIT, "arccos": _UNIT,
    "arctanh": _UNIT, "erfinv": _UNIT, "arccosh": dict(lo=1.1, hi=3.0),
}
UNARY_EXACT = {"abs", "sign", "ceil", "floor", "round", "rint", "trunc",
               "fix", "negative", "relu", "logical_not", "size_array",
               "isnan", "isinf", "isfinite", "identity", "zeros_like",
               "ones_like", "shape_array", "BlockGrad", "square"}
UNARY_ARITH = {"reciprocal", "degrees", "radians", "softsign"}


def _unary(name):
    dom = UNARY_DOMAIN.get(name, {})

    def make(rng):
        x = f32(rng, 2, 3, **dom)
        if name in ("round", "rint"):
            x = np.array([[0.5, 1.5, -2.5], [2.4, -0.6, 3.5]], np.float32)
        if name in ("isnan", "isinf", "isfinite"):
            x[0, 0], x[1, 1] = np.nan, np.inf
        if name == "logical_not":
            x[0, :2] = 0
        return [x]
    tol = "exact" if name in UNARY_EXACT else \
        "arith" if name in UNARY_ARITH else "rel"
    return make, {}, tol


SCALAR_INPUT = {
    "_rdiv_scalar": _POS, "_rmod_scalar": _POS, "_power_scalar": _POS,
    "_rpower_scalar": dict(lo=-1.0, hi=1.0),
}
SCALAR_EXACT = {"_maximum_scalar", "_minimum_scalar", "_equal_scalar",
                "_not_equal_scalar", "_greater_scalar",
                "_greater_equal_scalar", "_lesser_scalar",
                "_lesser_equal_scalar", "_logical_and_scalar",
                "_logical_or_scalar", "_logical_xor_scalar"}


def _scalar_op(name):
    def make(rng):
        x = f32(rng, 2, 3, **SCALAR_INPUT.get(name, {}))
        if name in SCALAR_EXACT:
            x = np.round(x * 2) / 2            # ties with the scalar
            x[0, 0] = 0.0
        return [x]
    scalar = 0.0 if "logical" in name else \
        2.0 if "power" in name else 0.5 if name in SCALAR_EXACT else 0.7
    tol = "exact" if name in SCALAR_EXACT else \
        "rel" if "power" in name or "mod" in name or "hypot" in name \
        else "arith"
    return make, {"scalar": scalar}, tol


BINARY_EXACT = {"broadcast_maximum", "broadcast_minimum", "broadcast_equal",
                "broadcast_not_equal", "broadcast_greater",
                "broadcast_greater_equal", "broadcast_lesser",
                "broadcast_lesser_equal", "broadcast_logical_and",
                "broadcast_logical_or", "broadcast_logical_xor"}


def _binary(name):
    def make(rng):
        a, b = f32(rng, 2, 3), f32(rng, 1, 3)
        if name in BINARY_EXACT:
            a, b = np.round(a), np.round(b)
        if name in ("broadcast_power",):
            a = f32(rng, 2, 3, **_POS)
        if name in ("broadcast_div", "broadcast_mod"):
            b = f32(rng, 1, 3, **_POS)
        return [a, b]
    tol = "exact" if name in BINARY_EXACT else \
        "arith" if name in ("broadcast_add", "broadcast_sub",
                            "broadcast_mul") else "rel"
    return make, {}, tol


def f32_maker(*shape):
    """An input maker of one float32 array of ``shape``."""
    return lambda rng: [f32(rng, *shape)]


def _conv_inputs(rng):
    return [f32(rng, 2, 4, 6, 6), f32(rng, 6, 2, 3, 3), f32(rng, 6)]


def _deconv_inputs(rng):
    return [f32(rng, 2, 4, 5, 5), f32(rng, 4, 3, 3, 3), f32(rng, 6)]


def _bn_inputs(rng):
    return [f32(rng, 4, 3, 5, 5), f32(rng, 3, lo=0.5, hi=1.5), f32(rng, 3),
            f32(rng, 3) * 0.1, f32(rng, 3, lo=0.5, hi=1.5)]


def _ctc_inputs(rng):
    labels = np.array([[1, 2, 2], [3, 1, -1]], np.float32)
    return [f32(rng, 7, 2, 5), labels,
            np.array([7, 5], np.float32), np.array([3, 2], np.float32)]


def _opt(n_state, pos=()):
    def make(rng):
        arrs = [f32(rng, 3, 4), f32(rng, 3, 4)]
        for i in range(n_state):
            arrs.append(f32(rng, 3, 4, **_POS) if i in pos else f32(rng, 3, 4))
        return arrs
    return make


def _qkv_interleaved(rng):
    return [f32(rng, 5, 2, 3 * 8)]


def _valatt(rng):
    att = np.abs(f32(rng, 2 * 2, 5, 5))
    return [f32(rng, 5, 2, 3 * 8), att / att.sum(-1, keepdims=True)]


def seq_inputs(rng):
    return [f32(rng, 5, 3, 2), np.array([2, 5, 1], np.float32)]


CASES = {
    "Activation": (f32_maker(2, 3), {"act_type": "softrelu"}, "rel"),
    "BatchNorm": (_bn_inputs, {"fix_gamma": False, "act_type": "relu",
                               "eps": 1e-3}, "rel"),
    "_contrib_BatchNormWithReLU": (_bn_inputs, {"fix_gamma": False}, "rel"),
    "CTCLoss": (_ctc_inputs, {"use_data_lengths": True,
                              "use_label_lengths": True}, "rel"),
    "Cast": (f32_maker(2, 3), {"dtype": "float16"}, "exact"),
    "amp_cast": (f32_maker(2, 3), {"dtype": "bfloat16"}, "exact"),
    "Concat": (lambda r: [f32(r, 2, 3), f32(r, 2, 1)], {"dim": 1}, "exact"),
    "stack": (lambda r: [f32(r, 2, 3), f32(r, 2, 3)], {"axis": 1}, "exact"),
    "add_n": (lambda r: [f32(r, 2, 3), f32(r, 2, 3), f32(r, 2, 3)], {},
              "arith"),
    "khatri_rao": (lambda r: [f32(r, 3, 2), f32(r, 3, 4)], {}, "arith"),
    "Convolution": (_conv_inputs, {"kernel": (3, 3), "num_filter": 6,
                                   "num_group": 2, "pad": (1, 1),
                                   "stride": (2, 2)}, "rel"),
    "Deconvolution": (_deconv_inputs, {"kernel": (3, 3), "num_filter": 6,
                                       "num_group": 2, "stride": (2, 2),
                                       "pad": (1, 1), "adj": (1, 1),
                                       "no_bias": False}, "rel"),
    "Dropout": (f32_maker(2, 3), {"p": 0.5}, "exact"),
    "Embedding": (lambda r: [np.array([[0, 3], [5, -1]], np.float32),
                             f32(r, 5, 4)],
                  {"input_dim": 5, "output_dim": 4}, "exact"),
    "Flatten": (f32_maker(2, 3, 2), {}, "exact"),
    "FullyConnected": (lambda r: [f32(r, 2, 3, 2), f32(r, 4, 6), f32(r, 4)],
                       {"num_hidden": 4}, "rel"),
    "GroupNorm": (lambda r: [f32(r, 2, 4, 3), f32(r, 4), f32(r, 4)],
                  {"num_groups": 2}, "rel"),
    "InstanceNorm": (lambda r: [f32(r, 2, 3, 5), f32(r, 3), f32(r, 3)], {},
                     "rel"),
    "LayerNorm": (lambda r: [f32(r, 2, 3, 5), f32(r, 5), f32(r, 5)], {}, "rel"),
    "L2Normalization": (f32_maker(2, 3, 4), {"mode": "channel"}, "rel"),
    "RMSNorm": (lambda r: [f32(r, 2, 5), f32(r, 5)], {}, "rel"),
    "LeakyReLU": (lambda r: [f32(r, 2, 3, 4), f32(r, 3)],
                  {"act_type": "prelu"}, "exact"),
    "LinearRegressionOutput": (lambda r: [f32(r, 3, 2), f32(r, 3, 2)], {},
                               "exact"),
    "LogisticRegressionOutput": (lambda r: [f32(r, 3, 2), f32(r, 3, 2)], {},
                                 "rel"),
    "MAERegressionOutput": (lambda r: [f32(r, 3, 2), f32(r, 3, 2)], {},
                            "exact"),
    "MakeLoss": (f32_maker(2, 3), {"grad_scale": 2.0}, "exact"),
    "Pad": (f32_maker(1, 2, 3, 3), {"mode": "reflect",
                             "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
            "exact"),
    "Pooling": (f32_maker(2, 3, 7, 7), {"kernel": (3, 3), "stride": (2, 2),
                                 "pool_type": "avg", "pad": (1, 1),
                                 "pooling_convention": "full",
                                 "count_include_pad": False}, "rel"),
    "Reshape": (f32_maker(2, 3, 4), {"shape": (0, -3)}, "exact"),
    "SequenceLast": (seq_inputs, {"use_sequence_length": True}, "exact"),
    "SequenceMask": (seq_inputs, {"use_sequence_length": True, "value": -1.0},
                     "exact"),
    "SequenceReverse": (seq_inputs, {"use_sequence_length": True}, "exact"),
    "SliceChannel": (f32_maker(2, 6), {"num_outputs": 3, "axis": 1}, "exact"),
    "SoftmaxActivation": (f32_maker(2, 3, 4), {"mode": "channel"}, "rel"),
    "SoftmaxOutput": (lambda r: [f32(r, 3, 4), np.array([0, 3, 1],
                                                       np.float32)], {},
                      "rel"),
    "SwapAxis": (f32_maker(2, 3, 4), {"dim1": 0, "dim2": 2}, "exact"),
    "UpSampling": (f32_maker(1, 2, 3, 3), {"scale": 2}, "exact"),
    "_contrib_AdaptiveAvgPooling2D": (f32_maker(2, 3, 7, 5),
                                      {"output_size": (3, 2)}, "rel"),
    "_contrib_BilinearResize2D": (f32_maker(1, 2, 4, 5),
                                  {"height": 7, "width": 9}, "rel"),
    "_contrib_allclose": (lambda r: [f32(r, 3), f32(r, 3)], {}, "exact"),
    "_contrib_boolean_mask": (lambda r: [f32(r, 4, 2), np.array(
        [1, 0, 1, 1], np.float32)], {}, "exact"),
    "_contrib_conv_epilogue": (lambda r: [f32(r, 2, 3, 4), f32(r, 2, 3, 4)],
                               {"act_type": "relu"}, "arith"),
    "_contrib_count_sketch": (lambda r: [
        f32(r, 2, 5), np.array([0, 2, 1, 2, 0], np.float32),
        np.array([1, -1, 1, 1, -1], np.float32)], {"out_dim": 3}, "arith"),
    "_contrib_div_sqrt_dim": (f32_maker(2, 4), {}, "arith"),
    "_contrib_fft": (f32_maker(2, 8), {}, "rel"),
    "_contrib_ifft": (f32_maker(2, 8), {}, "rel"),
    # above 1024 keys: the streaming path, the flash-attention kernel's
    # plain version on the CPU (K3)
    "_contrib_flash_attention": (lambda r: [f32(r, 1, 2, 4, 8),
                                            f32(r, 1, 2, 1100, 8),
                                            f32(r, 1, 2, 1100, 8)],
                                 {"causal": True}, "rel"),
    "_contrib_fused_self_attention": (f32_maker(2, 5, 3 * 8), {"heads": 2,
                                                        "causal": True},
                                      "rel"),
    "_contrib_index_copy": (lambda r: [f32(r, 4, 2), np.array(
        [3, 0], np.float32), f32(r, 2, 2)], {}, "exact"),
    "_contrib_interleaved_matmul_selfatt_qk": (_qkv_interleaved,
                                               {"heads": 2}, "rel"),
    "_contrib_interleaved_matmul_selfatt_valatt": (_valatt, {"heads": 2},
                                                   "rel"),
    "_contrib_matmul_epilogue": (lambda r: [f32(r, 3, 4), f32(r, 4)],
                                 {"act_type": "gelu"}, "rel"),
    "_contrib_quadratic": (f32_maker(2, 3), {"a": 0.5, "b": -1.0, "c": 2.0},
                           "arith"),
    "_linalg_det": (lambda r: [_spd(r)], {}, "rel"),
    "_linalg_extractdiag": (f32_maker(2, 3, 3), {"offset": 1}, "exact"),
    "_linalg_extracttrian": (f32_maker(2, 3, 3), {"offset": -1}, "exact"),
    "_linalg_gemm2": (lambda r: [f32(r, 2, 3, 4), f32(r, 2, 5, 4)],
                      {"transpose_b": True, "alpha": 0.5}, "rel"),
    # the inverse of an SPD matrix of condition ~30: 1e-4 (float32
    # solves on LAPACK vs XLA differ in the last bits times the condition)
    "_linalg_inverse": (lambda r: [_spd(r)], {}, 1e-4),
    "_linalg_makediag": (f32_maker(2, 3), {"offset": -1}, "exact"),
    "_linalg_maketrian": (f32_maker(2, 6), {"offset": 0, "lower": False},
                          "exact"),
    "_linalg_potrf": (lambda r: [_spd(r)], {}, "rel"),
    "_linalg_slogdet": (lambda r: [_spd(r)], {}, "rel"),
    "_linalg_syrk": (f32_maker(2, 3, 4), {"transpose": True, "alpha": 2.0}, "rel"),
    "_linalg_trmm": (lambda r: [f32(r, 2, 3, 3), f32(r, 2, 4, 3)],
                     {"rightside": True, "transpose": True}, "rel"),
    # a triangular solve, condition set by the diagonal (>= 2): 1e-4, as
    # the inverse
    "_linalg_trsm": (lambda r: [f32(r, 2, 3, 3) + 3 * np.eye(3, dtype=np.float32),
                                f32(r, 2, 4, 3)],
                     {"rightside": True, "lower": False, "alpha": 0.5},
                     1e-4),
    "adagrad_update": (_opt(1, pos=(0,)), {"lr": 0.1, "wd": 0.01}, "rel"),
    "adam_update": (_opt(2, pos=(1,)), {"lr": 0.1, "wd": 0.01,
                                        "clip_gradient": 1.0}, "rel"),
    "adamw_update": (_opt(2, pos=(1,)), {"lr": 0.1, "wd": 0.01,
                                         "eta": 0.5}, "rel"),
    "ftrl_update": (_opt(2, pos=(1,)), {"lr": 0.1, "wd": 0.01}, "rel"),
    "lamb_update_phase1": (_opt(2, pos=(1,)), {"t": 3, "wd": 0.01}, "rel"),
    "lamb_update_phase2": (lambda r: [f32(r, 3, 4), f32(r, 3, 4),
                                      np.float32([2.0]), np.float32([3.0])],
                           {"lr": 0.1, "lower_bound": 2.5}, "rel"),
    "mp_sgd_mom_update": (_opt(2), {"lr": 0.1, "momentum": 0.9}, "rel"),
    "mp_sgd_update": (_opt(1), {"lr": 0.1, "wd": 0.01}, "rel"),
    "nag_mom_update": (_opt(1), {"lr": 0.1, "momentum": 0.9}, "rel"),
    "rmsprop_update": (_opt(1, pos=(0,)), {"lr": 0.1}, "rel"),
    "sgd_mom_update": (_opt(1), {"lr": 0.1, "momentum": 0.9, "wd": 0.01},
                       "rel"),
    "sgd_update": (_opt(0), {"lr": 0.1, "rescale_grad": 0.5}, "rel"),
    "signsgd_update": (_opt(0), {"lr": 0.1}, "rel"),
    "arange_like": (f32_maker(2, 3), {"start": 1.0, "step": 0.5, "axis": 1},
                    "exact"),
    "arctan2": (lambda r: [f32(r, 2, 3), f32(r, 1, 3)], {}, "rel"),
    "ldexp": (lambda r: [f32(r, 2, 3), np.round(f32(r, 1, 3) * 2)], {},
              "arith"),
    "argmax": (f32_maker(3, 4), {"axis": 1, "keepdims": True}, "exact"),
    "argmin": (f32_maker(3, 4), {}, "exact"),
    "argsort": (f32_maker(3, 4), {"is_ascend": False}, "exact"),
    "batch_dot": (lambda r: [f32(r, 2, 4, 3), f32(r, 2, 4, 5)],
                  {"transpose_a": True}, "rel"),
    "batch_take": (lambda r: [f32(r, 3, 4), np.array([0, 3, 2],
                                                    np.float32)], {},
                   "exact"),
    "broadcast_axis": (f32_maker(2, 1, 3), {"axis": (1,), "size": (4,)}, "exact"),
    "broadcast_like": (lambda r: [f32(r, 1, 3), f32(r, 4, 3)], {}, "exact"),
    "broadcast_to": (f32_maker(1, 3), {"shape": (4, 0)}, "exact"),
    "clip": (f32_maker(3, 4), {"a_min": -0.5, "a_max": 0.7}, "exact"),
    "depth_to_space": (f32_maker(1, 8, 2, 3), {"block_size": 2}, "exact"),
    "space_to_depth": (f32_maker(1, 2, 4, 6), {"block_size": 2}, "exact"),
    "diag": (f32_maker(3, 4), {"k": 1}, "exact"),
    "dot": (lambda r: [f32(r, 2, 3, 4), f32(r, 4, 5)], {}, "rel"),
    "embedding_like_dot": (lambda r: [f32(r, 3, 4), f32(r, 5, 4)], {}, "rel"),
    "expand_dims": (f32_maker(2, 3), {"axis": 1}, "exact"),
    "gather_nd": (lambda r: [f32(r, 3, 4), np.array([[0, 2, -1], [1, 3, 9]],
                                                   np.float32)], {},
                  "exact"),
    "log_softmax": (f32_maker(2, 5), {"temperature": 2.0}, "rel"),
    "logsumexp": (f32_maker(2, 5), {"axis": 1, "keepdims": True}, "rel"),
    "max": (f32_maker(2, 3, 4), {"axis": (0, 2)}, "exact"),
    "min": (f32_maker(2, 3, 4), {"axis": 1, "exclude": True}, "exact"),
    "mean": (f32_maker(2, 3, 4), {"axis": (1,), "keepdims": True}, "rel"),
    "sum": (f32_maker(2, 3, 4), {"axis": 2, "exclude": True}, "rel"),
    "prod": (f32_maker(2, 3, 4), {"axis": (0, 2)}, "rel"),
    "nansum": (lambda r: [np.where(f32(r, 3, 4) > 0.5, np.nan,
                                   f32(r, 3, 4)).astype(np.float32)],
               {"axis": 1}, "rel"),
    "nanprod": (lambda r: [np.where(f32(r, 3, 4) > 0.5, np.nan,
                                    f32(r, 3, 4)).astype(np.float32)],
                {"axis": 0}, "rel"),
    "norm": (f32_maker(3, 4), {"ord": 1, "axis": (1,), "keepdims": True}, "rel"),
    "moveaxis": (f32_maker(2, 3, 4), {"source": (0,), "destination": (2,)},
                 "exact"),
    "one_hot": (lambda r: [np.array([0, 2, 5, -1], np.float32)],
                {"depth": 4, "on_value": 2.0, "off_value": -1.0}, "exact"),
    "pick": (lambda r: [f32(r, 3, 4), np.array([0, 5, 2], np.float32)],
             {"axis": 1}, "exact"),
    "repeat": (f32_maker(2, 3), {"repeats": 2, "axis": 1}, "exact"),
    "reshape_like": (lambda r: [f32(r, 2, 6), f32(r, 3, 4)], {}, "exact"),
    "reverse": (f32_maker(2, 3, 4), {"axis": (0, 2)}, "exact"),
    "scatter_nd": (lambda r: [f32(r, 3), np.array([[0, 1, 2], [3, 0, 1]],
                                                 np.float32)],
                   {"shape": (3, 4)}, "exact"),
    "slice": (f32_maker(4, 5), {"begin": (3, 1), "end": (0, None),
                         "step": (-1, 2)}, "exact"),
    "slice_axis": (f32_maker(4, 5), {"axis": 1, "begin": 1, "end": -1}, "exact"),
    "slice_like": (lambda r: [f32(r, 4, 5), f32(r, 2, 3)], {"axes": (1,)},
                   "exact"),
    "smooth_l1": (f32_maker(3, 4), {"scalar": 2.0}, "arith"),
    "softmax": (f32_maker(2, 5), {"axis": 0, "temperature": 0.5}, "rel"),
    "softmin": (f32_maker(2, 5), {}, "rel"),
    "sort": (f32_maker(3, 4), {"axis": 0, "is_ascend": False}, "exact"),
    "squeeze": (f32_maker(2, 1, 3, 1), {"axis": (1, 3)}, "exact"),
    "take": (lambda r: [f32(r, 4, 3), np.array([[0, 5], [-2, 1]],
                                              np.float32)],
             {"axis": 0, "mode": "wrap"}, "exact"),
    "tile": (f32_maker(2, 3), {"reps": (2, 1, 2)}, "exact"),
    "topk": (f32_maker(3, 5), {"k": 2, "ret_typ": "both"}, "exact"),
    "transpose": (f32_maker(2, 3, 4), {"axes": (1, 0, 2)}, "exact"),
    "where": (lambda r: [np.array([[1, 0, 2], [0, 0, 1]], np.float32),
                         f32(r, 2, 3), f32(r, 2, 3)], {}, "exact"),
}

def _finite(v):
    return np.isfinite(v).all()


RANDOM = {                 # sampler -> (inputs, params, support check)
    "_random_uniform": ([], {"low": -1.0, "high": 2.0, "shape": (50,)},
                        lambda v: (v >= -1).all() and (v < 2).all()),
    "_random_normal": ([], {"shape": (50,)}, _finite),
    "_random_gamma": ([], {"alpha": 2.0, "shape": (50,)},
                      lambda v: (v > 0).all()),
    "_random_exponential": ([], {"lam": 2.0, "shape": (50,)},
                            lambda v: (v >= 0).all()),
    "_random_poisson": ([], {"lam": 3.0, "shape": (50,)},
                        lambda v: (v >= 0).all() and (v == np.round(v)).all()),
    "_random_randint": ([], {"low": -2, "high": 5, "shape": (50,)},
                        lambda v: ((v >= -2) & (v < 5)).all()
                        and (v == np.round(v)).all()),
    "_random_negative_binomial": ([], {"k": 3, "p": 0.4, "shape": (50,)},
                                  lambda v: (v >= 0).all()),
    "_random_generalized_negative_binomial": (
        [], {"mu": 2.0, "alpha": 0.5, "shape": (50,)},
        lambda v: (v >= 0).all()),
    "_random_bernoulli": ([], {"p": 0.3, "shape": (50,)},
                          lambda v: np.isin(v, (0, 1)).all()),
    "_sample_uniform": ([np.float32([0, 1]), np.float32([1, 3])],
                        {"shape": (20,)},
                        lambda v: (v[0] < 1).all() and (v[1] >= 1).all()),
    "_sample_normal": ([np.float32([0, 5]), np.float32([1, 0.1])],
                       {"shape": (20,)}, _finite),
    "_sample_gamma": ([np.float32([1, 3]), np.float32([1, 2])],
                      {"shape": (20,)}, lambda v: (v > 0).all()),
    "_sample_exponential": ([np.float32([1, 3])], {"shape": (20,)},
                            lambda v: (v >= 0).all()),
    "_sample_poisson": ([np.float32([1, 3])], {"shape": (20,)},
                        lambda v: (v >= 0).all()),
    "_sample_negative_binomial": ([np.float32([2, 3]),
                                   np.float32([0.5, 0.3])],
                                  {"shape": (20,)}, lambda v: (v >= 0).all()),
    "_sample_generalized_negative_binomial": (
        [np.float32([2, 3]), np.float32([0.5, 0.0])], {"shape": (20,)},
        lambda v: (v >= 0).all()),
    "_sample_multinomial": ([np.float32([[0.2, 0.8, 0.0], [0, 0, 1]])],
                            {"shape": (6,)},
                            lambda v: (v[0] < 2).all() and (v[1] == 2).all()),
    "_sample_dirichlet": ([np.float32([1, 2, 3])], {"shape": (4,)},
                         lambda v: np.allclose(v.sum(-1), 1, atol=1e-5)),
    "_shuffle": ([np.arange(10, dtype=np.float32)], {}, None),
}


def spec(p):
    """(input maker, params, tolerance) of the primary op name ``p``."""
    if p in CASES:
        return CASES[p]
    if p.startswith("broadcast_"):
        return _binary(p)
    if p.endswith("_scalar"):
        return _scalar_op(p)
    return _unary(p)


def check(got, want, tol, name):
    if isinstance(got, tuple):                  # bfloat16
        assert want.dtype.name == got[0], (name, want.dtype)
        got, want = got[1], want.astype(np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if tol == "exact":
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    got, want = got.astype(np.float64), want.astype(np.float64)
    scale = float(np.nanmax(np.abs(want))) if want.size else 0.0
    if tol == "arith":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale,
                                   err_msg=name)
        return
    rtol = 1e-5 if tol == "rel" else tol
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=name)




def nd_fn(nd, name):
    """The wrapper the registry name ``name`` gets in the ``mx.nd``
    module ``nd``, by the JAX package's routing rules."""
    if name.startswith("_contrib_"):
        return getattr(nd.contrib, name[len("_contrib_"):])
    if name.startswith("_random_"):
        return getattr(nd.random, name[len("_random_"):])
    if name.startswith("_sample_"):
        assert getattr(nd, name[1:]) is getattr(nd.random, name[1:])
        return getattr(nd.random, name[1:])
    if name.startswith("_linalg_"):
        return getattr(nd.linalg, name[len("_linalg_"):])
    if name.startswith("_"):
        return getattr(nd._internal, name)
    if name in ("BilinearResize2D", "AdaptiveAvgPooling2D"):
        return getattr(nd.contrib, name)
    return getattr(nd.op, name)


# -- the samplers' moments ---------------------------------------------------
# The thresholds of tests/test_random_samplers.py (the JAX package's
# sampler tests), the same thresholds scaled the same way for the
# samplers that file does not cover: |mean - want| < tol and |var -
# want| < max(6 tol, 0.12 var).
N_DRAWS = 4000


def _full(v):
    return np.full((N_DRAWS,), v, np.float32)


def _int_valued(a):
    return (a == np.round(a)).all()


# name -> (registry name, inputs, params, mean, var, tol, support)
SAMPLER_MOMENTS = {
    "uniform": ("_random_uniform", [], {"low": -1.0, "high": 3.0},
                1.0, 16 / 12, 0.1, lambda a: (a >= -1).all() and (a < 3).all()),
    "normal": ("_random_normal", [], {"loc": 2.0, "scale": 0.5},
               2.0, 0.25, 0.05, None),
    "gamma": ("_random_gamma", [], {"alpha": 3.0, "beta": 2.0},
              6.0, 12.0, 0.6, lambda a: (a > 0).all()),
    "exponential": ("_random_exponential", [], {"lam": 4.0},
                    0.25, 1 / 16, 0.05, lambda a: (a >= 0).all()),
    "poisson": ("_random_poisson", [], {"lam": 5.0}, 5.0, 5.0, 0.5,
                _int_valued),
    "negative_binomial": ("_random_negative_binomial", [],
                          {"k": 5, "p": 0.4}, 7.5, 18.75, 0.4,
                          lambda a: (a >= 0).all()),
    "generalized_negative_binomial": (
        "_random_generalized_negative_binomial", [],
        {"mu": 3.0, "alpha": 0.5}, 3.0, 7.5, 0.3, lambda a: (a >= 0).all()),
    "randint": ("_random_randint", [], {"low": -3, "high": 5},
                0.5, (8 ** 2 - 1) / 12, 0.2,
                lambda a: ((a >= -3) & (a < 5)).all() and _int_valued(a)),
    "bernoulli": ("_random_bernoulli", [], {"p": 0.3}, 0.3, 0.21, 0.05,
                  lambda a: np.isin(a, (0, 1)).all()),
    "sample_uniform": ("_sample_uniform", [_full(1.0), _full(2.0)], {},
                       1.5, 1 / 12, 0.05,
                       lambda a: (a >= 1).all() and (a < 2).all()),
    "sample_normal": ("_sample_normal", [_full(-1.0), _full(2.0)], {},
                      -1.0, 4.0, 0.2, None),
    "sample_gamma": ("_sample_gamma", [_full(3.0), _full(2.0)], {},
                     6.0, 12.0, 0.6, lambda a: (a > 0).all()),
    "sample_exponential": ("_sample_exponential", [_full(4.0)], {},
                           0.25, 1 / 16.0, 0.05, lambda a: (a >= 0).all()),
    "sample_poisson": ("_sample_poisson", [_full(5.0)], {}, 5.0, 5.0, 0.5,
                       _int_valued),
    "sample_negative_binomial": ("_sample_negative_binomial",
                                 [_full(5.0), _full(0.4)], {}, 7.5, 18.75,
                                 1.5, lambda a: (a >= 0).all()),
    "sample_generalized_negative_binomial": (
        "_sample_generalized_negative_binomial", [_full(3.0), _full(0.5)],
        {}, 3.0, 7.5, 1.0, lambda a: (a >= 0).all()),
    "sample_multinomial": (
        "_sample_multinomial",
        [np.tile(np.float32([[0.2, 0.3, 0.5]]), (N_DRAWS, 1))], {},
        1.3, 0.3 + 0.5 * 4 - 1.3 ** 2, 0.05,
        lambda a: np.isin(a, (0, 1, 2)).all()),
}


def draw_sampler(nd, name, ctx):
    """One draw of the sampler ``name`` of :data:`SAMPLER_MOMENTS` on
    ``ctx``: an NDArray of :data:`N_DRAWS` values."""
    op, inputs, params = SAMPLER_MOMENTS[name][:3]
    if inputs:
        return nd_fn(nd, op)(*[nd.array(a, ctx=ctx) for a in inputs],
                             **params)
    return nd_fn(nd, op)(shape=(N_DRAWS,), ctx=ctx, **params)


def moments_ok(name, values):
    """(ok, mean, var) of the numpy ``values`` of sampler ``name``
    against its analytic moments and support."""
    mean_want, var_want, tol, support = SAMPLER_MOMENTS[name][3:]
    a = values.astype(np.float64)
    mean, var = a.mean(), a.var()
    ok = abs(mean - mean_want) < tol and \
        abs(var - var_want) < max(6 * tol, 0.12 * var_want) and \
        (support is None or bool(support(values)))
    return ok, mean, var

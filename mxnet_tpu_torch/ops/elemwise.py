"""Elementwise unary, binary and scalar operators (counterpart of
``mxnet_tpu/ops/elemwise.py``, ref ``src/operator/tensor/elemwise_*``),
each one PyTorch call or a short composition of them, registered from
tables as the JAX package registers them.

Comparisons and logical ops return their inputs' dtype, as MXNet's and
the JAX package's do (PyTorch's return bool); ``isnan``, ``isinf`` and
``isfinite`` return bool, as ``jnp``'s do. 64-bit dtypes come back
32-bit where the JAX package's do (``Cast``, ``shape_array``,
``size_array``): JAX runs with x64 off.
"""
from __future__ import annotations

import torch

from ..base import jax_dtype
from .registry import OpParam, register


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


_UNARY = {
    # name: (fn, differentiable)
    "abs": (torch.abs, True),
    "sign": (torch.sign, True),
    "ceil": (torch.ceil, True),
    "floor": (torch.floor, True),
    "round": (torch.round, True),            # half to even, as jnp.round
    "rint": (torch.round, True),
    "trunc": (torch.trunc, True),
    "fix": (torch.trunc, True),
    "exp": (torch.exp, True),
    "log": (torch.log, True),
    "log2": (torch.log2, True),
    "log10": (torch.log10, True),
    "log1p": (torch.log1p, True),
    "expm1": (torch.expm1, True),
    "sqrt": (torch.sqrt, True),
    "rsqrt": (torch.rsqrt, True),
    "cbrt": (_cbrt, True),
    "rcbrt": (lambda x: 1.0 / _cbrt(x), True),
    "square": (torch.square, True),
    "reciprocal": (lambda x: 1.0 / x, True),
    "negative": (torch.negative, True),
    # maximum, not relu: its gradient splits a tie at 0 as jnp.maximum's
    "relu": (lambda x: torch.maximum(x, _zero(x)), True),
    "sigmoid": (torch.sigmoid, True),
    "softsign": (lambda x: x / (1 + torch.abs(x)), True),
    "erf": (torch.special.erf, True),
    "erfinv": (torch.special.erfinv, True),
    "gamma": (lambda x: torch.exp(torch.special.gammaln(x)), True),
    "gammaln": (torch.special.gammaln, True),
    "sin": (torch.sin, True), "cos": (torch.cos, True),
    "tan": (torch.tan, True),
    "arcsin": (torch.arcsin, True), "arccos": (torch.arccos, True),
    "arctan": (torch.arctan, True),
    "sinh": (torch.sinh, True), "cosh": (torch.cosh, True),
    "tanh": (torch.tanh, True),
    "arcsinh": (torch.arcsinh, True), "arccosh": (torch.arccosh, True),
    "arctanh": (torch.arctanh, True),
    "degrees": (torch.rad2deg, True),
    "radians": (torch.deg2rad, True),
    "logical_not": (lambda x: (x == 0).to(x.dtype), False),
    "size_array": (lambda x: torch.tensor(x.numel(), dtype=torch.int32,
                                          device=x.device), False),
    "isnan": (torch.isnan, False),
    "isinf": (torch.isinf, False),
    "isfinite": (torch.isfinite, False),
}

for _name, (_fn, _diff) in _UNARY.items():
    register(_name, num_inputs=1, differentiable=_diff,
             doc=f"Elementwise {_name} (ref: src/operator/tensor/"
                 "elemwise_unary_op*.cc)")(_fn)

register("identity", aliases=["_copy"],
         doc="Identity / copy (ref: elemwise_unary_op_basic.cc _copy)")(
    lambda x: x.clone())
register("zeros_like", differentiable=False)(torch.zeros_like)
register("ones_like", differentiable=False)(torch.ones_like)
register("shape_array", differentiable=False,
         doc="The shape as a 1-D int32 array (ref: shape_array)")(
    lambda x: torch.tensor(tuple(x.shape), dtype=torch.int32,
                           device=x.device))
register("BlockGrad", aliases=["stop_gradient"],
         doc="Stops the gradient (ref: elemwise_unary_op_basic.cc "
             "BlockGrad)")(torch.Tensor.detach)


@register("Cast", aliases=["cast"],
          params=[OpParam("dtype", str, "float32", doc="target dtype")],
          doc="Casts to a new dtype; 64-bit requests give 32 bits, as in "
              "the JAX package (ref: elemwise_unary_op_basic.cc Cast)")
def _cast(x, dtype="float32"):
    return x.to(jax_dtype(dtype))


@register("amp_cast", params=[OpParam("dtype", str, "float32")],
          doc="AMP cast (ref: src/operator/tensor/amp_cast.cc)")
def _amp_cast(x, dtype="float32"):
    return x.to(jax_dtype(dtype))


def _cmp(fn):
    return lambda a, b: fn(a, b).to(torch.result_type(a, b))


def _ldexp(a, b):
    return a * torch.pow(2.0, b).to(torch.result_type(a, b))


_BINARY = {
    "broadcast_add": (torch.add, True, ["elemwise_add", "_plus"]),
    "broadcast_sub": (torch.sub, True, ["elemwise_sub", "_minus"]),
    "broadcast_mul": (torch.mul, True, ["elemwise_mul", "_mul"]),
    "broadcast_div": (torch.div, True, ["elemwise_div", "_div"]),
    "broadcast_mod": (torch.remainder, True, ["_mod"]),
    "broadcast_power": (torch.pow, True, ["_power", "pow"]),
    "broadcast_maximum": (torch.maximum, True, ["_maximum"]),
    "broadcast_minimum": (torch.minimum, True, ["_minimum"]),
    "broadcast_hypot": (torch.hypot, True, ["_hypot"]),
    "broadcast_equal": (_cmp(torch.eq), False, ["_equal"]),
    "broadcast_not_equal": (_cmp(torch.ne), False, ["_not_equal"]),
    "broadcast_greater": (_cmp(torch.gt), False, ["_greater"]),
    "broadcast_greater_equal": (_cmp(torch.ge), False, ["_greater_equal"]),
    "broadcast_lesser": (_cmp(torch.lt), False, ["_lesser"]),
    "broadcast_lesser_equal": (_cmp(torch.le), False, ["_lesser_equal"]),
    "broadcast_logical_and": (_cmp(torch.logical_and), False,
                              ["_logical_and"]),
    "broadcast_logical_or": (_cmp(torch.logical_or), False, ["_logical_or"]),
    "broadcast_logical_xor": (_cmp(torch.logical_xor), False,
                              ["_logical_xor"]),
    "arctan2": (torch.atan2, True, ["_arctan2"]),
    # lhs * 2^rhs over float arrays, as the JAX op spells it out
    "ldexp": (_ldexp, True, ["_ldexp"]),
}

for _name, (_fn, _diff, _aliases) in _BINARY.items():
    register(_name, num_inputs=2, differentiable=_diff, aliases=_aliases,
             doc=f"Broadcasting {_name} (ref: src/operator/tensor/"
                 "elemwise_binary_broadcast_op*.cc)")(_fn)


def _scalar(x, s):
    """``s`` as a 0-d tensor on ``x``'s device, which promotes with ``x``
    as a Python scalar does (JAX's weak type)."""
    return torch.tensor(s, device=x.device)


def _same(fn):
    return lambda x, s: fn(x, s).to(x.dtype)


_SCALAR = {
    "_plus_scalar": (lambda x, s: x + s, True),
    "_minus_scalar": (lambda x, s: x - s, True),
    "_rminus_scalar": (lambda x, s: s - x, True),
    "_mul_scalar": (lambda x, s: x * s, True),
    "_div_scalar": (lambda x, s: x / s, True),
    "_rdiv_scalar": (lambda x, s: s / x, True),
    "_mod_scalar": (lambda x, s: torch.remainder(x, s), True),
    "_rmod_scalar": (lambda x, s: torch.remainder(_scalar(x, s), x), True),
    "_power_scalar": (lambda x, s: torch.pow(x, s), True),
    "_rpower_scalar": (lambda x, s: torch.pow(s, x), True),
    "_maximum_scalar": (lambda x, s: torch.maximum(x, _scalar(x, s)), True),
    "_minimum_scalar": (lambda x, s: torch.minimum(x, _scalar(x, s)), True),
    "_equal_scalar": (_same(torch.eq), False),
    "_not_equal_scalar": (_same(torch.ne), False),
    "_greater_scalar": (_same(torch.gt), False),
    "_greater_equal_scalar": (_same(torch.ge), False),
    "_lesser_scalar": (_same(torch.lt), False),
    "_lesser_equal_scalar": (_same(torch.le), False),
    "_logical_and_scalar": (_same(lambda x, s: torch.logical_and(
        x, _scalar(x, s))), False),
    "_logical_or_scalar": (_same(lambda x, s: torch.logical_or(
        x, _scalar(x, s))), False),
    "_logical_xor_scalar": (_same(lambda x, s: torch.logical_xor(
        x, _scalar(x, s))), False),
    "_hypot_scalar": (lambda x, s: torch.hypot(x, torch.full_like(x, s)),
                      True),
}

for _name, (_fn, _diff) in _SCALAR.items():
    register(_name, num_inputs=1, differentiable=_diff,
             params=[OpParam("scalar", float, 0.0, doc="scalar operand")],
             doc=f"Scalar op {_name} (ref: src/operator/tensor/"
                 "elemwise_binary_scalar_op*.cc)",
             )((lambda f: lambda x, scalar=0.0: f(x, scalar))(_fn))

register("add_n", num_inputs=-1, aliases=["ElementWiseSum"],
         doc="Sum of N arrays in one op (ref: src/operator/tensor/"
             "elemwise_sum.cc)")(lambda *xs: sum(xs[1:], xs[0]))

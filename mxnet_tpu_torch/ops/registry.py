"""Typed operator registry (counterpart of ``mxnet_tpu/ops/registry.py``).

An :class:`Operator` holds a plain function on tensors under its MXNet
name, with its hyperparameters as :class:`OpParam` rows (the
``dmlc::Parameter`` analog) from which ``mx.nd`` generates its wrappers
and their docstrings. ``fn(*tensors, **params)`` returns a tensor or a
tuple of tensors; with ``needs_rng`` the dispatch passes ``generator=``
(the device's generator, ``mx.random``), with ``needs_mode`` it passes
``training=`` (``autograd.is_training()``).

Shapes are inferred by running ``fn`` on PyTorch ``meta`` tensors
(``Symbol.infer_shape``), where the JAX package runs ``jax.eval_shape``:
the same function, no per-op rules, nothing computed. The kernel entries
take their plain versions on a meta tensor, so inference needs no card.

:data:`DEFERRED` lists the JAX package's operator names that are not
ported yet, each with the ROADMAP item that brings it: :func:`get` of
such a name raises :class:`MXNetError` naming the item.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as _np

from ..base import MXNetError

__all__ = ["DEFERRED", "OpParam", "Operator", "PUBLIC_BINARY_HELPERS",
           "alias", "deferred_error", "get", "install_binary_helpers",
           "list_ops", "register"]

_REGISTRY: Dict[str, "Operator"] = {}

_DETECTION = ("box_iou", "box_nms", "ROIAlign", "MultiBoxPrior",
              "MultiBoxTarget", "MultiBoxDetection", "Proposal",
              "MultiProposal", "PSROIPooling", "DeformableConvolution",
              "ModulatedDeformableConvolution")
_QUANTIZATION = ("_contrib_dequantize", "_contrib_quantize_v2",
                 "_contrib_quantized_act", "_contrib_quantized_concat",
                 "_contrib_quantized_conv", "_contrib_quantized_elemwise_add",
                 "_contrib_quantized_fully_connected",
                 "_contrib_quantized_pooling", "QFullyConnected",
                 "QConvolution", "QActivation", "det_sign", "approx_sign",
                 "binary_pack", "_contrib_binary_pack",
                 "_contrib_xnor_fully_connected", "_contrib_xnor_convolution")

# JAX package op name -> the ROADMAP Queue 1 item that ports it
DEFERRED: Dict[str, str] = {
    **{n: "item 10 (detection)" for n in _DETECTION},
    **{f"_contrib_{n}": "item 10 (detection)" for n in _DETECTION},
    **{n: "item 10 (detection)"
       for n in ("BilinearSampler", "GridGenerator", "SpatialTransformer")},
    **{n: "item 12 (quantization)" for n in _QUANTIZATION},
    "_contrib_ring_attention": "item 9 (parallel/)",
    "_contrib_ulysses_attention": "item 9 (parallel/)",
    "_contrib_fused_cross_attention": "item 7c (the NMT transformer)",
    "RNN": "item 7b (gluon/rnn)",
}


def deferred_error(name: str) -> MXNetError:
    """The error a deferred operator name raises."""
    return MXNetError(f"the operator {name!r} is not ported yet: ROADMAP "
                      f"Queue 1 {DEFERRED[name]}")


@dataclass
class OpParam:
    """One hyperparameter of an op (dmlc::Parameter field analog)."""
    name: str
    type: Any = None            # python type or callable coercer
    default: Any = None
    required: bool = False
    doc: str = ""

    def coerce(self, value):
        if value is None:
            return None
        typ = self.type
        if typ is None or isinstance(value, bool) and typ is bool:
            return value
        if typ is tuple:
            return _as_tuple(value)
        if typ is bool:
            if isinstance(value, str):
                return value.lower() in ("1", "true", "yes")
            return bool(value)
        if typ in (int, float, str):
            return typ(value)
        if callable(typ):
            return typ(value)
        return value


def _as_tuple(value):
    """Tuples, lists, ints, and MXNet's string shapes ``'(2, 2)'``."""
    if isinstance(value, str):
        value = ast.literal_eval(value)
    if isinstance(value, int):
        return (value,)
    return tuple(value)


@dataclass
class Operator:
    """A registered operator: a plain function on tensors."""
    name: str
    fn: Callable
    num_inputs: int = 1          # -1 = variadic
    num_outputs: Any = 1         # an int, or a callable of the params
    params: List[OpParam] = field(default_factory=list)
    doc: str = ""
    differentiable: bool = True
    aliases: List[str] = field(default_factory=list)
    needs_rng: bool = False      # dispatch passes generator=
    needs_mode: bool = False     # dispatch passes training=
    allow_unknown_params: bool = False   # passed through as given (Custom)

    def coerce_params(self, kwargs: dict) -> dict:
        spec = {p.name: p for p in self.params}
        out = {}
        for key, val in kwargs.items():
            if key not in spec and self.allow_unknown_params:
                out[key] = val
                continue
            if key not in spec:
                raise MXNetError(f"op {self.name!r}: unknown parameter "
                                 f"{key!r}. Known: {sorted(spec)}")
            out[key] = spec[key].coerce(val)
        for p in self.params:
            if p.required and p.name not in out:
                raise MXNetError(f"op {self.name!r}: missing required "
                                 f"parameter {p.name!r}")
            if p.name not in out:
                out[p.name] = p.default
        return out

    def n_outputs(self, params: dict) -> int:
        n = self.num_outputs
        return n(params) if callable(n) else n

    def signature_doc(self) -> str:
        lines = [self.doc or self.name, "", "Parameters", "----------"]
        for p in self.params:
            typename = getattr(p.type, "__name__", str(p.type))
            dflt = "required" if p.required else f"default={p.default!r}"
            lines.append(f"{p.name} : {typename}, {dflt}")
            if p.doc:
                lines.append(f"    {p.doc}")
        return "\n".join(lines)


def register(name: str, *, num_inputs: int = 1, num_outputs=1,
             params: Optional[Sequence[OpParam]] = None, doc: str = "",
             differentiable: bool = True, aliases: Sequence[str] = (),
             needs_rng: bool = False, needs_mode: bool = False,
             allow_unknown_params: bool = False):
    """Decorator registering ``fn`` as operator ``name`` (and its
    ``aliases``); returns ``fn``."""
    def deco(fn):
        op = Operator(name=name, fn=fn, num_inputs=num_inputs,
                      num_outputs=num_outputs, params=list(params or []),
                      doc=doc or (fn.__doc__ or ""),
                      differentiable=differentiable, aliases=list(aliases),
                      needs_rng=needs_rng, needs_mode=needs_mode,
                      allow_unknown_params=allow_unknown_params)
        for n in (name, *op.aliases):
            if n in _REGISTRY:
                raise MXNetError(f"duplicate op registration: {n}")
            _REGISTRY[n] = op
        return fn
    return deco


def alias(existing: str, *names: str):
    op = get(existing)
    for n in names:
        _REGISTRY[n] = op
        op.aliases.append(n)


def get(name: str) -> Operator:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in DEFERRED:
            raise deferred_error(name) from None
        raise MXNetError(f"operator {name!r} is not registered "
                         f"({len(_REGISTRY)} ops known)") from None


def list_ops() -> List[str]:
    """Every registered name (ref: MXListAllOpNames)."""
    return sorted(_REGISTRY)


# Public scalar-or-array binary helpers (ref: python/mxnet/ndarray/
# ndarray.py maximum/minimum/power/equal/...), defined above the
# generated wrappers: array (+) array goes to the broadcast op, array (+)
# scalar to the _*_scalar op, scalar (+) array to the reflected scalar op,
# scalar (+) scalar to plain Python.
PUBLIC_BINARY_HELPERS = {
    # public name: (array op, scalar op, reflected scalar op, py fallback)
    "add": ("broadcast_add", "_plus_scalar", "_plus_scalar",
            lambda a, b: a + b),
    "subtract": ("broadcast_sub", "_minus_scalar", "_rminus_scalar",
                 lambda a, b: a - b),
    "multiply": ("broadcast_mul", "_mul_scalar", "_mul_scalar",
                 lambda a, b: a * b),
    "divide": ("broadcast_div", "_div_scalar", "_rdiv_scalar",
               lambda a, b: a / b),
    "modulo": ("broadcast_mod", "_mod_scalar", "_rmod_scalar",
               lambda a, b: a % b),
    "power": ("broadcast_power", "_power_scalar", "_rpower_scalar",
              lambda a, b: a ** b),
    "maximum": ("broadcast_maximum", "_maximum_scalar", "_maximum_scalar",
                max),
    "minimum": ("broadcast_minimum", "_minimum_scalar", "_minimum_scalar",
                min),
    "equal": ("broadcast_equal", "_equal_scalar", "_equal_scalar",
              lambda a, b: float(a == b)),
    "not_equal": ("broadcast_not_equal", "_not_equal_scalar",
                  "_not_equal_scalar", lambda a, b: float(a != b)),
    "greater": ("broadcast_greater", "_greater_scalar", "_lesser_scalar",
                lambda a, b: float(a > b)),
    "greater_equal": ("broadcast_greater_equal", "_greater_equal_scalar",
                      "_lesser_equal_scalar", lambda a, b: float(a >= b)),
    "lesser": ("broadcast_lesser", "_lesser_scalar", "_greater_scalar",
               lambda a, b: float(a < b)),
    "lesser_equal": ("broadcast_lesser_equal", "_lesser_equal_scalar",
                     "_greater_equal_scalar", lambda a, b: float(a <= b)),
    "logical_and": ("broadcast_logical_and", "_logical_and_scalar",
                    "_logical_and_scalar",
                    lambda a, b: float(bool(a) and bool(b))),
    "logical_or": ("broadcast_logical_or", "_logical_or_scalar",
                   "_logical_or_scalar",
                   lambda a, b: float(bool(a) or bool(b))),
    "logical_xor": ("broadcast_logical_xor", "_logical_xor_scalar",
                    "_logical_xor_scalar",
                    lambda a, b: float(bool(a) != bool(b))),
    "hypot": ("broadcast_hypot", "_hypot_scalar", "_hypot_scalar",
              lambda a, b: (a * a + b * b) ** 0.5),
}


def install_binary_helpers(module):
    """Install the public scalar-or-array binary helpers onto a generated
    namespace, which must already carry the broadcast ops and an
    ``_internal`` submodule with the scalar ops."""
    internal = module._internal

    def make(pub, array_name, scalar_name, rscalar_name, py_fallback):
        arr_fn = getattr(module, array_name)
        sc_fn = getattr(internal, scalar_name)
        rsc_fn = getattr(internal, rscalar_name)

        def helper(lhs, rhs):
            # numpy scalars (arr.max(), np.float32) count as scalars, like
            # the reference's numeric_types
            scalar_types = (int, float, bool, _np.generic)
            lhs_scalar = isinstance(lhs, scalar_types)
            rhs_scalar = isinstance(rhs, scalar_types)
            if not lhs_scalar and not rhs_scalar:
                return arr_fn(lhs, rhs)
            if not lhs_scalar:
                return sc_fn(lhs, scalar=float(rhs))
            if not rhs_scalar:
                return rsc_fn(rhs, scalar=float(lhs))
            return py_fallback(lhs, rhs)
        helper.__name__ = pub
        helper.__doc__ = (f"Scalar-or-array {pub} (ref: python/mxnet/"
                          f"ndarray/ndarray.py {pub})")
        return helper

    for pub, (a, s, r, py) in PUBLIC_BINARY_HELPERS.items():
        if not hasattr(module, pub):
            setattr(module, pub, make(pub, a, s, r, py))

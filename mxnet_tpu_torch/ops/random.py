"""Random samplers (counterpart of ``mxnet_tpu/ops/random.py``, ref
``src/operator/random/``).

Every draw comes from the explicit ``torch.Generator`` the dispatch
passes as ``generator=``: the device's generator of ``mx.random``
(``sampler_generator``), seeded by ``mx.random.seed``, never torch's
global one. Two families, as in MXNet: ``_random_*`` take fixed
parameters and a ``shape``; ``_sample_*`` take their parameters as
arrays, one distribution per element, with ``shape`` appending draw
axes. The values cannot equal the JAX package's (threefry against
Philox); the distributions, shapes and dtypes do. As in the JAX package,
every sampler returns float32 unless ``dtype`` says otherwise
(``_random_randint`` too), and ``_sample_multinomial`` int32.
"""
from __future__ import annotations

import torch

from ..base import jax_dtype
from .registry import OpParam, register


def _gamma(alpha, generator):
    """Gamma(alpha, 1) draws of ``alpha``'s shape (float32)."""
    return torch._standard_gamma(alpha, generator=generator)


def _poisson(rate, generator):
    return torch.poisson(rate, generator=generator)


def _shape_dtype_params():
    # ctx passes through uncoerced; the dispatch resolves it to the
    # device the sampler draws on
    return [OpParam("shape", tuple, None), OpParam("dtype", str, "float32"),
            OpParam("ctx", None, None)]


def _creation(name, draw, extra_params, doc=""):
    def impl(generator=None, shape=None, dtype="float32", ctx=None, **kw):
        shape = tuple(shape) if shape is not None else (1,)
        return draw(generator, shape, ctx, **kw).to(jax_dtype(dtype))

    register(name, num_inputs=0, params=extra_params + _shape_dtype_params(),
             differentiable=False, needs_rng=True,
             doc=doc or f"{name} sampler (ref: src/operator/random/"
                        "sample_op.cc)")(impl)


def _uniform(g, shape, dev, low=0.0, high=1.0):
    return torch.rand(shape, generator=g, device=dev) * (high - low) + low


def _normal(g, shape, dev, loc=0.0, scale=1.0):
    return torch.randn(shape, generator=g, device=dev) * scale + loc


def _gamma_draw(g, shape, dev, alpha=1.0, beta=1.0):
    return _gamma(torch.full(shape, float(alpha), device=dev), g) * beta


def _exponential(g, shape, dev, lam=1.0):
    return torch.empty(shape, device=dev).exponential_(generator=g) / lam


def _poisson_draw(g, shape, dev, lam=1.0):
    return _poisson(torch.full(shape, float(lam), device=dev), g)


def _randint(g, shape, dev, low=0, high=1):
    return torch.randint(int(low), int(high), shape, generator=g, device=dev)


def _negative_binomial(g, shape, dev, k=1, p=1.0):
    rate = _gamma(torch.full(shape, float(k), device=dev), g) \
        * ((1.0 - p) / max(p, 1e-12))
    return _poisson(rate, g)


def _gen_negative_binomial(g, shape, dev, mu=1.0, alpha=1.0):
    if alpha > 1e-12:
        rate = _gamma(torch.full(shape, 1.0 / alpha, device=dev), g) \
            * (mu * alpha)
    else:
        rate = torch.full(shape, float(mu), device=dev)
    return _poisson(rate, g)


_creation("_random_uniform", _uniform,
          [OpParam("low", float, 0.0), OpParam("high", float, 1.0)],
          doc="Uniform[low, high) (ref: sample_op.cc _random_uniform)")
_creation("_random_normal", _normal,
          [OpParam("loc", float, 0.0), OpParam("scale", float, 1.0)],
          doc="Normal(loc, scale) (ref: sample_op.cc _random_normal)")
_creation("_random_gamma", _gamma_draw,
          [OpParam("alpha", float, 1.0), OpParam("beta", float, 1.0)])
_creation("_random_exponential", _exponential, [OpParam("lam", float, 1.0)])
_creation("_random_poisson", _poisson_draw, [OpParam("lam", float, 1.0)])
_creation("_random_randint", _randint,
          [OpParam("low", int, 0), OpParam("high", int, 1)])
_creation("_random_negative_binomial", _negative_binomial,
          [OpParam("k", int, 1), OpParam("p", float, 1.0)],
          doc="NegativeBinomial(k, p) as the gamma-Poisson mixture "
              "(ref: sample_op.cc _random_negative_binomial)")
_creation("_random_generalized_negative_binomial", _gen_negative_binomial,
          [OpParam("mu", float, 1.0), OpParam("alpha", float, 1.0)],
          doc="GeneralizedNegativeBinomial(mu, alpha): mean mu, dispersion "
              "alpha; alpha -> 0 is Poisson(mu)")
_creation("_random_bernoulli",
          lambda g, shape, dev, p=0.5:
          torch.rand(shape, generator=g, device=dev) < p,
          [OpParam("p", float, 0.5)], doc="Bernoulli(p)")


def _per_elem(name, draw, n_in, doc):
    """``_sample_*``: one distribution per element of the parameter
    arrays; ``shape`` appends draw axes."""
    def impl(*args, generator=None, shape=None, dtype=None):
        extra = tuple(shape) if shape else ()
        out_shape = tuple(args[0].shape) + extra
        bargs = [a.reshape(tuple(a.shape) + (1,) * len(extra)).float()
                 .expand(out_shape) for a in args]
        return draw(generator, *bargs).to(jax_dtype(dtype or "float32"))

    register(name, num_inputs=n_in, needs_rng=True, differentiable=False,
             params=[OpParam("shape", tuple, None),
                     OpParam("dtype", str, None)], doc=doc)(impl)


_per_elem("_sample_uniform",
          lambda g, low, high: low + torch.rand(
              low.shape, generator=g, device=low.device) * (high - low), 2,
          "Per-element Uniform(low, high) (ref: multisample_op.cc)")
_per_elem("_sample_normal",
          lambda g, mu, sigma: mu + torch.randn(
              mu.shape, generator=g, device=mu.device) * sigma, 2,
          "Per-element Normal(mu, sigma) (ref: multisample_op.cc)")
_per_elem("_sample_gamma",
          lambda g, alpha, beta: _gamma(alpha.contiguous(), g) * beta, 2,
          "Per-element Gamma(alpha, beta) (ref: multisample_op.cc)")
_per_elem("_sample_exponential",
          lambda g, lam: torch.empty(lam.shape, device=lam.device)
          .exponential_(generator=g) / lam, 1,
          "Per-element Exponential(lam) (ref: multisample_op.cc)")
_per_elem("_sample_poisson",
          lambda g, lam: _poisson(lam.contiguous(), g), 1,
          "Per-element Poisson(lam) (ref: multisample_op.cc)")
_per_elem("_sample_negative_binomial",
          lambda g, k, p: _poisson(
              _gamma(torch.clamp(k, min=1e-6).contiguous(), g)
              * ((1.0 - p) / torch.clamp(p, min=1e-12)), g), 2,
          "Per-element NegativeBinomial(k, p), the gamma-Poisson mixture")
_per_elem("_sample_generalized_negative_binomial",
          lambda g, mu, alpha: _poisson(torch.where(
              alpha > 1e-12,
              _gamma((1.0 / torch.clamp(alpha, min=1e-12)).contiguous(), g)
              * (mu * alpha), mu), g), 2,
          "Per-element GeneralizedNegativeBinomial(mu, alpha)")


@register("_sample_multinomial", num_inputs=1, needs_rng=True,
          differentiable=False,
          params=[OpParam("shape", tuple, None),
                  OpParam("get_prob", bool, False),
                  OpParam("dtype", str, "int32")],
          doc="Categorical draws from probability rows (last axis); "
              "``get_prob`` is accepted and not read, as in the JAX op "
              "(ref: sample_multinomial_op.cc)")
def _sample_multinomial(probs, generator=None, shape=None, get_prob=False,
                        dtype="int32"):
    n = int(shape[0]) if shape else 1
    rows = probs.reshape(-1, probs.shape[-1]).float()
    rows = torch.clamp(rows, min=0)
    draws = torch.multinomial(rows, n, replacement=True, generator=generator)
    out = draws.reshape(tuple(probs.shape[:-1]) + (n,))
    if not shape:
        out = out[..., 0]
    return out.to(jax_dtype(dtype))


@register("_shuffle", needs_rng=True, differentiable=False,
          doc="Shuffle along the first axis (ref: shuffle_op.cc)")
def _shuffle(x, generator=None):
    perm = torch.randperm(x.shape[0], generator=generator, device=x.device)
    return x[perm]


@register("_sample_dirichlet", num_inputs=1, needs_rng=True,
          differentiable=False,
          params=[OpParam("shape", tuple, None),
                  OpParam("dtype", str, "float32")],
          doc="Dirichlet(alpha) over the last axis of alpha (..., K): "
              "normalized gamma draws; ``shape`` axes go before K")
def _sample_dirichlet(alpha, generator=None, shape=None, dtype="float32"):
    extra = tuple(shape) if shape else ()
    out_shape = tuple(alpha.shape[:-1]) + extra + tuple(alpha.shape[-1:])
    a = alpha.reshape(tuple(alpha.shape[:-1]) + (1,) * len(extra)
                      + tuple(alpha.shape[-1:])).float()
    g = _gamma(a.expand(out_shape).contiguous(), generator)
    return (g / torch.sum(g, dim=-1, keepdim=True)).to(jax_dtype(dtype))

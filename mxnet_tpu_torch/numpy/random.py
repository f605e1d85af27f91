"""``mx.np.random`` (counterpart of the JAX package's ``mx.np.random``,
ref ``numpy.random``'s stateful API): draws from the device's generator
of ``mx.random`` (``mx.random.seed`` reproduces them), NumPy's
parameterizations (pareto is Lomax, geometric counts trials from 1,
power is ``U ** (1 / a)``), integer draws int32. A draw records nothing:
samplers are not differentiated."""
from __future__ import annotations

import math

import torch

from .. import random as _mx_random
from ..base import as_torch_dtype
from . import _a, _call, _device

__all__ = ["uniform", "normal", "randint", "rand", "randn", "choice",
           "shuffle", "permutation", "seed", "exponential", "gamma", "beta",
           "dirichlet", "gumbel", "laplace", "logistic", "lognormal",
           "poisson", "chisquare", "f", "geometric", "pareto", "power",
           "rayleigh", "weibull", "binomial", "negative_binomial",
           "multivariate_normal", "multinomial"]

_EPS = 1e-12


def _gen():
    return _mx_random.sampler_generator(_device())


def _size(size):
    if size is None:
        return ()
    return (int(size),) if isinstance(size, int) else tuple(size)


def _u(shape):
    return torch.rand(shape, generator=_gen(), device=_device())


def _u01(shape):
    """Uniform on the open interval (0, 1): log and 1/U stay finite."""
    return torch.clamp(_u(shape), _EPS, 1.0 - _EPS)


def _f(x):
    return _a(x).to(torch.float32)


def _gamma_draw(alpha, shape):
    a = torch.broadcast_to(_f(alpha), shape).contiguous()
    return torch._standard_gamma(a, generator=_gen())


def _shape_of(size, *params):
    s = _size(size)
    if s:
        return s
    return tuple(torch.broadcast_shapes(*[_a(p).shape for p in params])) \
        if params else ()


def _sampler(name, draw, n_params=0):
    def run(*args, size=None, dtype=None, ctx=None, **kwargs):
        def inner(*a, **k):
            with torch.no_grad():
                out = draw(size, *a, **k)
            return out if dtype is None else out.to(as_torch_dtype(dtype))
        return _call(inner, *args, ctx=ctx, **kwargs)
    run.__name__ = name
    return run


uniform = _sampler("uniform", lambda size, low=0.0, high=1.0: _u(
    _shape_of(size, low, high)) * (_f(high) - _f(low)) + _f(low))
normal = _sampler("normal", lambda size, loc=0.0, scale=1.0: torch.randn(
    _shape_of(size, loc, scale), generator=_gen(), device=_device())
    * _f(scale) + _f(loc))


def _randint(size, low, high=None):
    lo, hi = (0, low) if high is None else (low, high)
    return torch.randint(int(lo), int(hi), _size(size), generator=_gen(),
                         device=_device(), dtype=torch.int64)


randint = _sampler("randint", _randint)


def rand(*shape):
    return uniform(size=shape)


def randn(*shape):
    return normal(size=shape)


def _choice(size, a, replace=True, p=None):
    pool = torch.arange(int(a), device=_device()) if isinstance(a, int) \
        else _a(a)
    n = pool.shape[0]
    k = math.prod(_size(size)) if size is not None else 1
    if p is None:
        if replace:
            idx = torch.randint(0, n, (k,), generator=_gen(),
                                device=_device())
        else:
            idx = torch.randperm(n, generator=_gen(), device=_device())[:k]
    else:
        idx = torch.multinomial(_f(p), k, replacement=replace,
                                generator=_gen())
    out = pool[idx]
    return out.reshape(_size(size) + tuple(pool.shape[1:])) \
        if size is not None else out[0]


choice = _sampler("choice", _choice)


def shuffle(x):
    """Permute ``x`` (an NDArray) along its first axis in place."""
    t = x._data
    perm = torch.randperm(t.shape[0], generator=_mx_random.sampler_generator(
        t.device), device=t.device)
    with torch.no_grad():
        t.copy_(t[perm])


def _permutation(size, x):
    if isinstance(x, int):
        return torch.randperm(x, generator=_gen(), device=_device())
    t = _a(x)
    return t[torch.randperm(t.shape[0], generator=_gen(), device=t.device)]


permutation = _sampler("permutation", _permutation)


def seed(s):
    _mx_random.seed(s)


exponential = _sampler("exponential", lambda size, scale=1.0: -torch.log(
    _u01(_shape_of(size, scale))) * _f(scale))
gamma = _sampler("gamma", lambda size, shape, scale=1.0: _gamma_draw(
    shape, _shape_of(size, shape, scale)) * _f(scale))


def _beta(size, a, b):
    s = _shape_of(size, a, b)
    x, y = _gamma_draw(a, s), _gamma_draw(b, s)
    return x / (x + y)


beta = _sampler("beta", _beta)


def _dirichlet(size, alpha):
    al = _f(alpha)
    g = _gamma_draw(al, _size(size) + tuple(al.shape))
    return g / g.sum(-1, keepdim=True)


dirichlet = _sampler("dirichlet", _dirichlet)
gumbel = _sampler("gumbel", lambda size, loc=0.0, scale=1.0: _f(loc) - _f(
    scale) * torch.log(-torch.log(_u01(_shape_of(size, loc, scale)))))


def _laplace(size, loc=0.0, scale=1.0):
    u = _u01(_shape_of(size, loc, scale)) - 0.5
    return _f(loc) - _f(scale) * torch.sign(u) * torch.log1p(
        -2.0 * torch.abs(u))


laplace = _sampler("laplace", _laplace)


def _logistic(size, loc=0.0, scale=1.0):
    u = _u01(_shape_of(size, loc, scale))
    return _f(loc) + _f(scale) * torch.log(u / (1.0 - u))


logistic = _sampler("logistic", _logistic)
lognormal = _sampler("lognormal", lambda size, mean=0.0, sigma=1.0:
                     torch.exp(torch.randn(_shape_of(size, mean, sigma),
                                           generator=_gen(),
                                           device=_device()) * _f(sigma)
                               + _f(mean)))
poisson = _sampler("poisson", lambda size, lam=1.0: torch.poisson(
    torch.broadcast_to(_f(lam), _shape_of(size, lam)).contiguous(),
    generator=_gen()).to(torch.int32))
chisquare = _sampler("chisquare", lambda size, df: 2.0 * _gamma_draw(
    _f(df) / 2.0, _shape_of(size, df)))


def _fdist(size, dfnum, dfden):
    s = _shape_of(size, dfnum, dfden)
    x = 2.0 * _gamma_draw(_f(dfnum) / 2.0, s) / _f(dfnum)
    y = 2.0 * _gamma_draw(_f(dfden) / 2.0, s) / _f(dfden)
    return x / y


f = _sampler("f", _fdist)
geometric = _sampler("geometric", lambda size, p: (torch.floor(
    torch.log(_u01(_shape_of(size, p)))
    / torch.log1p(-torch.clamp(_f(p), _EPS, 1.0 - _EPS))) + 1.0)
    .to(torch.int32))
pareto = _sampler("pareto", lambda size, a: torch.pow(
    _u01(_shape_of(size, a)), -1.0 / _f(a)) - 1.0)
power = _sampler("power", lambda size, a: torch.pow(
    _u01(_shape_of(size, a)), 1.0 / _f(a)))
rayleigh = _sampler("rayleigh", lambda size, scale=1.0: _f(scale)
                    * torch.sqrt(-2.0 * torch.log(_u01(_shape_of(size,
                                                                 scale)))))
weibull = _sampler("weibull", lambda size, a: torch.pow(
    -torch.log(_u01(_shape_of(size, a))), 1.0 / _f(a)))


def _binomial(size, n, p):
    s = _shape_of(size, n, p)
    return torch.binomial(torch.broadcast_to(_f(n), s).contiguous(),
                          torch.broadcast_to(torch.clamp(_f(p), 0.0, 1.0),
                                             s).contiguous(),
                          generator=_gen()).to(torch.int32)


binomial = _sampler("binomial", _binomial)


def _negative_binomial(size, n, p):
    s = _shape_of(size, n, p)
    p = _f(p)
    rate = _gamma_draw(n, s) * ((1.0 - p) / torch.clamp(p, min=_EPS))
    return torch.poisson(rate, generator=_gen())


negative_binomial = _sampler("negative_binomial", _negative_binomial)


def _multivariate_normal(size, mean, cov, **kw):
    mean, cov = _f(mean), _f(cov)
    chol = torch.linalg.cholesky(cov)
    z = torch.randn(_size(size) + tuple(mean.shape), generator=_gen(),
                    device=_device())
    return mean + z @ chol.T


multivariate_normal = _sampler("multivariate_normal", _multivariate_normal)


def multinomial(n, pvals, size=None):
    """numpy.random.multinomial: the counts of ``n`` draws over
    ``pvals``, int32."""
    def run(pv):
        p = _f(pv)
        shape = _size(size)
        k = p.shape[-1]
        rows = math.prod(shape) if shape else 1
        draws = torch.multinomial(p.expand(rows, k), int(n),
                                  replacement=True, generator=_gen())
        counts = torch.zeros(rows, k, dtype=torch.int64, device=p.device)
        counts.scatter_add_(1, draws, torch.ones_like(draws))
        return counts.reshape(shape + (k,))
    return _call(run, pvals)

"""The port's samplers (``mx.nd.random``, ``mx.nd.sample_*``,
``mx.random``) on the CPU: shape, dtype and support of every sampler,
the draws reproduced by ``mx.random.seed``, and their moments against
the analytic ones within the thresholds ``tests/test_random_samplers.py``
holds the JAX package's samplers to (the same thresholds, scaled the
same way, for the samplers that file does not cover; the table is
``tools/nd_op_cases.py``'s, which ``chip_smoke.py`` phase 28 shares).
The values cannot equal the JAX package's (threefry against Philox);
their shapes and dtypes are held to the JAX ops' in
``test_torch_nd_ops.py``."""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from tools.nd_op_cases import (N_DRAWS, SAMPLER_MOMENTS, draw_sampler,
                               moments_ok)

CPU = tmx.cpu()
nd = tmx.nd


@pytest.fixture(autouse=True)
def _seed():
    tmx.random.seed(42)


@pytest.mark.parametrize("name", sorted(SAMPLER_MOMENTS))
def test_sampler_moments_and_support(name):
    """The sampler's N draws on the CPU: an NDArray of float32 (int32 for
    the multinomial), its mean and variance within the thresholds."""
    x = draw_sampler(nd, name, CPU)
    assert isinstance(x, nd.NDArray) and x.shape == (N_DRAWS,) \
        and x.ctx == CPU
    want_dtype = np.int32 if name == "sample_multinomial" else np.float32
    assert x.dtype == want_dtype
    ok, mean, var = moments_ok(name, x.asnumpy())
    assert ok, (name, mean, var)


def test_per_element_parameters_and_shape():
    """Each element's row draws from its own parameters; ``shape``
    appends draw axes (as tests/test_random_samplers.py asks of the JAX
    package)."""
    lam = nd.array(np.array([0.5, 50.0], np.float32), ctx=CPU)
    draws = nd.sample_poisson(lam, shape=(2000,))
    assert draws.shape == (2, 2000)
    m = draws.asnumpy().mean(axis=1)
    assert abs(m[0] - 0.5) < 0.2 and abs(m[1] - 50.0) < 2.0
    alpha = nd.array(np.array([1.0, 20.0], np.float32), ctx=CPU)
    beta = nd.array(np.array([1.0, 1.0], np.float32), ctx=CPU)
    gm = nd.sample_gamma(alpha, beta, shape=(2000,)).asnumpy().mean(axis=1)
    assert abs(gm[0] - 1.0) < 0.25 and abs(gm[1] - 20.0) < 2.0


def test_dirichlet():
    alpha = nd.array(np.array([[1.0, 2.0, 3.0], [10.0, 10.0, 10.0]],
                              np.float32), ctx=CPU)
    d = nd.sample_dirichlet(alpha, shape=(500,))
    assert d.shape == (2, 500, 3)
    a = d.asnumpy()
    np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-5)
    assert (a >= 0).all()
    np.testing.assert_allclose(a[0].mean(0), [1 / 6, 2 / 6, 3 / 6],
                               atol=0.06)
    np.testing.assert_allclose(a[1].mean(0), [1 / 3, 1 / 3, 1 / 3],
                               atol=0.03)


def test_shuffle_is_a_permutation_of_rows():
    x = nd.array(np.arange(12, dtype=np.float32).reshape(6, 2), ctx=CPU)
    y = nd.random.shuffle(x).asnumpy()
    assert sorted(map(tuple, y)) == sorted(map(tuple, x.asnumpy()))
    assert (y != x.asnumpy()).any()


@pytest.mark.parametrize("name", ["uniform", "normal", "gamma", "poisson",
                                  "sample_gamma", "sample_multinomial",
                                  "bernoulli"])
def test_seed_reproduces_the_draws(name):
    tmx.random.seed(7)
    a = draw_sampler(nd, name, CPU).asnumpy()
    tmx.random.seed(7)
    b = draw_sampler(nd, name, CPU).asnumpy()
    c = draw_sampler(nd, name, CPU).asnumpy()
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_draws_come_from_the_device_generator_not_torch_global():
    """A sampler advances ``mx.random.device_generator(device)`` and
    leaves torch's global generator alone."""
    g = tmx.random.device_generator("cpu")
    before_g, before_global = g.get_state(), torch.get_rng_state()
    nd.random.uniform(shape=(4,), ctx=CPU)
    assert not torch.equal(g.get_state(), before_g)
    assert torch.equal(torch.get_rng_state(), before_global)


def test_mx_random_forwards_to_nd_random():
    tmx.random.seed(3)
    a = tmx.random.uniform(0, 1, shape=(5,), ctx=CPU).asnumpy()
    tmx.random.seed(3)
    b = nd.random.uniform(0, 1, shape=(5,), ctx=CPU).asnumpy()
    np.testing.assert_array_equal(a, b)
    r = tmx.random.randn(2, 3, ctx=CPU)
    assert r.shape == (2, 3) and r.dtype == np.float32
    for fn, kw in ((tmx.random.normal, {}), (tmx.random.gamma, {}),
                   (tmx.random.exponential, {}), (tmx.random.poisson, {}),
                   (tmx.random.negative_binomial, {}),
                   (tmx.random.generalized_negative_binomial, {}),
                   (tmx.random.randint, {"low": 0, "high": 3}),
                   (tmx.random.bernoulli, {})):
        out = fn(shape=(3,), ctx=CPU, **kw)
        assert isinstance(out, nd.NDArray) and out.shape == (3,)
    probs = nd.array([[0.5, 0.5]], ctx=CPU)
    assert tmx.random.multinomial(probs, shape=(4,)).shape == (1, 4)
    assert tmx.random.shuffle(nd.arange(4, ctx=CPU)).shape == (4,)


def test_no_ctx_means_the_card():
    """A sampler with no array input and no ctx targets cuda:0 and raises
    without a card (never carries on on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(MXNetError, match="no CUDA device"):
        nd.random.uniform(shape=(2,))

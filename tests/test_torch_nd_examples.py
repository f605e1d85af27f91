"""examples/train_dcgan.py's and train_vae.py's training loops, written
once against the ``mx`` API and run with the JAX package and with the
port on the CPU (the port inside ``with mx.cpu():``, the loops' text
otherwise the examples'): both from the same weights (the port's seeded
Xavier weights carried into the JAX blocks), the same numpy batches, no
dropout, hybridized as the examples hybridize. The losses of every step
agree within 1e-5 relative. The blocks are the examples' (the port's
built as ``test_torch_gluon_layers.py`` builds them); the generator's
``HybridLambda(lambda F, x: F.reshape(...))`` runs with ``F = mx.nd``."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_gluon_layers import (_PortVAE, _example, _port_discriminator,
                                     _port_generator)
from torch_parity import carry_block

RTOL = 1e-5
BATCH, NZ, STEPS = 8, 16, 3


def dcgan_loop(mx, gen, dis, batches):
    """train_dcgan.py's loop body, one (D, G) step per batch."""
    gt = mx.gluon.Trainer(gen.collect_params(), "adam",
                          {"learning_rate": 2e-3, "beta1": 0.5})
    dt = mx.gluon.Trainer(dis.collect_params(), "adam",
                          {"learning_rate": 2e-3, "beta1": 0.5})
    bce = mx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    ones = mx.nd.ones((BATCH,))
    zeros = mx.nd.zeros((BATCH,))
    losses = []
    for real_np, z_np in batches:
        real = mx.nd.array(real_np)
        z = mx.nd.array(z_np)
        fake = gen(z).detach()
        with mx.autograd.record():
            d_loss = (bce(dis(real).reshape(-1), ones)
                      + bce(dis(fake).reshape(-1), zeros)).mean()
        d_loss.backward()
        dt.step(BATCH)
        with mx.autograd.record():
            g_loss = bce(dis(gen(z)).reshape(-1), ones).mean()
        g_loss.backward()
        gt.step(BATCH)
        losses.append((float(d_loss.asscalar()), float(g_loss.asscalar())))
    return losses


def vae_loop(mx, net, batches, kl_weight=5e-3):
    """train_vae.py's loop body, one step per batch."""
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 2e-3})
    losses = []
    for x_np, eps_np in batches:
        x = mx.nd.array(x_np)
        eps = mx.nd.array(eps_np)
        with mx.autograd.record():
            xh, mu, logvar = net(x, eps)
            rec_l = ((xh - x) ** 2).mean()
            kl_l = (-0.5 * (1 + logvar - mu * mu -
                            mx.nd.exp(logvar))).sum(axis=1).mean()
            loss = rec_l + kl_weight * kl_l
        loss.backward()
        trainer.step(BATCH)
        losses.append((float(rec_l.asscalar()), float(kl_l.asscalar())))
    return losses


def _batches(nz):
    ex = _example("train_dcgan")
    rng = np.random.RandomState(0)
    return [(ex.real_batch(rng, BATCH),
             rng.randn(BATCH, nz).astype(np.float32)) for _ in range(STEPS)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=0)


def test_dcgan_loop_matches_jax():
    ex = _example("train_dcgan")
    jgen, jdis = ex.build_generator(), ex.build_discriminator()
    tgen, tdis = _port_generator(), _port_discriminator()
    carry_block(jgen, tgen, [np.zeros((BATCH, NZ), np.float32)], scale=0.05)
    carry_block(jdis, tdis, [np.zeros((BATCH, 1, 16, 16), np.float32)],
                seed=1, scale=0.05)
    for net in (jgen, jdis, tgen, tdis):
        net.hybridize()
    batches = _batches(NZ)
    want = dcgan_loop(jmx, jgen, jdis, batches)
    with tmx.cpu():
        got = dcgan_loop(tmx, tgen, tdis, batches)
    _close(got, want)
    assert all(np.isfinite(got).ravel())


def test_vae_loop_matches_jax():
    ex = _example("train_vae")
    jnet, tnet = ex.VAE(), _PortVAE()
    carry_block(jnet, tnet, [np.zeros((BATCH, 1, 16, 16), np.float32),
                             np.zeros((BATCH, 8), np.float32)])
    jnet.hybridize()
    tnet.hybridize()
    batches = [(x, np.random.RandomState(i).randn(BATCH, 8).astype(
        np.float32)) for i, (x, _) in enumerate(_batches(NZ))]
    want = vae_loop(jmx, jnet, batches)
    with tmx.cpu():
        got = vae_loop(tmx, tnet, batches)
    _close(got, want)


def test_hybrid_lambda_gets_mx_nd():
    seen = []
    lam = tmx.gluon.nn.HybridLambda(
        lambda F, x: seen.append(F) or F.reshape(x, (-1, 2, 2)))
    out = lam(tmx.nd.arange(8, ctx=tmx.cpu()))
    assert seen == [tmx.nd] and out.shape == (2, 2, 2)
    with pytest.raises(tmx.MXNetError, match="item 10"):
        tmx.gluon.nn.Lambda("MultiBoxPrior")

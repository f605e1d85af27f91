"""ResNet V1 in the port (mxnet_tpu_torch/gluon) against the JAX package
with carried weights, on the CPU.

Predict-mode logits agree at atol = rtol = 1e-4: looser than one op's
1e-5 because the convolutions sum in another order across ~20 layers.
The full-width ResNet-50 v1's parameter names and shapes equal the JAX
structural names, so a JAX checkpoint loads as it is."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import DeferredInitializationError
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as torch_resnet

from torch_parity import carry, logits, narrow_pair


def _batch(seed, n=3, size=32):
    return np.random.RandomState(seed).randn(n, 3, size, size) \
        .astype(np.float32)


def test_narrow_bottleneck_resnet_matches_jax():
    jnet, tnet = narrow_pair(seed=0)
    got, want = logits(jnet, tnet, _batch(1))
    assert got.shape == (3, 10)
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_resnet18_thumbnail_matches_jax():
    jnet, tnet = carry(jax_resnet.resnet18_v1(thumbnail=True, classes=10),
                       torch_resnet.resnet18_v1(thumbnail=True, classes=10),
                       seed=2, in_shape=(2, 3, 32, 32))
    got, want = logits(jnet, tnet, _batch(3, n=2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_resnet50_names_and_shapes_equal_jax_structural_names():
    jnet = jax_resnet.resnet50_v1()
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jnet(jmx.nd.array(np.zeros((1, 3, 32, 32), np.float32)))
    want = {k: tuple(p.shape) for k, p in jnet._structural_names().items()}
    tnet = torch_resnet.resnet50_v1()
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu(),
                    generator=tmx.random.generator(0))
    with torch.inference_mode():
        out = tnet(torch.zeros(1, 3, 32, 32))
    assert tuple(out.shape) == (1, 1000)
    got = {k: tuple(v.shape) for k, v in tnet.state_dict().items()}
    assert got == want
    assert list(tnet.collect_params()) == list(tnet.state_dict())
    assert "features.4.0.body.1.gamma" in got
    assert "features.7.2.body.5.running_var" in got


def test_initialize_is_seeded_and_forward_needs_it():
    nets = []
    for _ in range(2):
        net = torch_resnet.resnet18_v1(thumbnail=True, classes=4)
        net.initialize(tmx.init.Xavier(), ctx=tmx.cpu(),
                       generator=tmx.random.generator(7))
        with torch.inference_mode():
            net(torch.zeros(1, 3, 8, 8))
        nets.append(net.state_dict())
    for k in nets[0]:
        torch.testing.assert_close(nets[0][k], nets[1][k], rtol=0, atol=0)
    assert float(nets[0]["features.1.0.body.1.gamma"].min()) == 1.0
    with pytest.raises(DeferredInitializationError):
        torch_resnet.resnet18_v1(thumbnail=True)(torch.zeros(1, 3, 8, 8))


def test_load_jax_params_rejects_missing_extra_and_misshapen_keys():
    jnet, tnet = narrow_pair(seed=4)
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._structural_names().items()}
    fresh = lambda: torch_resnet.ResNetV1(  # noqa: E731
        torch_resnet.BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
        classes=10)
    missing = dict(arrays)
    missing.pop("output.bias")
    with pytest.raises(MXNetError, match="missing"):
        tmx.convert.load_jax_params(fresh(), missing, ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="extra"):
        tmx.convert.load_jax_params(fresh(), {**arrays, "x.weight": 0},
                                    ctx=tmx.cpu())
    bad = dict(arrays)
    bad["output.weight"] = np.zeros((10, 3), np.float32)
    with pytest.raises(MXNetError, match="output.weight"):
        tmx.convert.load_jax_params(tnet, bad)


def test_save_and_load_parameters_round_trip(tmp_path):
    _, tnet = narrow_pair(seed=5)
    path = str(tmp_path / "narrow.npz")
    tnet.save_parameters(path)
    other = torch_resnet.ResNetV1(torch_resnet.BottleneckV1,
                                  [1, 1, 1, 1], [8, 16, 32, 64, 128],
                                  classes=10)
    other.load_parameters(path, ctx=tmx.cpu())
    x = torch.from_numpy(_batch(6))
    with torch.inference_mode():
        torch.testing.assert_close(other(x), tnet(x), rtol=0, atol=0)


def test_training_mode_raises_until_the_training_slice():
    _, tnet = narrow_pair(seed=6)
    tnet.train()
    with pytest.raises(MXNetError, match="training branch"):
        tnet(torch.from_numpy(_batch(7)))

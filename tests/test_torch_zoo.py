"""The vision zoo of the port (mxnet_tpu_torch/gluon/model_zoo/vision:
ResNet V2, VGG, AlexNet, SqueezeNet, MobileNet V1 and V2, DenseNet,
Inception V3 and get_model) against the JAX package on the CPU.

Each family's predict-mode logits, at a narrow configuration where the
constructor allows one, with the same seeded weights and BatchNorm
statistics in both packages (``torch_parity.carry_block``; the JAX
forward jitted whole): atol = rtol = 1e-4, as
tests/test_torch_resnet.py holds ResNet V1 (the convolutions sum in
another order across tens of layers). Each full-width representative's
structural names and parameter shapes equal the JAX package's, the JAX
side read without a forward (a dimension it infers at the first forward
is 0 there and matches any)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

from torch_parity import carry_block, jitted_logits

NARROW_RESNET = ([1, 1, 1, 1], [8, 16, 32, 64, 128])

# family -> (factory from a vision namespace, batch, input size, input
# scale). SqueezeNet's and VGG's relus shrink Xavier-initialized
# activations by orders of magnitude; with zero biases each network is
# positively homogeneous, so a larger input scales its logits by as much.
NARROW = {
    "resnet_v2_basic": (lambda v: v.ResNetV2(
        v.BasicBlockV2, NARROW_RESNET[0], [8, 8, 16, 32, 64], classes=10),
        2, 32, 1.0),
    "resnet_v2_bottleneck": (lambda v: v.ResNetV2(
        v.BottleneckV2, *NARROW_RESNET, classes=10, thumbnail=True),
        2, 32, 1.0),
    "vgg11": (lambda v: v.vgg11(classes=10), 2, 32, 1e2),
    "alexnet": (lambda v: v.alexnet(classes=10), 2, 67, 1.0),
    "squeezenet1.1": (lambda v: v.squeezenet1_1(classes=10), 2, 64, 1e3),
    "mobilenet0.25": (lambda v: v.mobilenet0_25(classes=10), 2, 64, 1.0),
    "mobilenetv2_0.25": (lambda v: v.mobilenet_v2_0_25(classes=10), 2, 64,
                         1.0),
    "densenet_narrow": (lambda v: v.DenseNet(8, 4, (1, 1), classes=10), 1,
                        56, 1.0),
    "inceptionv3": (lambda v: v.inception_v3(classes=10), 1, 299, 1.0),
}


@pytest.mark.parametrize("family", sorted(NARROW))
def test_family_logits_match_jax(family):
    make, batch, size, scale = NARROW[family]
    shape = (batch, 3, size, size)
    jnet, tnet = make(jvision), make(tvision)
    carry_block(jnet, tnet, [np.zeros(shape, np.float32)], seed=3)
    x = np.random.RandomState(5).randn(*shape).astype(np.float32) * scale
    got, want = jitted_logits(jnet, tnet, x)
    assert got.shape == (batch, 10)
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# the full-width representative of each family, and the input size its
# port forward takes here (DenseNet's and Inception's own sizes: their
# last pools need them)
FULL = {"resnet50_v2": 32, "vgg16": 32, "alexnet": 67, "squeezenet1.1": 64,
        "mobilenet1.0": 32, "mobilenetv2_1.0": 32, "densenet121": 224,
        "inceptionv3": 299}


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_names_and_shapes_equal_jax(name):
    want = {k: tuple(p.shape) for k, p in
            jvision.get_model(name)._structural_names().items()}
    tnet = tvision.get_model(name)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu(),
                    generator=tmx.random.generator(0))
    size = FULL[name]
    with torch.inference_mode():
        out = tnet(torch.zeros(1, 3, size, size))
    assert tuple(out.shape) == (1, 1000)
    got = {k: tuple(v.shape) for k, v in tnet.state_dict().items()}
    assert sorted(got) == sorted(want)
    for key, shape in want.items():
        assert len(got[key]) == len(shape), key
        assert all(w in (0, g) for g, w in zip(got[key], shape)), \
            (key, got[key], shape)


def test_get_model_tables_and_errors_equal_jax():
    assert sorted(tvision._models) == sorted(jvision._models)
    assert len(tvision._models) == 34
    with pytest.raises(jmx.base.MXNetError) as jerr:
        jvision.get_model("resnet19_v3")
    with pytest.raises(MXNetError) as terr:
        tvision.get_model("ResNet19_v3")
    assert str(terr.value) == str(jerr.value)
    net = tvision.get_model("VGG16_BN", classes=7)
    assert isinstance(net, tvision.VGG) and net.output._units == 7


@pytest.mark.parametrize("name", ["resnet18_v2", "vgg11", "alexnet",
                                  "squeezenet1.0", "mobilenet0.5",
                                  "mobilenetv2_0.5", "densenet121",
                                  "inceptionv3"])
def test_pretrained_raises_as_jax(name):
    with pytest.raises(jmx.base.MXNetError):
        jvision.get_model(name, pretrained=True)
    with pytest.raises(MXNetError, match="pretrained"):
        tvision.get_model(name, pretrained=True)

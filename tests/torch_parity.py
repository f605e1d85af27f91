"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
build a network in the JAX package with seeded, non-trivial BatchNorm
statistics and carry its parameters into the same network of the port."""
import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jax_resnet
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as torch_resnet

NARROW = ([1, 1, 1, 1], [8, 16, 32, 64, 128])


def narrow_pair(seed=0, classes=10, in_shape=(3, 3, 32, 32)):
    """The narrow bottleneck ResNetV1 in both packages, same weights."""
    jnet = jax_resnet.ResNetV1(jax_resnet.BottleneckV1, *NARROW,
                               classes=classes)
    tnet = torch_resnet.ResNetV1(torch_resnet.BottleneckV1, *NARROW,
                                 classes=classes)
    return carry(jnet, tnet, seed, in_shape)


def carry(jnet, tnet, seed, in_shape):
    """Initialize ``jnet`` and infer its shapes on a batch of
    ``in_shape`` (test batches of that shape then reuse the compiled
    ops), give its BatchNorms seeded gamma, beta and running statistics,
    and load all of it into ``tnet`` on the CPU."""
    jnet.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    jnet(jmx.nd.array(np.zeros(in_shape, np.float32)))   # infer shapes
    rng = np.random.RandomState(seed)
    for name, param in jnet._structural_names().items():
        shape = param.shape
        if name.endswith("running_mean") or name.endswith("beta"):
            param.set_data(jmx.nd.array(rng.randn(*shape) * 0.1))
        elif name.endswith("running_var") or name.endswith("gamma"):
            param.set_data(jmx.nd.array(rng.rand(*shape) + 0.5))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._structural_names().items()}
    load_jax_params(tnet, arrays, ctx=tmx.cpu())
    return jnet, tnet


def logits(jnet, tnet, x):
    """Predict-mode outputs of both networks on the numpy batch ``x``."""
    want = jnet(jmx.nd.array(x)).asnumpy()
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    return got, want

"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): ``get_model(name)`` resolves any
of the 34 models by its reference name. Pretrained weights are not
bundled: ``pretrained=True`` raises; load a local file with
``load_parameters`` or ``convert.load_jax_params``."""
from __future__ import annotations

from ....base import MXNetError
from .alexnet import *           # noqa: F401,F403
from .densenet import *          # noqa: F401,F403
from .inception import *         # noqa: F401,F403
from .mobilenet import *         # noqa: F401,F403
from .resnet import *            # noqa: F401,F403
from .squeezenet import *        # noqa: F401,F403
from .vgg import *               # noqa: F401,F403
from .alexnet import __all__ as _alexnet_all
from .densenet import __all__ as _densenet_all
from .inception import __all__ as _inception_all
from .mobilenet import __all__ as _mobilenet_all
from .resnet import __all__ as _resnet_all
from .squeezenet import __all__ as _squeezenet_all
from .vgg import __all__ as _vgg_all

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn,
    "vgg16_bn": vgg16_bn, "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
}

__all__ = (["get_model"] + _alexnet_all + _densenet_all + _inception_all
           + _mobilenet_all + _resnet_all + _squeezenet_all + _vgg_all)


def get_model(name, **kwargs):
    """ref: model_zoo/__init__.py get_model — the model called ``name``
    (case-insensitive), built with ``kwargs``."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"model {name!r} is not in the zoo; "
                         f"options: {sorted(_models)}")
    return _models[name](**kwargs)

"""Vision model zoo of the port (parity:
mxnet_tpu/gluon/model_zoo/vision/): the ResNet v1 family."""
from .resnet import *  # noqa: F401,F403
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
}


def get_model(name, **kwargs):
    name = name.lower()
    if name not in _models:
        raise ValueError(
            "Model %s is not ported. Available options are\n\t%s" % (
                name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)

"""gluon.model_zoo.vision: the ResNet family so far (PyTorch counterpart
of ``mxnet_tpu/gluon/model_zoo/vision/``)."""
from . import resnet
from .resnet import *  # noqa: F401,F403
from .resnet import get_resnet

# the generated constructors (resnet18_v1 ...); get_resnet is a factory,
# not a model name
_models = {name: getattr(resnet, name) for name in resnet.__all__
           if name[0].islower() and not name.startswith("get_")}


def get_model(name, **kwargs):
    """Factory by model name (reference: model_zoo/vision/__init__.py)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)

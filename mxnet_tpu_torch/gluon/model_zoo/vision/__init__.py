"""gluon.model_zoo.vision: the ResNets and the non-residual families
(AlexNet, VGG, SqueezeNet, MobileNet v1/v2, DenseNet, Inception v3)
(PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/``)."""
from . import resnet, simple_nets
from .resnet import *  # noqa: F401,F403
from .resnet import get_resnet
from .simple_nets import *  # noqa: F401,F403

# the generated constructors (resnet18_v1, vgg16 ...); the get_* helpers
# are factories, not model names
_models = {}
for _mod in (resnet, simple_nets):
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        if callable(_obj) and _name[0].islower() \
                and not _name.startswith("get_"):
            _models[_name] = _obj

# the reference's model table spells these with dots / no underscore
_REFERENCE_ALIASES = {
    "squeezenet1.0": "squeezenet1_0", "squeezenet1.1": "squeezenet1_1",
    "inceptionv3": "inception_v3",
    "mobilenet1.0": "mobilenet1_0", "mobilenet0.75": "mobilenet0_75",
    "mobilenet0.5": "mobilenet0_5", "mobilenet0.25": "mobilenet0_25",
    "mobilenetv2_1.0": "mobilenet_v2_1_0",
    "mobilenetv2_0.75": "mobilenet_v2_0_75",
    "mobilenetv2_0.5": "mobilenet_v2_0_5",
    "mobilenetv2_0.25": "mobilenet_v2_0_25",
}
for _ref, _ours in _REFERENCE_ALIASES.items():
    _models[_ref] = _models[_ours]
del _mod, _name, _obj, _ref, _ours


def get_model(name, **kwargs):
    """Factory by model name (reference: model_zoo/vision/__init__.py)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)

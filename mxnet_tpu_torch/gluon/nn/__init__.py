"""gluon.nn: the layers the ResNet family needs (PyTorch counterpart of
``mxnet_tpu/gluon/nn/``)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from ..block import Block, HybridBlock  # noqa: F401

"""gluon.nn: the convolution, pooling and padding layers, activations,
normalizations, Dropout, Embedding and the container and lambda blocks
(PyTorch counterpart of ``mxnet_tpu/gluon/nn/``)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from ..block import Block, HybridBlock  # noqa: F401

"""``mx.contrib`` (PyTorch counterpart of ``mxnet_tpu/contrib/``): the int8
``quantization`` API and the ``ndarray`` and ``symbol`` namespaces of the
``_contrib_*`` ops; the rest of the reference's contrib namespace (text
embeddings, tensorboard, ONNX, contrib autograd and io) is ROADMAP.md
Queue 1, item 6h."""
from . import ndarray  # noqa: F401
from . import quantization  # noqa: F401
from . import symbol  # noqa: F401

__all__ = ["ndarray", "quantization", "symbol"]

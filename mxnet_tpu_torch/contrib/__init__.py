"""``mx.contrib`` (PyTorch counterpart of ``mxnet_tpu/contrib/``): the
int8 ``quantization`` API so far; the rest of the reference's contrib
namespace (text embeddings, tensorboard, ONNX, contrib autograd, io,
ndarray and symbol) is ROADMAP.md Queue 1, item 6h."""
from . import quantization  # noqa: F401

__all__ = ["quantization"]

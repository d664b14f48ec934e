"""Gluon (PyTorch counterpart of ``mxnet_tpu/gluon``): blocks as
``torch.nn.Module``s, parameters, the layers the ResNet family needs and
the model zoo's ResNets, the losses, ``Trainer``, ``data`` (datasets,
samplers, ``DataLoader``) and ``utils``.  Blocks called with ``NDArray``s
return NDArrays; called with ``torch.Tensor``s, tensors."""
from . import data, loss, model_zoo, nn, parameter, trainer, utils
from .block import Block, HybridBlock, params_from_jax
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer", "params_from_jax",
           "data", "loss", "model_zoo", "nn", "parameter", "trainer",
           "utils"]

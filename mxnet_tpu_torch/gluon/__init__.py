"""Gluon (PyTorch counterpart of ``mxnet_tpu/gluon``): blocks as
``torch.nn.Module``s, parameters, the layers the ResNet family needs and
the model zoo's ResNets, and the losses.  The surface takes and returns
``torch.Tensor``s for now; ``Trainer`` and the other layers come later."""
from . import loss, model_zoo, nn, parameter
from .block import Block, HybridBlock, params_from_jax
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "params_from_jax", "loss",
           "model_zoo", "nn", "parameter"]

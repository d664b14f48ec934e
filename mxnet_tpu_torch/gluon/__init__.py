"""Gluon (PyTorch counterpart of ``mxnet_tpu/gluon``): blocks as
``torch.nn.Module``s (``hybridize()`` runs them as cached programs,
captured as CUDA graphs on the card; ``SymbolBlock``, ``export``),
parameters, the ``nn`` layers and the model zoo, ``rnn`` (the fused
recurrent layers and the cells), the losses, ``Trainer``,
``data`` (datasets, samplers, ``DataLoader``), ``utils`` and
``contrib.nn``.  Blocks called with ``NDArray``s
return NDArrays; called with ``torch.Tensor``s, tensors."""
from . import data, loss, model_zoo, nn, parameter, rnn, trainer, utils
from . import contrib  # noqa: E402  (after nn)
from .block import Block, HybridBlock, SymbolBlock, params_from_jax
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer", "params_from_jax",
           "contrib", "data", "loss", "model_zoo", "nn", "parameter", "rnn",
           "trainer", "utils"]

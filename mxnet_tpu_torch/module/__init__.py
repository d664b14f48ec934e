"""``mx.mod``: the symbolic ``Module`` and its ``BaseModule`` (PyTorch
counterpart of ``mxnet_tpu/module``; ``BucketingModule`` and
``SequentialModule`` are not ported yet)."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]

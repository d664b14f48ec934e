"""``mx.mod``: the symbolic ``Module``, its ``BaseModule``,
``BucketingModule`` and ``SequentialModule`` (PyTorch counterpart of
``mxnet_tpu/module``)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule"]

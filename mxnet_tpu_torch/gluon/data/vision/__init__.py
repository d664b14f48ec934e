"""gluon.data.vision (PyTorch counterpart of
``mxnet_tpu/gluon/data/vision``): the vision datasets and transforms."""
from .datasets import CIFAR10, CIFAR100, MNIST, FashionMNIST, ImageRecordDataset
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageRecordDataset",
           "transforms"]

"""gluon.data (PyTorch counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers and the ``DataLoader``."""
from .dataloader import DataLoader
from .dataset import ArrayDataset, Dataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "DataLoader",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

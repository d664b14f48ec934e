"""gluon.data (PyTorch counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers, the ``DataLoader`` and ``vision`` (datasets and transforms)."""
from .dataloader import DataLoader
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "DataLoader", "Sampler", "SequentialSampler", "RandomSampler",
           "BatchSampler", "vision"]

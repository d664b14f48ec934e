"""Datasets (PyTorch counterpart of ``mxnet_tpu/gluon/data/dataset.py``):
``Dataset`` with ``filter``/``take``/``transform``/``transform_first``,
``SimpleDataset``, ``ArrayDataset`` and ``RecordFileDataset``."""
from __future__ import annotations

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([s for s in self if fn(s)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)

        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Samples ``i`` of each array together (one array: the sample
    itself); a 1-d NDArray is read through numpy."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for data in args:
            assert len(data) == self._length, \
                "all arrays must have same length"
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The raw records of an indexed RecordIO file (its ``.idx`` beside
    it), in the index's order."""

    def __init__(self, filename):
        from ... import recordio

        idx_file = filename[:-4] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)

"""Vision datasets (PyTorch counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``): ``MNIST``, ``FashionMNIST``,
``CIFAR10`` and ``CIFAR100`` read the idx and binary files already under
``root``; where they are absent each builds the reference's synthetic set
(numpy ``RandomState``, the same bytes from the same seed).  Nothing is
downloaded.  ``ImageRecordDataset`` decodes the images of a RecordIO
file.  Samples are (HWC ``NDArray`` on the current context, label)."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from .... import ndarray as nd
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset"]


def _synthetic_images(n, shape, num_classes, seed):
    """Images with faint noise and a bright 6x6 square at a place of
    their class: uint8 (n, h, w) and int32 labels."""
    rng = _np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=(n,)).astype(_np.int32)
    h, w = shape[0], shape[1]
    imgs = rng.rand(n, *shape).astype(_np.float32) * 0.15
    for c in range(num_classes):
        mask = labels == c
        y0 = (c * 2) % max(h - 6, 1)
        x0 = (c * 3) % max(w - 6, 1)
        imgs[mask, y0:y0 + 6, x0:x0 + 6] += 0.8
    return _np.clip(imgs * 255, 0, 255).astype(_np.uint8), labels


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        img = nd.array(self._data[idx])
        label = self._label[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from its idx files (gzipped or not) under ``root``; 6,000
    (train) or 1,000 synthetic 28x28x1 images where they are absent."""

    _n_classes = 10
    _shape = (28, 28, 1)
    _seed = 42

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        img_name = "train-images-idx3-ubyte" if self._train \
            else "t10k-images-idx3-ubyte"
        lab_name = "train-labels-idx1-ubyte" if self._train \
            else "t10k-labels-idx1-ubyte"
        img_path = os.path.join(self._root, img_name)
        lab_path = os.path.join(self._root, lab_name)
        if _exists(img_path) and _exists(lab_path):
            self._data = _read_idx(img_path).reshape(-1, 28, 28, 1)
            self._label = _read_idx(lab_path).astype(_np.int32)
        else:
            n = 6000 if self._train else 1000
            imgs, labels = _synthetic_images(
                n, self._shape[:2], self._n_classes,
                self._seed + (0 if self._train else 1))
            self._data = imgs.reshape(-1, *self._shape)
            self._label = labels


class FashionMNIST(MNIST):
    _seed = 77

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from its ``data_batch_*.bin``/``test_batch.bin`` under
    ``root``; 5,000 (train) or 1,000 synthetic 32x32x3 images where they
    are absent."""

    _n_classes = 10
    _seed = 99

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        files = [os.path.join(self._root, f"data_batch_{i}.bin")
                 for i in range(1, 6)] if self._train \
            else [os.path.join(self._root, "test_batch.bin")]
        if all(os.path.exists(f) for f in files):
            data, labels = [], []
            for f in files:
                raw = _np.fromfile(f, dtype=_np.uint8).reshape(-1, 3073)
                labels.append(raw[:, 0])
                data.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                            .transpose(0, 2, 3, 1))
            self._data = _np.concatenate(data)
            self._label = _np.concatenate(labels).astype(_np.int32)
        else:
            n = 5000 if self._train else 1000
            imgs, labels = _synthetic_images(
                n, (32, 32), self._n_classes,
                self._seed + (0 if self._train else 1))
            self._data = _np.repeat(imgs[..., None], 3, axis=-1)
            self._label = labels


class CIFAR100(CIFAR10):
    """CIFAR-100 from ``train.bin``/``test.bin`` (rows of coarse label,
    fine label, 3,072 pixels); the synthetic set has 20 classes, or 100
    with ``fine_label``."""

    _n_classes = 100
    _seed = 123

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        f = os.path.join(self._root,
                         "train.bin" if self._train else "test.bin")
        if os.path.exists(f):
            raw = _np.fromfile(f, dtype=_np.uint8).reshape(-1, 3074)
            self._label = raw[:, 1 if self._fine_label else 0] \
                .astype(_np.int32)
            self._data = raw[:, 2:].reshape(-1, 3, 32, 32) \
                .transpose(0, 2, 3, 1)
        else:
            n = 5000 if self._train else 1000
            classes = self._n_classes if self._fine_label else 20
            imgs, labels = _synthetic_images(
                n, (32, 32), classes, self._seed + (0 if self._train else 1))
            self._data = _np.repeat(imgs[..., None], 3, axis=-1)
            self._label = labels


class ImageRecordDataset(Dataset):
    """The images of a RecordIO file (``pack_img``'s records), decoded:
    (HWC uint8 ``NDArray``, the header's label)."""

    def __init__(self, filename, flag=1, transform=None):
        self._inner = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._inner)

    def __getitem__(self, idx):
        from .... import recordio

        header, img = recordio.unpack_img(self._inner[idx])
        img = nd.array(img)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


def _exists(p):
    return os.path.exists(p) or os.path.exists(p + ".gz")


def _read_idx(path):
    opener = gzip.open if not os.path.exists(path) else open
    real = path if os.path.exists(path) else path + ".gz"
    with opener(real, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = tuple(struct.unpack(">I", f.read(4))[0] for _ in range(ndim))
        return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(shape)

"""Vision transforms (PyTorch counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``): ``Compose``, ``Cast``,
``ToTensor``, ``Normalize``, ``Resize``, ``CenterCrop``,
``RandomResizedCrop``, ``RandomFlipLeftRight`` and
``RandomFlipTopBottom``.

Each is a block, so it takes an ``NDArray`` (and gives one back) or a
tensor, and computes on the image's device; the resizes and crops go
through ``image.py``'s helpers, which take the tensor and give float32
where they resize.  Only the random draws are made on the host, from the
streams the reference's are: numpy's global stream for the flips,
Python's ``random`` for ``RandomResizedCrop``'s window."""
from __future__ import annotations

import numpy as _np
import torch

from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom"]


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC (NHWC) values in [0, 255] -> CHW (NCHW) float32 in [0, 1]."""

    def hybrid_forward(self, F, x):
        return F._image_to_tensor(x)


class Normalize(HybridBlock):
    """``(x - mean) / std`` over the channel axis of CHW."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean if _np.isscalar(mean) else torch.tensor(
            _np.asarray(mean, dtype=_np.float32).reshape(-1, 1, 1))
        self._std = std if _np.isscalar(std) else torch.tensor(
            _np.asarray(std, dtype=_np.float32).reshape(-1, 1, 1))

    def _on(self, v, x):
        if isinstance(v, torch.Tensor) and v.device != x.device:
            v = v.to(x.device)
        return v

    def hybrid_forward(self, F, x):
        self._mean, self._std = self._on(self._mean, x), self._on(self._std, x)
        return (x - self._mean) / self._std


class Resize(Block):
    """Resized to ``size`` (w, h), or with ``keep_ratio`` and an int size
    its short side to ``size``."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._keep = keep_ratio and not isinstance(size, (tuple, list))
        self._interp = interpolation

    def forward(self, x):
        from .... import image as img_mod

        if self._keep:
            h, w = x.shape[0], x.shape[1]
            if h < w:
                new_h = self._size[0]
                new_w = max(1, round(w * self._size[0] / h))
            else:
                new_h = max(1, round(h * self._size[1] / w))
                new_w = self._size[1]
            return img_mod._resize_np(x, new_h, new_w, self._interp)
        return img_mod._resize_np(x, self._size[1], self._size[0],
                                  self._interp)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._interp = interpolation

    def forward(self, x):
        from .... import image as img_mod

        return img_mod.center_crop(x, self._size, self._interp)[0]


class RandomResizedCrop(Block):
    """A crop of random area (``scale``) and aspect ``ratio``, resized to
    ``size``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._args = (size if isinstance(size, (tuple, list))
                      else (size, size), scale, ratio, interpolation)

    def forward(self, x):
        from .... import image as img_mod

        return img_mod.random_size_crop(x, *self._args)[0]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return torch.flip(x, dims=[1 if x.ndim == 3 else 2])
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if _np.random.rand() < 0.5:
            return torch.flip(x, dims=[0 if x.ndim == 3 else 1])
        return x

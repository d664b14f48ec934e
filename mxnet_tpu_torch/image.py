"""Image loading and augmentation (PyTorch counterpart of
``mxnet_tpu/image.py``; reference: python/mxnet/image/image.py and
detection.py): ``imdecode``/``imread``, the resize and crop helpers, the
augmenters with ``CreateAugmenter``, ``ImageIter`` over a ``.rec``, a
``.lst`` or an in-memory image list, ``ImageRecordIterImpl`` (the
``ImageRecordIter`` route of ``use_native=False``) and ``ImageDetIter``.

Augmenters work on host numpy HWC arrays, as the reference's do, and make
the reference's draws in its order: Python's ``random`` (``randint``,
``uniform``, ``random``, ``shuffle``) and, for ``LightingAug``, numpy's
global stream, so a seeded run gives the reference's batches.  A resize
is ``jax.image.resize``'s arithmetic
(:func:`ops.image_ops.scale_resize`) on the image's device and returns
float32; the helpers also take an HWC tensor, which ``gluon.data.vision``'s
transforms give them.  A batch is one
``nd.array`` on the current context (the card unless the caller chose
the CPU).  ``imdecode`` of a compressed buffer needs PIL.
"""
from __future__ import annotations

import json
import os
import random as _pyrandom
from typing import List

import numpy as _np
import torch

from . import recordio as _recordio
from .base import MXNetError
from .io import DataBatch, DataDesc, DataIter
from .ndarray import array as nd_array

__all__ = ["imdecode", "imread",
           "imresize", "resize_short", "fixed_crop", "random_crop",
           "center_crop", "color_normalize", "random_size_crop", "Augmenter",
           "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "HorizontalFlipAug",
           "CastAug", "ColorNormalizeAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "LightingAug",
           "ColorJitterAug", "CreateAugmenter", "ImageIter", "ImageDetIter",
           "ImageRecordIterImpl"]


def _decode(buf, flag=1, to_rgb=True):
    """A compressed image buffer as an HWC uint8 numpy array."""
    import io as _io

    try:
        from PIL import Image as _PILImage
    except ImportError as e:
        raise MXNetError("imdecode: decoding a compressed image needs "
                         "PIL") from e
    img = _PILImage.open(_io.BytesIO(bytes(buf)))
    img = img.convert("L" if int(flag) == 0 else "RGB")
    arr = _np.asarray(img, dtype=_np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if int(flag) != 0 and not to_rgb:
        arr = arr[:, :, ::-1]
    return arr


def imdecode(buf, flag=1, to_rgb=True, **kwargs):
    """A compressed image buffer decoded to an HWC uint8 NDArray (``flag``
    0: grayscale, 1: colour; ``to_rgb=False`` gives BGR).  Needs PIL."""
    return nd_array(_decode(buf, flag, to_rgb))


def imread(filename, flag=1, to_rgb=True, **kwargs):
    """Read and decode an image file."""
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb, **kwargs)


def _resize_np(img, h, w, interp=1):
    """An HWC image resized to (h, w) (bilinear, antialiased when
    shrinking; nearest with ``interp=0``), float32: numpy for a numpy
    image, a tensor on its device for a tensor."""
    from .ops.image_ops import scale_resize

    if isinstance(img, torch.Tensor):
        x = img.to(torch.float32)
    else:
        x = torch.from_numpy(_np.ascontiguousarray(img, dtype=_np.float32))
    out = scale_resize(x, (int(h), int(w)) + tuple(x.shape[2:]),
                       "linear" if interp else "nearest")
    return out if isinstance(img, torch.Tensor) else out.numpy()


def imresize(src, w, h, interp=1):
    return _resize_np(src, h, w, interp)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return _resize_np(src, new_h, new_w, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize_np(out, size[1], size[0], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = _pyrandom.randint(0, max(0, w - new_w))
    y0 = _pyrandom.randint(0, max(0, h - new_h))
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * new_ratio)))
        new_h = int(round(_np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    src = src.astype(_np.float32) - mean
    if std is not None:
        src = src / std
    return src


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    """The short side resized to ``size``."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Resized to ``size`` (w, h), whatever the aspect ratio."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return _resize_np(src, self.size[1], self.size[0], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return src[:, ::-1]
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = _np.asarray(mean, dtype=_np.float32) \
            if mean is not None else None
        self.std = _np.asarray(std, dtype=_np.float32) \
            if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = _np.array([[[0.299, 0.587, 0.114]]], dtype=_np.float32)

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        gray = (src * self.coef).sum()
        # the 3 undoes the channel axis folded into src.size
        gray = (3.0 * (1.0 - alpha) / src.size) * gray
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = _np.array([[[0.299, 0.587, 0.114]]], dtype=_np.float32)

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        gray = (src * self.coef).sum(axis=2, keepdims=True) * (1.0 - alpha)
        return src * alpha + gray


class LightingAug(Augmenter):
    """PCA lighting noise, its alphas from numpy's global stream."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval)
        self.eigvec = _np.asarray(eigvec)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return src + rgb


class ColorJitterAug(Augmenter):
    """Brightness, contrast and saturation jitter in a shuffled order."""

    def __init__(self, brightness=0, contrast=0, saturation=0):
        super().__init__()
        self.augs = []
        if brightness:
            self.augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self.augs.append(ContrastJitterAug(contrast))
        if saturation:
            self.augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        augs = list(self.augs)
        _pyrandom.shuffle(augs)
        for a in augs:
            src = a(src)
        return src


def _color_augmenters(mean=None, std=None, brightness=0, contrast=0,
                      saturation=0, pca_noise=0):
    """The colour tail of CreateAugmenter and of ImageDetIter's default
    list (colour moves no pixel, so boxes stay valid under it)."""
    auglist: List[Augmenter] = []
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """The reference's augmenter list, in its order: short-side resize,
    a random-sized, random or centre crop, mirror, the cast to float32,
    then the colour tail."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    auglist.extend(_color_augmenters(mean, std, brightness, contrast,
                                     saturation, pca_noise))
    return auglist


_AUG_KEYS = ("resize", "rand_crop", "rand_resize", "rand_mirror", "mean",
             "std", "brightness", "contrast", "saturation", "pca_noise",
             "inter_method")


class ImageIter(DataIter):
    """Batches of augmented images from a ``.rec`` (its ``.idx`` beside
    it), a ``.lst`` (``idx \\t labels... \\t path``) or ``imglist``
    (``[label(s)..., path]`` entries), read under ``path_root``; NCHW
    float32 on the current context.  ``shuffle`` reorders the keys at
    each ``reset`` with ``random.shuffle``."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.auglist = aug_list if aug_list is not None else CreateAugmenter(
            (1,) + self.data_shape[1:] if len(self.data_shape) == 3
            else self.data_shape,
            **{k: v for k, v in kwargs.items() if k in _AUG_KEYS})
        self.shuffle = shuffle
        self.record = None
        self.imglist = None
        self.path_root = path_root
        self.imgkeys = []
        if path_imgrec:
            idx_path = path_imgrec[:-4] + ".idx"
            self.record = _recordio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                      "r")
            self.imgkeys = list(self.record.keys)
        elif path_imglist or imglist is not None:
            entries = []
            if path_imglist:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) < 3:
                            continue
                        entries.append(([float(v) for v in parts[1:-1]],
                                        parts[-1]))
            else:
                for item in imglist:
                    item = list(item) if isinstance(item, (list, tuple)) \
                        else [item]
                    labs = item[:-1]
                    if len(labs) == 1 and hasattr(labs[0], "__len__") and \
                            not isinstance(labs[0], str):
                        labs = [float(v) for v in labs[0]]
                    else:
                        labs = [float(v) for v in labs]
                    entries.append((labs, item[-1]))
            if not entries:
                raise MXNetError("ImageIter: empty image list")
            self.imglist = entries
            self.imgkeys = list(range(len(entries)))
        if num_parts > 1:
            self.imgkeys = self.imgkeys[part_index::num_parts]
        self.data_name = data_name
        self.label_name = label_name
        self.cursor = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        if self.shuffle:
            _pyrandom.shuffle(self.imgkeys)
        self.cursor = 0

    def _read(self, key):
        """(label, HWC image) from the record file or the image list."""
        if self.record is not None:
            header, img = _recordio.unpack_img(self.record.read_idx(key))
            return header.label, img
        labs, path = self.imglist[key]
        with open(os.path.join(self.path_root, path), "rb") as f:
            img = _decode(f.read()).astype(_np.float32)
        lab = labs[0] if len(labs) == 1 else _np.asarray(labs, _np.float32)
        return lab, img

    def next(self):
        if (self.record is None and self.imglist is None) or \
                self.cursor + self.batch_size > len(self.imgkeys):
            raise StopIteration
        imgs, labels = [], []
        for i in range(self.batch_size):
            key = self.imgkeys[self.cursor + i]
            lab, img = self._read(key)
            for aug in self.auglist:
                img = aug(img)
            if img.ndim == 2:
                img = img[:, :, None]
            imgs.append(_np.transpose(img, (2, 0, 1)))
            labels.append(float(lab) if _np.isscalar(lab)
                          or getattr(lab, "size", 1) == 1
                          else _np.asarray(lab)[:self.label_width])
        self.cursor += self.batch_size
        data = nd_array(_np.stack(imgs).astype(_np.float32))
        label = nd_array(_np.asarray(labels, dtype=_np.float32))
        return DataBatch([data], [label], pad=0)


def ImageRecordIterImpl(path_imgrec=None, data_shape=(3, 224, 224),
                        batch_size=128, shuffle=False, rand_crop=False,
                        rand_mirror=False, mean_r=0, mean_g=0, mean_b=0,
                        std_r=1, std_g=1, std_b=1, preprocess_threads=4,
                        num_parts=1, part_index=0, **kwargs):
    """``ImageRecordIter``'s ``ImageIter`` route: the per-channel means
    and stds become a ``ColorNormalizeAug`` where both are set."""
    mean = None
    if mean_r or mean_g or mean_b:
        mean = _np.array([mean_r, mean_g, mean_b])
    std = None
    if std_r != 1 or std_g != 1 or std_b != 1:
        std = _np.array([std_r, std_g, std_b])
    return ImageIter(batch_size, data_shape, path_imgrec=path_imgrec,
                     shuffle=shuffle, rand_crop=rand_crop,
                     rand_mirror=rand_mirror, mean=mean, std=std,
                     num_parts=num_parts, part_index=part_index, **kwargs)


class ImageDetIter(ImageIter):
    """Detection batches from a ``.rec`` whose labels are
    ``[header_width, obj_width, header..., objects...]`` (``pack_label``):
    each image's objects ``[class, xmin, ymin, xmax, ymax, ...]``
    (normalized) padded with -1 rows to (max_objects, obj_width).  The
    default augmenters force-resize to ``data_shape`` then apply the colour
    tail; ``rand_mirror`` flips image and boxes together.  ``rand_crop``
    and ``rand_resize`` would move the boxes' frame and raise."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 max_objects=16, obj_width=5, rand_mirror=False, **kwargs):
        self.max_objects = int(max_objects)
        self.obj_width = int(obj_width)
        self._det_rand_mirror = rand_mirror
        kwargs.pop("label_width", None)
        for geo in ("rand_crop", "rand_resize"):
            if kwargs.pop(geo, False):
                raise NotImplementedError(
                    f"ImageDetIter does not support {geo}: only force-resize "
                    "and rand_mirror adjust the normalized boxes correctly")
        if kwargs.get("aug_list") is None:
            color = {k: kwargs.pop(k) for k in
                     ("mean", "std", "brightness", "contrast", "saturation",
                      "pca_noise") if k in kwargs}
            kwargs["aug_list"] = [
                ForceResizeAug((data_shape[2], data_shape[1])), CastAug(),
            ] + _color_augmenters(**color)
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, rand_mirror=False, **kwargs)

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.max_objects, self.obj_width))]

    def _parse_det_label(self, raw):
        arr = _np.asarray(raw, dtype=_np.float32).ravel()
        out = _np.full((self.max_objects, self.obj_width), -1.0, _np.float32)
        if arr.size < 2:
            return out
        header_width = int(arr[0])
        obj_width = int(arr[1])
        body = arr[header_width:]
        n = min(body.size // obj_width, self.max_objects)
        objs = body[:n * obj_width].reshape(n, obj_width)
        w = min(obj_width, self.obj_width)
        out[:n, :w] = objs[:, :w]
        return out

    def next(self):
        if self.record is None or \
                self.cursor + self.batch_size > len(self.imgkeys):
            raise StopIteration
        imgs, labels = [], []
        for i in range(self.batch_size):
            key = self.imgkeys[self.cursor + i]
            header, img = _recordio.unpack_img(self.record.read_idx(key))
            lab = self._parse_det_label(header.label)
            for aug in self.auglist:
                img = aug(img)
            if self._det_rand_mirror and _pyrandom.random() < 0.5:
                img = img[:, ::-1]
                flipped = lab.copy()
                valid = flipped[:, 0] >= 0
                flipped[valid, 1] = 1.0 - lab[valid, 3]
                flipped[valid, 3] = 1.0 - lab[valid, 1]
                lab = flipped
            if img.ndim == 2:
                img = img[:, :, None]
            imgs.append(_np.transpose(img, (2, 0, 1)))
            labels.append(lab)
        self.cursor += self.batch_size
        return DataBatch([nd_array(_np.stack(imgs).astype(_np.float32))],
                         [nd_array(_np.stack(labels))], pad=0)

    @staticmethod
    def pack_label(objects, header_width=2):
        """The header-array label ``pack_img`` takes: ``[header_width,
        obj_width, objects...]``."""
        objects = _np.asarray(objects, dtype=_np.float32)
        obj_width = objects.shape[1] if objects.ndim == 2 else 0
        return _np.concatenate([
            _np.asarray([header_width, obj_width], _np.float32),
            objects.ravel()])

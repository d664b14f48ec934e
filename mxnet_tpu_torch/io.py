"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter``,
``MNISTIter``, ``ImageRecordIter`` and ``RecordIOIter``.

PyTorch counterpart of ``mxnet_tpu/io.py`` (reference:
python/mxnet/io.py, src/io/iter_csv.cc, src/io/iter_mnist.cc).  Batches
are ``NDArray``s made with ``nd.array`` on the current context (``gpu(0)``
unless the caller chose another, as the reference's land on its default
device); ``NDArrayIter`` shuffles with numpy's global generator.
``PrefetchingIter`` reads ahead on one thread, under the context that was
current when it started.  ``MNISTIter`` reads idx
files already on disk (or makes the reference's synthetic set when they
are absent); nothing is downloaded.

``ImageRecordIter`` takes the reference's two RecordIO image routes:
``ImageRecordIterNative`` (the default for RGB: decode, resize, crop and
mirror on host worker threads into uint8 NHWC batches, normalized and
transposed on the device) and, with ``use_native=False``, no
``path_imgrec`` or C != 3, ``image.ImageRecordIterImpl`` (``ImageIter``
with its augmenters); ``RecordIOIter`` yields a shard's raw records.

``LibSVMIter`` reads a LibSVM file straight into CSR arrays (no dense
row is ever made) and serves ``CSRNDArray`` batches with the reference's
rows, labels and ``pad``.

``shard_data_batch`` cuts this rank's block of a batch over a mesh axis
(one process per device: a rank holds its own block of a sharded array).
``fast_forward`` skips batches for a mid-epoch resume
(``NDArrayIter.seek`` jumps without making them).
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import queue
import struct
import threading
import weakref
from collections import namedtuple

import numpy as _np

from .base import MXNetError
from .context import Context
from .ndarray import array as nd_array
from .ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter",
           "ImageRecordIterNative", "RecordIOIter", "LibSVMIter",
           "shard_data_batch", "fast_forward"]


def fast_forward(data_iter, num_batches: int) -> int:
    """Advance an iterator by ``num_batches`` without training on them:
    ``Module.fit(resume=True)``'s mid-epoch resume (reference:
    ``io.fast_forward``).  An iterator with ``seek(batch_index)``
    (``NDArrayIter`` and its subclasses) jumps; any other is consumed batch
    by batch.  Returns the batches skipped (fewer than ``num_batches`` when
    the epoch is shorter)."""
    n = int(num_batches or 0)
    if n <= 0:
        return 0
    seek = getattr(data_iter, "seek", None)
    if callable(seek):
        try:
            seek(n)
            return n
        except Exception:
            pass  # fall through to plain consumption
    consumed = 0
    for _ in range(n):
        try:
            next(data_iter)
        except StopIteration:
            break
        consumed += 1
    return consumed


def shard_data_batch(batch, mesh, axis: str = "dp", strict: bool = False):
    """Cut this rank's block of every array of ``batch`` (data and labels)
    on ``axis`` of ``mesh``, in place on the batch's NDArrays (reference:
    ``io.shard_data_batch``, which places the whole batch sharded on the
    axis).  On a mesh with more axes the block is replicated across them.

    An array whose leading dimension the axis size does not divide is left
    whole, unless ``strict=True``: then ``MXNetError`` names the batch size
    and the axis.  An axis the mesh lacks raises."""
    axis_names = tuple(str(a) for a in mesh.axis_names)
    if axis not in axis_names:
        raise MXNetError(
            f"shard_data_batch: axis {axis!r} is not an axis of the mesh "
            f"(axes: {axis_names})")
    ndev = int(mesh.shape[axis])
    me = int(mesh.axis_index(axis))
    for arr in list(batch.data or []) + list(batch.label or []):
        if not (isinstance(arr, NDArray) and arr._data is not None
                and arr.shape):
            continue
        if arr.shape[0] % ndev:
            if strict:
                raise MXNetError(
                    f"shard_data_batch: batch size {arr.shape[0]} is not "
                    f"divisible by mesh axis {axis!r} of size {ndev}; pad "
                    f"the final batch or pick a batch size that is a "
                    f"multiple of {ndev}")
            continue
        b = arr.shape[0] // ndev
        arr._data = arr._data.narrow(0, me * b, b).contiguous()
    return batch


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else []
        label_shapes = [l.shape for l in self.label] if self.label else []
        return f"{self.__class__.__name__}: data shapes: {data_shapes} label shapes: {label_shapes}"


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return None


class NDArrayIter(DataIter):
    """Iterate over ndarray/numpy data (reference: io.py:546)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        if last_batch_handle == "discard":
            self.num_data = (self.num_data // batch_size) * batch_size
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        # roll_over: the final batch of the previous epoch wrapped around and
        # consumed some samples from the FRONT of the old order; remember
        # which ones BEFORE reshuffling, else the skip lands on different
        # samples and epochs stop being permutations of the dataset
        consumed = None
        if self.last_batch_handle == "roll_over" and \
                getattr(self, "_rolled", 0):
            consumed = self.idx[:self._rolled].copy()
        if self.shuffle:
            _np.random.shuffle(self.idx)
        start = 0
        if consumed is not None:
            mask = _np.isin(self.idx, consumed)
            self.idx = _np.concatenate([self.idx[mask], self.idx[~mask]])
            start = len(consumed)
        self._rolled = 0
        self.cursor = -self.batch_size + start

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def seek(self, batch_index: int) -> None:
        """Position the cursor so that the NEXT batch served is
        ``batch_index`` (0-based) of the current epoch's order, without
        making the skipped batches; the order is the last ``reset()``'s."""
        if batch_index < 0:
            raise ValueError(f"seek: negative batch index {batch_index}")
        self.cursor = -self.batch_size + batch_index * self.batch_size

    def tell(self) -> int:
        """Batches already served this epoch (what ``seek`` takes to come
        back to this position)."""
        return max(0, (self.cursor + self.batch_size) // self.batch_size)

    def _take(self, arrays):
        out = []
        for k, v in arrays:
            if self.cursor + self.batch_size <= self.num_data:
                sel = self.idx[max(self.cursor, 0):self.cursor + self.batch_size]
            else:
                pad = self.batch_size - (self.num_data - self.cursor)
                sel = _np.concatenate([self.idx[self.cursor:], self.idx[:pad]])
                if self.last_batch_handle == "roll_over":
                    self._rolled = pad
            out.append(nd_array(v[sel]))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _parse_libsvm(path, ncol: int):
    """A LibSVM file as (labels float64, indptr int64, indices int32,
    values float32): each row's features sorted by index, a repeated
    index keeping its last value and zeros dropped, which is the CSR of
    the dense rows the reference builds.  Every number of the file is read
    by one ``np.fromstring``; the host loop only counts each line's
    features."""
    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    counts = _np.fromiter((ln.count(":") for ln in lines), dtype=_np.int64,
                          count=len(lines))
    nums = _np.fromstring("\n".join(lines).replace(":", " "), sep=" ")
    if nums.size != len(lines) + 2 * int(counts.sum()):
        raise MXNetError(f"{path}: not a LibSVM file (a line is not "
                         f"'label index:value ...')")
    starts = _np.zeros(len(lines), dtype=_np.int64)
    _np.cumsum(1 + 2 * counts[:-1], out=starts[1:])
    labels = nums[starts]
    is_label = _np.zeros(nums.size, dtype=bool)
    is_label[starts] = True
    pairs = nums[~is_label].reshape(-1, 2)
    cols = pairs[:, 0].astype(_np.int64)
    vals = pairs[:, 1].astype(_np.float32)
    if cols.size and (cols.min() < 0 or cols.max() >= ncol):
        raise MXNetError(f"{path}: feature index out of range [0, {ncol})")
    rows = _np.repeat(_np.arange(len(lines), dtype=_np.int64), counts)
    key = rows * ncol + cols
    order = _np.argsort(key, kind="stable")
    key = key[order]
    last = _np.ones(len(key), dtype=bool)
    last[:-1] = key[1:] != key[:-1]
    keep = order[last]
    keep = keep[vals[keep] != 0]
    indptr = _np.zeros(len(lines) + 1, dtype=_np.int64)
    _np.cumsum(_np.bincount(rows[keep], minlength=len(lines)),
               out=indptr[1:])
    return (labels, indptr, cols[keep].astype(_np.int32), vals[keep])


class LibSVMIter(DataIter):
    """LibSVM reader (reference: ``io.py`` LibSVMIter over
    ``src/io/iter_libsvm.cc``): batches of ``batch_size`` rows in file
    order, data a ``CSRNDArray`` of ``data_shape`` columns and labels a
    float32 vector on the current context; the last batch wraps to the
    first rows with ``pad`` set (``NDArrayIter``'s default)."""

    def __init__(self, data_libsvm, data_shape, label_shape=(1,),
                 batch_size=1, data_name="data", label_name="label",
                 **kwargs):
        super().__init__(batch_size)
        self._ncol = int(data_shape[0]) if isinstance(
            data_shape, (tuple, list)) else int(data_shape)
        self._labels, self._indptr, self._indices, self._values = \
            _parse_libsvm(data_libsvm, self._ncol)
        self.num_data = len(self._labels)
        self.provide_data = [DataDesc(data_name, (batch_size, self._ncol),
                                      _np.dtype(_np.float32))]
        self.provide_label = [DataDesc(label_name, (batch_size,),
                                       self._labels.dtype)]
        self.reset()

    def reset(self):
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _spans(self):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            return [(self.cursor, end)]
        return [(self.cursor, self.num_data), (0, end - self.num_data)]

    def getdata(self):
        import torch

        from .ndarray.ndarray import _device
        from .ndarray.sparse import CSRNDArray

        ptrs, idx, val, base = [_np.zeros(1, _np.int64)], [], [], 0
        for a, b in self._spans():
            lo, hi = self._indptr[a], self._indptr[b]
            ptrs.append(self._indptr[a + 1:b + 1] - lo + base)
            idx.append(self._indices[lo:hi])
            val.append(self._values[lo:hi])
            base += hi - lo
        dev = _device(None)
        return [CSRNDArray(
            torch.from_numpy(_np.concatenate(val)).to(dev),
            torch.from_numpy(_np.concatenate(idx)).to(dev),
            torch.from_numpy(_np.concatenate(ptrs).astype(_np.int32)).to(dev),
            (self.batch_size, self._ncol))]

    def getlabel(self):
        sel = _np.concatenate([_np.arange(a, b) for a, b in self._spans()])
        return [nd_array(self._labels[sel])]

    def getpad(self):
        return max(0, self.cursor + self.batch_size - self.num_data)


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise ValueError("data cannot be None")
        return []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = collections.OrderedDict(
            [(default_name if len(data) == 1 else f"_{i}_{default_name}", d)
             for i, d in enumerate(data)])
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, _np.asarray(v)))
    return out


class ResizeIter(DataIter):
    """Resize another iterator's epoch length (reference: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetch over one or more iterators
    (reference: io.py PrefetchingIter)."""

    def __init__(self, iters, rename_data=None, rename_label=None, prefetch_depth=2):
        iters = iters if isinstance(iters, list) else [iters]
        super().__init__(iters[0].batch_size)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._depth = prefetch_depth
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._thread = None
        self._gen = 0          # epoch generation: stale puts are discarded
        self._exhausted = False
        self.current_batch = None
        self._start()

    def _start(self):
        """Start the reader thread.  It makes its batches under the
        context current here (contexts are per thread), and hands an
        exception to the consumer instead of leaving it waiting."""
        gen = self._gen
        q = self._queue
        stop = self._stop
        stack = getattr(Context._tls, "stack", None)
        ctx = stack[-1] if stack else contextlib.nullcontext()

        def worker():
            with ctx:
                while not stop.is_set():
                    try:
                        batches = [it.next() for it in self.iters]
                    except StopIteration:
                        q.put((gen, None))
                        return
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        q.put((gen, e))
                        return
                    q.put((gen, batches))

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        # stop the worker FOR REAL before touching the underlying iterators:
        # a short join would race it.reset() against an in-flight it.next()
        # and let a pre-reset batch leak into the new epoch
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            try:
                while True:
                    self._queue.get_nowait()  # unblock a worker stuck in put()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        for it in self.iters:
            it.reset()
        self._gen += 1
        self._exhausted = False
        self._stop = threading.Event()
        self._queue = queue.Queue(maxsize=self._depth)
        self._start()

    def iter_next(self):
        if self._exhausted:
            return False  # worker already exited; get() would hang forever
        while True:
            gen, batches = self._queue.get()
            if gen == self._gen:
                break  # discard stale entries from a pre-reset worker
        if batches is None or isinstance(batches, BaseException):
            self._exhausted = True
            if batches is not None:
                raise batches
            return False
        self.current_batch = batches[0] if len(batches) == 1 else DataBatch(
            sum([b.data for b in batches], []),
            sum([(b.label or []) for b in batches], []),
            batches[0].pad, batches[0].index)
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class CSVIter(NDArrayIter):
    """CSV reader (reference: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[1:] == (1,):
                label = label[:, 0]
        else:
            # reference iter_csv.cc: "If NULL, all labels will be returned
            # as 0" — a dummy zero label per instance
            label = _np.zeros((data.shape[0],), _np.float32)
        # reference BatchLoader semantics: round_batch=True carries the
        # wrap-around overflow into the next epoch (roll_over); False emits
        # the final partial batch with padding (pad), never discards
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="roll_over" if round_batch
                         else "pad",
                         label_name="label")


class MNISTIter(NDArrayIter):
    """MNIST reader (reference: src/io/iter_mnist.cc).  Reads idx-format
    files (gzipped or not); makes the reference's deterministic synthetic
    set when they are absent."""

    def __init__(self, image="train-images-idx3-ubyte", label="train-labels-idx1-ubyte",
                 batch_size=128, shuffle=True, flat=False, seed=0, silent=False,
                 num_parts=1, part_index=0, **kwargs):
        import gzip
        import struct

        def read_idx(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                magic = struct.unpack(">I", f.read(4))[0]
                ndim = magic & 0xFF
                shape = tuple(struct.unpack(">I", f.read(4))[0] for _ in range(ndim))
                return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(shape)

        if image and _exists_any(image):
            imgs = read_idx(_first_existing(image)).astype(_np.float32) / 255.0
            labs = read_idx(_first_existing(label)).astype(_np.float32)
        else:
            rng = _np.random.RandomState(seed)
            n = 6000
            labs = rng.randint(0, 10, size=(n,)).astype(_np.float32)
            imgs = _np.zeros((n, 28, 28), dtype=_np.float32)
            # class-dependent pattern so models can actually learn
            for c in range(10):
                mask = labs == c
                base = rng.rand(28, 28) * 0.1
                base[c * 2:c * 2 + 6, c * 2:c * 2 + 6] += 0.9
                imgs[mask] = base + rng.rand(int(mask.sum()), 28, 28) * 0.1
        if num_parts > 1:
            imgs = imgs[part_index::num_parts]
            labs = labs[part_index::num_parts]
        data = imgs.reshape(-1, 784) if flat else imgs.reshape(-1, 1, 28, 28)
        # forward ONLY the naming kwargs so custom-named heads (e.g.
        # SVMOutput's svm_label) bind, while other reference-config kwargs
        # (prefetch_buffer etc.) stay ignored as before
        naming = {k: kwargs[k] for k in ("data_name", "label_name")
                  if k in kwargs}
        super().__init__(data, labs, batch_size=batch_size, shuffle=shuffle,
                         **naming)


def _exists_any(path):
    import os

    return os.path.exists(path) or os.path.exists(path + ".gz")


def _first_existing(path):
    import os

    return path if os.path.exists(path) else path + ".gz"


# the live image pipelines: their worker threads are stopped at exit, so
# none still holds the record file while the interpreter finalizes
_PIPELINES = weakref.WeakSet()


@atexit.register
def _close_pipelines():
    for pipe in list(_PIPELINES):
        pipe.close()


class _Worker:
    """One decode worker's random stream: ``std::mt19937`` seeded with
    ``uint32(seed + worker_id + 9973 * epoch)``, the native pipeline's
    (``cpp/src/imagedec.cc``).  numpy's legacy ``RandomState`` is the same
    Mersenne Twister, and its full-range uint32 draw is one raw output."""

    def __init__(self, seed: int):
        self._rs = _np.random.RandomState(seed & 0xFFFFFFFF)

    def draw(self) -> int:
        return int(self._rs.randint(0, 2 ** 32, dtype=_np.uint32))

    def shuffle(self, items: list) -> None:
        self._rs.shuffle(items)


def _resize_bilinear(src, dh: int, dw: int):
    """The native pipeline's bilinear resize of an RGB uint8 image, in its
    float32 arithmetic: source sample ``(i + 0.5) * (in / out) - 0.5``,
    truncated toward zero and clamped, and each channel
    ``uint8((1-wy)((1-wx)p00 + wx p01) + wy((1-wx)p10 + wx p11) + 0.5)``."""
    sh, sw = src.shape[:2]
    f32 = _np.float32

    def axis(n_src, n_dst):
        scale = f32(n_src) / f32(n_dst)
        fc = (_np.arange(n_dst, dtype=f32) + f32(0.5)) * scale - f32(0.5)
        c0 = _np.maximum(fc.astype(_np.int32), 0)
        c1 = _np.minimum(c0 + 1, n_src - 1)
        w = _np.maximum(fc - c0.astype(f32), f32(0))
        return c0, c1, w

    y0, y1, wy = axis(sh, dh)
    x0, x1, wx = axis(sw, dw)
    wy, wx = wy[:, None, None], wx[None, :, None]
    img = src.astype(f32)
    top, bot = img[y0], img[y1]
    one = f32(1)
    v = (one - wy) * ((one - wx) * top[:, x0] + wx * top[:, x1]) + \
        wy * ((one - wx) * bot[:, x0] + wx * bot[:, x1])
    return (v + f32(0.5)).astype(_np.uint8)


def _decode_raw0(img: bytes):
    """A RAW0 blob as an (H, W, 3) uint8 array (a gray or other channel
    count broadcasts its first channel), or None when malformed."""
    if len(img) < 8:
        return None
    (ndim,) = struct.unpack("<I", img[4:8])
    if ndim < 2 or ndim > 3 or len(img) < 8 + 4 * ndim:
        return None
    shape = struct.unpack(f"<{ndim}i", img[8:8 + 4 * ndim]) + (1,)
    h, w, c = shape[0], shape[1], shape[2] if ndim == 3 else 1
    if min(h, w, c) <= 0:
        return None
    need = h * w * c
    if len(img) - (8 + 4 * ndim) < need:
        return None
    px = _np.frombuffer(img, _np.uint8, need, 8 + 4 * ndim).reshape(h, w, c)
    return px if c == 3 else _np.repeat(px[:, :, :1], 3, axis=2)


def _decode_jpeg(img: bytes, min_side: int):
    """A JPEG through PIL, decoded at the smallest 1/2^k scale whose short
    side still covers ``min_side`` (the native pipeline's libjpeg
    ``scale_denom``), as (H, W, 3) uint8."""
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError("ImageRecordIter: a JPEG record needs PIL to "
                         "decode (RAW0 records need nothing)") from e
    import io as _io

    im = Image.open(_io.BytesIO(img))
    if min_side > 0:
        w, h = im.size
        den = 1
        while den < 8 and min(w, h) // (den * 2) >= min_side:
            den *= 2
        if den > 1:
            im.draft("RGB", (-(-w // den), -(-h // den)))
    return _np.asarray(im.convert("RGB"))


class _ImagePipeline:
    """The record reader and the decode workers of one
    :class:`ImageRecordIterNative`.

    Workers take chunks of records (``window``: one batch, four with
    ``shuffle``) from the shard's reader under a lock, decode, resize,
    crop and mirror each record into a uint8 NHWC batch (pinned host
    memory when ``pin``), and hand the batches over in the order their
    chunks were read, so an epoch's order depends on the thread count only
    through the random draws.  A trailing batch repeats its own rows and
    counts its real images; a shard with fewer batches than the largest
    shard's ``ceil(size / B)`` emits copies of its first batch counting 0
    images, so every shard steps equally."""

    def __init__(self, path, batch_size, data_shape, resize, num_threads,
                 queue_depth, shard_index, num_shards, rand_crop, rand_mirror,
                 shuffle, label_width, seed, pin):
        c, h, w = data_shape
        if batch_size < 1 or h < 1 or w < 1 or resize < 0:
            raise MXNetError("ImageRecordIter: batch_size and data_shape "
                             "must be positive")
        self.path = path
        self.B, self.H, self.W = int(batch_size), int(h), int(w)
        self.resize = int(resize)
        self.num_threads = max(1, int(num_threads))
        self.depth = max(1, int(queue_depth))
        self.shard, self.nshards = int(shard_index), max(1, int(num_shards))
        self.rand_crop, self.rand_mirror = bool(rand_crop), bool(rand_mirror)
        self.shuffle = bool(shuffle)
        self.label_width = max(1, int(label_width))
        self.seed = int(seed)
        self.pin = pin
        from .recordio import _count_records

        n_total = _count_records(path)
        max_shard = -(-n_total // self.nshards)
        self.target = -(-max_shard // self.B)
        self.epoch = 0
        self._threads = []
        self._start()
        _PIPELINES.add(self)

    # -- epoch -----------------------------------------------------------
    def _start(self):
        from .recordio import MXRecordIO

        self._reader = MXRecordIO(self.path, "r")
        self._ordinal = 0
        self._stream_end = False
        self._next_seq = 0      # next batch number to hand to a chunk
        self._emit = 0          # next batch number next() returns
        self._done = {}
        self._error = None
        self._first = None
        self._stop = False
        self._active = self.num_threads
        self._read_lock = threading.Lock()
        self._cv = threading.Condition()
        self._threads = [threading.Thread(target=self._work, args=(i,),
                                          daemon=True)
                         for i in range(self.num_threads)]
        for t in self._threads:
            t.start()

    def _halt(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []
        self._reader.close()

    def reset(self):
        self._halt()
        self.epoch += 1     # new crops and mirrors every epoch
        self._start()

    def close(self):
        if self._threads:
            self._halt()

    # -- workers ---------------------------------------------------------
    def _fetch(self, n):
        """Up to ``n`` of the shard's records, and the first batch number
        of the batches they make."""
        with self._read_lock:
            out = []
            while len(out) < n and not self._stream_end:
                buf = self._reader.read()
                if buf is None:
                    self._stream_end = True
                    break
                if self._ordinal % self.nshards == self.shard:
                    out.append(buf)
                self._ordinal += 1
            with self._cv:
                # hold back while far ahead of the consumer
                while not self._stop and self._next_seq - self._emit >= \
                        self.depth + self.num_threads:
                    self._cv.wait()
                seq = self._next_seq
                self._next_seq += -(-len(out) // self.B)
            return out, seq

    def _new_batch(self):
        import torch

        data = torch.empty((self.B, self.H, self.W, 3), dtype=torch.uint8,
                           pin_memory=self.pin)
        return data, _np.zeros((self.B, self.label_width), _np.float32)

    def _work(self, worker_id):
        rng = _Worker(self.seed + worker_id + 9973 * self.epoch)
        window = 4 * self.B if self.shuffle else self.B
        try:
            while True:
                chunk, seq = self._fetch(window)
                if not chunk or self._stop:
                    break
                if self.shuffle:
                    rng.shuffle(chunk)
                for k in range(0, len(chunk), self.B):
                    part = chunk[k:k + self.B]
                    data, labels = self._new_batch()
                    px = data.numpy()
                    for i, rec in enumerate(part):
                        self._decode(rec, rng, px[i], labels[i])
                    for i in range(len(part), self.B):   # repeat its rows
                        px[i] = px[i % len(part)]
                        labels[i] = labels[i % len(part)]
                    self._put(seq + k // self.B, (data, labels, len(part)))
        except Exception as e:  # noqa: BLE001 (handed to the consumer)
            with self._cv:
                self._error = self._error or e
                self._cv.notify_all()
        finally:
            with self._cv:
                self._active -= 1
                self._cv.notify_all()

    def _put(self, seq, batch):
        with self._cv:
            if seq == 0:
                self._first = batch
            self._done[seq] = batch
            self._cv.notify_all()

    def _decode(self, rec, rng, out_px, out_label):
        if len(rec) < 24:
            raise MXNetError(f"{self.path}: a record of {len(rec)} bytes "
                             f"has no image header")
        flag, label = struct.unpack("<If", rec[:8])
        img = rec[24:]
        if flag > 0:
            if len(img) < 4 * flag:
                raise MXNetError(f"{self.path}: a record shorter than its "
                                 f"{flag} labels")
            n = min(flag, self.label_width)
            out_label[:n] = _np.frombuffer(img, _np.float32, n)
            img = img[4 * flag:]
        else:
            out_label[0] = label
        if img[:4] == b"RAW0":
            src = _decode_raw0(img)
            if src is None:
                raise MXNetError(f"{self.path}: a malformed RAW0 record")
        else:
            try:
                src = _decode_jpeg(img, self.resize)
            except MXNetError:
                raise
            except Exception as e:
                raise MXNetError(f"{self.path}: an undecodable image "
                                 f"record ({e})") from e
        h, w = src.shape[:2]
        rh, rw = h, w
        if self.resize > 0:     # shorter side to `resize`, aspect kept
            if h < w:
                rh, rw = self.resize, max(self.W, w * self.resize // max(1, h))
            else:
                rw, rh = self.resize, max(self.H, h * self.resize // max(1, w))
        rh, rw = max(rh, self.H), max(rw, self.W)
        if (rh, rw) != (h, w):
            src = _resize_bilinear(src, rh, rw)
        if self.rand_crop:
            y0 = 0 if rh == self.H else rng.draw() % (rh - self.H + 1)
            x0 = 0 if rw == self.W else rng.draw() % (rw - self.W + 1)
        else:
            y0, x0 = (rh - self.H) // 2, (rw - self.W) // 2
        crop = src[y0:y0 + self.H, x0:x0 + self.W]
        if self.rand_mirror and rng.draw() & 1:
            crop = crop[:, ::-1]
        out_px[...] = crop

    # -- consumer --------------------------------------------------------
    def next(self):
        """(uint8 NHWC tensor, float32 labels, real image count), or None
        at the end of the epoch."""
        with self._cv:
            while True:
                if self._emit in self._done:
                    batch = self._done.pop(self._emit)
                    self._emit += 1
                    self._cv.notify_all()
                    return batch
                if self._error is not None:
                    raise self._error
                if self._active == 0:
                    break
                self._cv.wait()
            if self._emit >= self.target:
                return None
            # this shard is short of the largest one's batches
            self._emit += 1
        if self._first is None:
            data, labels = self._new_batch()
            data.zero_()
            return data, labels, 0
        return self._first[0].clone(), self._first[1].copy(), 0


class ImageRecordIterNative(DataIter):
    """The RecordIO image pipeline, with the semantics of the reference's
    default route (``ImageRecordIterNative`` over ``cpp/src/imagedec.cc``):
    decode RAW0 (JPEG through PIL where PIL can be imported; an
    undecodable record raises ``MXNetError``, it is never skipped), resize
    the shorter side to ``resize`` (default the larger of H and W) with
    the native bilinear arithmetic, crop H x W (random with
    ``rand_crop``, else centered), mirror (with ``rand_mirror``, each
    image with probability 1/2), on ``preprocess_threads`` worker threads
    (numpy), each drawing from ``mt19937(seed + worker + 9973 * epoch)``.

    Batches are uint8 NHWC on the host (pinned when the current context
    is a card), copied to the current context's device as they are;
    ``(x - mean) / std * scale`` and the transpose to NCHW run there, so
    one byte a pixel crosses the link.  ``DataBatch.pad`` counts a
    trailing batch's repeated rows."""

    def __init__(self, path_imgrec, data_shape=(3, 224, 224), batch_size=128,
                 resize=-1, rand_crop=False, rand_mirror=False, shuffle=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 preprocess_threads=4, prefetch_buffer=4,
                 num_parts=1, part_index=0, label_width=1, seed=0,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        from .context import current_context, resolve_device

        c, h, w = data_shape
        if c != 3:
            raise MXNetError("ImageRecordIterNative: RGB only (C=3); "
                             "ImageRecordIter sends other shapes to the "
                             "ImageIter route")
        if resize <= 0:
            resize = max(h, w)
        pin = resolve_device(current_context()).type == "cuda"
        self._pipe = _ImagePipeline(
            path_imgrec, batch_size, tuple(data_shape), resize,
            preprocess_threads, prefetch_buffer, part_index, num_parts,
            rand_crop, rand_mirror, shuffle, label_width, seed, pin)
        self._label_width = label_width
        self.data_name, self.label_name = data_name, label_name
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + tuple(data_shape))]
        lshape = (batch_size,) if label_width == 1 else \
            (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, lshape)]
        self._mean = _np.asarray([mean_r, mean_g, mean_b], _np.float32)
        self._std = _np.asarray([std_r, std_g, std_b], _np.float32)
        self._scale = float(scale)
        self._consts = {}

    def _preprocess(self, img_u8, dev):
        """uint8 NHWC (host) -> normalized float32 NCHW on ``dev``."""
        import torch

        if dev not in self._consts:
            self._consts[dev] = tuple(
                torch.from_numpy(a).to(dev).view(1, 3, 1, 1)
                for a in (self._mean, self._std))
        mean, std = self._consts[dev]
        u8 = img_u8.to(dev, non_blocking=True)
        B, H, W, _ = u8.shape
        x = torch.empty((B, 3, H, W), dtype=torch.float32, device=dev)
        x.copy_(u8.permute(0, 3, 1, 2))
        x = (x - mean) / std
        if self._scale != 1.0:
            x = x * self._scale
        return x

    def next(self):
        import torch

        from .context import current_context, resolve_device

        batch = self._pipe.next()
        if batch is None:
            raise StopIteration
        img, lab, count = batch
        dev = resolve_device(current_context())
        data = NDArray(self._preprocess(img, dev))
        label = torch.from_numpy(_np.ascontiguousarray(
            lab[:, 0] if self._label_width == 1 else lab))
        if dev.type == "cuda":
            # pinned, so the copy does not wait for the card's queue
            label = label.pin_memory()
        return DataBatch([data], [NDArray(label.to(dev, non_blocking=True))],
                         pad=self.batch_size - count)

    def reset(self):
        self._pipe.reset()

    def close(self):
        self._pipe.close()

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001 (interpreter shutdown)
            pass


def ImageRecordIter(**kwargs):
    """The RecordIO image pipeline (reference: src/io/
    iter_image_recordio_2.cc): :class:`ImageRecordIterNative`, the
    reference's default route, for an RGB ``data_shape`` over a
    ``path_imgrec``; otherwise (``use_native=False``, no ``path_imgrec``,
    or C != 3) the ``ImageIter`` route, ``image.ImageRecordIterImpl``."""
    use_native = kwargs.pop("use_native", True)
    if use_native and kwargs.get("path_imgrec") and \
            tuple(kwargs.get("data_shape", (3, 224, 224)))[0] == 3:
        return ImageRecordIterNative(**kwargs)
    from .image import ImageRecordIterImpl

    return ImageRecordIterImpl(**kwargs)


class RecordIOIter:
    """The raw records of one shard of a RecordIO file, in order: record
    ``i`` (counting logical records) belongs to part ``i % num_parts``
    (reference: ``io.RecordIOIter``, dmlc's round-robin split).  Yields
    ``bytes``; decode with ``recordio.unpack``/``unpack_img``.
    ``batch_records`` and ``queue_depth`` (the reference's native
    read-ahead) are accepted; reading is synchronous."""

    def __init__(self, path, batch_records=64, queue_depth=4, part_index=0,
                 num_parts=1):
        from .recordio import MXRecordIO

        self._path = path
        self._reader = MXRecordIO(path, "r")
        self._part_index, self._num_parts = part_index, max(1, num_parts)
        self._ordinal = 0

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        while True:
            buf = self._reader.read()
            if buf is None:
                raise StopIteration
            mine = (self._ordinal % self._num_parts) == self._part_index
            self._ordinal += 1
            if mine:
                return buf

    def reset(self):
        self._reader.reset()
        self._ordinal = 0

    def close(self):
        self._reader.close()

"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter``,
``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``, ``CSVIter`` and
``MNISTIter``.

PyTorch counterpart of ``mxnet_tpu/io.py`` (reference:
python/mxnet/io.py, src/io/iter_csv.cc, src/io/iter_mnist.cc).  Batches
are ``NDArray``s made with ``nd.array`` on the current context (``gpu(0)``
unless the caller chose another, as the reference's land on its default
device); ``NDArrayIter`` shuffles with numpy's global generator.
``PrefetchingIter`` reads ahead on one thread, under the context that was
current when it started.  ``MNISTIter`` reads idx
files already on disk (or makes the reference's synthetic set when they
are absent); nothing is downloaded.

Not ported, each refused with ``MXNetError``: ``ImageRecordIter`` and
``RecordIOIter`` (the reference's native decode pipeline; ROADMAP.md,
Queue 1, item 3) and ``shard_data_batch`` (a device mesh; Queue 1,
item 5).
"""
from __future__ import annotations

import collections
import contextlib
import queue
import threading
from collections import namedtuple

import numpy as _np

from .base import MXNetError
from .context import Context
from .ndarray import array as nd_array
from .ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter",
           "RecordIOIter", "shard_data_batch"]


def shard_data_batch(batch, mesh, axis: str = "dp", strict: bool = False):
    raise MXNetError("shard_data_batch: a device mesh is not ported "
                     "(ROADMAP.md, Queue 1, item 5: multi-process "
                     "distributed)")


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


def ImageRecordIter(**kwargs):
    raise MXNetError("ImageRecordIter is not ported (ROADMAP.md, Queue 1, "
                     "item 3: the RecordIO image pipeline)")


class RecordIOIter:
    def __init__(self, *args, **kwargs):
        raise MXNetError("RecordIOIter is not ported (ROADMAP.md, Queue 1, "
                         "item 3: the RecordIO image pipeline)")

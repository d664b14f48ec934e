"""DataLoader (PyTorch counterpart of
``mxnet_tpu/gluon/data/dataloader.py``).

``default_batchify_fn`` stacks ``NDArray`` samples with ``nd.stack`` on
their own device, as the reference does, so a dataset kept on the card
gives batches on the card.  Other samples (numpy arrays, scalars) are
stacked with numpy (float64 becomes float32) into CPU ``NDArray``s
(pinned with ``pin_memory=True``), and the training loop moves each such
batch to its context (``x.as_in_context(ctx)``), as torch's own loader
leaves device placement to the caller.  ``num_workers=0`` batches in the
calling thread; ``num_workers > 0`` with ``thread_pool=True`` (the
default) in a thread pool, ``prefetch`` batches ahead, yielded in order.
The reference's process pool (``thread_pool=False``) is not ported
(ROADMAP.md, Queue 1, item 2): asking for it raises.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as _np
import torch

from ... import ndarray as nd
from ...base import MXNetError
from ...ndarray.ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data, pin_memory=False):
    """Stack samples into a batch: NDArrays on their own device, anything
    else on the host (tuples of samples into a list of batches)."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data, axis=0)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(i), pin_memory)
                for i in zip(*data)]
    arr = _np.asarray(data)
    if arr.dtype == _np.float64:
        arr = arr.astype(_np.float32)
    t = torch.from_numpy(_np.ascontiguousarray(arr))
    return NDArray(t.pin_memory() if pin_memory else t)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with explicit "
                                 "sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError("batch_sampler is mutually exclusive with "
                             "batch_size/shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, int(num_workers))
        if self._num_workers and not thread_pool:
            raise MXNetError(
                "DataLoader(thread_pool=False): the process pool is not "
                "ported yet (ROADMAP.md, Queue 1, item 2); use "
                "thread_pool=True")
        if batchify_fn is None:
            def batchify_fn(data):
                return default_batchify_fn(data, pin_memory)
        self._batchify_fn = batchify_fn
        self._pool = ThreadPoolExecutor(self._num_workers) \
            if self._num_workers else None
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)

    def _batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if self._pool is None:
            for batch_idx in self._batch_sampler:
                yield self._batch(batch_idx)
            return
        pending = []
        it = iter(self._batch_sampler)
        try:
            for batch_idx in it:
                pending.append(self._pool.submit(self._batch, batch_idx))
                if len(pending) > self._prefetch:
                    yield pending.pop(0).result()
            while pending:
                yield pending.pop(0).result()
        finally:
            for fut in pending:
                fut.cancel()

    def close(self):
        """Shut down the worker threads."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        return len(self._batch_sampler)

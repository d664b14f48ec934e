"""Bucketed sequence data iterator (PyTorch counterpart of
``mxnet_tpu/rnn/io.py``; reference: python/mxnet/rnn/io.py).

Each batch is one bucket's sentences padded to the bucket length, so a
``BucketingModule`` binds one executor per bucket.  The order comes from
Python's global ``random``, with the reference's draws: each bucket's
shuffle of a throwaway copy (which orders nothing but consumes draws),
then the shuffle of the batch list.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as _np

from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import array as nd_array

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Buckets encoded sentences by length; each batch is one bucket padded
    to the bucket length (reference: BucketSentenceIter; used by
    example/rnn/bucketing).

    sentences: list of lists of int ids. Label is the input shifted by one
    (next-token prediction), as in the reference.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            counts = _np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(counts)
                       if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets.sort()
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.invalid_label = invalid_label

        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = next((i for i, b in enumerate(buckets) if b >= len(sent)),
                        None)
            if buck is None:
                ndiscard += 1
                continue
            buf = _np.full((buckets[buck],), invalid_label, dtype=dtype)
            buf[:len(sent)] = sent
            self.data[buck].append(buf)
        self.data = [_np.asarray(x) for x in self.data]
        if ndiscard:
            import logging

            logging.warning("BucketSentenceIter: discarded %d sentences longer "
                            "than the largest bucket", ndiscard)

        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        self.reset()

    @property
    def provide_data(self):
        shape = (self.batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else (self.default_bucket_key, self.batch_size)
        return [DataDesc(self.data_name, shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else (self.default_bucket_key, self.batch_size)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self.curr_idx = 0
        self.idx = []
        for i, buck in enumerate(self.data):
            # shuffles a copy: no effect on the order, but the draws are
            # the reference's, so the batch order below is too
            _pyrandom.shuffle(buck.tolist())
            for j in range(0, len(buck) - self.batch_size + 1, self.batch_size):
                self.idx.append((i, j))
        _pyrandom.shuffle(self.idx)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        buck = self.data[i][j:j + self.batch_size]
        label = _np.full_like(buck, self.invalid_label)
        label[:, :-1] = buck[:, 1:]
        if self.major_axis == 1:
            buck, label = buck.T, label.T
        shape = buck.shape
        return DataBatch([nd_array(buck)], [nd_array(label)], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, shape)],
                         provide_label=[DataDesc(self.label_name, shape)])
